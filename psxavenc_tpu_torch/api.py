"""Batch tensor API: BS frames in, packed bitstream words out.

Counterpart of ``psxavenc_tpu.api.bs_encode_frames_packed`` with the
``fused_mxu`` packer, the path psxavenc_tpu runs on its accelerator:

  NV21 -> pixel rows (glue) -> DC sums and DC stage (K2 for v3/v3dc)
  -> AC fit threshold -> FDCT + scale search (K1) -> emission +
  placement prep (K3) -> placement (K4) -> the overflow path.

The device is the frames tensor's device; on the CPU every kernel runs
its plain version.
"""

import torch

from .ops import bitpack as bitpack_ops
from .ops import bitpack_cuda
from .ops import bs as bs_ops
from .ops import bs_cuda

COUNTERS = {"overflow_frames": 0}


class _Stages:
    """The four kernel stages: the wrappers, or the plain versions (which
    run on any device, for measuring the plain path on the card)."""

    def __init__(self, use_kernels):
        if use_kernels:
            self.dc_stage = bs_cuda.dc_stage
            self.select = bs_cuda.select_scale_pix
            self.emit_prep = bs_cuda.emit_prep
            self.place = bitpack_cuda.place_vals
        else:
            self.dc_stage = bs_cuda.dc_stage_plain
            self.select = bs_cuda.select_scale_pix_plain
            self.emit_prep = bs_cuda.emit_prep_plain
            self.place = bitpack_cuda.place_vals_plain


_KERNELS = _Stages(True)
_PLAIN = _Stages(False)


def _overflow_words(coefs, scale_idx, dc_bits, dc_code, eof,
                    capacity_words, cap32):
    """Exact flat path for frames with a block stream over 256 bits
    (api.py:212-235 of psxavenc_tpu): emit the symbols at the selected
    scale and pack them with ``pack_bits``. Returns (n, cap32) int32
    placed u32 words."""
    n, nb = dc_code.shape
    c = coefs[:, :63, :nb].to(torch.int32)
    codes, bits = bs_ops.emit_symbols_at(c, scale_idx, dc_bits, dc_code)
    eof_codes = torch.zeros((n, 1, 65), dtype=torch.int64,
                            device=codes.device)
    eof_bits = torch.zeros_like(eof_codes)
    eof_codes[:, 0, 0] = eof
    eof_bits[:, 0, 0] = 10
    codes = torch.cat([codes, eof_codes], dim=1).reshape(n, -1)
    bits = torch.cat([bits, eof_bits], dim=1).reshape(n, -1)
    words, _ = bitpack_ops.pack_bits(codes, bits,
                                     capacity_words=capacity_words)
    words = torch.nn.functional.pad(words, (0, 2 * cap32 - capacity_words))
    pairs = words.reshape(n, cap32, 2)
    return bitpack_ops.u32_to_i32(pairs[..., 0] | (pairs[..., 1] << 16))


def bs_encode_frames_packed(frames, budgets, *, codec, width, height,
                            capacity_words, use_kernels=True):
    """Fused BS frame batch: (B, w*h*3/2) uint8 NV21 frames and (B,) int32
    byte budgets on one device -> dict of device tensors:

    - ``scale`` (B,) int32: chosen quant scales, 64 = unfittable (the
      caller raises, mdec.c:723);
    - ``words`` (B, capacity_words) int16: the packed payload, the bit
      patterns of little-endian u16 words (view as uint16 on the host);
    - ``total_bits`` (B,) int32: bitstream bits including the EOF code;
    - ``nz_count`` (B,) int32: nonzero AC count at the chosen scale.

    ``capacity_words`` must cover the largest budget: (max - 8) // 2.
    ``use_kernels=False`` runs the plain versions on any device (for
    measuring the plain path; it is never chosen automatically).
    """
    st = _KERNELS if use_kernels else _PLAIN
    eof = 0x1FF if codec == bs_ops.BS_V2 else 0x3FF
    pix = bs_ops.rearrange_nv21_rows(frames, width, height)   # (B, 64, NB)
    nb = pix.shape[2]
    dc_q = bs_ops.dc_quant_from_pixrows(pix)
    if codec == bs_ops.BS_V2:
        dc_bits, dc_code = bs_ops._dc_stage(dc_q, codec)
    else:
        dc_bits, dc_code = st.dc_stage(dc_q, codec)
    dc_total = dc_bits.sum(dim=1, dtype=torch.int32)
    thr_ac = bs_ops.ac_threshold(budgets, dc_total, nb)

    scale, ac_bits, nz, coefs = st.select(pix, thr_ac)
    # Unfittable frames emit at scale 1 (the caller raises for them).
    scale_idx = torch.where(scale <= 63, scale - 1, 0)
    total_bits = ac_bits + dc_total + 2 * nb + 10
    vals32, e0, block_bits, _ = st.emit_prep(coefs, scale_idx + 1, dc_code,
                                             dc_bits, eof=eof)
    out32 = st.place(vals32, e0, capacity_words=capacity_words)

    # Frames with a block over the 256-bit window take the exact path;
    # for every other frame both paths give the same words.
    ovf = (block_bits > 16 * bitpack_ops.BLOCK_CAP_WORDS).any(dim=1)
    idx = torch.nonzero(ovf)[:, 0]
    if idx.numel():
        COUNTERS["overflow_frames"] += int(idx.numel())
        out32[idx] = _overflow_words(
            coefs[idx], scale_idx[idx], dc_bits[idx], dc_code[idx], eof,
            capacity_words, out32.shape[1])
    return {"scale": scale,
            "words": bitpack_ops.words_u16(out32, capacity_words),
            "total_bits": total_bits,
            "nz_count": nz}
