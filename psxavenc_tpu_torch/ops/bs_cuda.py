"""Wrappers and plain versions of the BS kernels K1-K3.

Counterpart of ``psxavenc_tpu/ops/bs_pallas.py``. Each kernel has:

- a plain PyTorch version (``*_plain``) computing the same integers, used
  for CPU tensors and as the reference the kernel is checked against;
- a wrapper that takes the plain version only for CPU tensors and, for
  CUDA tensors, launches the hand-written kernel (``csrc/``) or raises;
- a launch count in ``LAUNCHES``, incremented where the kernel launches.

The kernel sources carry the design notes: what each replaces, what bounds
it on the H100, and what the design does about it.
"""

import torch

from . import _build
from . import bs as bs_ops
from . import bitpack as bitpack_ops

TILE = 512  # coefficient lane padding, as psxavenc_tpu's select kernel

LAUNCHES = {"select_scale_pix": 0, "dc_stage": 0, "emit_prep": 0}


def _on_cuda(t, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _require(t, dtype, ndim, name):
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def nb_padded(nb):
    return -(-nb // TILE) * TILE


# ------------------------------------------------------------------- K1

def _exact_totals(ca, s):
    """Exact AC (bits, nonzero count) per frame of |coefs| ``ca``
    (B, 63, NB) at scale s (1..63)."""
    d = bs_ops.quant_zz(ca.device)[None, :, None] * s
    mag = torch.div(ca + (d >> 1), d, rounding_mode="floor")
    nz = mag != 0
    run = bs_ops._runs(nz, 1)
    bits = torch.where(nz, bs_ops.ac_bits_closed_form(run, mag), 0)
    return (bits.sum(dim=(1, 2), dtype=torch.int32),
            nz.sum(dim=(1, 2), dtype=torch.int32))


def select_scale_pix_plain(pix, thr_ac):
    """FDCT + first-fit scale selection (plain torch).

    pix: (B, 64, NB) int8 centered pixel rows; thr_ac: (B,) int32.
    Returns (scale, ac_bits, nz, coefs): scale (B,) int32 is the first s in
    1..63 whose exact AC bit total is <= thr_ac (64 if none, with ac_bits
    and nz 0); coefs (B, 64, nb_pad) int16 signed zigzag rows, row 63 and
    the pad lanes zero. The scales are walked in order; a frame leaves the
    walk at its first fit.
    """
    B, P, nb = pix.shape
    c = bs_ops.pixrows_to_coefs_zz(pix)                    # (B, 63, NB)
    coefs = torch.zeros((B, 64, nb_padded(nb)), dtype=torch.int16,
                        device=pix.device)
    coefs[:, :63, :nb] = c.to(torch.int16)
    ca = c.abs()
    thr = thr_ac.to(device=pix.device, dtype=torch.int32)
    scale = torch.full((B,), 64, dtype=torch.int32, device=pix.device)
    bits = torch.zeros((B,), dtype=torch.int32, device=pix.device)
    nz = torch.zeros((B,), dtype=torch.int32, device=pix.device)
    active = torch.arange(B, device=pix.device)   # frames without a fit
    for s in range(1, 64):
        b_s, n_s = _exact_totals(ca[active], s)
        fit = b_s <= thr[active]
        done = active[fit]
        scale[done] = s
        bits[done] = b_s[fit]
        nz[done] = n_s[fit]
        active = active[~fit]
        if not active.numel():
            break
    return scale, bits, nz, coefs


def select_scale_pix(pix, thr_ac):
    """K1 (``csrc/bs_select.cu``): see :func:`select_scale_pix_plain`."""
    if not _on_cuda(pix, "select_scale_pix"):
        return select_scale_pix_plain(pix, thr_ac)
    _require(pix, torch.int8, 3, "select_scale_pix pix")
    B, P, nb = pix.shape
    if P != 64:
        raise ValueError("select_scale_pix: pix must be (B, 64, NB)")
    thr = thr_ac.to(device=pix.device, dtype=torch.int32).contiguous()
    if thr.shape != (B,):
        raise ValueError("select_scale_pix: thr_ac must be (B,)")
    nb_pad = nb_padded(nb)
    scale = torch.empty((B,), dtype=torch.int32, device=pix.device)
    bits = torch.empty_like(scale)
    nz = torch.empty_like(scale)
    coefs = torch.empty((B, 64, nb_pad), dtype=torch.int16, device=pix.device)
    LAUNCHES["select_scale_pix"] += 1
    _build.launch("psx_select_scale_pix", pix, _build.ptr(pix),
                  _build.ptr(thr), B, nb, nb_pad, _build.ptr(scale),
                  _build.ptr(bits), _build.ptr(nz), _build.ptr(coefs))
    return scale, bits, nz, coefs


# ------------------------------------------------------------------- K2

def dc_stage_plain(dc_q, codec):
    """v3/v3dc DC chain + DC Huffman (plain torch): (B, NB) clamped
    quantized DCs -> (dc_bits, dc_code) int32."""
    return bs_ops._dc_stage(dc_q, codec)


def dc_stage(dc_q, codec):
    """K2 (``csrc/bs_dc.cu``): see :func:`dc_stage_plain`; v3/v3dc only."""
    if codec not in (bs_ops.BS_V3, bs_ops.BS_V3DC):
        raise ValueError("dc_stage: codec must be BS_V3 or BS_V3DC")
    if not _on_cuda(dc_q, "dc_stage"):
        return dc_stage_plain(dc_q, codec)
    dc_q = dc_q.to(torch.int32).contiguous()
    B, nb = dc_q.shape
    if nb % 6:
        raise ValueError("dc_stage: NB must be a multiple of 6")
    bits = torch.empty_like(dc_q)
    code = torch.empty_like(dc_q)
    LAUNCHES["dc_stage"] += 1
    _build.launch("psx_dc_stage", dc_q, _build.ptr(dc_q), B, nb,
                  int(codec == bs_ops.BS_V3DC), _build.ptr(bits),
                  _build.ptr(code))
    return bits, code


# ------------------------------------------------------------------- K3

def _place(acc, o, b, c):
    """OR (B, NB) codes ``c`` of ``b`` bits at in-block offsets ``o`` into
    the (B, 8, NB) MSB-first u32 windows ``acc`` (int64)."""
    q = (o >> 5)[:, None, :]
    sbits = 64 - (o & 31) - b
    mask = bitpack_ops.U32_MASK
    sh = (sbits - 32).clamp(0, 31)
    sl = (32 - sbits).clamp(0, 31)
    hi = torch.where(sbits >= 32, torch.bitwise_left_shift(c, sh) & mask,
                     c >> sl)
    lo = torch.where(sbits < 32,
                     torch.bitwise_left_shift(c, sbits.clamp(0, 31)) & mask,
                     0)
    row = torch.arange(8, device=acc.device)[None, :, None]
    return (acc | torch.where(row == q, hi[:, None, :], 0)
            | torch.where(row == q + 1, lo[:, None, :], 0))


def emit_prep_plain(coefs, scale, dc_code, dc_bits, *, eof):
    """Winner emission + per-block packing + placement prep (plain torch).

    coefs: (B, 64, nb_pad) int16 select-kernel coefficients; scale (B,) in
    1..63; dc_code/dc_bits (B, NB). Returns (vals32 (B, NB+1, 9) int32 u32
    bit patterns, e0 (B, NB+1) int32, block_bits (B, NB) int32,
    total_bits (B,) int32), the EOF block at index NB. Blocks over 256
    bits are cut; callers gate on block_bits.
    """
    B = coefs.shape[0]
    nb = dc_code.shape[1]
    dev = coefs.device
    c = coefs[:, :63, :nb].to(torch.int32)
    qs = (bs_ops.quant_zz(dev)[None, :]
          * scale.to(torch.int32)[:, None])[:, :, None]
    mag = bs_ops._div_rounded_fast(c.abs(), qs.expand_as(c))
    ac = torch.where(c < 0, -mag, mag).clamp(-0x200, 0x1FE)
    nz = ac != 0
    run = bs_ops._runs(nz, 1)
    bits_nz, code_nz = bs_ops.ac_bits_code_closed_form(run, ac)
    bits = torch.where(nz, bits_nz, 0).to(torch.int64)
    code = torch.where(nz, code_nz, 0).to(torch.int64)

    dcb = dc_bits.to(torch.int64)
    offs = dcb[:, None, :] + torch.cumsum(bits, dim=1) - bits  # (B, 63, NB)
    total = offs[:, 62] + bits[:, 62]
    acc = torch.zeros((B, 8, nb), dtype=torch.int64, device=dev)
    acc = _place(acc, torch.zeros_like(dcb), dcb, dc_code.to(torch.int64))
    for i in range(63):
        acc = _place(acc, offs[:, i], bits[:, i], code[:, i])
    two = torch.full_like(total, 2)
    acc = _place(acc, total, two, two)                 # EOB
    block_bits = total + 2

    # The EOF block: a lone 10-bit code at the top of stream word 0.
    eof_acc = torch.zeros((B, 8, 1), dtype=torch.int64, device=dev)
    eof_acc[:, 0, 0] = eof << 22
    acc = torch.cat([acc, eof_acc], dim=2)              # (B, 8, NB+1)
    bb = torch.cat([block_bits, torch.full((B, 1), 10, dtype=torch.int64,
                                           device=dev)], dim=1)
    goff = torch.cumsum(bb, dim=1) - bb
    streams = torch.stack([acc >> 16, acc & 0xFFFF], dim=2).reshape(
        B, 16, nb + 1).transpose(1, 2)
    vals32, e0 = bitpack_ops.streams_to_u32(streams, goff)
    return (bitpack_ops.u32_to_i32(vals32), e0.to(torch.int32),
            block_bits.to(torch.int32), bb.sum(dim=1).to(torch.int32))


def emit_prep(coefs, scale, dc_code, dc_bits, *, eof):
    """K3 (``csrc/bs_emit.cu``): see :func:`emit_prep_plain`."""
    if not _on_cuda(coefs, "emit_prep"):
        return emit_prep_plain(coefs, scale, dc_code, dc_bits, eof=eof)
    _require(coefs, torch.int16, 3, "emit_prep coefs")
    B, P, nb_pad = coefs.shape
    nb = dc_code.shape[1]
    if P != 64 or nb > nb_pad:
        raise ValueError("emit_prep: coefs must be (B, 64, nb_pad >= NB)")
    dev = coefs.device
    scale = scale.to(device=dev, dtype=torch.int32).contiguous()
    dc_code = dc_code.to(device=dev, dtype=torch.int32).contiguous()
    dc_bits = dc_bits.to(device=dev, dtype=torch.int32).contiguous()
    if scale.shape != (B,) or dc_code.shape != (B, nb) \
            or dc_bits.shape != (B, nb):
        raise ValueError("emit_prep: expected scale (B,) and dc_code, "
                         "dc_bits (B, NB)")
    vals32 = torch.empty((B, nb + 1, 9), dtype=torch.int32, device=dev)
    e0 = torch.empty((B, nb + 1), dtype=torch.int32, device=dev)
    block_bits = torch.empty((B, nb), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    LAUNCHES["emit_prep"] += 1
    _build.launch("psx_emit_prep", coefs, _build.ptr(coefs), B, nb_pad, nb,
                  _build.ptr(scale), _build.ptr(dc_code), _build.ptr(dc_bits),
                  int(eof), _build.ptr(vals32), _build.ptr(e0),
                  _build.ptr(block_bits), _build.ptr(total))
    return vals32, e0, block_bits, total
