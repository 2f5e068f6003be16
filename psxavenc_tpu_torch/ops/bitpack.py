"""BS bitstream packing on torch tensors.

Counterpart of ``pack_bits``, ``streams_to_u32`` and ``BLOCK_CAP_WORDS``
in ``psxavenc_tpu/ops/bitpack.py``. Bit order matches the reference
packer (mdec.c:321-333): 16-bit groups filled MSB-first, stored as
little-endian byte pairs. Unsigned 32-bit values are held in int64 and
masked, since torch's ``>>`` on int32 is arithmetic.
"""

import torch

BLOCK_CAP_WORDS = 16  # per-block stream capacity (256 bits)

U32_MASK = 0xFFFFFFFF


def _shl(x, n):
    return torch.bitwise_left_shift(x, n)


def pack_bits(codes, bits, *, capacity_words):
    """Pack symbol streams into 16-bit words, the exact flat packer.

    codes: (R, S) int64 right-aligned code values; bits: (R, S) bit
    lengths (0 = skip). Returns (words (R, capacity_words) int64 holding
    u16 values, total_bits (R,) int64). Bits past the capacity drop.
    """
    codes = codes.to(torch.int64)
    bits = bits.to(torch.int64)
    R = codes.shape[0]
    offsets = torch.cumsum(bits, dim=1) - bits
    total_bits = offsets[:, -1] + bits[:, -1]
    end = offsets + bits

    # One spare column collects dropped writes.
    words = torch.zeros((R, capacity_words + 1), dtype=torch.int64,
                        device=codes.device)
    w0 = offsets >> 4
    one = torch.ones_like(codes)
    for part in range(3):
        w = w0 + part
        win_start = w << 4
        win_end = win_start + 16
        # Overlap of [offset, end) with this word's bit window; the code's
        # LSB sits at global bit end-1.
        lo = torch.maximum(offsets, win_start)
        hi = torch.minimum(end, win_end)
        n = hi - lo
        valid = (n > 0) & (bits > 0)
        rsh = (end - hi).clamp(0, 31)
        nbits = n.clamp(0, 31)
        chunk = (codes >> rsh) & (_shl(one, nbits) - 1)
        lsh = (win_end - hi).clamp(0, 31)
        val = torch.where(valid, _shl(chunk, lsh) & U32_MASK, 0)
        idx = torch.where(valid & (w < capacity_words), w, capacity_words)
        # Bit ranges are disjoint, so add == or.
        words.scatter_add_(1, idx, val)
    return words[:, :capacity_words], total_bits


def streams_to_u32(streams, goff):
    """Per-block placed u32 values: shift each block's 16-word MSB-first
    stream to its global sub-word offset, even-align it and pack
    little-endian u16 pairs.

    streams: (..., NBe, 16) u16 values; goff: (..., NBe) global bit
    offsets. Returns (vals32 (..., NBe, 9) int64 u32 values, e0 (..., NBe)
    int64 u32-word offsets, monotone along the block axis).
    """
    s = streams.to(torch.int64)
    sh = (goff & 15).to(torch.int64)[..., None]
    s_prev = torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)
    # Stream bits [16i - sh, 16(i+1) - sh) form contrib word i; sh == 0
    # makes the << 16 term vanish under the & 0xFFFF mask.
    c_main = (s >> sh) | (_shl(s_prev, 16 - sh) & 0xFFFF)
    c_tail = _shl(s[..., -1:], 16 - sh) & 0xFFFF
    contrib = torch.cat([c_main, c_tail], dim=-1)
    w0 = goff >> 4
    zcol = torch.zeros_like(contrib[..., :1])
    shifted = torch.where(((w0 & 1) == 1)[..., None],
                          torch.cat([zcol, contrib], dim=-1),
                          torch.cat([contrib, zcol], dim=-1))
    pairs = shifted.reshape(shifted.shape[:-1] + (9, 2))
    vals32 = pairs[..., 0] | (pairs[..., 1] << 16)
    return vals32, (goff >> 5).to(torch.int64)


def u32_to_i32(x):
    """int64 holding u32 values -> int32 with the same bit pattern."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def words_u16(out32, capacity_words):
    """(B, cap32) int32 placed words -> (B, capacity_words) int16 view of
    the little-endian u16 payload (the on-disk byte order; read it as
    uint16 on the host)."""
    return out32.view(torch.int16)[:, :capacity_words]
