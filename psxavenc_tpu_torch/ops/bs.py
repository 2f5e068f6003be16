"""MDEC BS frame encoding ops on torch tensors: tables, quantization,
run lengths, Huffman closed forms, DC chain, symbol emission and the
NV21 rearranges.

Counterpart of the parts of ``psxavenc_tpu/ops/bs.py`` that the fused
BS path needs. The constant tables are copied (``tests/test_torch_tables``
pins them equal to the JAX module's arrays); every function computes the
same integers as its JAX namesake. Code values that JAX keeps in uint32
are held in int32 or int64 here: none of them exceeds 17 bits.
"""

import numpy as np
import torch
from torch import where

from . import fdct as fdct_ops

# PSX default quantization matrix (mdec.c:189-198).
QUANT_PSX = np.array([
    2, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
], dtype=np.int32)

# Inverse zigzag: scan position -> row-major block index (mdec.c:213-222).
ZAGZIG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# AC quantizer divisors of scan positions 1..63 at scale 1.
QUANT_ZZ = QUANT_PSX[ZAGZIG[1:]]

INDEX_CR, INDEX_CB, INDEX_Y = 0, 1, 2

BS_V2, BS_V3, BS_V3DC = 0, 1, 2

# Closed-form AC Huffman constants (the MDEC code set of mdec.c:39-157,
# packed as in psxavenc_tpu/ops/bs.py): 6-bit prefixes five per word and
# (prefix << 4 | bits - 3) combos three per word, addressed by run or by
# magnitude-class offset + run.
_ACC_W1 = (0x61C50C3, 0x51C4147, 0xE8228E7, 0x1969F20D, 0x597)
_ACC_W2 = (0xF904184, 0x11455789, 0x10)
_ACC_W37 = (0x1270B945, 0x14306512, 0x2151B993, 0x15296)
_ACC_W8 = (0x41361D,)
_ACBC_W1 = (0x520C430, 0x7418C73, 0x7511054, 0x2369D855, 0xE881A26,
            0x1FA220D8, 0x17A669AA, 0x16A)
_ACBC_W2 = (0x4519042, 0x983E246, 0x11A569EA, 0x42D1B)
_ACBC_W37 = (0xB895853, 0x12B4A9CA, 0xC81954E, 0x2664ED4A, 0x21652DBA,
             0x15B2A16B)
_ESC10 = 0x7FFF                      # unrepresentable combo = escape


def _clamp_coeff(q):
    """int16 wrap then clamp to [-0x200, +0x1FE] (mdec.c:257-267)."""
    w = ((q & 0xFFFF) ^ 0x8000) - 0x8000
    return w.clamp(-0x200, 0x1FE)


def _div_rounded(n, d):
    """round(n/d) half away from zero, exact integers (mdec.c:438)."""
    an = n.abs()
    q = torch.div(an + (d >> 1), d, rounding_mode="floor")
    return where(n < 0, -q, q)


def _div_rounded_fast(n, d):
    """Exact round-half-away n/d via an f32 reciprocal and one integer
    remainder correction (valid for |n| < 2^17, 1 <= d <= 2^13), the
    arithmetic of psxavenc_tpu's quantizer and of the CUDA kernels."""
    an = n.abs()
    t = an + (d >> 1)
    q0 = (t.to(torch.float32) * (1.0 / d.to(torch.float32))).to(n.dtype)
    r = t - q0 * d
    q = q0 + (r >= d).to(n.dtype) - (r < 0).to(n.dtype)
    return where(n < 0, -q, q)


def _ge(x, t):
    return (x >= t).to(x.dtype)


def ac_bits_closed_form(run, mag):
    """AC Huffman code length as a step function of (run, |level|);
    escapes are 22 bits (mdec.c:258)."""
    r, a = run, mag
    ge = _ge
    b1 = (3 + ge(r, 1) + ge(r, 2) + ge(r, 3) + ge(r, 5) + ge(r, 8)
          + ge(r, 10) + 2 * ge(r, 14) + 2 * ge(r, 17) + ge(r, 22)
          + 3 * ge(r, 27))
    b1 = where(r > 31, 22, b1)
    b2 = (5 + 2 * ge(r, 1) + ge(r, 2) + ge(r, 3) + 2 * ge(r, 4)
          + 2 * ge(r, 6) + ge(r, 9) + 3 * ge(r, 11))
    b2 = where(r > 16, 22, b2)
    b3 = (6 + 3 * ge(r, 1) + 2 * ge(r, 2) + 2 * ge(r, 3) + ge(r, 5)
          + 3 * ge(r, 6))
    b3 = where(r > 6, 22, b3)
    b4 = where(r > 3, 22, 8 + 3 * ge(r, 1) + 2 * ge(r, 2) + ge(r, 3))
    b5 = where(r > 2, 22, 9 + 4 * ge(r, 1) + ge(r, 2))
    b6 = where(r > 1, 22, 9 + 5 * ge(r, 1))
    b7 = where(r > 1, 22, 11 + 3 * ge(r, 1))
    big0 = where(a <= 40, 13 + ge(a, 12) + ge(a, 16) + ge(a, 32), 22)
    big1 = where(a <= 18, 16 + ge(a, 15), 22)
    big = where(r == 0, big0, where(r == 1, big1, 22))
    bits = big
    for level, bl in ((7, b7), (6, b6), (5, b5), (4, b4), (3, b3),
                      (2, b2), (1, b1)):
        bits = where(a == level, bl, bits)
    return bits


def _packed(words, idx, width, per_word):
    """Extract constant #idx from int32 words holding ``per_word``
    values of ``width`` bits each."""
    w = torch.div(idx, per_word, rounding_mode="floor")
    sh = (idx % per_word) * width
    acc = torch.zeros_like(idx)
    for wi, cw in enumerate(words):
        acc = where(w == wi, cw, acc)
    return (acc >> sh) & ((1 << width) - 1)


def _packed6(words, idx):
    return _packed(words, idx, 6, 5)


def _packed10(words, idx):
    return _packed(words, idx, 10, 3)


def _p8r0(a):
    """Run-0 prefix of |level| >= 8."""
    return where(a < 12, _packed6(_ACC_W8, (a - 8).clamp(0, 3)),
                 where(a < 16, 0x1A - (a - 12),
                       where(a < 32, 0x1F - (a - 16), 0x18 - (a - 32))))


def ac_bits_code_closed_form(run, ac):
    """Fused AC Huffman (bits, code) of a signed level at run ``run``:
    one magnitude-class chain yields a (prefix << 4 | bits - 3) combo."""
    r = run
    a = ac.abs()
    sign = (ac < 0).to(ac.dtype)

    c1 = where(r < 22, _packed10(_ACBC_W1, r.clamp(max=21)),
               where(r < 27, ((0x1F - (r - 22)) << 4) | (14 - 3),
                     ((0x1F - (r - 27)) << 4) | (17 - 3)))
    c1 = where(r > 31, _ESC10, c1)
    c2 = where(r < 11, _packed10(_ACBC_W2, r.clamp(max=10)),
               ((0x1A - (r - 11)) << 4) | (17 - 3))
    c2 = where(r > 16, _ESC10, c2)
    off37 = where(a == 3, 0, where(a == 4, 7, where(
        a == 5, 11, where(a == 6, 14, 16))))
    rmax37 = where(a == 3, 6, where(a == 4, 3, where(a == 5, 2, 1)))
    c37 = _packed10(_ACBC_W37, (off37 + r).clamp(0, 17))
    c37 = where(r > rmax37, _ESC10, c37)
    p8r0 = _p8r0(a)
    b8r0 = 13 + _ge(a, 12) + _ge(a, 16) + _ge(a, 32)
    p8r1 = where(a < 15, 0x1F - (a - 8), 0x13 - (a - 15))
    b8r1 = 16 + _ge(a, 15)
    c8 = where(r == 0, (p8r0 << 4) | (b8r0 - 3), (p8r1 << 4) | (b8r1 - 3))
    esc8 = ((r == 0) & (a > 40)) | ((r == 1) & (a > 18)) | (r > 1)
    c8 = where(esc8, _ESC10, c8)

    combo = where(a == 1, c1, where(a == 2, c2, where(a <= 7, c37, c8)))
    is_esc = combo == _ESC10
    bits = where(is_esc, 22, (combo & 0xF) + 3)
    escape = (1 << 16) | ((r << 10) | (ac & 0x3FF))
    code = where(is_esc, escape, ((combo >> 4) << 1) | sign)
    return bits, code


def ac_code_closed_form(run, ac, bits):
    """AC Huffman code value of (run, level); ``bits`` is the closed-form
    length (22 = escape)."""
    r = run
    a = ac.abs()
    sign = (ac < 0).to(ac.dtype)

    p1 = where(r < 22, _packed6(_ACC_W1, r.clamp(max=21)),
               where(r < 27, 0x1F - (r - 22), 0x1F - (r - 27)))
    p2 = where(r < 11, _packed6(_ACC_W2, r.clamp(max=10)), 0x1A - (r - 11))
    off37 = where(a == 3, 0, where(a == 4, 7, where(
        a == 5, 11, where(a == 6, 14, 16))))
    p37 = _packed6(_ACC_W37, (off37 + r).clamp(0, 17))
    p8r1 = where(a < 15, 0x1F - (a - 8), 0x13 - (a - 15))
    p8 = where(r == 0, _p8r0(a), p8r1)
    prefix = where(a == 1, p1, where(a == 2, p2, where(a <= 7, p37, p8)))
    escape = (1 << 16) | ((r << 10) | (ac & 0x3FF))
    return where(bits == 22, escape, (prefix << 1) | sign)


def dc_bits_code_closed_form(types, keys):
    """BS v3 DC-delta Huffman (bits, code) of the 9-bit delta key
    (mdec.c:159-187); types 0/1 = chroma, 2 = luma. The unmapped delta
    -256 takes -255's code."""
    sd = ((keys & 0x1FF) ^ 0x100) - 0x100
    sd = sd.clamp(min=-255)
    mag = sd.abs()
    db = sum(_ge(mag, 1 << k) for k in range(1, 8))
    is_y = types == INDEX_Y
    one = torch.ones_like(db)

    bits_c = where(db == 0, 3, 2 * db + 2)
    bits = where(is_y & (db >= 3), 2 * db + 1, bits_c)
    bits = where(mag == 0, where(is_y, 3, 2), bits)

    pv_c = where(db == 0, 1, (one << (db + 1)) - 2)
    pv_y = where(db >= 4, (one << db) - 2,
                 where(db == 3, 6, where(db == 2, 5, db)))
    pv = where(is_y, pv_y, pv_c)
    mask = (one << (db + 1)) - 1
    suffix = where(sd > 0, sd & mask, (sd - 1) & mask)
    code = (pv << (db + 1)) | suffix
    code = where(mag == 0, where(is_y, 4, 0), code)
    return bits, code


_NEG_INF = -(1 << 31) + 1


def _shift_right(x, k, fill):
    """x[..., i - k] along the last axis, ``fill`` for i < k."""
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def dc_chain(dc, codec):
    """BS v3/v3dc DC delta chain (mdec.c:455-480) over a batch.

    ``dc``: (B, NB) clamped quantized DCs in encode order. Returns the
    (B, NB) delta & 0x1FF keys and the (NB,) block types. Per block type
    delta = round_half_away((dc - last) / 4), last += 4 * delta, then
    v3dc wraps the delta into [-0x80, 0x80].

    ``last`` stays a multiple of 4, so each block maps it through a
    threshold function f(x) = a if x < t else b; these compose, and the
    Cr, Cb and Y chains run as a Hillis-Steele scan of log2(4 * NB / 6)
    steps (psxavenc_tpu's ``_dc_chain_kernel`` formulation).
    """
    B, nb = dc.shape
    mb = nb // 6
    L = 4 * mb
    grid = dc.reshape(B, mb, 6).to(torch.int32)
    d = torch.zeros((B, 3, L), dtype=torch.int32, device=dc.device)
    d[:, 0, :mb] = grid[:, :, 0]
    d[:, 1, :mb] = grid[:, :, 1]
    d[:, 2, :] = grid[:, :, 2:].reshape(B, L)

    r = d & 3
    const = where(r == 0, d, where(r == 1, d - 1, d + 1))
    on_half = r == 2
    t = where(on_half, d, _NEG_INF)
    a = where(on_half, d + 2, const)
    b = where(on_half, d - 2, const)
    k = 1
    while k < L:
        # compose(p = element i-k, q = element i): threshold of p,
        # values q(a_p), q(b_p). End padding is constant elements, which
        # leave every earlier prefix as it is.
        tp = _shift_right(t, k, _NEG_INF)
        ap = _shift_right(a, k, 0)
        bp = _shift_right(b, k, 0)
        m = torch.arange(L, device=dc.device) >= k
        na = where(ap < t, a, b)
        nb_ = where(bp < t, a, b)
        t = where(m, tp, t)
        a = where(m, na, a)
        b = where(m, nb_, b)
        k *= 2
    last_after = where(0 < t, a, b)
    last_before = _shift_right(last_after, 1, 0)
    deltas3 = (last_after - last_before) >> 2

    deltas = torch.cat([deltas3[:, 0, :mb, None], deltas3[:, 1, :mb, None],
                        deltas3[:, 2].reshape(B, mb, 4)], dim=2)
    deltas = deltas.reshape(B, nb)
    if codec == BS_V3DC:
        deltas = where(deltas < -0x80, deltas + 0x100, deltas)
        deltas = where(deltas > 0x80, deltas - 0x100, deltas)
    types = (torch.arange(nb, dtype=torch.int32, device=dc.device)
             % 6).clamp(max=2)
    return deltas & 0x1FF, types


def _dc_stage(dc_q, codec):
    """Scale-independent DC Huffman stage: (B, NB) clamped quantized DCs
    -> (dc_bits, dc_code), both int32."""
    B, nb = dc_q.shape
    if codec == BS_V2:
        dc_bits = torch.full((B, nb), 10, dtype=torch.int32,
                             device=dc_q.device)
        return dc_bits, (dc_q & 0x3FF).to(torch.int32)
    keys, types = dc_chain(dc_q, codec)
    bits, code = dc_bits_code_closed_form(types[None, :], keys)
    return bits.to(torch.int32), code.to(torch.int32)


def _runs(nz, dim):
    """Zero-run length before each nonzero scan position along ``dim``
    (size 63, scan positions 1..63)."""
    shape = [1] * nz.ndim
    shape[dim] = 63
    posb = torch.arange(1, 64, dtype=torch.int32,
                        device=nz.device).reshape(shape)
    nzpos = where(nz, posb, 0)
    prev_incl = torch.cummax(nzpos, dim=dim).values
    prev_excl = prev_incl.roll(1, dims=dim)
    prev_excl.select(dim, 0).zero_()
    return posb - prev_excl - 1


def quant_zz(device):
    """(63,) int32 AC divisors at scale 1, scan order."""
    return torch.as_tensor(QUANT_ZZ, dtype=torch.int32, device=device)


def emit_symbols_at(c, scale_idx, dc_bits, dc_code):
    """Symbol emission at known per-frame scale indices.

    c: (B, 63, NB) int32 zigzag AC coefficients; scale_idx (B,);
    dc_bits/dc_code (B, NB). Returns (codes, bits), (B, NB, 65) int64:
    DC, the 63 ACs in scan order (zero-width where the level is zero),
    EOB.
    """
    B, _, nb = c.shape
    qs = quant_zz(c.device)[None, :] * (scale_idx.to(torch.int32)
                                        + 1)[:, None]
    ac = _clamp_coeff(_div_rounded_fast(c.to(torch.int32), qs[:, :, None]))
    nz = ac != 0
    run = _runs(nz, 1)
    bits_nz = ac_bits_closed_form(run, ac.abs())
    code_nz = ac_code_closed_form(run, ac, bits_nz)
    bits_w = where(nz, bits_nz, 0).transpose(1, 2)
    code_w = where(nz, code_nz, 0).transpose(1, 2)
    # EOB: the 2-bit code 0b10.
    eob = torch.full((B, nb, 1), 2, dtype=torch.int64, device=c.device)
    bits = torch.cat([dc_bits[..., None].to(torch.int64),
                      bits_w.to(torch.int64), eob], dim=2)
    codes = torch.cat([dc_code[..., None].to(torch.int64),
                       code_w.to(torch.int64), eob], dim=2)
    return codes, bits


def _blocks_encode_order(y, cr, cb, mb_x, mb_y):
    """(B, H, W) luma + (B, H/2, W/2) chroma -> (B, MB, 6, 8, 8) blocks in
    encode order (mdec.c:605-634): MBs column-major, blocks Cr, Cb, Y1-4."""
    B = y.shape[0]

    def blocks8(plane):
        return plane.reshape(B, mb_y, 8, mb_x, 8).permute(0, 3, 1, 2, 4)

    yb = y.reshape(B, mb_y, 2, 8, mb_x, 2, 8).permute(0, 4, 1, 2, 5, 3, 6)
    blocks = torch.stack([blocks8(cr), blocks8(cb), yb[:, :, :, 0, 0],
                          yb[:, :, :, 0, 1], yb[:, :, :, 1, 0],
                          yb[:, :, :, 1, 1]], dim=3)
    return blocks.reshape(B, mb_x * mb_y, 6, 8, 8)


def _split_nv21(frames, width, height):
    B = frames.shape[0]
    y = frames[:, :width * height].reshape(B, height, width)
    c = frames[:, width * height:].reshape(B, height // 2, width // 2, 2)
    return y, c[..., 0], c[..., 1]


def rearrange_nv21_frame(frames, width, height):
    """(B, w*h*3/2) NV21 bytes -> (B, MB, 6, 8, 8) int32 centered samples
    in encode order."""
    y, cr, cb = _split_nv21(frames, width, height)
    blocks = _blocks_encode_order(y, cr, cb, width // 16, height // 16)
    return blocks.to(torch.int32) - 128


def rearrange_nv21_rows(frames, width, height):
    """(B, w*h*3/2) NV21 bytes -> (B, 64, NB) int8 centered samples:
    column n = block n in encode order, row 8r+c = sample (r, c); the
    input form of the select kernel. p - 128 == int8(p ^ 0x80)."""
    y, cr, cb = _split_nv21(frames, width, height)
    blocks = _blocks_encode_order(y, cr, cb, width // 16, height // 16)
    B = blocks.shape[0]
    rows = blocks.reshape(B, -1, 64).transpose(1, 2)
    return (rows ^ 0x80).contiguous().view(torch.int8)


def pixrows_to_coefs_zz(pix):
    """(B, 64, NB) centered pixel rows -> (B, 63, NB) int32 zigzag AC
    coefficients (the row-form FDCT)."""
    rows = [pix[:, i, :].to(torch.int32) for i in range(64)]
    out = fdct_ops.fdct_rows(rows)
    return torch.stack([out[int(ZAGZIG[p + 1])] for p in range(63)], dim=1)


def dc_quant_from_pixrows(pix):
    """Clamped quantized DC per block from (B, 64, NB) pixel rows. The
    islow FDCT's DC is exactly the block's centered pixel sum, quantized
    by 8 * QUANT_PSX[0] = 16 (mdec.c:671)."""
    dc = pix.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return _clamp_coeff(_div_rounded(dc, 16))


def ac_threshold(budgets, dc_total, nb):
    """Per-frame AC-bit fit threshold: a frame fits iff its AC bits <=
    thr (the exact inverse of 8 + 2 * ceil(total_bits / 16) <= budget,
    mdec.c:321-333)."""
    half = torch.div(budgets.to(torch.int32) - 8, 2, rounding_mode="floor")
    return half * 16 - (dc_total + 2 * nb + 10)
