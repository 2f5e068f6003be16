"""MDEC BS frame encoding ops on torch tensors: tables, quantization,
run lengths, Huffman closed forms, DC chain, scale selection, symbol
emission and the NV21 rearranges.

Counterpart of ``psxavenc_tpu/ops/bs.py``: the fused pixel path and the
coefficient-input symbols path. The constant tables are copied
(``tests/test_torch_tables`` pins them equal to the JAX module's
arrays); every function computes the
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


def dc_steps(d):
    """Each DC's map of ``last`` (a multiple of 4) as a threshold function
    x -> a if x < t else b: (t, a, b). A DC that is 2 mod 4 is a tie of the
    rounding (t = dc, a = dc + 2, b = dc - 2); any other is a constant
    (t = _NEG_INF, a = b)."""
    r = d & 3
    const = where(r == 0, d, where(r == 1, d - 1, d + 1))
    on_half = r == 2
    return (where(on_half, d, _NEG_INF), where(on_half, d + 2, const),
            where(on_half, d - 2, const))


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

    t, a, b = dc_steps(d)
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


def _ac_quant(c, qs):
    """Quantize and clamp the AC positions by divisors ``qs``
    broadcastable to ``c``."""
    return _clamp_coeff(_div_rounded_fast(c, qs))


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
    ac = _ac_quant(c.to(torch.int32), qs[:, :, None])
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


def _select(bits_ps, nz_ps, dc_total, budgets, nb):
    """First-fit scale selection over (B, 63) per-scale AC totals, the
    budget rule (a frame fits iff 8 + 2 * ceil(total_bits / 16) <= its
    budget, mdec.c:321-333). Returns (scale, scale_idx, nz_count,
    total_bits). A frame that fits nowhere gets scale 64 and index 0, so
    its counts are those of scale 1 (argmax over an all-false row)."""
    per_scale_bits = bits_ps + (dc_total + 2 * nb + 10)[:, None]
    total_bytes = 8 + 2 * ((per_scale_bits + 15) >> 4)
    fits = total_bytes <= budgets.to(torch.int32)[:, None]
    scale_idx = fits.to(torch.int32).argmax(dim=1).to(torch.int32)
    scale = where(fits.any(dim=1), scale_idx + 1, 64).to(torch.int32)

    def take(x):
        return torch.gather(x, 1, scale_idx[:, None].long())[:, 0]

    return scale, scale_idx, take(nz_ps), take(per_scale_bits)


def _select_only(c, bits_ps, nz_ps, dc_bits, dc_code, dc_total, budgets,
                 nb):
    """Scale selection without symbol emission: the winner, its exact
    totals and what the emission kernel needs."""
    scale, scale_idx, nz_at, total_at = _select(bits_ps, nz_ps, dc_total,
                                                budgets, nb)
    return {"scale": scale, "scale_idx": scale_idx, "nz_count": nz_at,
            "total_bits": total_at, "c": c, "dc_bits": dc_bits,
            "dc_code": dc_code}


def _select_and_emit(c, bits_ps, nz_ps, dc_bits, dc_code, dc_total,
                     budgets, nb):
    scale, scale_idx, nz_at, total_at = _select(bits_ps, nz_ps, dc_total,
                                                budgets, nb)
    codes, bits = emit_symbols_at(c, scale_idx, dc_bits, dc_code)
    return {"scale": scale, "codes": codes, "bits": bits,
            "nz_count": nz_at, "total_bits": total_at}


SWEEP_CHUNK = 8
_SWEEP_SENTINEL = 1 << 29            # an uncosted scale's bits: never fits


def _sweep(c, budgets, dc_total, nb):
    """The chunked early-exit sweep (psxavenc_tpu/ops/bs.py:641-683):
    exact (B, 63) per-scale AC bit and nonzero totals, costed eight
    scales at a time in order until every frame fits one of the costed
    scales. Uncosted scales keep a sentinel that never fits, so the
    selection equals a full sweep's."""
    B = c.shape[0]
    dev = c.device
    q = quant_zz(dev)
    bits_ps = torch.full((B, 63), _SWEEP_SENTINEL, dtype=torch.int32,
                         device=dev)
    nz_ps = torch.zeros((B, 63), dtype=torch.int32, device=dev)
    extra = (dc_total + 2 * nb + 10)[:, None]
    limit = budgets.to(device=dev, dtype=torch.int32)[:, None]
    pos = torch.arange(63, device=dev)
    for lo in range(0, 63, SWEEP_CHUNK):
        fits = (8 + 2 * ((bits_ps + extra + 15) >> 4) <= limit) & (pos < lo)
        if bool(fits.any(dim=1).all()):
            break
        for i in range(lo, min(lo + SWEEP_CHUNK, 63)):
            ac = _ac_quant(c, (q * (i + 1))[None, :, None])
            nz = ac != 0
            bits = where(nz, ac_bits_closed_form(_runs(nz, 1), ac.abs()), 0)
            bits_ps[:, i] = bits.sum(dim=(1, 2), dtype=torch.int32)
            nz_ps[:, i] = nz.sum(dim=(1, 2), dtype=torch.int32)
    return bits_ps, nz_ps


def encode_frames_symbols(coefs, budgets, *, codec, kernel_sweep=True,
                          emit=True, use_kernels=True):
    """Quantize and symbolize a batch of frames at the reference's scales.

    coefs: (B, NB, 64) int32 FDCT output in encode order; budgets: (B,)
    int32 byte budgets. ``kernel_sweep`` is the counterpart of
    psxavenc_tpu's ``pallas_sweep``: True runs the per-frame AC threshold
    and the K6 scale search (``bs_cuda.select_scale``; its plain version
    with ``use_kernels=False``), False the chunked early-exit sweep in
    plain torch (the JAX package's XLA sweep). The two differ only on a
    frame that fits no scale: the search reports ac_bits = nz = 0, the
    sweep scale 1's totals.

    Returns a dict of tensors (leading axis B): ``scale`` (64 = nothing
    fits; the caller raises), ``codes``/``bits`` (B, NB, 65) int64 symbol
    streams (DC, 63 ACs, EOB), ``nz_count`` and ``total_bits`` (without
    the final 10-bit EOF). With ``emit=False``, instead of the symbols:
    ``scale_idx``, the (B, 63, NB) int32 zigzag AC coefficients ``c``,
    ``dc_bits`` and ``dc_code``.
    """
    from . import bs_cuda

    B, nb, _ = coefs.shape
    coefs = coefs.to(torch.int32)
    dc_q = _clamp_coeff(_div_rounded(coefs[:, :, 0], 16))
    dc_bits, dc_code = _dc_stage(dc_q, codec)
    zz = torch.as_tensor(ZAGZIG[1:], dtype=torch.long, device=coefs.device)
    c = coefs[:, :, zz].transpose(1, 2).contiguous()    # (B, 63, NB)
    dc_total = dc_bits.sum(dim=1, dtype=torch.int32)

    if not kernel_sweep:
        bits_ps, nz_ps = _sweep(c, budgets, dc_total, nb)
        finish = _select_and_emit if emit else _select_only
        return finish(c, bits_ps, nz_ps, dc_bits, dc_code, dc_total,
                      budgets, nb)

    select = bs_cuda.select_scale if use_kernels else \
        bs_cuda.select_scale_plain
    scale, ac_bits, nz = select(c, ac_threshold(budgets, dc_total, nb))
    scale_idx = where(scale <= 63, scale - 1, 0)
    out = {"scale": scale, "nz_count": nz,
           "total_bits": ac_bits + dc_total + 2 * nb + 10}
    if not emit:
        out.update(scale_idx=scale_idx, c=c, dc_bits=dc_bits,
                   dc_code=dc_code)
        return out
    out["codes"], out["bits"] = emit_symbols_at(c, scale_idx, dc_bits,
                                                dc_code)
    return out


def encode_frame_symbols(coefs, budget, *, codec, kernel_sweep=True):
    """Single-frame wrapper over :func:`encode_frames_symbols`."""
    budgets = torch.as_tensor(budget, dtype=torch.int32,
                              device=coefs.device).reshape(1)
    out = encode_frames_symbols(coefs[None], budgets, codec=codec,
                                kernel_sweep=kernel_sweep)
    return {k: v[0] for k, v in out.items()}


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



def select_stages(codec, dc_stage, select):
    """The fused select stage after the rearrange as ordered (name, fn)
    stages: ``dc`` (the DC sums; ``dc_stage``, K2 or its plain version, for
    v3/v3dc), ``threshold`` (the AC fit threshold), ``k1`` (``select``:
    K1's FDCT and scale search, or its plain version) and ``totals``. Each
    fn(s) reads what the stages before it put into the dict ``s`` (first
    ``pix`` and ``budgets``) and adds its own results."""

    def dc(s):
        dc_q = dc_quant_from_pixrows(s["pix"])
        if codec == BS_V2:
            s["dc_bits"], s["dc_code"] = _dc_stage(dc_q, codec)
        else:
            s["dc_bits"], s["dc_code"] = dc_stage(dc_q, codec)
        s["dc_total"] = s["dc_bits"].sum(dim=1, dtype=torch.int32)

    def threshold(s):
        s["thr"] = ac_threshold(s["budgets"], s["dc_total"],
                                s["pix"].shape[2])

    def k1(s):
        s["scale"], s["ac_bits"], s["nz_count"], s["c"] = select(
            s["pix"], s["thr"])

    def totals(s):
        # Unfittable frames emit at scale 1 (the caller raises for them).
        s["scale_idx"] = torch.where(s["scale"] <= 63, s["scale"] - 1, 0)
        s["total_bits"] = s["ac_bits"] + s["dc_total"] + \
            2 * s["pix"].shape[2] + 10

    return [("dc", dc), ("threshold", threshold), ("k1", k1),
            ("totals", totals)]


def select_frames_pixels(pix, frame_max_sizes, *, codec):
    """Scale selection straight from the (B, 64, NB) pixel-row layout (see
    :func:`rearrange_nv21_rows`) and (B,) byte budgets: :func:`select_stages`
    through the kernels' wrappers (K2 for v3/v3dc, K1) on the pixels'
    device.

    Counterpart of psxavenc_tpu's ``select_frames_pixels``, with its dict:
    ``scale`` (64 = unfittable), ``scale_idx``, ``nz_count``,
    ``total_bits``, ``dc_bits``, ``dc_code`` and ``c64``, K1's (B, 64,
    nb_pad) int16 signed zigzag coefficient rows (row 63 and the pad lanes
    zero), the input of the emission kernels.
    """
    from . import bs_cuda           # bs_cuda imports this module

    if pix.dim() != 3 or pix.shape[1] != 64:
        raise ValueError("select_frames_pixels: pix must be (B, 64, NB)")
    s = {"pix": pix, "budgets": frame_max_sizes}
    for _, fn in select_stages(codec, bs_cuda.dc_stage,
                               bs_cuda.select_scale_pix):
        fn(s)
    return {"scale": s["scale"], "scale_idx": s["scale_idx"],
            "nz_count": s["nz_count"], "total_bits": s["total_bits"],
            "dc_bits": s["dc_bits"], "dc_code": s["dc_code"],
            "c64": s["c"]}
