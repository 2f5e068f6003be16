"""Bit-exact integer forward DCT on torch tensors.

Counterpart of ``psxavenc_tpu/ops/fdct.py``: FFmpeg's islow variant of
the IJG integer DCT (CONST_BITS = 13, PASS1_BITS = 4), int32 arithmetic,
with the reference's int16 store after pass 1 reproduced by an explicit
wrap. ``csrc/bs_common.cuh`` carries the same arithmetic for the kernels.
"""

import torch

CONST_BITS = 13
PASS1_BITS = 4

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _pass_rows(rows, shift_even_up, descale_bits):
    """One 1-D islow pass on a list of 8 same-shaped int32 tensors."""
    d0, d1, d2, d3, d4, d5, d6, d7 = rows

    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4

    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    if shift_even_up:
        out0 = (tmp10 + tmp11) << PASS1_BITS
        out4 = (tmp10 - tmp11) << PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, PASS1_BITS)

    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out2 = _descale(z1 + tmp13 * FIX_0_765366865, descale_bits)
    out6 = _descale(z1 - tmp12 * FIX_1_847759065, descale_bits)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602

    t4 = tmp4 * FIX_0_298631336
    t5 = tmp5 * FIX_2_053119869
    t6 = tmp6 * FIX_3_072711026
    t7 = tmp7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5

    out7 = _descale(t4 + z1 + z3, descale_bits)
    out5 = _descale(t5 + z2 + z4, descale_bits)
    out3 = _descale(t6 + z2 + z3, descale_bits)
    out1 = _descale(t7 + z1 + z4, descale_bits)

    return [out0, out1, out2, out3, out4, out5, out6, out7]


def _wrap16(x):
    """int16 reinterpretation (the reference's pass-1 int16 store)."""
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def fdct_rows(rows):
    """islow FDCT on 64 separate int32 sample tensors.

    rows[8*r + c] holds sample (r, c) of every block; returns 64 tensors,
    out[8*u + v] = coefficient (u, v).
    """
    p1 = [None] * 64
    for r in range(8):
        outs = _pass_rows([rows[8 * r + i] for i in range(8)], True,
                          CONST_BITS - PASS1_BITS)
        for i in range(8):
            p1[8 * r + i] = _wrap16(outs[i])
    out = [None] * 64
    for i in range(8):
        outs = _pass_rows([p1[8 * r + i] for r in range(8)], False,
                          CONST_BITS + PASS1_BITS)
        for u in range(8):
            out[8 * u + i] = outs[u]
    return out


def fdct_islow(blocks):
    """(..., 8, 8) samples -> (..., 8, 8) int32 coefficients."""
    blocks = blocks.to(torch.int32)
    rows = [blocks[..., r, c] for r in range(8) for c in range(8)]
    out = fdct_rows(rows)
    return torch.stack(out, dim=-1).reshape(blocks.shape)
