"""Hand-made inputs of the emission kernels (K3, K7, the tail emission),
shared by the CPU tests and the card tests. Imports no JAX."""

import numpy as np

from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

QUANT = np.asarray(tbs.QUANT_ZZ, np.int32)
# The bit totals of frame 0's first six blocks.
EDGE_BITS = [10 + 12 * 22 + 2, 256, 257, 10 + 63 * 22 + 2, 10 + 22 + 13 + 2,
             12]


def edge_inputs(nb, seed=5):
    """Two frames of ``nb`` blocks at scales 1 and 3: (c (2, 63, nb) int32,
    scale, dc_code, dc_bits). Frame 0 starts with six hand-made blocks
    (their bit totals: EDGE_BITS), the rest of both frames is noise whose
    busy blocks are long at scale 1.

    0: twelve escapes (level 100): the twelfth covers bits 252..273;
    1: ten escapes and eight 3-bit codes: exactly 256 bits;
    2: the same with an 11-bit DC: 257 bits;
    3: all 63 levels clamped, to -0x200 and 0x1FE in turn;
    4: level 1 after a run of 40 and level -1 after a run of 21... the
       first is an escape (run over 31);
    5: no AC level at all."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-700, 700, (2, 63, nb)).astype(np.int32)
    c[:, 20:, nb // 2:] = 0
    dc_bits = rng.integers(2, 11, (2, nb)).astype(np.int32)
    c[0, :, :6] = 0
    dc_bits[0, :6] = 10
    c[0, :12, 0] = 100 * QUANT[:12]
    for n in (1, 2):
        c[0, :10, n] = -100 * QUANT[:10]
        c[0, 10:18, n] = QUANT[10:18]
    dc_bits[0, 2] = 11
    c[0, :, 3] = np.where(np.arange(63) % 2, 30000, -30000)
    c[0, 40, 4] = QUANT[40]
    c[0, 62, 4] = -QUANT[62]
    dc_code = (rng.integers(0, 1 << 11, (2, nb)).astype(np.int32)
               & ((1 << dc_bits) - 1))
    return c, np.array([1, 3], np.int32), dc_code, dc_bits


def code_table_inputs():
    """One frame at scale 1 whose blocks hold a single level each: every
    (run 0..33, |level| 1..42, sign), the block of run r, level a and sign
    g at index (r * 42 + a - 1) * 2 + g. That is every pair with a
    variable-length code and the escapes next to them (runs over 31,
    levels over 40). Returns (c (1, 63, 2856) int32, scale, dc_code,
    dc_bits)."""
    run, level, sign = np.meshgrid(np.arange(34), np.arange(1, 43),
                                   np.array([1, -1]), indexing="ij")
    run, level, sign = run.ravel(), level.ravel(), sign.ravel()
    nb = run.size
    c = np.zeros((1, 63, nb), np.int32)
    c[0, run, np.arange(nb)] = sign * level * QUANT[run]
    dc_bits = np.full((1, nb), 10, np.int32)
    dc_code = (np.arange(nb, dtype=np.int32) * 37 % 1024)[None]
    return c, np.array([1], np.int32), dc_code, dc_bits


def select_form(c):
    """(B, 63, NB) int32 -> K1's (B, 64, nb_pad) int16 form."""
    c64 = np.zeros((c.shape[0], 64, bs_cuda.nb_padded(c.shape[2])), np.int16)
    c64[:, :63, :c.shape[2]] = c
    return c64
