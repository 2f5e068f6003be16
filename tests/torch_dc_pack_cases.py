"""Hand-made inputs of K2 (the v3/v3dc DC chain) and K10 (per-block symbol
packing), shared by the CPU tests, the card tests and chip_smoke.py.
Imports no JAX."""

import numpy as np

DC_MIN, DC_MAX = -512, 510   # the clamped DC range (ops/bs.py:_clamp_coeff)
# (NB, B) of the DC cases: one macroblock, a chain length (37) that is not
# a multiple of 32, 320x240 and 640x480.
DC_SHAPES = ((6, 1), (6 * 37, 5), (1800, 5), (7200, 5))
DC_CASES = ("noise", "all ties", "tie runs", "extremes")
# S of the packing cases: the BS symbol rows (65), shorter and longer ones.
PACK_SYMBOLS = (65, 17, 130)
PACK_CASES = ("top bit", "garbage above the length", "0-bit symbols between",
              "256, 257, far over, all zero")


def _ties(x):
    """The nearest DC that is 2 mod 4 (a tie of the rounding)."""
    return (x & ~3) | 2


def dc_case(name, batch, nb, seed=3):
    """(batch, nb) int32 clamped DCs:

    - noise: uniform over the clamped range;
    - all ties: every DC 2 mod 4, so every step of a chain depends on the
      one before it;
    - tie runs: runs of 1 to 40 equal ties (``last`` then swings between
      dc + 2 and dc - 2 at every step), crossing the lanes' segments;
    - extremes: the ends of the range and pairs whose delta is exactly
      +-0x80 or one past it, where v3dc wraps."""
    rng = np.random.default_rng(seed)
    shape = (batch, nb)
    if name == "noise":
        dc = rng.integers(DC_MIN, DC_MAX + 1, shape)
    elif name == "all ties":
        dc = _ties(rng.integers(DC_MIN, DC_MAX + 1, shape))
    elif name == "tie runs":
        dc = np.empty(shape, np.int64)
        for f in range(batch):
            n = 0
            while n < nb:
                run = int(rng.integers(1, 41))
                dc[f, n:n + run] = _ties(int(rng.integers(DC_MIN, DC_MAX + 1)))
                n += run
    elif name == "extremes":
        values = np.array([DC_MIN, DC_MIN + 2, DC_MAX, DC_MAX - 2, -256, 256,
                           -260, 260, -254, 254, -2, 0, 2])
        dc = values[rng.integers(0, len(values), shape)]
    else:
        raise ValueError(name)
    return dc.astype(np.int32)


def _row_totals(rng, target, n):
    """n bit lengths in 0..32 that sum to ``target`` (at most 32 n),
    shuffled by random moves between symbols."""
    b = np.full(n, target // n)
    b[:target % n] += 1
    for _ in range(3 * n):
        i, j = rng.integers(0, n, 2)
        d = int(rng.integers(0, 9))
        d = min(d, b[i], 32 - b[j])
        b[i] -= d
        b[j] += d
    return b


def pack_case(name, batch, nbe, nsym, seed=4):
    """(codes (batch, nbe, nsym) int64 u32 values, bits int32 0..32); every
    code carries random bits above its length:

    - top bit: lengths of 32 (half of them) or 1..32, every code's bit 31
      set;
    - garbage above the length: lengths 1..20;
    - 0-bit symbols between: half the lengths 0, the rest 1..32;
    - 256, 257, far over, all zero: rows of exactly 256 bits, of 257, of 32
      bits a symbol (cut at 256), of no bits, and of 0..8 bits a symbol, in
      turn."""
    rng = np.random.default_rng(seed)
    shape = (batch, nbe, nsym)
    codes = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.int64)
    if name == "top bit":
        bits = np.where(rng.random(shape) < 0.5, 32,
                        rng.integers(1, 33, shape))
        codes |= 1 << 31
    elif name == "garbage above the length":
        bits = rng.integers(1, 21, shape)
    elif name == "0-bit symbols between":
        bits = np.where(rng.random(shape) < 0.5, 0, rng.integers(1, 33, shape))
    elif name == "256, 257, far over, all zero":
        bits = np.zeros((batch * nbe, nsym), np.int64)
        for r in range(batch * nbe):
            kind = r % 5
            if kind < 2:
                bits[r] = _row_totals(rng, 256 + kind, nsym)
            elif kind == 2:
                bits[r] = 32
            elif kind == 4:
                bits[r] = rng.integers(0, 9, nsym)
        bits = bits.reshape(shape)
    else:
        raise ValueError(name)
    return codes, bits.astype(np.int32)
