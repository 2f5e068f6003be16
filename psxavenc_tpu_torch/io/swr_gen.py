"""Generate libswresample-exact polyphase banks for ARBITRARY ratios.

The shipped data/swr_banks.npz covers the 41 probed common-PSX ratios;
this module synthesizes the same (starts, taps, W, L, M, D) structure
for any rational src->dst pair, bit-identically to what impulse-probing
the real library produces (reference behavior:
psxavenc/decoding.c:237-255 via libswresample).

The construction was reverse-engineered EXACTLY from the probed banks
(0 mismatching taps over every stored bank, tests/test_swr_gen.py):

  factor = min(0.97 * dst / src, 1.0)          # cutoff 0.97, upsample
                                               # capped at 1.0
  flen   = ceil(32 / factor) aligned up to even  # filter_size 32
  half   = flen * factor / 2                   # Kaiser window half-width
  tap_i(ph) = sinc(x) * factor * I0(9*sqrt(1-(x/half)^2))/I0(9),
              x = (i - flen/2 + ph/L) * factor,  i in [0, flen)
              (the window support never crosses +-half: no edge cases)
  taps(ph) = clip_int16(round_half_even(32768 * tap(ph) / sum(tap(0))))
             (normalized by the PHASE-0 sum; identity for upsampling)

  output n (L = dst/g, M = src/g) uses phase ph_n = (-n*M) mod L with
  start_n = ceil(n*M/L) - flen/2 (tap flen/2 - ph/L sits exactly on the
  ideal src position n*M/L); negative starts drop the leading taps
  (zero priming). Output length: (n_in*L - D) // M with
  D = L*flen/2 - (M - 1) (verified == the probed calibration for all
  41 shipped ratios).

Rounding uses round-half-even on doubles, matching lrint under the
default FP rounding mode. I0 is evaluated with a float64 series; the
window ratio I0(x)/I0(9) agreed with the library to the last tap on
every probed bank (scipy's i0 and the Abramowitz-Stegun polynomial give
identical taps here).
"""

import functools
import math

import numpy as np


def _i0(x):
    """Modified Bessel I0 via the A-S 9.8.1/9.8.2 polynomials (float64).
    Tap-identical to scipy.special.i0 over this construction's range."""
    x = np.abs(np.asarray(x, np.float64))
    t = x / 3.75
    u = t * t
    small = 1.0 + u * (3.5156229 + u * (3.0899424 + u * (1.2067492
            + u * (0.2659732 + u * (0.0360768 + u * 0.0045813)))))
    with np.errstate(divide="ignore", invalid="ignore"):
        ti = np.where(t > 0, 1.0 / np.where(t == 0, 1.0, t), 1.0)
        big = (np.exp(x) / np.sqrt(np.where(x == 0, 1.0, x))) * (
            0.39894228 + ti * (0.01328592 + ti * (0.00225319
            + ti * (-0.00157565 + ti * (0.00916281 + ti * (-0.02057706
            + ti * (0.02635537 + ti * (-0.01647633
            + ti * 0.00392377))))))))
    return np.where(t <= 1.0, small, big)


def _phase_taps(flen, factor, half, q, norm):
    """Int16 taps for fractional phase offset ``q`` = ph/L in [0, 1)."""
    i = np.arange(flen, dtype=np.float64)
    x = (i - flen / 2 + q) * factor
    r = np.clip(1.0 - (x / half) ** 2, 0.0, None)
    h = np.sinc(x) * factor * (_i0(9.0 * np.sqrt(r)) / _i0(9.0))
    h = h / norm
    return np.clip(np.round(h * 32768.0), -32768, 32767).astype(np.int64)


@functools.lru_cache(maxsize=32)
def generate_bank(src_rate, dst_rate):
    """-> (starts, taps, W, L, M, D) in the exact layout
    io/swr_exact.apply_bank replays (row n covers output n for n < W,
    then row W + ((n - W) % L) with start += M per period)."""
    g = math.gcd(src_rate, dst_rate)
    L = dst_rate // g
    M = src_rate // g
    factor = min(0.97 * dst_rate / src_rate, 1.0)
    flen = int(math.ceil(32.0 / factor))
    flen += flen % 2
    half = flen * factor / 2.0

    i = np.arange(flen, dtype=np.float64)
    x0 = (i - flen / 2) * factor
    r0 = np.clip(1.0 - (x0 / half) ** 2, 0.0, None)
    norm = float(np.sum(np.sinc(x0) * factor
                        * (_i0(9.0 * np.sqrt(r0)) / _i0(9.0))))

    # Transient width: rows whose full filter starts before the input.
    W = 0
    while -(-(W * M) // L) - flen // 2 < 0:
        W += 1

    rows = []
    starts = []
    for n in range(W + L):
        ph = (-n * M) % L
        full_start = -(-(n * M) // L) - flen // 2   # ceil(nM/L) - flen/2
        t = _phase_taps(flen, factor, half, ph / L, norm)
        if full_start < 0:
            # Stream start: the library reflects the input (x[-m] takes
            # x[m]), so tap i at src index s = full_start + i < 0 folds
            # onto index -s (probed behavior; x[0] is not duplicated).
            cut = -full_start
            folded = t[cut:].copy()
            for i in range(cut):
                j = cut - i                    # -(full_start + i)
                if j < len(folded):
                    folded[j] += t[i]
            t = folded
            starts.append(0)
        else:
            starts.append(full_start)
        rows.append(t)

    K = max(len(t) for t in rows)
    taps = np.zeros((len(rows), K), np.int64)
    for r, t in enumerate(rows):
        taps[r, :len(t)] = t
    D = L * flen // 2 - (M - 1)
    return (np.asarray(starts, np.int64), taps, W, L, M, D)
