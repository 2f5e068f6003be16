"""Bit-exact swresample replay for the ffmpeg-free fallback tier.

libswresample's s16 rate conversion (the path the reference drives,
decoding.c:237-255) is an integer polyphase FIR:

    y[n] = clip_int16((sum_k T[n][k] * x[start_n + k] + 16384) >> 15)

with T/start periodic after a short transient: row(n + L) = row(n)
shifted by M src samples (L/M = dst/src reduced). The taps were recovered
EXACTLY from the real library by impulse probing (an impulse of -2^15
makes the rounded output equal the negated tap — tools/
extract_swr_banks.py, which also re-verifies every shipped bank against
libswresample on random data before writing). Output length follows
len = (n_in*L - D) // M with D calibrated per ratio (the reference never
flushes the resampler at EOF, so the filter-delay tail is dropped).

Ratios not shipped in data/swr_banks.npz fall back to the documented
scipy approximation (PARITY.md).
"""

import pathlib

import numpy as np

_BANKS_PATH = pathlib.Path(__file__).resolve().parent.parent / "data" \
    / "swr_banks.npz"
_banks = None
_mixes = None


def _load():
    global _banks, _mixes
    if _banks is None:
        _banks = {}
        _mixes = {}
        if _BANKS_PATH.exists():
            z = np.load(_BANKS_PATH)
            keys = {k.rsplit("_", 1)[0] for k in z.files
                    if not k.startswith("mix_")}
            for key in keys:
                src, dst = (int(v) for v in key.split("_"))
                w, l, m, d = (int(v) for v in z[f"{key}_meta"])
                _banks[(src, dst)] = (z[f"{key}_starts"],
                                      z[f"{key}_taps"], w, l, m, d)
            for k in z.files:
                if k.startswith("mix_"):
                    _, i, o = k.split("_")
                    _mixes[(int(i), int(o))] = z[k]
    return _banks


def mix_matrix(in_ch, out_ch):
    """libswresample's exact Q15 default rematrix (in_ch -> out_ch), or
    None if not shipped. Probed from the real library by
    tools/extract_swr_banks.py: the float-pipeline coefficients differ
    by +-1 Q15 step from double-precision recomputation on some layouts
    (e.g. 5.1->stereo FC is 9597, not round(0.2928932*32768) = 9598)."""
    _load()
    return _mixes.get((in_ch, out_ch))


def _bank_for(src_rate, dst_rate):
    banks = _load()
    if (src_rate, dst_rate) in banks:
        return banks[(src_rate, dst_rate)]
    return None


def apply_bank(x, starts, taps, W, L, M, D, n_in=None):
    """Apply one extracted bank: x (n, ch) int16 -> (len, ch) int16."""
    x = np.asarray(x)
    n = len(x) if n_in is None else n_in
    ch = x.shape[1]
    out_len = max(0, (n * L - D) // M)
    nrows, K = taps.shape
    # Pad so every window [start, start+K) is in range; starts can be
    # slightly negative in the transient and run past the end at the
    # tail (zero history / no flush — matching swresample).
    lpad = max(0, -int(starts.min()))
    # Worst-case window end across all outputs:
    max_start = int(starts[W + (out_len - W - 1) % L]) + \
        M * ((out_len - 1 - W) // L + 1) if out_len > W else \
        int(starts[:out_len].max(initial=0))
    rpad = max(0, max_start + K - n) + M + K
    xp = np.zeros((lpad + n + rpad, ch), np.int64)
    xp[lpad:lpad + n] = x

    y = np.empty((out_len, ch), np.int64)
    # Transient rows one by one (few), then each phase vectorized.
    for i in range(min(W, out_len)):
        s = int(starts[i]) + lpad
        y[i] = (xp[s:s + K].T @ taps[i] + 16384) >> 15
    if out_len > W:
        from numpy.lib.stride_tricks import sliding_window_view

        win = sliding_window_view(xp, (K, ch))[:, 0]  # (pos, K, ch)
        for r in range(L):
            n0 = W + r
            if n0 >= out_len:
                continue
            cnt = (out_len - 1 - n0) // L + 1
            s0 = int(starts[W + r]) + lpad
            idx = s0 + M * np.arange(cnt)
            w = win[idx]                        # (cnt, K, ch)
            acc = np.einsum("nkc,k->nc", w, taps[W + r])
            y[n0::L] = (acc + 16384) >> 15
    return np.clip(y, -32768, 32767).astype(np.int16)


def resample(x, src_rate, dst_rate):
    """Bit-exact swresample replay, or None when the ratio is not in the
    shipped banks. x: (n, ch) int16."""
    bank = _bank_for(src_rate, dst_rate)
    if bank is None:
        return None
    starts, taps, W, L, M, D = bank
    return apply_bank(np.asarray(x, np.int64), starts, taps, W, L, M, D)
