"""SPU/XA-ADPCM unit encoder, plain PyTorch.

Counterpart of ``psxavenc_tpu/ops/adpcm.py`` and of the reference encoder
(libpsxav/adpcm.c:39-191): one 28-sample unit at a time, for each of 4-5
prediction filters a minimum shift from the raw residual extrema, up to 3
shifts around it, and the quantize/decode feedback loop per candidate; the
(filter, shift) pair with the lowest squared error wins, the first one on
a tie. The decoder state (prev1, prev2) threads through the units.

JAX's ``vmap`` over streams and candidates is a written-out batch dimension
here (streams B, candidates C) and its ``lax.scan`` over units a Python
loop. All arithmetic is int32 with C semantics (arithmetic right shifts);
the squared error is native int64, which the TPU formulation lacked.

This is the plain version of kernel K5 (``csrc/adpcm_units.cu``, wrapper
``ops/adpcm_cuda.py``); it runs on any device.
"""

import torch

SAMPLES_PER_UNIT = 28

# Prediction filter coefficients (adpcm.c:36-37). XA uses the first 4,
# SPU all 5 (adpcm.c:33-34).
FILTER_K1 = (0, 60, 115, 98, 122)
FILTER_K2 = (0, 0, -52, -55, -60)

SHIFT_RANGE_4BPS = 12
SHIFT_RANGE_8BPS = 8
XA_FILTER_COUNT = 4
SPU_FILTER_COUNT = 5


def _predict(k1, k2, prev1, prev2):
    """(k1*prev1 + k2*prev2 + 32) >> 6 with arithmetic shift (adpcm.c:66)."""
    return (k1 * prev1 + k2 * prev2 + 32) >> 6


def _find_min_shift(prev1, prev2, raw, k1, k2, shift_range):
    """Minimum shift per stream and filter over one unit (adpcm.c:39-79).

    prev1, prev2: (B,) int32; raw: (B, 28) int32; k1, k2: (F,) int32.
    Returns (B, F) int32. The residual pass uses the raw samples as the
    predictor history (no quantization feedback).
    """
    p1 = torch.cat([prev1[:, None], raw[:, :-1]], dim=1)
    p2 = torch.cat([prev2[:, None], prev1[:, None], raw[:, :-2]], dim=1)
    resid = raw[:, None, :] - _predict(k1[None, :, None], k2[None, :, None],
                                       p1[:, None, :], p2[:, None, :])
    s_min = resid.amin(dim=2).clamp(max=0)
    s_max = resid.amax(dim=2).clamp(min=0)
    # right_shift = first r in [0, shift_range) meeting both range
    # conditions, else shift_range (the two while loops of adpcm.c:73-74
    # compose to this because both predicates are monotone in r).
    rs = torch.arange(shift_range + 1, dtype=torch.int32, device=raw.device)
    ok = (((s_max[..., None] >> rs) <= (0x7FFF >> shift_range))
          & ((s_min[..., None] >> rs) >= (-0x8000 >> shift_range)))
    first = ok.to(torch.int32).argmax(dim=2).to(torch.int32)
    right_shift = torch.where(ok.any(dim=2), first, shift_range)
    return shift_range - right_shift


def _attempt(prev1, prev2, raw, k1, k2, sample_shift, shift_range):
    """Encode + decode every candidate (adpcm.c:81-140).

    prev1, prev2: (B,); raw: (B, 28); k1, k2: (C,); sample_shift: (B, C).
    Returns (values (B, C, 28) int32, new prev1, new prev2 (B, C) int32,
    squared error (B, C) int64).
    """
    sample_mask = 0xFFFF >> shift_range
    min_e = -0x8000 >> shift_range
    max_e = 0x7FFF >> shift_range
    half = 1 << (shift_range - 1)

    B, C = sample_shift.shape
    p1 = prev1[:, None].expand(B, C)
    p2 = prev2[:, None].expand(B, C)
    mse = torch.zeros((B, C), dtype=torch.int64, device=raw.device)
    values = []
    for i in range(SAMPLES_PER_UNIT):
        s = raw[:, i:i + 1]
        pred = _predict(k1, k2, p1, p2)
        enc = (((s - pred) << sample_shift) + half) >> shift_range
        enc = enc.clamp(min_e, max_e) & sample_mask
        # int16 reinterpretation of (enc << shift_range) (adpcm.c:120).
        dec = (enc << shift_range) & 0xFFFF
        dec = dec - ((dec & 0x8000) << 1)
        dec = ((dec >> sample_shift) + pred).clamp(-0x8000, 0x7FFF)
        err = (dec - s).to(torch.int64)
        mse = mse + err * err
        values.append(enc)
        p2 = p1
        p1 = dec
    return torch.stack(values, dim=2), p1, p2, mse


def encode_unit(prev1, prev2, samples, limit, filter_count, shift_range):
    """Encode one unit of each of B streams: the full candidate search
    (adpcm.c:142-191).

    prev1, prev2: (B,) int32 decoder state; samples: (B, 28) int32;
    limit: (B,) int32, samples at positions >= limit count as 0
    (adpcm.c:65,110); filter_count 1-5; shift_range 12 (4-bit) or 8
    (8-bit). Returns (header (B,), values (B, 28), new prev1, new prev2),
    int32.
    """
    dev = samples.device
    idx = torch.arange(SAMPLES_PER_UNIT, dtype=torch.int32, device=dev)
    raw = torch.where(idx[None, :] < limit[:, None], samples, 0)
    k1 = torch.tensor(FILTER_K1[:filter_count], dtype=torch.int32,
                      device=dev)
    k2 = torch.tensor(FILTER_K2[:filter_count], dtype=torch.int32,
                      device=dev)
    min_shifts = _find_min_shift(prev1, prev2, raw, k1, k2, shift_range)

    # Candidates in reference order: filter-major, shift ascending
    # (adpcm.c:158-183). Clipping may repeat a shift at the range edges;
    # repeats tie, and the first one wins, as the reference's
    # [max(0, ms-1), min(range, ms+1)] loop would have it.
    deltas = torch.tensor([-1, 0, 1], dtype=torch.int32, device=dev)
    cand_shift = (min_shifts[:, :, None] + deltas).clamp(
        0, shift_range).reshape(len(prev1), -1)             # (B, C)
    values, np1, np2, mse = _attempt(
        prev1, prev2, raw, k1.repeat_interleave(3),
        k2.repeat_interleave(3), cand_shift, shift_range)

    # argmin returns the first minimum: the reference's strict
    # `best_mse > mse` update (adpcm.c:177).
    best = mse.argmin(dim=1, keepdim=True)
    shift = cand_shift.gather(1, best)[:, 0]
    header = (shift & 0x0F) | ((best[:, 0].to(torch.int32) // 3) << 4)
    values = values.gather(1, best[:, :, None].expand(-1, 1,
                                                      SAMPLES_PER_UNIT))
    return (header, values[:, 0], np1.gather(1, best)[:, 0],
            np2.gather(1, best)[:, 0])


def encode_units_scan(samples, limits, prev1, prev2, *, filter_count,
                      shift_range):
    """Encode B unit streams, threading the decoder state over time.

    samples: (B, T, 28) int32; limits: (B, T) int32 per-unit limits;
    prev1, prev2: (B,) int32 initial state. Returns headers (B, T), values
    (B, T, 28) and the state after each unit, s1 and s2 (B, T), all int32:
    callers take the state at any unit (padding units that follow the
    real ones still change it).
    """
    samples = samples.to(torch.int32)
    limits = limits.to(torch.int32)
    p1 = prev1.to(torch.int32)
    p2 = prev2.to(torch.int32)
    headers, values, s1, s2 = [], [], [], []
    for t in range(samples.shape[1]):
        h, v, p1, p2 = encode_unit(p1, p2, samples[:, t], limits[:, t],
                                   filter_count, shift_range)
        headers.append(h)
        values.append(v)
        s1.append(p1)
        s2.append(p2)
    B = samples.shape[0]
    if not headers:
        empty = torch.zeros((B, 0), dtype=torch.int32, device=samples.device)
        return (empty, samples.new_zeros((B, 0, SAMPLES_PER_UNIT)), empty,
                empty)
    return (torch.stack(headers, 1), torch.stack(values, 1),
            torch.stack(s1, 1), torch.stack(s2, 1))
