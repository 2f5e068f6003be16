"""Wrapper, plain version and plain model of the ADPCM unit kernel K5.

Counterpart of ``encode_units_pallas`` in
``psxavenc_tpu/ops/adpcm_pallas.py``, with its public layout: headers
(B, T), packed sample words (B, T, W) with W = 4 for 4-bit (nibble m of
word k at bit 4m, which are bytes [2+4k, 2+4k+4) of an SPU block) and
W = 7 for 8-bit (byte m of word k at bit 8m), and the decoder state after
each unit, s1 and s2 (B, T), all int32. The wrappers take the plain
version only for CPU tensors and launch ``csrc/adpcm_units.cu`` for CUDA
tensors; ``LAUNCHES`` counts the launches.

K5 reads its units straight from int16 PCM (:func:`encode_pcm_units`): a
(B, N) row of samples a stream and a (B, T) int32 offset a unit (the
CLI's chunk layout), or no offsets (the dense layout, unit t at sample
28 t: :func:`encode_units`' (B, T, 28) units); or the shared row (the
batch runner's grouped call), every stream's samples back to back in one
unpadded (N,) row, a start and a length a stream, with offsets or at
28 t. ``INPUTS`` counts the card's calls by layout.

On the card the plan (:func:`plan_segments`) picks the route from (B, T)
alone: the serial route where the batch fills the card, else each stream
cut into S segments encoded in parallel from guessed states and repaired
exactly (``csrc/adpcm_units.cu``'s note). :func:`encode_units_segmented_plain`
is the scheme's plain model, step for step and count for count, over a
row encoder (the plain scan or the native tier); the tests and
``chip_smoke.py`` use it, nothing on the card's path calls it.
"""

import bisect

import numpy as np
import torch

from . import _build
from . import adpcm
from .bs_cuda import _on_cuda, _opt_ptr, _require

LAUNCHES = {"adpcm_encode_units": 0}
INPUTS = {"offsets": 0, "dense": 0, "shared_row": 0}

# (filter_count, shift_range) pairs the kernel is built for: SPU and the
# two XA bit depths.
KERNEL_VARIANTS = ((5, 12), (4, 12), (4, 8))

# The segmented route. A segment is at least L_MIN units long: on
# synthetic audio a guessed start meets the true trajectory within a few
# units on nearly every segment (PERF.md), so longer segments only
# lengthen the speculation's chain. The plan cuts streams until
# FILL_GROUPS lane groups run, about 31 a SM on the H100's 132 SMs: on the
# card 4,096 x 1,000 SPU units read about the same for 1, 2 and 4
# segments a stream, 1,024 streams faster with 4 than with 1 or 2
# (tools/torch_kernel_bench.py --kernels adpcm), so a batch of that many
# streams runs the serial route. Each speculative run starts WARMUP_UNITS
# before its segment, and ROUNDS parallel repair rounds run before the
# serial walk (each round carries a true start one segment further; what
# is left the walk finishes).
L_MIN = 64
FILL_GROUPS = 4096
WARMUP_UNITS = 8
ROUNDS = 2
# stats_out's counts: segments (B on the serial route), units encoded in
# speculation (warm-up included), units re-encoded by the rounds, rounds
# that re-encoded any unit, units the serial walk encoded (every unit on
# the serial route).
STAT_NAMES = ("segments", "spec_units", "repair_units", "rounds_changed",
              "walked_units")


def plan_segments(B, T):
    """Segments a stream for a (B, T) call: 1 where B alone fills the card
    (or T is under two segments), else as many as fill it, each at least
    L_MIN units."""
    if B < 1 or B >= FILL_GROUPS or T < 2 * L_MIN:
        return 1
    return min(T // L_MIN, -(-FILL_GROUPS // B))


def segment_starts(T, S):
    """The S + 1 bounds of a stream's segments: segment k is units
    [k T // S, (k + 1) T // S)."""
    return [k * T // S for k in range(S + 1)]


def _segments(B, T, segments):
    if segments is None:
        return plan_segments(B, T)
    if isinstance(segments, bool) or not isinstance(segments, int) \
            or segments < 1:
        raise ValueError(f"encode_units: segments must be a positive int, "
                         f"got {segments!r}")
    return max(1, min(segments, T))


def n_words(shift_range):
    return 4 if shift_range == adpcm.SHIFT_RANGE_4BPS else 7


_INT32_MAX = np.iinfo(np.int32).max


def unit_offsets(offsets):
    """(B, T) host unit offsets -> a contiguous int32 numpy array, as K5
    takes them; raises ValueError where an offset + 27 does not fit int32
    (or an offset is negative)."""
    offsets = np.asarray(offsets)
    if offsets.size and int(offsets.min()) < 0:
        raise ValueError("unit offsets must be non-negative")
    if offsets.size and int(offsets.max()) + adpcm.SAMPLES_PER_UNIT - 1 \
            > _INT32_MAX:
        raise ValueError("unit offsets must fit int32 with their unit's "
                         f"28 samples, got {int(offsets.max())}")
    return np.ascontiguousarray(offsets, np.int32)


def shared_row(base, lengths, n):
    """(B,) host starts and sample counts of the streams in a shared row
    of ``n`` samples -> contiguous int64 and int32 numpy arrays, as K5
    takes them, a stream of no samples started at 0 (K5 reads sample 0
    for it and masks its units); raises ValueError where one is negative,
    a count does not fit int32 or a stream ends past the row."""
    base, lengths = np.asarray(base), np.asarray(lengths)
    if base.ndim != 1 or base.shape != lengths.shape:
        raise ValueError("a shared row takes (B,) starts and lengths")
    if base.size and (int(base.min()) < 0 or int(lengths.min()) < 0
                      or int(lengths.max()) > _INT32_MAX
                      or int((base.astype(np.int64)
                              + lengths.astype(np.int64)).max()) > n):
        raise ValueError(f"a shared row's streams must lie within its {n} "
                         "samples")
    return (np.ascontiguousarray(np.where(lengths > 0, base, 0), np.int64),
            np.ascontiguousarray(lengths, np.int32))


def gather_units_plain(pcm, offsets, T, base=None, lengths=None):
    """The units K5 reads: (B, N) samples and (B, T) offsets -> (B, T, 28)
    int32 on the samples' device. Sample indices clip to [0, N - 1], so a
    unit past the end repeats the last sample (its limit masks it); N == 0
    gives zeros. ``offsets`` None is the dense layout, N = 28 T: the
    samples reshaped.

    With ``base`` and ``lengths`` ((B,) arrays or tensors) ``pcm`` is a
    shared (N,) row: stream b, the ``lengths[b]`` samples from
    ``base[b]``, is gathered as a request of that one row would be, at
    ``offsets[b]`` or, where ``offsets`` is None, at 28 t."""
    n = adpcm.SAMPLES_PER_UNIT
    out = torch.empty((len(lengths) if base is not None else pcm.shape[0],
                       T, n), dtype=torch.int32, device=pcm.device)
    if base is not None:
        grid = (n * torch.arange(T, device=pcm.device))[None]
        for b, (s, m) in enumerate(zip(base.tolist(), lengths.tolist())):
            at = offsets[b:b + 1] if offsets is not None \
                else None if m == n * T else grid
            out[b] = gather_units_plain(pcm[s:s + m][None], at, T)[0]
        return out
    B, N = pcm.shape
    if offsets is None:
        return out.copy_(pcm.reshape(B, T, n))
    if N == 0:
        return out.zero_()
    # Rows edged with 27 copies of their first and last samples: unit o is
    # the window at o + 27, clipped to the row, which clips every index.
    row = torch.cat([pcm[:, :1].expand(B, n - 1), pcm,
                     pcm[:, -1:].expand(B, n - 1)], 1).to(out.dtype)
    starts = (offsets.to(torch.int64) + n - 1).clamp(0, N + n - 2)
    for r in range(B):
        torch.index_select(row[r].unfold(0, n, 1), 0, starts[r], out=out[r])
    return out


def s16_units(units):
    """``units`` (s16 samples of any integer dtype) as int16; ValueError
    where one lies outside [-32768, 32767], which int16 would wrap (a
    device sync where they are on the card and not int16)."""
    if units.dtype != torch.int16 and units.numel():
        lo, hi = torch.aminmax(units)
        if int(lo) < -32768 or int(hi) > 32767:
            raise ValueError("ADPCM units must be s16 samples, got values "
                             f"in [{int(lo)}, {int(hi)}]")
    return units.to(torch.int16)


def clip_limits(limits):
    """Per-unit limits as the kernel takes them: int32 in
    [-(1 << 30), 28] (adpcm_pallas.py:209-210)."""
    return limits.clamp(-(1 << 30), adpcm.SAMPLES_PER_UNIT).to(torch.int32)


def pack_words(values, shift_range):
    """(B, T, 28) sample values -> (B, T, W) int32 packed words."""
    bits = 4 if shift_range == adpcm.SHIFT_RANGE_4BPS else 8
    per_word = 32 // bits
    B, T, n = values.shape
    W = n_words(shift_range)
    v = torch.zeros((B, T, W * per_word), dtype=torch.int64,
                    device=values.device)
    v[..., :n] = values.to(torch.int64) & ((1 << bits) - 1)
    shifts = bits * torch.arange(per_word, device=values.device)
    words = (v.reshape(B, T, W, per_word) << shifts).sum(dim=3)
    return (words - ((words & 0x80000000) << 1)).to(torch.int32)


def unpack_words(words, shift_range):
    """(B, T, W) packed words -> (B, T, 28) int32 sample values."""
    bits = 4 if shift_range == adpcm.SHIFT_RANGE_4BPS else 8
    per_word = 32 // bits
    shifts = bits * torch.arange(per_word, dtype=torch.int32,
                                 device=words.device)
    v = (words[..., None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(*words.shape[:2], -1)[..., :adpcm.SAMPLES_PER_UNIT]


def unpack_words_u8(words, shift_range):
    """(B, T, W) packed words -> (B, T, 28) uint8 sample values, contiguous,
    equal to ``unpack_words(words, shift_range).to(torch.uint8)``.

    Reads the words' little-endian bytes: for 8-bit they are the 28 values
    (a view of ``words``); for 4-bit byte i holds value 2i in its low
    nibble and 2i + 1 in its high one, written into the result's two
    strided halves. Nothing is allocated but the 4-bit result: no int32
    temporary, so unpacking a grouped call's words costs 28 bytes a
    unit."""
    B, T, _ = words.shape
    b = words.view(torch.uint8)
    if shift_range != adpcm.SHIFT_RANGE_4BPS:
        return b
    b = b[..., :adpcm.SAMPLES_PER_UNIT // 2]
    out = torch.empty((B, T, adpcm.SAMPLES_PER_UNIT // 2, 2),
                      dtype=torch.uint8, device=words.device)
    torch.bitwise_and(b, 15, out=out[..., 0])
    torch.bitwise_right_shift(b, 4, out=out[..., 1])
    return out.view(B, T, adpcm.SAMPLES_PER_UNIT)


def encode_units_plain(units, limits, prev1, prev2, *, filter_count,
                       shift_range):
    """(B, T, 28) units, (B, T) limits, (B,) prev1/prev2 -> headers (B, T),
    words (B, T, W), s1, s2 (B, T), int32 (plain torch, any device)."""
    h, values, s1, s2 = adpcm.encode_units_scan(
        units, clip_limits(limits), prev1, prev2, filter_count=filter_count,
        shift_range=shift_range)
    return h, pack_words(values, shift_range), s1, s2


def _row_encoder(rows, filter_count, shift_range):
    """A function (units (n, m, 28), limits (n, m), prev1, prev2 (n,)),
    numpy, -> headers, values (n, m, 28), s1, s2 as int32 numpy: the plain
    scan (``rows="plain"``) or the native tier (``"native"``)."""
    if rows == "native":
        from ..native import tiers

        def encode(units, limits, p1, p2):
            return tuple(np.asarray(o, np.int32) for o in
                         tiers.adpcm_encode_units(units, limits, p1, p2,
                                                  filter_count, shift_range))
    elif rows == "plain":
        def encode(units, limits, p1, p2):
            out = adpcm.encode_units_scan(
                *(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                  for a in (units, limits, p1, p2)),
                filter_count=filter_count, shift_range=shift_range)
            return tuple(o.numpy() for o in out)
    else:
        raise ValueError(f"rows must be 'plain' or 'native', got {rows!r}")
    return encode


def encode_units_segmented_plain(units, limits, prev1, prev2, *,
                                 filter_count, shift_range, segments=None,
                                 warmup=WARMUP_UNITS, rounds=ROUNDS,
                                 rows="plain"):
    """The segmented K5, step for step on the host over a row encoder
    (``rows``: "plain" or "native"): the plan (or ``segments`` forced),
    the speculation, ``rounds`` repair rounds and the serial walk, as
    ``csrc/adpcm_units.cu`` runs them. Returns :func:`encode_units_plain`'s
    four outputs and the kernel's stats ((5,) int64, ``STAT_NAMES``), on
    the units' device."""
    encode = _row_encoder(rows, filter_count, shift_range)
    x = units.to("cpu", torch.int32).numpy()
    lim = clip_limits(limits).cpu().numpy()
    prev = np.stack([prev1.to("cpu", torch.int32).numpy(),
                     prev2.to("cpu", torch.int32).numpy()], axis=1)
    B, T = lim.shape
    S = _segments(B, T, segments)
    if S == 1:
        h, v, a, b = encode(x, lim, prev[:, 0], prev[:, 1])
        stats = [B, 0, 0, 0, B * T]
    else:
        h, v, a, b, stats = _segmented(encode, x, lim, prev, S, warmup,
                                       rounds)
    dev = units.device
    return (torch.from_numpy(h).to(dev),
            pack_words(torch.from_numpy(v), shift_range).to(dev),
            torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.tensor(stats, dtype=torch.int64, device=dev))


def _segmented(encode, x, lim, prev, S, warmup, rounds):
    B, T = lim.shape
    bounds = segment_starts(T, S)
    h = np.zeros((B, T), np.int32)
    v = np.zeros((B, T, adpcm.SAMPLES_PER_UNIT), np.int32)
    a = np.zeros((B, T), np.int32)
    b = np.zeros((B, T), np.int32)
    stats = [B * S, 0, 0, 0, 0]

    def run(jobs):
        """Encodes each job (stream, first unit, last unit + 1, state) as
        one row, the rows padded at their ends."""
        n = max(t1 - t0 for _, t0, t1, _ in jobs)
        U = np.zeros((len(jobs), n, adpcm.SAMPLES_PER_UNIT), np.int32)
        L = np.zeros((len(jobs), n), np.int32)
        P = np.array([p for *_, p in jobs], np.int32)
        for i, (s, t0, t1, _) in enumerate(jobs):
            U[i, :t1 - t0] = x[s, t0:t1]
            L[i, :t1 - t0] = lim[s, t0:t1]
        return encode(U, L, P[:, 0], P[:, 1])

    def rerun(jobs):
        """Re-encodes each job from its state, overwriting unit after unit
        and stopping after the first whose post-state equals the stored
        one. Returns, per job, (units encoded, merged, post-state)."""
        if not jobs:
            return []
        hh, vv, aa, bb = run(jobs)
        out = []
        for i, (s, t0, t1, _) in enumerate(jobs):
            same = np.flatnonzero((aa[i, :t1 - t0] == a[s, t0:t1])
                                  & (bb[i, :t1 - t0] == b[s, t0:t1]))
            m = int(same[0]) + 1 if len(same) else t1 - t0
            h[s, t0:t0 + m] = hh[i, :m]
            v[s, t0:t0 + m] = vv[i, :m]
            a[s, t0:t0 + m] = aa[i, :m]
            b[s, t0:t0 + m] = bb[i, :m]
            out.append((m, bool(len(same)), (aa[i, m - 1], bb[i, m - 1])))
        return out

    # Speculation: every segment from the caller's state (a stream's
    # first) or from the raw samples before its warm-up, masked by their
    # unit's limit; the warm-up's outputs are dropped.
    jobs, offsets = [], []
    for s in range(B):
        for k in range(S):
            t0 = bounds[k]
            w0 = 0 if k == 0 else max(0, t0 - warmup)
            if w0 == 0:
                p = tuple(prev[s])
            else:
                u, n = x[s, w0 - 1], lim[s, w0 - 1]
                p = (u[27] if n > 27 else 0, u[26] if n > 26 else 0)
            jobs.append((s, w0, bounds[k + 1], p))
            offsets.append(t0 - w0)
    hh, vv, aa, bb = run(jobs)
    starts = np.zeros((B, S, 2), np.int64)
    ends = np.zeros((B, S, 2), np.int64)
    for i, ((s, w0, t1, p), off) in enumerate(zip(jobs, offsets)):
        k, t0 = i % S, w0 + off
        h[s, t0:t1] = hh[i, off:t1 - w0]
        v[s, t0:t1] = vv[i, off:t1 - w0]
        a[s, t0:t1] = aa[i, off:t1 - w0]
        b[s, t0:t1] = bb[i, off:t1 - w0]
        starts[s, k] = (aa[i, off - 1], bb[i, off - 1]) if off else p
        ends[s, k] = (aa[i, t1 - w0 - 1], bb[i, t1 - w0 - 1])
        stats[1] += t1 - w0

    # Repair rounds, each from a snapshot of the segments' end states.
    for _ in range(rounds):
        need = [(s, k) for s in range(B) for k in range(1, S)
                if tuple(ends[s, k - 1]) != tuple(starts[s, k])]
        done = rerun([(s, bounds[k], bounds[k + 1], ends[s, k - 1])
                      for s, k in need])
        new_ends = ends.copy()
        for (s, k), (m, merged, post) in zip(need, done):
            starts[s, k] = ends[s, k - 1]
            if not merged:
                new_ends[s, k] = post
            stats[2] += m
        stats[3] += bool(need)
        ends = new_ends

    # The serial walk: each boundary in time order against the true state;
    # where a start is wrong, re-encode across segment ends until merged.
    for s in range(B):
        k, p = 1, (a[s, bounds[1] - 1], b[s, bounds[1] - 1])
        while k < S:
            if tuple(starts[s, k]) == tuple(p):
                p = (a[s, bounds[k + 1] - 1], b[s, bounds[k + 1] - 1])
                k += 1
                continue
            t, merged = bounds[k], False
            while t < T and not merged:
                (m, merged, p), = rerun([(s, t, min(T, t + 2 * (
                    bounds[k + 1] - bounds[k])), p)])
                stats[4] += m
                t += m
            if not merged or t == T:
                break
            k = bisect.bisect_right(bounds, t) - 1
            if t != bounds[k]:
                p = (a[s, bounds[k + 1] - 1], b[s, bounds[k + 1] - 1])
                k += 1
    return h, v, a, b, stats


def _stats_arg(stats_out, device):
    if stats_out is None:
        return None
    _require(stats_out, torch.int64, 1, "encode_units stats_out")
    if stats_out.shape != (len(STAT_NAMES),) or stats_out.device != device:
        raise ValueError(f"encode_units: stats_out must be "
                         f"({len(STAT_NAMES)},) on {device}")
    return stats_out


def encode_pcm_units(pcm, offsets, limits, prev1, prev2, *, filter_count,
                     shift_range, segments=None, stats_out=None, base=None,
                     lengths=None):
    """K5 (``csrc/adpcm_units.cu``) on units read from int16 PCM -> the
    outputs of :func:`encode_units_plain`.

    ``pcm``: (B, N) int16, contiguous; ``offsets``: (B, T) int32,
    contiguous (see :func:`unit_offsets`), or None for the dense layout
    (unit t is samples [28 t, 28 t + 28), N = 28 T: ValueError otherwise);
    ``limits`` (B, T); ``prev1``,
    ``prev2`` (B,) int32. A sample index clips to [0, N - 1], as
    :func:`gather_units_plain`'s. ``segments``: None (the plan,
    :func:`plan_segments`) or the segments a stream forced (1: the serial
    route), for tests and measurements; no output depends on it.
    ``stats_out``: optional (5,) int64 tensor on the samples' device that
    the kernels fill with ``STAT_NAMES``; the CPU path zeroes it. On the
    CPU the plain version runs on :func:`gather_units_plain`'s units.

    ``base``, ``lengths``: the shared row. ``pcm`` is then one (N,) int16
    row and stream b the ``lengths[b]`` samples from ``base[b]``: (B,)
    int64 and int32 tensors on the samples' device, made by
    :func:`shared_row`, which checks them on the host as
    :func:`unit_offsets` checks the offsets (here only that 28 T fits
    int32 where ``offsets`` is None). Unit t of stream b starts at
    ``offsets[b, t]`` of its stream, or at 28 t where ``offsets`` is None;
    its indices clip to [0, lengths[b] - 1], and a stream of no samples
    reads zeros."""
    stats_out = _stats_arg(stats_out, pcm.device)
    B, T = limits.shape[:2]
    if base is not None:
        if base.shape != (B,) or lengths.shape != (B,) or (
                offsets is None
                and adpcm.SAMPLES_PER_UNIT * T - 1 > _INT32_MAX):
            raise ValueError("encode_pcm_units: a shared row takes B starts "
                             "and lengths, and unit offsets that fit int32")
    elif offsets is None and pcm.shape[1] != adpcm.SAMPLES_PER_UNIT * T:
        raise ValueError(f"encode_pcm_units: the dense layout takes 28 T = "
                         f"{adpcm.SAMPLES_PER_UNIT * T} samples a stream, "
                         f"got {pcm.shape[1]}")
    if not _on_cuda(pcm, "encode_pcm_units"):
        _segments(B, T, segments)
        if stats_out is not None:
            stats_out.zero_()
        return encode_units_plain(
            gather_units_plain(pcm, offsets, T, base=base, lengths=lengths),
            limits, prev1, prev2, filter_count=filter_count,
            shift_range=shift_range)
    if (filter_count, shift_range) not in KERNEL_VARIANTS:
        raise ValueError(f"encode_pcm_units: no kernel for filter_count="
                         f"{filter_count}, shift_range={shift_range}")
    _require(pcm, torch.int16, 1 if base is not None else 2,
             "encode_pcm_units pcm")
    if offsets is not None:
        _require(offsets, torch.int32, 2, "encode_pcm_units offsets")
    if base is not None:
        _require(base, torch.int64, 1, "encode_pcm_units base")
        _require(lengths, torch.int32, 1, "encode_pcm_units lengths")
    _require(limits, torch.int32, 2, "encode_pcm_units limits")
    _require(prev1, torch.int32, 1, "encode_pcm_units prev1")
    _require(prev2, torch.int32, 1, "encode_pcm_units prev2")
    dev = pcm.device
    if (base is None and pcm.shape[0] != B) or prev1.shape != (B,) \
            or prev2.shape != (B,) \
            or (offsets is not None and offsets.shape != (B, T)) \
            or any(t is not None and t.device != dev
                   for t in (offsets, base, lengths, limits, prev1, prev2)):
        raise ValueError("encode_pcm_units: expected pcm (B, N), offsets "
                         "and limits (B, T) and prev1/prev2 (B,) on one "
                         "device")
    if base is not None:
        if pcm.numel() == 0:    # the sample 0 that an empty stream reads
            pcm = pcm.new_zeros(1)
        n = 0                     # K5 takes each stream's from `lengths`
    else:
        if pcm.shape[1] > _INT32_MAX:
            raise ValueError("encode_pcm_units: K5's sample indices must "
                             "fit int32")
        if pcm.shape[1] == 0:  # as gather_units_plain: every sample reads 0
            pcm = pcm.new_zeros((B, 1))
        n = pcm.shape[1]
    S = _segments(B, T, segments)
    limits = clip_limits(limits)
    hdr = torch.empty((B, T), dtype=torch.int32, device=dev)
    words = torch.empty((B, T, n_words(shift_range)), dtype=torch.int32,
                        device=dev)
    s1 = torch.empty((B, T), dtype=torch.int32, device=dev)
    s2 = torch.empty((B, T), dtype=torch.int32, device=dev)
    if stats_out is not None:
        stats_out.zero_()
    if B and T:
        starts = ends = None
        if S > 1:
            starts = torch.empty((B * S, 2), dtype=torch.int32, device=dev)
            ends = torch.empty((2, B * S, 2), dtype=torch.int32, device=dev)
        INPUTS["shared_row" if base is not None else
               "dense" if offsets is None else "offsets"] += 1
        LAUNCHES["adpcm_encode_units"] += 1 if S == 1 else 2 + ROUNDS
        _build.launch("psx_adpcm_encode_pcm_units", pcm, _build.ptr(pcm),
                      _opt_ptr(offsets), _opt_ptr(base), _opt_ptr(lengths),
                      _build.ptr(limits), _build.ptr(prev1),
                      _build.ptr(prev2), n, B, T, filter_count, shift_range,
                      S, WARMUP_UNITS, ROUNDS,
                      _build.ptr(hdr), _build.ptr(words), _build.ptr(s1),
                      _build.ptr(s2), _opt_ptr(starts), _opt_ptr(ends),
                      _opt_ptr(stats_out))
    return hdr, words, s1, s2


def encode_units(units, limits, prev1, prev2, *, filter_count,
                 shift_range, segments=None, stats_out=None):
    """K5 on (B, T, 28) units of s16 samples, of any integer dtype:
    :func:`encode_pcm_units`' dense layout on their int16 copy (a view
    where they are int16 and contiguous). On the CPU a sample outside s16
    raises ValueError (:func:`s16_units`); on the card the call makes no
    host sync, so the caller holds them to s16 (the tensor API checks).
    ``segments`` and ``stats_out`` as :func:`encode_pcm_units`'."""
    if units.ndim != 3 or units.shape[2] != adpcm.SAMPLES_PER_UNIT \
            or units.shape[:2] != limits.shape[:2]:
        raise ValueError("encode_units: expected units (B, T, 28) and "
                         "limits (B, T)")
    B, T, n = units.shape
    pcm = units.to(torch.int16) if units.is_cuda else s16_units(units)
    pcm = pcm.reshape(B, T * n).contiguous()
    return encode_pcm_units(pcm, None, limits, prev1, prev2,
                            filter_count=filter_count,
                            shift_range=shift_range, segments=segments,
                            stats_out=stats_out)
