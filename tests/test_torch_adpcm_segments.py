"""The segmented K5's scheme on the CPU, through its plain model.

``ops/adpcm_cuda.py::encode_units_segmented_plain`` runs the plan, the
speculation from guessed states, the parallel repair rounds and the serial
walk of ``csrc/adpcm_units.cu`` step for step over a row encoder. Here it
is held to the JAX scan (``psxavenc_tpu/ops/adpcm.py::encode_units_scan``)
at small T, with segments forced, on inputs whose guesses merge, whose
guesses never merge (a loud 440 Hz tone), silence, masked units at segment
boundaries and nonzero states; and to the native tier's whole-stream
encode on a tone long enough that the walk has to re-encode. The card
tests (tests/test_torch_cuda.py) hold the kernels to the same model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psxavenc_tpu.ops import adpcm as jops
from psxavenc_tpu_torch.native import tiers
from psxavenc_tpu_torch.ops import adpcm_cuda
from psxavenc_tpu_torch.utils.synth import rand_pcm, tone

VARIANTS = [(5, 12), (4, 12), (4, 8)]


def mixed_streams(T, S, seed=5):
    """Six (T, 28) streams and their limits and states: synthetic audio
    from zero; the 440 Hz tone at 30,000; silence; synthetic audio with
    masked units at segment boundaries; synthetic audio from a nonzero
    state; the tone with partial limits and a nonzero state."""
    rng = np.random.default_rng(seed)
    pcm = rand_pcm(T * 28, channels=2, seed=seed).reshape(-1, 2).T
    tones = tone(T * 28, channels=2).T
    units = np.stack([pcm[0], tones[0], np.zeros(T * 28, np.int32),
                      pcm[1], pcm[0][::-1].copy(),
                      tones[1]]).astype(np.int32)
    units = units.reshape(6, T, 28)
    lim = np.full((6, T), 28, np.int32)
    bounds = adpcm_cuda.segment_starts(T, S)
    for k in bounds[1:-1]:
        lim[3, k] = 0                  # masked, first unit of a segment
        lim[3, k - 1] = -7             # and the last unit before it
    lim[3, 1] = 13
    lim[5, ::5] = 19
    p1 = np.zeros(6, np.int32)
    p2 = np.zeros(6, np.int32)
    p1[[4, 5]] = rng.integers(-0x8000, 0x8000, 2)
    p2[[4, 5]] = rng.integers(-0x8000, 0x8000, 2)
    return units, lim, p1, p2


def model(units, lim, p1, p2, fc, sr, **kw):
    return adpcm_cuda.encode_units_segmented_plain(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (units, lim, p1, p2)),
        filter_count=fc, shift_range=sr, **kw)


def assert_equal_outputs(got, want, sr):
    """got: the model's (headers, words, s1, s2); want: headers, sample
    values, s1, s2 of a whole-stream encode."""
    got = (got[0], adpcm_cuda.unpack_words(got[1], sr), got[2], got[3])
    for name, g, w in zip(("headers", "values", "s1", "s2"), got, want):
        g = np.asarray(g).astype(np.int64)
        w = np.asarray(w).astype(np.int64)
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), (name, np.argwhere(g != w)[:5])


@pytest.mark.parametrize("B,T,S", [
    (4096, 1000, 1),        # bench.py's batch: the serial route
    (adpcm_cuda.FILL_GROUPS, 81000, 1),
    (2, 81000, 1265),       # a 60 s stereo XA track
    (2, 73728, 1152),       # the XA CLI's 1,024-sector chunk
    (2, 4608, 72),          # a .str chunk of 64 sectors
    (0, 1000, 1),           # no stream
    (1, 127, 1),            # under two segments
    (1, 128, 2),
    (3, 1000, 15),
    (100, 5000, 41),
    (1024, 1000, 4),
    (4095, 1000, 2),
])
def test_plan(B, T, S):
    assert adpcm_cuda.plan_segments(B, T) == S
    if S > 1:
        bounds = adpcm_cuda.segment_starts(T, S)
        assert min(np.diff(bounds)) >= adpcm_cuda.L_MIN
        assert B * S >= adpcm_cuda.FILL_GROUPS or S == T // adpcm_cuda.L_MIN


@pytest.mark.parametrize("T", [1, 2, 63, 64, 129, 1000, 81000])
def test_segment_bounds_cover(T):
    for S in sorted({1, 2, 3, 7, min(T, 64), T}):
        if S > T:
            continue
        b = adpcm_cuda.segment_starts(T, S)
        assert b[0] == 0 and b[-1] == T and len(b) == S + 1
        d = np.diff(b)
        assert d.min() >= 1 and d.max() - d.min() <= 1


@pytest.mark.parametrize("warmup", [adpcm_cuda.WARMUP_UNITS, 0])
@pytest.mark.parametrize("filter_count,shift_range", VARIANTS)
def test_model_matches_jax(filter_count, shift_range, warmup):
    """The model with S = 5 on T = 61 units (segments of 12 and 13) equals
    the JAX scan on every stream; without a warm-up the guesses are worse,
    so rounds and the walk repair."""
    T, S = 61, 5
    units, lim, p1, p2 = mixed_streams(T, S)
    want = jops.encode_units_scan(
        jnp.asarray(units), jnp.asarray(lim), jnp.asarray(p1),
        jnp.asarray(p2), filter_count=filter_count, shift_range=shift_range)
    *got, stats = model(units, lim, p1, p2, filter_count, shift_range,
                        segments=S, warmup=warmup)
    assert_equal_outputs(got, [np.asarray(w) for w in want], shift_range)
    stats = stats.tolist()
    assert stats[0] == 6 * S
    if warmup == 0:
        assert stats[1] == 6 * T and stats[2] > 0 and stats[3] >= 1


@pytest.mark.parametrize("filter_count,shift_range", [(5, 12), (4, 12)])
def test_model_matches_native_on_tone(filter_count, shift_range):
    """On a stereo 440 Hz tone at 30,000 the guessed starts lock into other
    limit cycles: the rounds cannot repair them and the walk re-encodes
    thousands of units; the planned scheme still equals the native
    tier's whole-stream encode."""
    T = 8192
    units = np.ascontiguousarray(tone(T * 28, channels=2).T, np.int32) \
        .reshape(2, T, 28)
    lim = np.full((2, T), 28, np.int32)
    zero = np.zeros(2, np.int32)
    *got, stats = model(units, lim, zero, zero, filter_count, shift_range,
                        rows="native")
    want = tiers.adpcm_encode_units(units, lim, zero, zero, filter_count,
                                    shift_range)
    assert_equal_outputs(got, want, shift_range)
    S = adpcm_cuda.plan_segments(2, T)
    segments, spec, repair, rounds, walked = stats.tolist()
    assert segments == 2 * S and rounds == adpcm_cuda.ROUNDS
    assert walked > T // 4 and repair > T


def test_model_matches_native_on_synthetic_track():
    """On synthetic audio (chip_smoke's track recipe, 8,192 units a
    channel) with nonzero states and masked units, the speculation's
    warm-ups merge nearly everywhere: the rounds repair a few units and
    the walk none."""
    T = 8192
    pcm = rand_pcm(T * 28, channels=2, seed=61).reshape(-1, 2).T
    units = np.ascontiguousarray(pcm, np.int32).reshape(2, T, 28)
    lim = np.full((2, T), 28, np.int32)
    lim[0, 64:70] = 0
    lim[1, 1000] = -2
    p1 = np.array([1200, -31000], np.int32)
    p2 = np.array([-5, 32767], np.int32)
    for fc, sr in VARIANTS:
        *got, stats = model(units, lim, p1, p2, fc, sr, rows="native")
        assert_equal_outputs(
            got, tiers.adpcm_encode_units(units, lim, p1, p2, fc, sr), sr)
        segments, spec, repair, rounds, walked = stats.tolist()
        S = adpcm_cuda.plan_segments(2, T)
        assert segments == 2 * S
        assert spec == 2 * T + 2 * (S - 1) * adpcm_cuda.WARMUP_UNITS
        assert walked == 0 and repair < T // 8


@pytest.mark.parametrize("rows", ["plain", "native"])
def test_model_serial_route(rows):
    """S = 1 is one whole-stream encode: B segments, every unit walked."""
    units, lim, p1, p2 = mixed_streams(9, 1)
    *got, stats = model(units, lim, p1, p2, 4, 12, rows=rows)
    want = tiers.adpcm_encode_units(units, lim, p1, p2, 4, 12)
    assert_equal_outputs(got, want, 12)
    assert stats.tolist() == [6, 0, 0, 0, 6 * 9]


@pytest.mark.parametrize("segments", [None, 1, 3, 1000])
def test_cpu_wrapper_takes_the_plain_version(segments):
    """``segments=`` on CPU tensors takes the plain version, as K1's
    ``seeds=`` does, and zeroes ``stats_out``."""
    units, lim, p1, p2 = mixed_streams(10, 3)
    args = [torch.from_numpy(a) for a in (units, lim, p1, p2)]
    stats = torch.full((5,), 7, dtype=torch.int64)
    before = adpcm_cuda.LAUNCHES["adpcm_encode_units"]
    got = adpcm_cuda.encode_units(*args, filter_count=4, shift_range=8,
                                  segments=segments, stats_out=stats)
    want = adpcm_cuda.encode_units_plain(*args, filter_count=4,
                                         shift_range=8)
    assert adpcm_cuda.LAUNCHES["adpcm_encode_units"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert stats.tolist() == [0] * 5


@pytest.mark.parametrize("kw", [{"segments": 0}, {"segments": 2.0},
                                {"segments": True},
                                {"stats_out": torch.zeros(5)},
                                {"stats_out": torch.zeros(4,
                                                          dtype=torch.int64)}])
def test_cpu_wrapper_rejects_bad_arguments(kw):
    units, lim, p1, p2 = mixed_streams(4, 2)
    with pytest.raises(ValueError):
        adpcm_cuda.encode_units(
            *(torch.from_numpy(a) for a in (units, lim, p1, p2)),
            filter_count=4, shift_range=12, **kw)
