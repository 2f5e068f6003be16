"""psxavenc's ``-t str -s 640x480`` frames through the port's
``BsFrameEncoder`` against the benchmark's plain reference
(``benchmark/benchref/bs.py``, loaded by path), and the counters made
from the kernels' own statistics (``utils/spans.py``), on the CPU.

Three frames of the benchmark's synthetic movie (``benchlib/traffic.py``,
loaded by path) at each of the cell's budgets, 16,128 and 18,144 bytes (8
and 9 sectors of 2,016), go through the encoder on the device tier (a
short batch padded to 8 frames, K1's plain version) and the native tier,
and equal the reference byte for byte. K1's and K5's statistics reach the
counters ``k1_*`` and ``k5_*`` only while a ``torch.profiler`` profile
runs; then ``k1_frames`` and ``k5_units`` count each call's frames and
units, and the counters taken from the statistics read 0 here, where the
plain versions zero them. With no profile running the step returns no
statistics tensor."""

import importlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from psxavenc_tpu_torch import api
from psxavenc_tpu_torch.models import adpcm_stream, bs_video
from psxavenc_tpu_torch.ops import adpcm as adpcm_ops
from psxavenc_tpu_torch.ops import bs as bs_ops
from psxavenc_tpu_torch.ops import bs_cuda
from psxavenc_tpu_torch.utils import spans

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
W, H = 640, 480
BUDGETS = (16128, 18144)
K1_COUNTERS = ("k1_frames", "k1_global_frames", "k1_evaluations")
K5_COUNTERS = ("k5_units", "k5_walked_units")


def _bench_module(package, module):
    """``benchmark/<package>/<module>.py``, its package loaded by path."""
    if package not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            package, BENCH / package / "__init__.py",
            submodule_search_locations=[str(BENCH / package)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[package] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{package}.{module}")


@pytest.fixture(scope="module")
def frames():
    """Three 640x480 NV21 frames of the benchmark's movie: two frames of
    one scene and the first of the next."""
    movie = _bench_module("benchlib", "traffic").movie(
        2024, 3, W, H, torch.device("cpu"), scene_frames=2)
    return movie


@pytest.fixture(autouse=True)
def _no_leftovers():
    spans.reset()
    yield
    spans.reset()


def _encode(frames, budget, tier, monkeypatch):
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", tier)
    enc = bs_video.BsFrameEncoder(bs_ops.BS_V2, W, H, "cpu")
    try:
        handle = enc.encode_frames_async(list(frames), [budget] * 3)
        return handle, enc.fetch(handle)
    finally:
        enc.close()


@pytest.mark.parametrize("tier", ["device", "native"])
@pytest.mark.parametrize("budget", BUDGETS)
def test_frames_equal_the_reference(frames, budget, tier, monkeypatch):
    handle, out = _encode(frames, budget, tier, monkeypatch)
    if tier == "device":
        assert handle[1]["scale"].shape == (8,)     # padded to a batch
    ref = _bench_module("benchref", "bs")
    bufs, scales, _ = ref.encode_frames(
        torch.from_numpy(frames), torch.full((3,), budget), W, H)
    assert [info["quant_scale"] for _, info in out] == scales.tolist()
    assert all(1 <= s <= 63 for s in scales.tolist())
    for (buf, _), want in zip(out, bufs):
        assert buf.tobytes() == want.numpy().tobytes()


def test_k1_counters_only_under_a_profile(frames, monkeypatch):
    """Off: no statistics tensor comes back and nothing is counted. On:
    each batch adds its padded frames to ``k1_frames``; the plain K1
    zeroes its rows, so the rest read 0; the three frames' DC bits (v2's
    10 a block) and total bits reach ``dc_bits`` and ``frame_bits``; the
    span ``bs.step`` counts one a batch; the bytes are the same."""
    handle, off = _encode(frames, BUDGETS[0], "device", monkeypatch)
    assert "k1_stats" not in handle[1] and "dc_total" not in handle[1]
    assert spans.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        handle, on = _encode(frames, BUDGETS[0], "device", monkeypatch)
        assert handle[1]["k1_stats"].shape == (8, len(bs_cuda.STAT_NAMES))
        handle2, _ = _encode(frames, BUDGETS[1], "device", monkeypatch)
    total = sum(int(h[1]["total_bits"][:3].sum()) for h in (handle,
                                                             handle2))
    snap = spans.snapshot()
    assert snap["counters"] == {
        "k1_frames": 16, "k1_global_frames": 0, "k1_evaluations": 0,
        "dc_bits": 2 * 3 * 7200 * 10, "frame_bits": total}
    assert snap["spans"]["bs.step"]["count"] == 2
    assert [b.tobytes() for b, _ in on] == [b.tobytes() for b, _ in off]


def test_k1_stats_only_where_k1_runs():
    """The packed API returns K1's rows only when asked, and refuses the
    request on a packer that does not run K1."""
    g = torch.Generator().manual_seed(5)
    fr = torch.randint(0, 256, (2, 48 * 32 * 3 // 2), dtype=torch.uint8,
                       generator=g)
    budgets = torch.tensor([900, 400], dtype=torch.int32)
    kw = dict(codec=bs_ops.BS_V2, width=48, height=32, capacity_words=446)
    plain = api.bs_encode_frames_packed(fr, budgets, **kw)
    asked = api.bs_encode_frames_packed(fr, budgets, k1_stats=True, **kw)
    assert "k1_stats" not in plain
    assert asked["k1_stats"].dtype == torch.int32
    assert asked["k1_stats"].shape == (2, len(bs_cuda.STAT_NAMES))
    assert not asked["k1_stats"].any()
    for k in plain:
        assert torch.equal(plain[k], asked[k]), k
    with pytest.raises(ValueError, match="does not run K1"):
        api.bs_encode_frames_packed(fr, budgets, k1_stats=True,
                                    kernel_sweep=False, **kw)


def test_k5_counters_only_under_a_profile(monkeypatch):
    """K5's plain version (PSXAVENC_NO_NATIVE_ADPCM): each call adds its
    units to ``k5_units`` under a profile; the walk's count reads 0; off,
    nothing is counted and the outputs are the same."""
    monkeypatch.setenv("PSXAVENC_NO_NATIVE_ADPCM", "1")
    rng = np.random.default_rng(24)
    pcm = rng.integers(-20000, 20000, (2, 140)).astype(np.int16)
    offsets, limits = adpcm_stream.chunk_unit_layout([140])
    args = (pcm, np.stack([offsets] * 2), np.stack([limits] * 2),
            adpcm_ops.SPU_FILTER_COUNT, adpcm_ops.SHIFT_RANGE_4BPS)
    off = adpcm_stream.encode_unit_streams(*args, device="cpu")
    assert spans.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        on = adpcm_stream.encode_unit_streams(*args, device="cpu")
        adpcm_stream.encode_unit_streams(*args, device="cpu")
    assert spans.snapshot()["counters"] == {"k5_units": 20,
                                            "k5_walked_units": 0}
    for a, b in zip(off, on):
        assert np.array_equal(a, b)


def test_the_native_tiers_count_nothing(frames, monkeypatch):
    """The native tiers run neither K1 nor K5: no counter of theirs."""
    with profile(activities=[ProfilerActivity.CPU]):
        _encode(frames[:1].repeat(3, 0), BUDGETS[1], "native", monkeypatch)
        pcm = np.zeros((1, 56), np.int16)
        offsets, limits = adpcm_stream.chunk_unit_layout([56])
        adpcm_stream.encode_unit_streams(
            pcm, offsets[None], limits[None], adpcm_ops.SPU_FILTER_COUNT,
            adpcm_ops.SHIFT_RANGE_4BPS, device="cpu")
    assert not set(spans.snapshot()["counters"]) & set(
        K1_COUNTERS + K5_COUNTERS)
