"""psxavenc's ``-t str -v v3`` frames through the port's ``BsFrameEncoder``
against the benchmark's plain v3 reference (``benchmark/benchref/bs_v3.py``,
loaded by path), noise frames in v2 against ``benchref/bs.py``, the
reference's DC chain on hand-made DCs, and the DC counters
(``utils/spans.py``), on the CPU.

Three frames of the benchmark's synthetic movie (``benchlib/traffic.py``,
loaded by path) at each of the ``str3.encoder`` cell's budgets, 16,128 and
18,144 bytes, go through the encoder on the device tier (a short batch
padded to 8 frames, K2's and K1's plain versions) and the native tier, and
equal the reference byte for byte; so do three frames of uniform noise
(the ``str.noise`` cell's content) in v2. The reference's DC codes equal
the port's DC stage (K2's plain version and the plain model of its
segmented scan) on differences of +-255, on the unmapped +-256, on ties
of the rounding and along chains across macroblocks. ``k2_frames``,
``dc_bits`` and ``frame_bits`` count only while a ``torch.profiler``
profile runs."""

import importlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from psxavenc_tpu_torch.models import bs_video
from psxavenc_tpu_torch.ops import bs as bs_ops
from psxavenc_tpu_torch.ops import bs_cuda
from psxavenc_tpu_torch.utils import spans

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
W, H = 320, 240
NB = (W // 16) * (H // 16) * 6
BUDGETS = (16128, 18144)


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


def _ref_v3():
    return _bench_module("benchref", "bs_v3")


@pytest.fixture(scope="module")
def movie():
    """Three NV21 frames of the benchmark's movie: two frames of one scene
    and the first of the next."""
    return _bench_module("benchlib", "traffic").movie(
        2026, 3, W, H, torch.device("cpu"), scene_frames=2)


@pytest.fixture(scope="module")
def noise():
    """Three frames of uniform random NV21 bytes."""
    g = torch.Generator().manual_seed(2027)
    return torch.randint(0, 256, (3, W * H * 3 // 2), generator=g,
                         dtype=torch.uint8).numpy()


@pytest.fixture(autouse=True)
def _no_leftovers():
    spans.reset()
    yield
    spans.reset()


def _encode(frames, budget, tier, codec, monkeypatch):
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", tier)
    enc = bs_video.BsFrameEncoder(codec, W, H, "cpu")
    try:
        handle = enc.encode_frames_async(list(frames), [budget] * 3)
        return handle, enc.fetch(handle)
    finally:
        enc.close()


@pytest.mark.parametrize("tier", ["device", "native"])
@pytest.mark.parametrize("budget", BUDGETS)
def test_v3_frames_equal_the_reference(movie, budget, tier, monkeypatch):
    handle, out = _encode(movie, budget, tier, bs_ops.BS_V3, monkeypatch)
    if tier == "device":
        assert handle[1]["scale"].shape == (8,)     # padded to a batch
    bufs, scales, _, dc_total = _ref_v3().encode_frames(
        torch.from_numpy(movie), torch.full((3,), budget), W, H)
    assert [info["quant_scale"] for _, info in out] == scales.tolist()
    assert all(1 <= s <= 63 for s in scales.tolist())
    assert (dc_total < 10 * NB).all()               # v3 spends less on DCs
    for (buf, _), want in zip(out, bufs):
        assert buf[6] == 3
        assert buf.tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("tier", ["device", "native"])
@pytest.mark.parametrize("budget", BUDGETS)
def test_v2_noise_equals_the_reference(noise, budget, tier, monkeypatch):
    _, out = _encode(noise, budget, tier, bs_ops.BS_V2, monkeypatch)
    bufs, scales, _ = _bench_module("benchref", "bs").encode_frames(
        torch.from_numpy(noise), torch.full((3,), budget), W, H)
    assert [info["quant_scale"] for _, info in out] == scales.tolist()
    assert all(40 <= s <= 63 for s in scales.tolist())
    for (buf, _), want in zip(out, bufs):
        assert buf.tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("kind, delta, want", [
    (0, 0, (2, 0b00)), (1, 0, (2, 0b00)), (2, 0, (3, 0b100)),
    (0, 1, (3, 0b011)), (0, -1, (3, 0b010)),
    (2, 1, (3, 0b001)), (2, -1, (3, 0b000)),
    (2, 5, (6, 0b101_101)), (2, -5, (6, 0b101_010)),
    (1, 255, (16, 0xFE << 8 | 255)), (1, -255, (16, 0xFE << 8)),
    (2, 255, (15, 0x7E << 8 | 255)), (2, -255, (15, 0x7E << 8)),
    (2, -256, (15, 0x7E << 8)), (2, 256, (15, 0x7E << 8)),
    (0, 128, (16, 0xFE << 8 | 128)), (0, -128, (16, 0xFE << 8 | 127))])
def test_reference_dc_codes(kind, delta, want):
    """mdec.c's trees (a size's prefix, then the size's bits: the
    difference, or difference + 2**size - 1 below 0); +-256 take -255's
    code."""
    assert _ref_v3().dc_code(kind, delta) == want


def _mb(cr, cb, y):
    return [cr, cb, *y]


DC_CASES = {
    # Differences of +255 then -255 in the Y chain: -512 -> 508 -> -512.
    "extremes": _mb(0, 0, [-512, 508, -512, 0]),
    # 510 leaves last at 512, so -512 is a difference of -256; then
    # -512 -> 510 is +256 (255.5 rounded away from zero).
    "unmapped": _mb(510, -512, [510, -512, 510, -512]) + _mb(
        -512, 510, [-512, 510, 0, 0]),
    # Every difference a tie (2 mod 4), rounded away from zero.
    "ties": _mb(2, -2, [6, -6, 10, -10]) + _mb(-6, 6, [2, -2, 14, -14]),
    # Each type's predictor runs on across macroblocks, apart from the
    # others.
    "chains": _mb(100, -100, [40, 44, 48, 52]) + _mb(
        104, -96, [-30, 30, 31, 33]) + _mb(-200, 300, [7, 8, 9, 10]),
}


@pytest.mark.parametrize("case", sorted(DC_CASES))
def test_reference_dc_chain_equals_the_ports(case):
    """The reference's sequential loop against the port's DC stage on the
    same levels (K2's plain version and the plain model of its scan)."""
    dc = torch.tensor([DC_CASES[case]], dtype=torch.int64)
    ref = _ref_v3()
    bits, code = ref.dc_codes(dc)
    for stage in (bs_cuda.dc_stage_plain, bs_cuda.dc_stage_segmented_plain):
        got_bits, got_code = stage(dc.to(torch.int32), bs_ops.BS_V3)
        assert got_bits.tolist() == bits.tolist()
        assert got_code.tolist() == code.tolist()


def test_reference_dc_differences_by_hand():
    ref = _ref_v3()
    diff = ref.dc_differences(torch.tensor([DC_CASES["unmapped"]]))[0]
    assert diff[2:6].tolist() == [128, -256, 256, -256]     # Y
    assert diff[[0, 6, 1, 7]].tolist() == [128, -256, -128, 256]
    assert diff[8:10].tolist() == [0, 256]
    ties = ref.dc_differences(torch.tensor([DC_CASES["ties"]]))[0]
    assert ties.tolist() == [1, -1, 2, -4, 5, -6, -3, 3, 4, -2, 5, -8]
    chains = ref.dc_differences(torch.tensor([DC_CASES["chains"]]))[0]
    assert chains[[0, 6, 12]].tolist() == [25, 1, -76]      # Cr alone
    assert chains[[1, 7, 13]].tolist() == [-25, 1, 99]      # Cb alone
    shared = ref.dc_differences(torch.tensor([DC_CASES["chains"]]),
                                shared=True)[0]
    assert shared[:3].tolist() == [25, -50, 35]


def test_the_control_differs(movie):
    """One predictor for all three types: other DC codes, other bytes."""
    ref = _ref_v3()
    frames = torch.from_numpy(movie)
    budgets = torch.full((3,), BUDGETS[1])
    want = ref.encode_frames(frames, budgets, W, H)
    ctl = ref.encode_frames(frames, budgets, W, H, shared=True)
    assert not torch.equal(want[3], ctl[3])
    for a, b in zip(want[0], ctl[0]):
        assert not torch.equal(a, b)


def test_dc_counters_only_under_a_profile(movie, monkeypatch):
    """Off: no DC bits come back and nothing is counted. On: each K2 call
    adds its padded batch to ``k2_frames``; the frames' DC bits equal the
    reference's code lengths, and ``frame_bits`` their total bits; the
    bytes are the same."""
    handle, off = _encode(movie, BUDGETS[0], "device", bs_ops.BS_V3,
                          monkeypatch)
    assert "dc_total" not in handle[1]
    assert spans.snapshot()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        handle, on = _encode(movie, BUDGETS[0], "device", bs_ops.BS_V3,
                             monkeypatch)
    counters = spans.snapshot()["counters"]
    _, _, _, dc_total = _ref_v3().encode_frames(
        torch.from_numpy(movie), torch.full((3,), BUDGETS[0]), W, H)
    assert counters["k2_frames"] == 8
    assert counters["dc_bits"] == int(dc_total.sum())
    assert counters["frame_bits"] == int(handle[1]["total_bits"][:3].sum())
    assert counters["k1_frames"] == 8
    assert [b.tobytes() for b, _ in on] == [b.tobytes() for b, _ in off]


def test_v2_counts_no_k2_frames(monkeypatch):
    """v2 runs no K2: under a profile it counts DC bits (10 a block) but
    no ``k2_frames``."""
    fr = np.zeros((3, W * H * 3 // 2), np.uint8)
    with profile(activities=[ProfilerActivity.CPU]):
        _encode(fr, BUDGETS[0], "device", bs_ops.BS_V2, monkeypatch)
    counters = spans.snapshot()["counters"]
    assert "k2_frames" not in counters
    assert counters["dc_bits"] == 3 * NB * 10
