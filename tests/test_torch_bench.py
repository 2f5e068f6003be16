"""bench_torch.py on the CPU: its figures' helpers, its CPU run (the
native tiers, no CUDA call, no details file), its refusal without a card,
and its checks: fused_mxu held to blocks on the plain versions, and a
changed plain version or native reference refused."""

import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.ops import _build

from test_torch_parity import video_frames

REPO = pathlib.Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
W, H, BUDGET = 48, 32, 4000


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_torch",
                                                  REPO / "bench_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("values, want", [
    ([3.0, 1.0, 2.0], (2.0, 1.0, 3.0)),
    ([4.0, 1.0, 2.0, 10.0], (3.0, 1.0, 10.0)),
    ([5.5], (5.5, 5.5, 5.5)),
])
def test_summary(bench, values, want):
    assert bench.summary(values) == dict(zip(("median", "least",
                                              "greatest"), want))


def test_interleaved_alternates_the_order(bench):
    calls = []
    runs = {"a": lambda: calls.append("a") or len(calls),
            "b": lambda: calls.append("b") or len(calls)}
    out = bench.interleaved(runs, 4)
    assert calls == list("abbaabba")
    assert out == {"a": [1, 4, 5, 8], "b": [2, 3, 6, 7]}


def test_cpu_quick_runs_no_cuda_and_writes_nothing(bench, monkeypatch,
                                                   tmp_path, capsys):
    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call in the CPU run")

    for name in ("is_available", "synchronize", "Event", "CUDAGraph",
                 "Stream", "get_device_name", "device_count"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(_build, "lib", no_cuda)
    monkeypatch.setattr(bench, "card_line", no_cuda)
    monkeypatch.setattr(bench, "DETAILS", tmp_path / "details.json")
    monkeypatch.setattr(bench, "NATIVE_FRAMES", 4)
    monkeypatch.setattr(bench, "NATIVE_ADPCM_STREAMS", 8)
    assert bench.main(["--device", "cpu", "--quick"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == KEYS
    assert line["device"] == "cpu" and line["value"] > 0
    assert line["vs_baseline"] is None
    assert list(tmp_path.iterdir()) == []


def _run(*args):
    return subprocess.run([sys.executable, str(REPO / "bench_torch.py"),
                           *args], capture_output=True, text=True,
                          timeout=120, cwd=REPO)


def test_cpu_quick_exit_code_and_last_line():
    proc = _run("--device", "cpu", "--quick")
    assert proc.returncode == 0, proc.stderr
    assert set(json.loads(proc.stdout.strip().splitlines()[-1])) == KEYS


def test_without_a_card_it_exits_1_and_prints_no_figure():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _run("--quick")
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def _frames():
    return video_frames(W, H, 2, seed=4, noise=1)


def test_validation_holds_fused_mxu_to_blocks_on_plain_versions(bench):
    bench.validate_video(torch.device("cpu"), _frames(), W, H, BUDGET)


def test_validation_refuses_a_changed_plain_version(bench, monkeypatch):
    real = tapi.bs_encode_frames_packed

    def changed(*args, packer=None, use_kernels=True, **kw):
        out = real(*args, packer=packer, use_kernels=use_kernels, **kw)
        if not use_kernels:
            out["words"] = out["words"].clone()
            out["words"][0, 0] ^= 1
        return out

    monkeypatch.setattr(bench.api, "bs_encode_frames_packed", changed)
    with pytest.raises(bench.Mismatch, match="blocks on the plain"):
        bench.validate_video(torch.device("cpu"), _frames(), W, H, BUDGET)


@pytest.mark.parametrize("what", ["video", "adpcm"])
def test_checks_refuse_a_changed_native_reference(bench, monkeypatch, what):
    """The device batches are held to the native tiers: equal on the
    CPU, and refused when the reference's output changes."""
    monkeypatch.setattr(bench, "VIDEO_W", W)
    monkeypatch.setattr(bench, "VIDEO_H", H)
    if what == "video":
        frames = _frames()
        out = tapi.bs_encode_frames_packed(
            torch.from_numpy(frames),
            torch.full((len(frames),), bench.FRAME_BUDGET, dtype=torch.int32),
            codec=0, width=W, height=H, capacity_words=bench.CAP_WORDS)

        def check():
            bench.check_video_native(out, frames, 0)
        fn, key = "bs_encode_frames", "words"
    else:
        units, limits, z = bench.adpcm_units(4, 3)
        out = tapi.spu_encode_batch(*(torch.from_numpy(a) for a in
                                      (units, limits, z, z)))

        def check():
            bench.check_adpcm_native(out, units, limits, z)
        fn, key = "adpcm_encode_units", 0
    check()
    real = getattr(bench.tiers, fn)

    def changed(*args, **kw):
        got = real(*args, **kw)
        got = dict(got) if isinstance(got, dict) else list(got)
        got[key] = np.array(got[key])
        got[key].reshape(-1)[0] ^= 1
        return got

    monkeypatch.setattr(bench.tiers, fn, changed)
    with pytest.raises(bench.Mismatch, match="native"):
        check()
