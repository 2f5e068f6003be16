"""The port's tools and example on the CPU: the stage profile's stages, run
in order, give ``api.bs_encode_frames_packed``'s words; the native-tier
profile builds its harness against the port's source; the card tools
stop without a card; the tensor-API example runs on the CPU; the port's
console scripts resolve."""

import importlib
import importlib.util
import pathlib
import sys

import pytest
import torch

from psxavenc_tpu_torch import api as tapi

from test_torch_parity import video_frames

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load(path):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(path).stem, REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def stages_tool():
    return _load("tools/torch_profile_stages.py")


@pytest.mark.parametrize("codec", [0, 1, 2])
def test_stages_in_order_give_the_steps_words(stages_tool, codec):
    """``api.step_stages``, the stages the profile times, run in order give
    the step's outputs. Video and noise frames (blocks past 256 bits, so
    the tail emission writes) and one unfittable budget."""
    w, h = 48, 32
    frames = torch.from_numpy(video_frames(w, h, 5, seed=12, noise=2))
    budgets = torch.tensor([2304, 1200, 2304, 60, 2304, 1800, 2304],
                           dtype=torch.int32)
    kw = dict(codec=codec, width=w, height=h, capacity_words=1148)
    want = tapi.bs_encode_frames_packed(frames, budgets, **kw)
    for use_kernels in (True, False):
        stages = tapi.step_stages(use_kernels=use_kernels, **kw)
        names = [name for name, _ in stages]
        assert set(names) == set(stages_tool.LABELS)
        assert set(stages_tool.NAMED) <= set(names)
        state = tapi.run_stages(stages, {"frames": frames,
                                         "budgets": budgets})
        for key in ("words", "scale", "total_bits", "nz_count"):
            assert torch.equal(state[key], want[key]), key
        before = stages_tool.state_before(tapi, stages, frames, budgets,
                                          "k3")
        assert "c" in before and "vals32" not in before


def test_native_profile_harness_runs():
    tool = _load("tools/torch_profile_native.py")
    assert tool.SRC.exists() and "psxavenc_tpu_torch" in str(tool.SRC)
    assert tool.harness() == 0


@pytest.mark.parametrize("path,argv", [
    ("tools/torch_profile_stages.py", []),
    ("tools/torch_kernel_bench.py", ["--kernels", "select,adpcm"]),
])
def test_card_tools_stop_without_a_card(path, argv, monkeypatch, capsys):
    tool = _load(path)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_kernel_bench_knows_select_and_adpcm():
    bench = _load("tools/torch_kernel_bench.py")
    assert {"select", "adpcm"} <= set(bench.GROUPS)


def test_example_runs_on_the_cpu(capsys):
    example = _load("examples/torch_batch_api.py")
    assert example.main(["cpu"]) == 0
    out = capsys.readouterr().out
    assert "SPU blocks: (256, 100, 16)" in out
    assert "packed words: (8, 4028)" in out
    assert "split over 2 device(s) (cpu, cpu)" in out


def test_console_scripts_resolve():
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items()
            if v.startswith("psxavenc_tpu_torch.")}
    assert port == {"psxavenc-tpu-torch": "psxavenc_tpu_torch.cli:main",
                    "psxavenc-tpu-torch-batch":
                    "psxavenc_tpu_torch.batch:main"}
    for target in port.values():
        module, name = target.split(":")
        assert callable(getattr(importlib.import_module(module), name))
    assert all(k.startswith("psxavenc-tpu") for k in scripts)
