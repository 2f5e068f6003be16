"""The ``str3.encoder`` and ``str.noise`` cells' pieces on the CPU: the
``str-v3-320x240`` configuration against ``str-v2-320x240``'s, both cells,
their traffic and their metrics resolved, K2's frozen work count against
the program's, the ``frame_feed`` driver's noise frames, tiny runs of both
reading 0 wrong with the census naming K2 only for v3 and the controls
reading wrong, and the seven new readers: their definitions, and None
without a trace or a counter."""

import json
import os
import types

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, run_cell

from benchlib import roofline, roofline_dc, runner, spec
from benchlib.drivers import frame_feed

V3 = ("step_device_ms.v3", "k2_v3_roofline", "k1_evals_per_frame.v3",
      "dc_bits_pct.v3", "device_idle_pct.v3")
NOISE = ("step_device_ms.noise", "k1_evals_per_frame.noise")
TINY = {"driver": "frame_feed", "content": "movie", "movie_seconds": 0.6,
        "scene_frames": 5, "batch_frames": 128, "check_frames": 3,
        "warmup_passes": 1, "trace_seconds": 0.2}
SPEC = spec.load_spec()


def _config(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        return entry, json.load(f)


def test_the_v3_configuration():
    """Every key of the v2 configuration, equal but the codec, the
    reference, the name, the source and the prose; its own source; nothing
    reduced."""
    entry, cfg = _config("str-v3-320x240")
    _, base = _config("str-v2-320x240")
    assert entry["reduced"] == [] and cfg["name"] == "str-v3-320x240"
    assert entry["source"].endswith("mdec.c#L455-L480")
    assert entry["source"] == cfg["source"]
    assert [c["source"] for c in SPEC["configs"]].count(
        entry["source"]) == 1
    assert set(base) <= set(cfg)
    for k, v in base.items():
        if k not in ("name", "source", "codec", "reference", "defines"):
            assert cfg[k] == v, k
    assert (cfg["codec"], cfg["reference"]) == ("v3", "benchref/bs_v3.py")
    assert "mdec.c:455-480" in cfg["defines"]


@pytest.mark.parametrize("cell, config, traffic, metrics", [
    ("str3.encoder", "str-v3-320x240", "feed", V3),
    ("str.noise", "str-v2-320x240", "noise", NOISE)])
def test_the_cells_list_their_metrics(cell, config, traffic, metrics):
    c = spec.Cell(SPEC, cell)
    assert (c.entry["config"], c.traffic_name, c.chips) == (config,
                                                            traffic, 1)
    assert [m["name"] for m in c.per_layer] == list(metrics)
    assert {m["name"] for m in c.end_to_end} == {"memory_peak_mib",
                                                 "setup_s"}
    for m in c.per_layer:
        assert m["workloads"] == [cell]
        assert m["moves"] == "memory_peak_mib"
        assert callable(c.reader(m["name"]).read)
    assert c.driver() is frame_feed


def test_the_traffic_is_the_encoder_feed():
    """``feed.json`` is ``encoder.json``'s feed with its content named;
    ``noise.json`` the same feed on noise, with no scenes."""
    base = spec.Cell(SPEC, "str.encoder").traffic
    feed = spec.Cell(SPEC, "str3.encoder").traffic
    noise = spec.Cell(SPEC, "str.noise").traffic
    assert (feed["content"], noise["content"]) == ("movie", "noise")
    for k, v in base.items():
        if k not in ("driver", "why"):
            assert feed[k] == v, k
            if k != "scene_frames":
                assert noise[k] == v, k
    assert "scene_frames" not in noise


@pytest.mark.parametrize("args", [(900, 1800), (128, 1800), (8, 7200),
                                  (1, 6)])
def test_k2_work_is_the_programs(args):
    from psxavenc_tpu_torch.utils import roofline as program
    assert roofline_dc.dc_work(*args) == program.dc_work(*args)
    assert roofline_dc.dc_work(*args) == (3 * args[0] * args[1] * 4,
                                          12 * args[0] * args[1])


def test_noise_frames_from_the_seed():
    a = frame_feed.noise(2**31 + 7, 3, 48, 32, torch.device("cpu"))
    assert a.shape == (3, 48 * 32 * 3 // 2) and a.dtype == np.uint8
    assert a.flags["C_CONTIGUOUS"]
    assert np.array_equal(a, frame_feed.noise(2**31 + 7, 3, 48, 32, "cpu"))
    assert not np.array_equal(a, frame_feed.noise(8, 3, 48, 32, "cpu"))
    counts = np.bincount(a.ravel(), minlength=256)
    assert counts.min() > 0 and abs(a.mean() - 127.5) < 3


def _tiny_tree(tree, name, content, real):
    """Adds the cell ``name``: 9 48x32 frames of ``content`` on ``real``'s
    codec, reading ``real``'s metrics."""
    path = os.path.join(tree, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    config = "str-v2-48x32"
    if spec.Cell(SPEC, real).config["codec"] == "v3":
        config = "str-v3-48x32"
        with open(os.path.join(tree, "benchmark", "configs",
                               "str-v2-48x32.json")) as f:
            cfg = json.load(f)
        cfg.update(name=config, codec="v3", reference="benchref/bs_v3.py")
        with open(os.path.join(tree, "benchmark", "configs",
                               config + ".json"), "w") as f:
            json.dump(cfg, f)
        s["configs"].append(dict(s["configs"][0], name=config,
                                 file=f"benchmark/configs/{config}.json"))
    with open(os.path.join(tree, "benchmark", "traffic",
                           name + ".json"), "w") as f:
        json.dump(dict(TINY, content=content), f)
    s["workloads"].append(dict(name=name, config=config, traffic=name,
                               chips=1, why="a test cell"))
    for m in s["per_layer"]:
        if real in m.get("workloads", []):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(s, f)
    return tree


@pytest.fixture
def feed_tree(tiny_tree, monkeypatch):
    """The tiny tree with ``v3.tiny`` (9 48x32 frames of movie in v3) and
    ``noise.tiny`` (9 48x32 frames of noise in v2)."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    _tiny_tree(tiny_tree, "v3.tiny", "movie", "str3.encoder")
    return _tiny_tree(tiny_tree, "noise.tiny", "noise", "str.noise")


def _driver(tree, name, seed, tmp_path):
    cell = spec.Cell(spec.load_spec(tree), name, root=tree,
                     bench_dir=os.path.join(tree, "benchmark"))
    return cell.driver().Driver(cell, seed, torch.device("cpu"),
                                str(tmp_path), runner.Spans())


@pytest.mark.parametrize("name", ["v3.tiny", "noise.tiny"])
def test_a_short_feed_is_correct(feed_tree, name):
    r = run_cell(feed_tree, name, seed=2**31 + 3)
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] > 0 and r["attempted"] % 9 == 0   # whole passes
    assert r["checks"]["frames_wrong"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("name, k2", [("v3.tiny", True),
                                      ("noise.tiny", False)])
def test_the_census_names_k2_only_for_v3(feed_tree, tmp_path, name, k2):
    driver = _driver(feed_tree, name, 4, tmp_path)
    driver.setup()
    driver.unit()
    ctx = types.SimpleNamespace(traced_units=2)
    driver.census(ctx)
    want = {"select_pix_kernel", "emit_prep_kernel", "emit_tail_kernel",
            "place_kernel"} | ({"dc_chain_kernel"} if k2 else set())
    assert set(ctx.work) == want
    nb = (48 // 16) * (32 // 16) * 6
    if k2:
        assert ctx.work["dc_chain_kernel"] == tuple(
            2 * x for x in roofline_dc.dc_work(9, nb))
    assert ctx.batches_traced == 2


@pytest.mark.parametrize("name", ["v3.tiny", "noise.tiny"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_reads_wrong(feed_tree, tmp_path, name, seed):
    driver = _driver(feed_tree, name, seed, tmp_path)
    driver.setup()
    driver.unit()
    assert driver.check() == [("frames_wrong", 0, 0)]
    (label, wrong, limit), = driver.control()
    assert (label, limit) == ("frames_wrong", 0) and wrong >= 1


def _reader(name):
    return spec.load_file(os.path.join(BENCH, "metrics", name + ".py"))


def _snapshot(counters):
    return lambda: {"spans": {}, "counters": counters}


@pytest.mark.parametrize("name", V3 + NOISE)
def test_readers_without_a_trace_or_counter(monkeypatch, name):
    """None with no trace, no work and no counter (as on the parent, whose
    program counts no DC bits), and where the program has no spans
    module."""
    ctx = types.SimpleNamespace(trace=None, work=None, batches_traced=0)
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    monkeypatch.setattr(mod, "snapshot", _snapshot(
        {"k1_frames": 8, "frame_bits": 100}))
    assert _reader(name).read(ctx) is None

    def missing(module):
        raise ModuleNotFoundError(module)

    monkeypatch.setattr(spec, "program", missing)
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name, counters, want", [
    ("k1_evals_per_frame.v3", {"k1_frames": 256, "k1_evaluations": 384},
     1.5),
    ("k1_evals_per_frame.noise", {"k1_frames": 8, "k1_evaluations": 20},
     2.5),
    ("dc_bits_pct.v3", {"dc_bits": 13_000, "frame_bits": 130_000}, 10.0)])
def test_counter_readers(monkeypatch, name, counters, want):
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    monkeypatch.setattr(mod, "snapshot", _snapshot(counters))
    assert _reader(name).read(None) == pytest.approx(want)


def test_trace_readers():
    trace = types.SimpleNamespace(
        busy_s=1.0, window_s=5.0, kernels={"a": 0.002, "b": 0.006},
        kernel_seconds=lambda *f: 0.004)
    ctx = types.SimpleNamespace(
        trace=trace, batches_traced=4,
        work={"dc_chain_kernel": (roofline.HBM_BYTES_PER_S * 0.001, 0.0)})
    for name in ("step_device_ms.v3", "step_device_ms.noise"):
        assert _reader(name).read(ctx) == pytest.approx(2.0)
    assert _reader("device_idle_pct.v3").read(ctx) == pytest.approx(80.0)
    assert _reader("k2_v3_roofline").read(ctx) == pytest.approx(25.0)
    ctx.work = {"select_pix_kernel": (1.0, 1.0)}
    assert _reader("k2_v3_roofline").read(ctx) is None
