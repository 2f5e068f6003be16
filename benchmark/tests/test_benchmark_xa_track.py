"""The ``xa.track`` cell's pieces on the CPU: the ``track`` mix through the
``cli_track`` driver on a tiny cell (a short master, the CLI on
PSXAVENC_PLATFORM=cpu) reads ``tracks_wrong`` 0, a planted fault and the
control read wrong, and the cell's readers read their definitions, None
where the program has no such span, and a number in a traced run."""

import json
import os
import types

import pytest
import torch
from conftest import run_cell

from benchlib import roofline, runner, spec

NEW = ("xa_msps.host", "resample_ms.track", "xa_sectors_ms.track",
       "k5_track_roofline", "device_idle_pct.track")
TINY_TRACK = {"driver": "cli_track", "track_seconds": 0.6,
              "check_share": 0.5, "warmup_tracks": 1, "trace_seconds": 0.2}


@pytest.fixture
def xa_tree(tiny_tree, monkeypatch):
    """The tiny tree with ``xa.tiny``: the ``xa.track`` cell at a 0.6 s
    master, in every list that names ``xa.track``."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    monkeypatch.setenv("PSXAVENC_NO_NATIVE_INGEST", "1")
    with open(os.path.join(tiny_tree, "benchmark", "traffic",
                           "tiny_track.json"), "w") as f:
        json.dump(TINY_TRACK, f)
    path = os.path.join(tiny_tree, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    s["workloads"].append(dict(name="xa.tiny", config="xa-37800-stereo",
                               traffic="tiny_track", chips=1,
                               why="a test cell"))
    for m in s["end_to_end"] + s["per_layer"]:
        if "xa.track" in m.get("workloads", []):
            m["workloads"].append("xa.tiny")
    with open(path, "w") as f:
        json.dump(s, f)
    return tiny_tree


def _cell(tree, name="xa.tiny"):
    return spec.Cell(spec.load_spec(tree), name, root=tree,
                     bench_dir=os.path.join(tree, "benchmark"))


def test_the_cell_lists_its_metrics():
    cell = spec.Cell(spec.load_spec(), "xa.track")
    assert cell.traffic["driver"] == "cli_track"
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    assert {m["name"] for m in cell.end_to_end} == {"memory_peak_mib",
                                                    "setup_s"}
    assert cell.config["reference"] == "benchref/xa.py"


def test_a_short_track_is_correct(xa_tree):
    r = run_cell(xa_tree, "xa.tiny")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["tracks_wrong"] == {"value": 0, "limit": 0}


def test_a_traced_short_track_reads_the_new_metrics(xa_tree):
    """On the CPU every new reader but K5's roofline (no kernel runs on a
    card) finds what it reads."""
    r = run_cell(xa_tree, "xa.tiny", seconds=0.3, trace=True)
    assert r["correct"]
    for name in NEW:
        if name == "k5_track_roofline":
            assert name not in r["metrics"]
        else:
            assert r["metrics"][name]["value"] >= 0, name
    assert r["metrics"]["xa_msps.host"]["value"] > 0


def test_a_sound_header_altered(xa_tree, monkeypatch):
    """An XA unit's header altered where the unit encoder produces it."""
    from psxavenc_tpu_torch.models import adpcm_stream
    real = adpcm_stream.encode_unit_streams

    def altered(*a, **kw):
        h, v, s1, s2 = real(*a, **kw)
        h = h.copy()
        h[1, 5] ^= 0x01
        return h, v, s1, s2

    monkeypatch.setattr(adpcm_stream, "encode_unit_streams", altered)
    assert not run_cell(xa_tree, "xa.tiny")["correct"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_reads_wrong(xa_tree, tmp_path, seed):
    """Segments from guessed states, never repaired: the track is wrong,
    while the program reads 0."""
    cell = _cell(xa_tree)
    driver = cell.driver().Driver(cell, seed, torch.device("cpu"),
                                  str(tmp_path), runner.Spans())
    driver.setup()
    driver.unit()
    assert driver.check() == [("tracks_wrong", 0, 0)]
    (name, value, limit), = driver.control()
    assert name == "tracks_wrong" and value >= 1 and limit == 0


def _reader(name):
    return spec.load_file(os.path.join(spec.BENCH_DIR, "metrics",
                                       name + ".py"))


SNAP = {"spans": {
    "ingest.resample": {"count": 2, "total_ns": 8_000_000_000,
                        "self_ns": 8_000_000_000},
    "xa.sectors": {"count": 2, "total_ns": 900_000_000,
                   "self_ns": 300_000_000}}, "counters": {}}


@pytest.mark.parametrize("name, want", [("resample_ms.track", 4000.0),
                                        ("xa_sectors_ms.track", 150.0)])
def test_span_readers(monkeypatch, name, want):
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    monkeypatch.setattr(mod, "snapshot", lambda: SNAP)
    assert _reader(name).read(None) == pytest.approx(want)
    monkeypatch.setattr(mod, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    assert _reader(name).read(None) is None

    def missing(module):
        raise ModuleNotFoundError(module)

    monkeypatch.setattr(spec, "program", missing)
    assert _reader(name).read(None) is None


def test_rate_roofline_and_idle_readers():
    trace = types.SimpleNamespace(busy_s=0.25, window_s=5.0,
                                  kernel_seconds=lambda *f: 0.5)
    ctx = types.SimpleNamespace(
        spans=types.SimpleNamespace(seconds=lambda n: [2.0, 2.0]),
        driver=types.SimpleNamespace(frames=7_938_000), trace=trace,
        work={"adpcm_": (0.0, roofline.INT32_OPS_PER_S * 0.05)})
    assert _reader("xa_msps.host").read(ctx) == pytest.approx(3.969)
    assert _reader("device_idle_pct.track").read(ctx) == pytest.approx(95.0)
    assert _reader("k5_track_roofline").read(ctx) == pytest.approx(10.0)
    ctx.trace = None
    assert _reader("k5_track_roofline").read(ctx) is None
    assert _reader("device_idle_pct.track").read(ctx) is None
