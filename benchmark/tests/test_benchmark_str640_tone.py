"""The ``str640.encoder`` and ``xa.tone`` cells' pieces on the CPU: the
``str-v2-640x480`` configuration against ``str-v2-320x240``'s, both cells
and their metrics resolved, the tone master (length, rate, amplitude,
phases from the seed), tiny runs of both drivers reading 0 wrong (a
planted fault and the control reading wrong), the serial check of
``benchref/xa_serial.py`` against ``benchref/xa.py``, and the seven new
readers: their definitions, and None without a trace or a counter."""

import json
import os
import types

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, run_cell

from benchlib import roofline, runner, spec
from benchlib.drivers import cli_tone
from benchref import xa as ref_xa
from benchref import xa_serial

STR640 = ("step_device_ms.str640", "k1_str640_roofline",
          "k1_evals_per_frame.str640", "k1_global_pct.str640",
          "device_idle_pct.str640")
TONE = ("k5_walked_pct.tone", "k5_tone_roofline")
TINY_TONE = {"driver": "cli_tone", "track_seconds": 0.6, "frequency": 440,
             "amplitude": 30000, "check_share": 0.5, "warmup_tracks": 1,
             "trace_seconds": 0.2}
TINY_STR640 = {"driver": "video_feed", "movie_seconds": 0.6,
               "scene_frames": 5, "batch_frames": 128, "check_frames": 3,
               "warmup_passes": 1, "trace_seconds": 0.2}
SPEC = spec.load_spec()
XA_CFG = spec.Cell(SPEC, "xa.track").config


def _config(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        return entry, json.load(f)


def test_the_640x480_configuration():
    """Every key of the 320x240 configuration, equal but the size, the
    name, the source and the prose; its own source; nothing reduced."""
    entry, cfg = _config("str-v2-640x480")
    _, base = _config("str-v2-320x240")
    assert entry["reduced"] == [] and cfg["name"] == "str-v2-640x480"
    assert entry["source"].endswith("args.c#L401-L422")
    assert [c["source"] for c in SPEC["configs"]].count(
        entry["source"]) == 1
    assert set(base) <= set(cfg)
    for k, v in base.items():
        if k not in ("name", "source", "width", "height", "defines"):
            assert cfg[k] == v, k
    assert (cfg["width"], cfg["height"]) == (640, 480)
    blocks = (640 // 16) * (480 // 16) * 6
    assert blocks == 7200 > 1830    # K1's shared-memory rows hold 1,830


@pytest.mark.parametrize("cell, config, traffic, metrics", [
    ("str640.encoder", "str-v2-640x480", "encoder", STR640),
    ("xa.tone", "xa-37800-stereo", "tone", TONE)])
def test_the_cells_list_their_metrics(cell, config, traffic, metrics):
    c = spec.Cell(SPEC, cell)
    assert (c.entry["config"], c.traffic_name, c.chips) == (config,
                                                            traffic, 1)
    assert [m["name"] for m in c.per_layer] == list(metrics)
    assert {m["name"] for m in c.end_to_end} == {"memory_peak_mib",
                                                 "setup_s"}
    for m in c.per_layer:
        assert m["workloads"] == [cell]
        assert callable(c.reader(m["name"]).read)
    assert c.driver().Driver


def test_the_tone_master():
    """180 s at 44,100 Hz, both channels a 440 Hz sine of amplitude
    30,000; the seed draws the phases, the same seed the same master."""
    mix = spec.Cell(SPEC, "xa.tone").traffic
    rate = XA_CFG["master_frequency"]
    n = int(round(mix["track_seconds"] * rate))
    assert (n, rate, mix["frequency"], mix["amplitude"]) == (
        7_938_000, 44100, 440, 30000)
    a = cli_tone.tone_master(2**31 + 5, 44100, rate, 440, 30000)
    assert a.shape == (44100, 2) and a.dtype == np.int16
    assert np.array_equal(a, cli_tone.tone_master(2**31 + 5, 44100, rate,
                                                  440, 30000))
    b = cli_tone.tone_master(6, 44100, rate, 440, 30000)
    assert not np.array_equal(a, b)
    for x in (a, b):
        assert 29_990 <= np.abs(x).max(axis=0).min() <= 30_000
        spec_ = np.abs(np.fft.rfft(x.astype(np.float64), axis=0))
        assert (spec_.argmax(axis=0) == 440).all()   # 1 Hz bins
        assert x[0, 0] != x[0, 1]           # phases drawn per channel


def _tiny_tree(tiny_tree, name, config, traffic, mix, real):
    with open(os.path.join(tiny_tree, "benchmark", "traffic",
                           traffic + ".json"), "w") as f:
        json.dump(mix, f)
    path = os.path.join(tiny_tree, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    s["workloads"].append(dict(name=name, config=config, traffic=traffic,
                               chips=1, why="a test cell"))
    for m in s["per_layer"]:
        if real in m.get("workloads", []):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(s, f)
    return tiny_tree


@pytest.fixture
def tone_tree(tiny_tree, monkeypatch):
    """The tiny tree with ``tone.tiny``: ``xa.tone`` at a 0.6 s master."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    monkeypatch.setenv("PSXAVENC_NO_NATIVE_INGEST", "1")
    return _tiny_tree(tiny_tree, "tone.tiny", "xa-37800-stereo",
                      "tiny_tone", TINY_TONE, "xa.tone")


@pytest.fixture
def str640_tree(tiny_tree, monkeypatch):
    """The tiny tree with ``str640.tiny``: 9 frames of ``str640.encoder``."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    return _tiny_tree(tiny_tree, "str640.tiny", "str-v2-640x480",
                      "tiny_str640", TINY_STR640, "str640.encoder")


def test_a_short_tone_is_correct(tone_tree):
    r = run_cell(tone_tree, "tone.tiny", seed=2**31 + 11)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["tracks_wrong"] == {"value": 0, "limit": 0}


def test_a_sound_nibble_altered(tone_tree, monkeypatch):
    """One XA unit's sample altered where the unit encoder produces it:
    the serial check finds no reference file, so every track is wrong."""
    from psxavenc_tpu_torch.models import adpcm_stream
    real = adpcm_stream.encode_unit_streams

    def altered(*a, **kw):
        h, v, s1, s2 = real(*a, **kw)
        v = v.copy()
        v[0, 30, 7] ^= 0x01
        return h, v, s1, s2

    monkeypatch.setattr(adpcm_stream, "encode_unit_streams", altered)
    r = run_cell(tone_tree, "tone.tiny")
    assert not r["correct"] and r["checks"]["tracks_wrong"]["value"] >= 1


@pytest.mark.parametrize("seed", [1, 2])
def test_the_tone_control_reads_wrong(tone_tree, tmp_path, seed):
    cell = spec.Cell(spec.load_spec(tone_tree), "tone.tiny", root=tone_tree,
                     bench_dir=os.path.join(tone_tree, "benchmark"))
    driver = cell.driver().Driver(cell, seed, torch.device("cpu"),
                                  str(tmp_path), runner.Spans())
    driver.setup()
    driver.unit()
    assert driver.check() == [("tracks_wrong", 0, 0)]
    assert driver.control() == [("tracks_wrong", 1, 0)]


def test_the_serial_check_is_the_segmented_reference():
    """On a 1 s tone, whose segments the reference's passes settle one at
    a time, the file the serial check writes from the reference's own file
    is that file, and the control's file fails the check."""
    master = cli_tone.tone_master(3, 44100, 44100, 440, 30000)
    want = ref_xa.xa_file(XA_CFG, master, "cpu")
    units = xa_serial.check_units(XA_CFG, master, want, "cpu")
    assert units is not None and units[2] <= 4       # the decode's passes
    assert xa_serial.xa_file_checked(XA_CFG, master, want, "cpu") == want
    ctl = ref_xa.xa_file(XA_CFG, master, "cpu", rounds=1)
    assert ctl != want
    assert xa_serial.xa_file_checked(XA_CFG, master, ctl, "cpu") is None
    assert xa_serial.check_units(XA_CFG, master, want[:-1], "cpu") is None


def test_a_short_640x480_movie_is_correct(str640_tree):
    r = run_cell(str640_tree, "str640.tiny", seed=2**31 + 3)
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] > 0 and r["attempted"] % 9 == 0   # whole passes
    assert r["checks"]["frames_wrong"] == {"value": 0, "limit": 0}


def _reader(name):
    return spec.load_file(os.path.join(BENCH, "metrics", name + ".py"))


def _snapshot(counters):
    return lambda: {"spans": {}, "counters": counters}


@pytest.mark.parametrize("name", STR640 + TONE)
def test_readers_without_a_trace_or_counter(monkeypatch, name):
    """None with no trace, no work and no counter (as on the parent, whose
    program counts none of them), and where the program has no spans
    module."""
    ctx = types.SimpleNamespace(trace=None, work=None, batches_traced=0)
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    monkeypatch.setattr(mod, "snapshot", _snapshot(
        {"h2d_pageable_bytes": 10}))
    assert _reader(name).read(ctx) is None

    def missing(module):
        raise ModuleNotFoundError(module)

    monkeypatch.setattr(spec, "program", missing)
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name, counters, want", [
    ("k1_evals_per_frame.str640",
     {"k1_frames": 256, "k1_evaluations": 640, "k1_global_frames": 256},
     2.5),
    ("k1_global_pct.str640",
     {"k1_frames": 256, "k1_evaluations": 640, "k1_global_frames": 192},
     75.0),
    ("k5_walked_pct.tone", {"k5_units": 400, "k5_walked_units": 398},
     99.5)])
def test_counter_readers(monkeypatch, name, counters, want):
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    monkeypatch.setattr(mod, "snapshot", _snapshot(counters))
    assert _reader(name).read(None) == pytest.approx(want)


def test_trace_readers():
    trace = types.SimpleNamespace(
        busy_s=1.0, window_s=4.0, kernels={"a": 0.002, "b": 0.006},
        kernel_seconds=lambda *f: 0.004)
    ctx = types.SimpleNamespace(
        trace=trace, batches_traced=4,
        work={"select_pix_kernel": (roofline.HBM_BYTES_PER_S * 0.001, 0.0),
              "adpcm_": (0.0, roofline.INT32_OPS_PER_S * 0.002)})
    assert _reader("step_device_ms.str640").read(ctx) == pytest.approx(2.0)
    assert _reader("device_idle_pct.str640").read(ctx) == pytest.approx(75.0)
    assert _reader("k1_str640_roofline").read(ctx) == pytest.approx(25.0)
    assert _reader("k5_tone_roofline").read(ctx) == pytest.approx(50.0)
    ctx.work = {"adpcm_": (1.0, 1.0)}
    assert _reader("k1_str640_roofline").read(ctx) is None
