"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files; a cell and a metric added as new files only are
found."""

import json
import os
import re

import pytest
from conftest import BENCH, ROOT, run_cell

from benchlib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
SPEC = spec.load_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_resolve():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert os.path.exists(os.path.join(BENCH, cfg["reference"]))
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_cells_resolve():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        cell = spec.Cell(SPEC, w["name"])
        assert cell.driver().Driver
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
    assert len(pairs) == len(SPEC["workloads"])


def test_metrics_are_well_formed():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert spec._applies(e2e[m["moves"]], w)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_a_cell_and_a_metric_added_as_files_are_found(tiny_tree):
    """A new traffic file, a new metric reader and new entries: the
    harness finds them by name and edits no file that was there."""
    before = {}
    for dirpath, _, files in os.walk(tiny_tree):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                before[p] = fh.read()
    with open(os.path.join(tiny_tree, "benchmark", "traffic",
                           "tiny_short.json"), "w") as f:
        json.dump(dict(json.load(open(os.path.join(
            tiny_tree, "benchmark", "traffic", "tiny_bank.json"))),
            clips=3), f)
    with open(os.path.join(tiny_tree, "benchmark", "metrics",
                           "lists_done.audio.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.driver.lists)\n")
    path = os.path.join(tiny_tree, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    s["workloads"].append(dict(name="vag.short", config="vag-44100-mono",
                               traffic="tiny_short", chips=1, why="t"))
    s["per_layer"].append(dict(name="lists_done.audio", unit="lists",
                               better="higher", source="program_counter",
                               layer="batch.py grouping",
                               moves="memory_peak_mib",
                               workloads=["vag.short"]))
    with open(path, "w") as f:
        json.dump(s, f)
    for p, data in before.items():
        if p != path:
            with open(p, "rb") as fh:
                assert fh.read() == data
    result = run_cell(tiny_tree, "vag.short", trace=True)
    assert result["metrics"]["lists_done.audio"]["value"] >= 1
    assert result["correct"]


@pytest.mark.parametrize("cell, rate", [("str.tiny", "video_fps.host"),
                                        ("vag.tiny", "audio_msps.host"),
                                        ("movie.tiny", "movie_fps.host")])
def test_host_rates_and_memory_of_a_traced_run(monkeypatch, tiny_tree, cell,
                                               rate):
    """A traced run reads its host-clock rate over the untraced units
    alone; the memory peak, 0 on the CPU, is left out of the line rather
    than read as 0."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    c = spec.Cell(spec.load_spec(tiny_tree), cell, root=tiny_tree,
                  bench_dir=os.path.join(tiny_tree, "benchmark"))
    assert rate in {m["name"] for m in c.per_layer}
    traced = run_cell(tiny_tree, cell, seconds=0.6, trace=True)
    assert traced["correct"] and traced["metrics"][rate]["value"] > 0
    plain = run_cell(tiny_tree, cell, seconds=0.3,
                     tmp=os.path.join(tiny_tree, "work2"))
    assert set(plain["metrics"]) == {"setup_s"}
    assert plain["device"]["memory_peak_bytes"] == 0
