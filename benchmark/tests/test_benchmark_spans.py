"""The readers of the program's spans and counters
(``psxavenc_tpu_torch.utils.spans``): each returns the number its
docstring defines on a made-up context, None where there is nothing to
read or the program has no such module, and a number in a traced run of
the tiny cells on the CPU."""

import os
import types

import pytest

from benchlib import spec

from conftest import run_cell

READERS = ("idle_named_pct", "prep_ms.video", "launch_ms.video",
           "collect_ms.video", "plan_ms.audio", "encode_ms.audio",
           "replay_ms.audio", "pageable_copy_mib.audio", "ingest_ms.movie",
           "sectors_ms.movie")

SNAP = {"spans": {
    "bs.stack": {"count": 4, "total_ns": 9_000_000, "self_ns": 8_000_000},
    "bs.stage": {"count": 4, "total_ns": 4_000_000, "self_ns": 4_000_000},
    "bs.launch": {"count": 4, "total_ns": 12_000_000, "self_ns": 10_000_000},
    "bs.collect": {"count": 4, "total_ns": 6_000_000, "self_ns": 6_000_000},
    "batch.plan": {"count": 10, "total_ns": 30_000_000,
                   "self_ns": 20_000_000},
    "batch.encode": {"count": 2, "total_ns": 50_000_000,
                     "self_ns": 10_000_000},
    "batch.replay": {"count": 10, "total_ns": 20_000_000,
                     "self_ns": 20_000_000},
    "ingest.open": {"count": 2, "total_ns": 400_000_000,
                    "self_ns": 100_000_000},
    "str.sectors": {"count": 2, "total_ns": 900_000_000,
                    "self_ns": 500_000_000}},
    "counters": {"h2d_pageable_bytes": 3 * 2**20,
                 "d2h_pageable_bytes": 2**20}}

WANT = {"prep_ms.video": 3.0, "launch_ms.video": 2.5,
        "collect_ms.video": 1.5, "plan_ms.audio": 3.0,
        "encode_ms.audio": 25.0, "replay_ms.audio": 2.0,
        "pageable_copy_mib.audio": 2.0, "ingest_ms.movie": 200.0,
        "sectors_ms.movie": 250.0, "idle_named_pct": 75.0}


def _reader(name):
    return spec.load_file(os.path.join(spec.BENCH_DIR, "metrics",
                                       name + ".py"))


def _ctx(gaps=(), units=2):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(idle_gaps=list(gaps)),
        traced_units=units)


@pytest.fixture
def program_spans(monkeypatch):
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    mod.reset()
    yield mod
    mod.reset()


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_definition(monkeypatch, program_spans, name):
    monkeypatch.setattr(program_spans, "snapshot", lambda: SNAP)
    ctx = _ctx([("bs.launch", 0.5), ("batch.plan", 0.25),
                ("enqueue", 0.2), ("no_span", 0.05)])
    assert _reader(name).read(ctx) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_spans(monkeypatch, program_spans, name):
    """Nothing recorded, no idle time, or no such module (a program
    before the spans): None, and no exception."""
    assert program_spans.snapshot() == {"spans": {}, "counters": {}}
    assert _reader(name).read(_ctx()) is None

    def missing(module):
        raise ModuleNotFoundError(module)

    monkeypatch.setattr(spec, "program", missing)
    assert _reader(name).read(_ctx([("bs.launch", 1.0)])) is None


@pytest.mark.parametrize("cell, names", [
    ("str.tiny", ("idle_named_pct", "prep_ms.video", "launch_ms.video",
                  "collect_ms.video")),
    ("vag.tiny", ("idle_named_pct", "plan_ms.audio", "encode_ms.audio",
                  "replay_ms.audio")),
    ("movie.tiny", ("idle_named_pct", "ingest_ms.movie",
                    "sectors_ms.movie"))])
def test_a_traced_tiny_run_reads_them(monkeypatch, tiny_tree,
                                      program_spans, cell, names):
    """On the CPU every reader but the pageable copies (the CPU copies
    nothing to a card) finds its spans in a traced run's window."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    result = run_cell(tiny_tree, cell, seconds=0.2, trace=True)
    assert result["correct"]
    for name in names:
        assert result["metrics"][name]["value"] >= 0, name
    assert "pageable_copy_mib.audio" not in result["metrics"]
