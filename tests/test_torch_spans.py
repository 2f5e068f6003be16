"""The port's spans and counters (``utils/spans.py``), on the CPU.

Off (no profiler running): ``span()`` is one shared no-op, ``count()``
does nothing, and a ``-t vag`` job list through ``batch.run_jobs``, a
60 s ``-t str`` movie and a ``-t xa`` track from a 44,100 Hz master
through ``cli.main`` leave ``snapshot()`` empty. On: the same jobs put
every span they reach into the profiler's Chrome trace as a
``user_annotation`` inside its parent, the aggregates count one
``bs.launch`` and one ``bs.step`` inside it a batch, one ``batch.plan``
and ``batch.replay`` a file, ``ingest.open``'s steps inside it, and one
``ingest.resample`` and ``xa.sectors`` a track, the sector loops' timed
steps add up inside their span's self time, and the outputs are byte-equal to
the untraced ones. Spans open at batch, chunk and file granularity only,
and every literal passed to ``span(`` in the package is in ``NAMES``, to
``count(`` (or ``containers/xa.py``'s ``SECTOR_NS``) in ``COUNTERS``."""

import ast
import importlib.util
import json
import math
import pathlib
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from psxavenc_tpu_torch import batch, cli
from psxavenc_tpu_torch.containers import xa
from psxavenc_tpu_torch.models import bs_video
from psxavenc_tpu_torch.utils import spans, synth

PKG = pathlib.Path(spans.__file__).resolve().parent.parent
EMPTY = {"spans": {}, "counters": {}}

# The innermost program span around each span, in the two jobs.
OPEN_STEPS = ("native", "probe", "demux", "resample", "nv21", "stack",
              "finish")
MOVIE_PARENTS = {
    "ingest.open": None,
    **{f"ingest.{k}": "ingest.open" for k in OPEN_STEPS},
    "str.schedule": None, "bs.open": None, "str.sectors": None,
    **{f"bs.{k}": "str.sectors"
       for k in ("stack", "stage", "launch", "wait", "collect")},
    **{f"bs.{k}": "bs.launch" for k in ("upload", "step", "read_back")},
    "xa.encode": "str.sectors", "xa.assemble": "str.sectors",
    **{f"adpcm.{k}": "xa.encode" for k in ("upload", "kernel", "read_back")},
}
LIST_PARENTS = {
    "batch.parse": None, "batch.plan": None, "ingest.open": "batch.plan",
    **{f"ingest.{k}": "ingest.open" for k in OPEN_STEPS},
    "batch.encode": None,
    "batch.replay": None,
    **{f"adpcm.{k}": "batch.encode"
       for k in ("upload", "kernel", "read_back")},
}
TRACK_PARENTS = {
    "ingest.open": None,
    **{f"ingest.{k}": "ingest.open" for k in OPEN_STEPS},
    "xa.sectors": None,
    "xa.encode": "xa.sectors", "xa.assemble": "xa.sectors",
    **{f"adpcm.{k}": "xa.encode" for k in ("upload", "kernel", "read_back")},
}
CLIPS = 6


@pytest.fixture(autouse=True)
def _clean():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def cpu(monkeypatch):
    """The CLI on the CPU, and the ingest's Python readers (as on the
    card's host, which has no FFmpeg libraries)."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    monkeypatch.setenv("PSXAVENC_NO_NATIVE_INGEST", "1")
    monkeypatch.delenv("PSXAVENC_PROFILE", raising=False)


@pytest.fixture(scope="module")
def movie(tmp_path_factory):
    """A 60 s AVI at 15 fps with 37,800 Hz stereo sound, at 48x32."""
    d = tmp_path_factory.mktemp("movie")
    n = 900
    return synth.write_avi_sized(
        d / "movie.avi", 48, 32, synth.rand_frames(48, 32, n, seed=3), 15,
        audio=synth.rand_pcm(n * 37800 // 15, channels=2, seed=4),
        audio_rate=37800)


def _str_argv(src, out):
    return ["-q", "-t", "str", "-x", "2", "-v", "v2", "-f", "37800", "-c",
            "2", "-s", "48x32", str(src), str(out)]


def _list(tmp_path, sub):
    (tmp_path / sub).mkdir()
    jobs = []
    for k in range(CLIPS):
        src = tmp_path / f"clip{k}.wav"
        if not src.exists():
            synth.write_wav(src, synth.rand_pcm(800 + 900 * k, seed=k),
                            44100)
        jobs.append(["-q", "-t", "vag", "-f", "44100", str(src),
                     str(tmp_path / sub / f"clip{k}.vag")])
    return jobs


def _outputs(jobs):
    return [pathlib.Path(j[-1]).read_bytes() for j in jobs]


def _annotations(path):
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") in spans.NAMES]


def _parent(e, events):
    """The innermost program span around ``e`` on its thread, or None."""
    a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
    around = [p for p in events if p is not e and p["tid"] == e["tid"]
              and float(p["ts"]) <= a and b <= float(p["ts"]) + p["dur"]]
    return min(around, key=lambda p: p["dur"])["name"] if around else None


def _check_trace(events, parents, snap):
    """Every span of the aggregates is in the trace, as often, and each
    trace span sits inside the parent the jobs' code gives it."""
    names = [e["name"] for e in events]
    assert {n: names.count(n) for n in set(names)} == \
        {n: s["count"] for n, s in snap["spans"].items()}
    for e in events:
        assert _parent(e, events) == parents[e["name"]], e


def _check_times(snap):
    for name, s in snap["spans"].items():
        assert 0 <= s["self_ns"] <= s["total_ns"], name


SECTOR_TIMERS = ("sector_video_ns", "sector_audio_ns", "sector_checksum_ns",
                 "sector_write_ns", "sector_progress_ns")


def _check_sector_timers(snap, loop, n_sectors, kinds):
    """The sector loop's timed steps: each of ``kinds`` counted,
    ``sectors`` the file's sectors, and all of them inside ``loop``'s self
    time (the sums open no span, so they take nothing off it)."""
    c = snap["counters"]
    assert c["sectors"] == n_sectors
    timed = [c[f"sector_{k}_ns"] for k in kinds]
    assert all(t > 0 for t in timed), c
    assert set(c) & set(SECTOR_TIMERS) == {f"sector_{k}_ns" for k in kinds}
    assert sum(timed) <= snap["spans"][loop]["self_ns"]


def test_off_is_the_shared_noop():
    assert not spans.enabled()
    a = spans.span("bs.launch", 7)
    assert a is spans.span("str.sectors") is spans._OFF
    with a:
        spans.count("h2d_pageable_bytes", 100)
    spans.count_h2d(torch.zeros(4), "cuda")
    assert spans.snapshot() == EMPTY


def test_a_span_charges_its_record_function_to_itself(monkeypatch):
    """A span's record function, entered and left, lies inside its own
    clock readings: a child's instrumentation adds to the child's total
    and nothing to the self time of the span around it. The clock here
    ticks 1 ns a reading and 1,000 ns a record function's enter or exit."""
    clock = [0]

    def now():
        clock[0] += 1
        return clock[0]

    class Record:
        def __init__(self, name, args=None):
            pass

        def __enter__(self):
            clock[0] += 1000

        def __exit__(self, *exc):
            clock[0] += 1000

    monkeypatch.setattr(spans.time, "perf_counter_ns", now)
    monkeypatch.setattr(spans.torch.profiler, "record_function", Record)
    monkeypatch.setattr(spans, "enabled", lambda: True)
    with spans.span("batch.encode"):
        with spans.span("adpcm.kernel"):
            pass
    s = spans.snapshot()["spans"]
    assert s["adpcm.kernel"]["total_ns"] >= 2000
    outer = s["batch.encode"]
    assert 2000 <= outer["self_ns"] < 2010
    assert outer["total_ns"] == outer["self_ns"] + \
        s["adpcm.kernel"]["total_ns"]


def test_sector_sums_off_are_none():
    """Off, a sector loop gets no sums, so it reads no clock, and its
    flush counts nothing."""
    assert xa.sector_sums() is None
    xa.count_sector_sums(None, 5)
    assert spans.snapshot() == EMPTY


def test_sector_sums_add_to_the_counters_once_a_loop():
    """On, a loop's sums start at 0 for every step, and the flush adds the
    steps that ran and the sectors written to the counters, opening no
    span."""
    with profile(activities=[ProfilerActivity.CPU]):
        ns = xa.sector_sums()
        assert ns == dict.fromkeys(xa.SECTOR_NS, 0)
        ns["sector_write_ns"] += 500
        ns["sector_audio_ns"] += 70
        xa.count_sector_sums(ns, 3)
        xa.count_sector_sums(ns, 2)
    assert spans.snapshot() == {"spans": {}, "counters": {
        "sector_write_ns": 1000, "sector_audio_ns": 140, "sectors": 5}}


def test_on_follows_the_profiler():
    """The switch is torch's own: on inside ``with profile`` and between
    ``start()`` and ``stop()`` (as PSXAVENC_PROFILE runs it), also on a
    thread started inside the profile."""
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.enabled()
        t = threading.Thread(target=lambda: seen.append(spans.enabled()))
        t.start()
        t.join()
    assert seen == [True] and not spans.enabled()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    assert spans.enabled()
    prof.stop()
    assert not spans.enabled()


def test_aggregates_self_time_and_counters(tmp_path):
    """Self time is the total less the child spans on the same thread; a
    thread keeps its own stack; counters add while on."""
    def nested():
        with spans.span("batch.encode"):
            with spans.span("adpcm.kernel", 1):
                torch.ones(64).sum()
            with spans.span("adpcm.read_back", 1):
                pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nested()
        t = threading.Thread(target=nested)
        t.start()
        t.join()
        spans.count("d2h_pageable_bytes", 12)
        spans.count_h2d(torch.zeros(5, dtype=torch.int32), "cuda")
        spans.count_h2d(torch.zeros(5), "cpu")
        spans.count_d2h(types.SimpleNamespace(
            device=torch.device("cuda", 0), nbytes=30))
    snap = spans.snapshot()
    s = snap["spans"]
    assert {n: v["count"] for n, v in s.items()} == {
        "batch.encode": 2, "adpcm.kernel": 2, "adpcm.read_back": 2}
    enc = s["batch.encode"]
    assert enc["self_ns"] == enc["total_ns"] - s["adpcm.kernel"][
        "total_ns"] - s["adpcm.read_back"]["total_ns"]
    _check_times(snap)
    assert snap["counters"] == {"d2h_pageable_bytes": 42,
                                "h2d_pageable_bytes": 20}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _annotations(path)
    assert {e["name"] for e in events} == set(s)
    for e in events:
        assert _parent(e, events) == (None if e["name"] == "batch.encode"
                                      else "batch.encode")
    spans.reset()
    assert spans.snapshot() == EMPTY


def test_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span and
    every count of every thread reaches the aggregates."""
    threads, each = 16, 300

    def work():
        for k in range(each):
            with spans.span("batch.replay", k):
                with spans.span("adpcm.read_back"):
                    spans.count("d2h_pageable_bytes", 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    snap = spans.snapshot()
    assert snap["spans"]["batch.replay"]["count"] == threads * each
    assert snap["spans"]["adpcm.read_back"]["count"] == threads * each
    assert snap["counters"] == {"d2h_pageable_bytes": 3 * threads * each}
    _check_times(snap)


def test_job_list_off_and_on(tmp_path, cpu):
    """A grouped ``-t vag`` list: nothing recorded untraced; traced, one
    ``batch.plan`` and one ``batch.replay`` a file, ``ingest.open``'s
    steps (``ingest.native``, ``ingest.probe`` where the WAV has no loop
    chunk, ``ingest.finish``) once a file, each span in the trace inside
    its parent, at most 8 spans a file and 6 a list; the same bytes."""
    plain = _list(tmp_path, "plain")
    assert batch.run_jobs(plain, quiet=True, device="cpu") == [0] * CLIPS
    assert spans.snapshot() == EMPTY
    traced = _list(tmp_path, "traced")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert batch.run_jobs(traced, quiet=True, device="cpu") == \
            [0] * CLIPS
    assert _outputs(traced) == _outputs(plain)
    snap = spans.snapshot()
    counts = {n: s["count"] for n, s in snap["spans"].items()}
    assert counts["batch.plan"] == counts["batch.replay"] == CLIPS
    assert counts["ingest.open"] == counts["ingest.demux"] == CLIPS
    assert counts["ingest.resample"] == CLIPS
    for k in ("native", "probe", "finish"):
        assert counts[f"ingest.{k}"] == CLIPS, k
    assert counts["batch.encode"] == counts["batch.parse"] == 1
    assert sum(counts.values()) <= 8 * CLIPS + 6
    _check_times(snap)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    _check_trace(_annotations(path), LIST_PARENTS, snap)


def test_movie_off_and_on(tmp_path, cpu, monkeypatch, movie):
    """A 60 s ``-t str -x 2`` movie through the CLI: nothing recorded
    untraced; under PSXAVENC_PROFILE one ``bs.launch`` and one ``bs.step``
    inside it a frame batch, every span in the trace inside its parent, at
    most 200 spans; the sector steps' sums, ``sectors`` the file's 2,336-byte
    sectors; the same bytes."""
    assert cli.main(_str_argv(movie, tmp_path / "plain.str")) == 0
    assert spans.snapshot() == EMPTY
    launches = []
    enqueue = bs_video.BsFrameEncoder.encode_frames_async

    def counted(self, *a, **kw):
        launches.append(1)
        return enqueue(self, *a, **kw)

    monkeypatch.setattr(bs_video.BsFrameEncoder, "encode_frames_async",
                        counted)
    monkeypatch.setenv("PSXAVENC_PROFILE", str(tmp_path / "prof"))
    assert cli.main(_str_argv(movie, tmp_path / "traced.str")) == 0
    assert (tmp_path / "traced.str").read_bytes() == \
        (tmp_path / "plain.str").read_bytes()
    snap = spans.snapshot()
    counts = {n: s["count"] for n, s in snap["spans"].items()}
    assert len(launches) >= math.ceil(900 / 128)
    for k in ("stack", "launch", "step", "collect"):
        assert counts[f"bs.{k}"] == len(launches)
    for k in ("ingest.open", "ingest.native", "ingest.demux",
              "ingest.resample", "ingest.nv21", "ingest.stack",
              "ingest.finish", "str.schedule", "str.sectors", "bs.open"):
        assert counts[k] == 1, k
    size = (tmp_path / "traced.str").stat().st_size
    assert size % 2336 == 0
    _check_sector_timers(snap, "str.sectors", size // 2336,
                         ("video", "audio", "checksum", "write", "progress"))
    assert counts["xa.encode"] == counts["xa.assemble"] > 1
    assert sum(counts.values()) <= 200
    _check_times(snap)
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    _check_trace(_annotations(trace), MOVIE_PARENTS, snap)


def test_xa_track_off_and_on(tmp_path, cpu, monkeypatch):
    """A ``-t xa`` track at its defaults from a 44,100 Hz stereo master
    (30 s: 563 sectors, one chunk): nothing recorded untraced; under
    PSXAVENC_PROFILE one ``ingest.resample`` and one ``xa.sectors``, the
    chunk's spans inside ``xa.sectors``, every span in the trace inside
    its parent; the sector steps' sums, ``sectors`` 563; the same bytes."""
    src = tmp_path / "track.wav"
    synth.write_wav(src, synth.rand_pcm(30 * 44100, channels=2, seed=9),
                    44100, channels=2)
    assert cli.main(["-q", "-t", "xa", str(src),
                     str(tmp_path / "plain.xa")]) == 0
    assert spans.snapshot() == EMPTY
    monkeypatch.setenv("PSXAVENC_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["-q", "-t", "xa", str(src),
                     str(tmp_path / "traced.xa")]) == 0
    assert (tmp_path / "traced.xa").read_bytes() == \
        (tmp_path / "plain.xa").read_bytes()
    snap = spans.snapshot()
    counts = {n: s["count"] for n, s in snap["spans"].items()}
    assert set(counts) <= set(TRACK_PARENTS)
    for k in ("ingest.open", "ingest.native", "ingest.probe",
              "ingest.demux", "ingest.resample", "ingest.finish",
              "xa.sectors", "xa.encode", "xa.assemble"):
        assert counts[k] == 1, k
    sectors = snap["spans"]["xa.sectors"]
    assert sectors["self_ns"] < sectors["total_ns"]
    assert (tmp_path / "traced.xa").stat().st_size == 563 * 2336
    _check_sector_timers(snap, "xa.sectors", 563,
                         ("audio", "checksum", "write", "progress"))
    _check_times(snap)
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    _check_trace(_annotations(trace), TRACK_PARENTS, snap)


def test_encoder_feed_spans_a_batch(cpu):
    """The encoder fed as the ``str.encoder`` cell feeds it (batches of
    128 one ahead of fetch): ``bs.open`` once, ``bs.step`` once a batch,
    at most 6 spans a batch; untraced, no span, no counter and no timing
    event in the handle (on the CPU there is none traced either)."""
    frames = np.zeros((300, 48 * 32 * 3 // 2), np.uint8)
    frames[:] = np.arange(frames.shape[1]) % 251
    budgets = [2016 * 2] * len(frames)
    enc = bs_video.BsFrameEncoder(0, 48, 32, "cpu")
    plain = enc.encode_frames_async(list(frames[:128]), budgets[:128])
    assert plain[4] is None
    want = enc.fetch(plain)
    enc.close()
    assert spans.snapshot() == EMPTY
    with profile(activities=[ProfilerActivity.CPU]):
        enc = bs_video.BsFrameEncoder(0, 48, 32, "cpu")
        pending = enc.encode_frames_async(list(frames[:128]), budgets[:128])
        assert pending[4] is None
        nxt = enc.encode_frames_async(list(frames[128:256]),
                                      budgets[128:256])
        got = enc.fetch(pending)
        last = enc.encode_frames_async(list(frames[256:]), budgets[256:])
        enc.fetch(nxt)
        enc.fetch(last)
        enc.close()
    counts = {n: s["count"] for n, s in spans.snapshot()["spans"].items()}
    assert counts.pop("bs.open") == 1
    assert counts["bs.launch"] == counts["bs.step"] == \
        counts["bs.collect"] == 3
    assert sum(counts.values()) <= 6 * 3
    assert [b.tobytes() for b, _ in got] == [b.tobytes() for b, _ in want]


def _calls(name):
    """(file, first argument) of every call ``spans.<name>(...)`` in the
    package, and of ``<name>(...)`` in ``utils/spans.py``."""
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        tree = ast.parse(path.read_text(), filename=rel)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == name
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "spans") or (
                    rel == "utils/spans.py" and isinstance(f, ast.Name)
                    and f.id == name):
                arg = node.args[0]
                yield rel, arg.value if isinstance(arg, ast.Constant) \
                    else ast.dump(arg)


def test_every_span_literal_is_catalogued():
    """Every span the package opens is a literal of ``NAMES``, and every
    name there is opened somewhere; the same for the counters, counted by
    a literal or, in the sector loops' flush, from ``xa.SECTOR_NS``."""
    opened = set(_calls("span"))
    assert {a for _, a in opened} == spans.NAMES, opened
    counted = {a for _, a in _calls("count")}
    flushed = {a for rel, a in _calls("count")
               if rel == "containers/xa.py" and a.startswith("Name(")}
    assert len(flushed) == 1, counted
    assert (counted - flushed) | set(xa.SECTOR_NS) == spans.COUNTERS, counted


@pytest.mark.parametrize("name", ["k1_frames", "k1_global_frames",
                                  "k1_evaluations", "k5_units",
                                  "k5_walked_units"])
def test_the_kernel_stats_counters_are_listed(name):
    """The counters read from K1's and K5's statistics are in
    ``COUNTERS``, and the package counts each by that literal."""
    assert name in spans.COUNTERS
    assert name in {a for _, a in _calls("count")}


def test_the_cost_tool_measures_each_call():
    """``tools/torch_span_cost.py`` times a span off and on, a count off,
    a sector loop's timed step and an ungated record function, and leaves
    no aggregates behind."""
    spec = importlib.util.spec_from_file_location(
        "torch_span_cost", PKG.parent / "tools" / "torch_span_cost.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    r = tool.measure(n=2000, n_on=200, reps=1)
    for k in ("span_off_ns", "count_off_ns", "span_on_ns", "step_sum_ns",
              "record_function_off_ns", "with_noop_ns"):
        assert r[k] > 0, k
    assert spans.snapshot() == EMPTY


@pytest.mark.parametrize("doc", ["README.md", "psxavenc_tpu_torch/cli.py"])
def test_the_profile_docs_name_every_span(doc):
    """README's and the CLI's PSXAVENC_PROFILE paragraphs list the spans
    the trace carries."""
    text = (PKG.parent / doc).read_text()
    para = text[text.index("PSXAVENC_PROFILE=DIR"):]
    para = para[:para.index("graph replays")]
    for name in spans.NAMES:
        assert f"`{name}`" in para, (doc, name)
