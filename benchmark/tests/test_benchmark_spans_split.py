"""The readers of the program's split host stages: ``bs.launch``'s
children and the video batch's device times, ``ingest.open``'s steps and
the sector loops' timed steps and sectors
(``psxavenc_tpu_torch.utils.spans``). Each returns the number its
docstring defines on a made-up context, None where there is nothing to
read or the program has no such module, and a number in a traced run of
the tiny cells on the CPU where the CPU records it."""

import os
import types

import pytest

from benchlib import spec

from conftest import run_cell

READERS = ("upload_ms.video", "step_launch_ms.video", "read_back_ms.video",
           "step_span_ms.video", "step_busy_pct.video",
           "upload_device_ms.video", "read_back_device_ms.video",
           "open_self_pct.audio", "probe_ms.audio",
           "sector_checksum_ms.movie", "sector_timed_pct.movie",
           "sector_timed_pct.track", "sector_us.movie", "sector_us.track")

SNAP = {"spans": {
    "bs.launch": {"count": 4, "total_ns": 12_000_000, "self_ns": 800_000},
    "bs.upload": {"count": 4, "total_ns": 2_000_000, "self_ns": 2_000_000},
    "bs.step": {"count": 4, "total_ns": 8_000_000, "self_ns": 8_000_000},
    "bs.read_back": {"count": 4, "total_ns": 1_200_000,
                     "self_ns": 1_200_000},
    "ingest.open": {"count": 10, "total_ns": 400_000_000,
                    "self_ns": 20_000_000},
    "ingest.probe": {"count": 5, "total_ns": 30_000_000,
                     "self_ns": 30_000_000},
    "str.sectors": {"count": 2, "total_ns": 900_000_000,
                    "self_ns": 500_000_000},
    "xa.sectors": {"count": 1, "total_ns": 600_000_000,
                   "self_ns": 500_000_000}},
    "counters": {"bs_step_device_ns": 2_000_000,
                 "bs_upload_device_ns": 600_000,
                 "bs_read_back_device_ns": 400_000,
                 "sectors": 10_000,
                 "sector_video_ns": 150_000_000,
                 "sector_audio_ns": 50_000_000,
                 "sector_checksum_ns": 100_000_000,
                 "sector_write_ns": 60_000_000,
                 "sector_progress_ns": 40_000_000}}

KERNEL_S = 0.0015

WANT = {"upload_ms.video": 0.5, "step_launch_ms.video": 2.0,
        "read_back_ms.video": 0.3, "step_span_ms.video": 0.5,
        "step_busy_pct.video": 75.0, "open_self_pct.audio": 5.0,
        "probe_ms.audio": 3.0, "sector_checksum_ms.movie": 50.0,
        "sector_timed_pct.movie": 80.0, "sector_timed_pct.track": 50.0,
        "upload_device_ms.video": 0.15, "read_back_device_ms.video": 0.1,
        "sector_us.movie": 50.0, "sector_us.track": 50.0}


def _reader(name):
    return spec.load_file(os.path.join(spec.BENCH_DIR, "metrics",
                                       name + ".py"))


def _ctx(kernel_s=0.0):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(idle_gaps=[],
                                    kernels={"k1": kernel_s / 3,
                                             "k3": 2 * kernel_s / 3}),
        traced_units=2)


@pytest.fixture
def program_spans():
    mod = spec.program("psxavenc_tpu_torch.utils.spans")
    mod.reset()
    yield mod
    mod.reset()


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_definition(monkeypatch, program_spans, name):
    monkeypatch.setattr(program_spans, "snapshot", lambda: SNAP)
    assert _reader(name).read(_ctx(KERNEL_S)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_spans(monkeypatch, program_spans, name):
    """Nothing recorded, or no such module (a program before the split):
    None, and no exception."""
    assert program_spans.snapshot() == {"spans": {}, "counters": {}}
    assert _reader(name).read(_ctx(KERNEL_S)) is None

    def missing(module):
        raise ModuleNotFoundError(module)

    monkeypatch.setattr(spec, "program", missing)
    assert _reader(name).read(_ctx(KERNEL_S)) is None


def test_the_step_share_reads_none_without_a_trace_or_kernels(
        monkeypatch, program_spans):
    monkeypatch.setattr(program_spans, "snapshot", lambda: SNAP)
    reader = _reader("step_busy_pct.video")
    assert reader.read(_ctx(0.0)) is None
    assert reader.read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("cell, names, absent", [
    ("str.tiny", ("step_launch_ms.video",),
     ("upload_ms.video", "read_back_ms.video", "step_span_ms.video",
      "step_busy_pct.video", "upload_device_ms.video",
      "read_back_device_ms.video")),
    ("vag.tiny", ("open_self_pct.audio", "probe_ms.audio"), ()),
    ("movie.tiny", ("sector_checksum_ms.movie", "sector_timed_pct.movie",
                    "sector_us.movie"), ())])
def test_a_traced_tiny_run_reads_them(monkeypatch, tiny_tree,
                                      program_spans, cell, names, absent):
    """On the CPU, with the ingest's Python readers as on the card's host
    (no FFmpeg libraries), each reader finds its spans and counters in a
    traced run's window, but those of the card's uploads, read-backs and
    timing events, which the CPU does not make."""
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    monkeypatch.setenv("PSXAVENC_NO_NATIVE_INGEST", "1")
    result = run_cell(tiny_tree, cell, seconds=0.2, trace=True)
    assert result["correct"]
    for name in names:
        assert result["metrics"][name]["value"] >= 0, name
    for name in absent:
        assert name not in result["metrics"], name
    if cell == "movie.tiny":
        assert 0 < result["metrics"]["sector_timed_pct.movie"]["value"] \
            <= 100
