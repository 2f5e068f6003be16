"""The window's units: the device's memory peak is reset once, after
set-up and before the first unit; each unit's wall and CPU seconds are
recorded; the result's summary of them reads its definition on hand-made
unit times."""

import contextlib
import os
import time
import types

import pytest
import torch

from benchlib import runner, spec


def _reader(name):
    return spec.load_file(os.path.join(spec.BENCH_DIR, "metrics",
                                       name + ".py"))


class FakeDriver:
    """Logs its calls into the log the card's calls go to."""

    def __init__(self, log):
        self.log = log
        self.attempted = self.failed = 0

    def setup(self):
        self.log.append("setup")

    def unit(self):
        self.log.append("unit")
        self.attempted += 1

    def census(self, ctx):
        pass

    def release(self):
        self.log.append("release")

    def check(self):
        return [("wrong", 0, 0)]


def _fake_cell(log):
    driver = FakeDriver(log)
    return types.SimpleNamespace(
        chips=1, traffic={"trace_seconds": 0.01},
        driver=lambda: types.SimpleNamespace(Driver=lambda *a: driver),
        end_to_end=[{"name": "memory_peak_mib", "unit": "MiB"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[], reader=_reader)


@pytest.mark.parametrize("traced", [False, True])
def test_peak_is_reset_once_after_setup(monkeypatch, tmp_path, traced):
    log = []
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "synchronize",
                        lambda d=None: log.append("sync"))
    monkeypatch.setattr(cuda, "reset_peak_memory_stats",
                        lambda d=None: log.append("reset"))
    monkeypatch.setattr(cuda, "max_memory_allocated",
                        lambda d=None: log.append("peak") or 3 * 2**20)
    monkeypatch.setattr(cuda, "get_device_name", lambda d=None: "card")
    from benchlib import trace
    monkeypatch.setattr(trace, "profiler", contextlib.nullcontext)
    monkeypatch.setattr(trace, "read", lambda prof, tmp: types.SimpleNamespace(
        busy_s=0.1, window_s=1.0, device_ops=[], idle_gaps=[]))
    card = types.SimpleNamespace(type="cuda")
    result = runner.run(_fake_cell(log), 1, 0.05, traced,
                        time.perf_counter(), card, str(tmp_path))
    assert log.count("reset") == 1
    assert log.index("setup") < log.index("reset") < log.index("unit")
    assert log.index("unit") < log.index("peak") < log.index("release")
    assert result["device"]["memory_peak_bytes"] == 3 * 2**20
    if not traced:
        assert result["metrics"]["memory_peak_mib"]["value"] == 3.0


def _spans(plain, traced=(), cpu=()):
    s = runner.Spans()
    for t in plain:
        s.record("unit", t)
    for t in cpu:
        s.record("unit_cpu", t)
    s.traced = True
    for t in traced:
        s.record("unit", t)
    s.traced = False
    return s


def test_a_unit_records_its_wall_and_cpu_seconds():
    """A unit that sleeps spends wall time and almost no CPU time; one
    that computes spends both."""

    class Sleeps:
        def unit(self):
            time.sleep(0.1)

    class Spins:
        def unit(self):
            t0 = time.thread_time()
            while time.thread_time() - t0 < 0.05:
                pass

    s = runner.Spans()
    runner.run_unit(Sleeps(), s)
    runner.run_unit(Spins(), s)
    (wall_sleep, wall_spin), (cpu_sleep, cpu_spin) = (
        s.seconds("unit"), s.seconds("unit_cpu"))
    assert wall_sleep >= 0.1 and cpu_sleep < 0.05
    assert cpu_spin >= 0.05 and wall_spin >= cpu_spin * 0.99


@pytest.mark.parametrize("wall, traced, want", [
    ([4.0, 1.0, 3.0, 2.0, 5.0], [], {
        "count": 5, "wall_min_s": 1.0, "wall_q1_s": 1.5,
        "wall_median_s": 3.0, "wall_mean_s": 3.0}),
    ([2.5], [], {"count": 1, "wall_min_s": 2.5, "wall_q1_s": 2.5,
                 "wall_median_s": 2.5, "wall_mean_s": 2.5}),
    # a traced run: the traced units are left out
    ([0.2, 0.4], [9.0, 9.0], {"count": 2, "wall_min_s": 0.2,
                              "wall_mean_s": 0.3}),
    ([], [], {"count": 0})])
def test_unit_summary(wall, traced, want):
    got = runner.unit_summary(_spans(wall, traced,
                                     cpu=[w / 2 for w in wall]))
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    if wall:
        assert got["cpu_mean_s"] == pytest.approx(got["wall_mean_s"] / 2)
        assert got["cpu_median_s"] == pytest.approx(
            got["wall_median_s"] / 2)
