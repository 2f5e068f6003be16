"""Host cost of the port's spans and counters (``utils/spans.py``).

Nanoseconds a call, each the median of ``--reps`` loops of ``--n`` calls
(``--n-on`` under the profiler, whose trace keeps every event):

- ``span_off_ns``: ``with spans.span(name, key)`` with no profiler running;
- ``count_off_ns``: ``spans.count(name, n)`` with no profiler running;
- ``span_on_ns``: the same span under ``torch.profiler`` (CPU activity,
  and the card's where there is one), record function and aggregates;
- ``step_sum_ns``: a sector loop's timed step while a profile runs, a
  clock reading before the step and one after it, added to the loop's
  dict of sums (``containers/xa.py::sector_sums``); off, the step costs
  one ``is not None`` check;
- ``record_function_off_ns``: an ungated ``torch.profiler.record_function``
  with no profiler running, what a span would cost without the switch;
- ``with_noop_ns``: a with-statement on a shared no-op, the floor.

    python tools/torch_span_cost.py [--n 200000] [--n-on 20000] [--reps 5]

Prints the host's cores, Python and torch, then one JSON line. Runs on
any host; on the card's machine the CUDA activity is traced too."""

import argparse
import json
import os
import platform
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from psxavenc_tpu_torch.utils import spans  # noqa: E402


class _Noop:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _per_call(fn, n, reps):
    """Median ns a call of ``fn`` over ``reps`` loops of ``n`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn(n)
        times.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(times)


def _spans(n):
    for k in range(n):
        with spans.span("bs.launch", k):
            pass


def _step_sums(n):
    ns = {"sector_write_ns": 0}
    clock = time.perf_counter_ns
    for _ in range(n):
        t0 = clock()
        ns["sector_write_ns"] += clock() - t0


def _counts(n):
    for _ in range(n):
        spans.count("h2d_pageable_bytes", 4096)


def _record_functions(n):
    for k in range(n):
        with torch.profiler.record_function("bs.launch", str(k)):
            pass


def _noops(n, noop=_Noop()):
    for _ in range(n):
        with noop:
            pass


def measure(n=200_000, n_on=20_000, reps=5):
    """-> dict of the costs (ns a call) and the host's description."""
    out = {"span_off_ns": _per_call(_spans, n, reps),
           "count_off_ns": _per_call(_counts, n, reps),
           "step_sum_ns": _per_call(_step_sums, n, reps),
           "record_function_off_ns": _per_call(_record_functions, n, reps),
           "with_noop_ns": _per_call(_noops, n, reps)}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    on = []
    for _ in range(reps):
        with profile(activities=activities):
            on.append(_per_call(_spans, n_on, 1))
    spans.reset()
    out["span_on_ns"] = statistics.median(on)
    out.update(n=n, n_on=n_on, reps=reps, torch=torch.__version__,
               python=platform.python_version(),
               cpu=f"{platform.machine()}, {os.cpu_count()} cores")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--n-on", type=int, default=20_000)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    r = measure(a.n, a.n_on, a.reps)
    print(f"host {r['cpu']}, Python {r['python']}, torch {r['torch']}")
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
