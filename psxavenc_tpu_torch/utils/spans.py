"""Spans and counters of the port's host stages, on only while a
``torch.profiler`` profile runs.

``span(name, key=None)`` names a stage of work (``with span("bs.launch",
seq): ...``). With no profile running it returns one shared no-op after a
single check: no clock reading, no dict, lock or tensor. While a profile
runs (``PSXAVENC_PROFILE``, or the benchmark's traced window), the span
enters ``torch.profiler.record_function(name, str(key))``, so it lands in
the profiler's Chrome trace as a ``user_annotation`` on the clock of the
card's kernels and copies, and it adds to in-memory aggregates per name:
the count, the total nanoseconds and the self nanoseconds (the total less
what its child spans on the same thread cover; each thread keeps its own
stack). ``key`` names the request, a batch's sequence number or a job's
index; it goes to the record function's argument string, which torch's
Chrome export leaves out (torch 2.13), so in the trace a stage's spans
pair up by their order on their thread.

``count(name, n)`` adds ``n`` to a counter, also only while a profile
runs; ``count_h2d`` and ``count_d2h`` add a tensor's bytes to the
pageable-copy counters at a copy between the host and a card.
``snapshot()`` reads the aggregates and the counters, ``reset()``
clears them. ``NAMES`` lists every span the port opens, ``COUNTERS`` every
counter.

Spans open at batch, chunk and file granularity, never per sector, frame
or sample. A thread that starts after the profile does is not traced by
torch's profiler unless it profiles all threads; its spans still reach the
aggregates.
"""

import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

NAMES = frozenset({
    # models/bs_video.py
    "bs.open", "bs.stack", "bs.stage", "bs.launch", "bs.wait", "bs.collect",
    # io/ingest.py
    "ingest.open", "ingest.demux", "ingest.nv21", "ingest.stack",
    # containers/strf.py, containers/xa.py
    "str.schedule", "str.sectors", "xa.encode", "xa.assemble",
    # batch.py
    "batch.parse", "batch.plan", "batch.encode", "batch.replay",
    # models/adpcm_stream.py
    "adpcm.upload", "adpcm.kernel", "adpcm.read_back",
})

COUNTERS = frozenset({"h2d_pageable_bytes", "d2h_pageable_bytes"})

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def enabled():
        """True while a torch.profiler profile runs (on every thread)."""
        return _autograd_profiler._is_profiler_enabled
else:
    enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The span of a stage while no profile runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_lock = threading.Lock()
_local = threading.local()
_spans = {}         # name -> [count, total ns, self ns]
_counters = {}


class _Span:
    __slots__ = ("name", "record", "t0", "child_ns")

    def __init__(self, name, key):
        self.name = name
        self.record = torch.profiler.record_function(
            name, None if key is None else str(key))
        self.child_ns = 0

    def __enter__(self):
        self.record.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        self.record.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dur
        with _lock:
            agg = _spans.get(self.name)
            if agg is None:
                agg = _spans[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
        return False


def span(name, key=None):
    """A context manager for the stage ``name`` (one of ``NAMES``): the
    shared no-op unless a profile runs."""
    if not enabled():
        return _OFF
    return _Span(name, key)


def count(name, n):
    """Add ``n`` to the counter ``name`` (one of ``COUNTERS``) while a
    profile runs."""
    if not enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def count_h2d(t, device):
    """Count ``t``'s bytes in ``h2d_pageable_bytes`` when it is pageable
    host memory about to be copied to a card (``device``)."""
    if enabled() and torch.device(device).type == "cuda" \
            and t.device.type == "cpu" and not t.is_pinned():
        count("h2d_pageable_bytes", t.nbytes)


def count_d2h(t):
    """Count ``t``'s bytes in ``d2h_pageable_bytes`` when it is on a card
    and about to be copied into pageable host memory."""
    if enabled() and t.device.type == "cuda":
        count("d2h_pageable_bytes", t.nbytes)


def snapshot():
    """-> {"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
    {name: n}}: what was recorded since the last ``reset()``."""
    with _lock:
        return {"spans": {n: {"count": c, "total_ns": t, "self_ns": s}
                          for n, (c, t, s) in _spans.items()},
                "counters": dict(_counters)}


def reset():
    with _lock:
        _spans.clear()
        _counters.clear()
