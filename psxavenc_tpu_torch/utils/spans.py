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
stack). A span reads its clock before it makes its record function and
after it leaves it, so the record function counts in the span's own total
and not in the self time of the span around it; the update of the
aggregates, under a lock, lies outside both. ``key`` names the request, a
batch's sequence number or a job's index; it goes to the record
function's argument string, which torch's Chrome export leaves out (torch
2.13), so in the trace a stage's spans pair up by their order on their
thread.

``count(name, n)`` adds ``n`` to a counter, also only while a profile
runs; ``count_h2d`` and ``count_d2h`` add a tensor's bytes to the
pageable-copy counters at a copy between the host and a card. The
kernels' own statistics become counters too: while a profile runs, the
video step hands K1 a stats row a frame and each K5 call a stats row,
read back with the outputs (``models/bs_video.py``,
``models/adpcm_stream.py``); with no profile running neither is made.
``snapshot()`` reads the aggregates and the counters, ``reset()``
clears them. ``NAMES`` lists every span the port opens, ``COUNTERS`` every
counter.

Spans open at batch, chunk and file granularity, never per sector, frame
or sample (about 17 us each while on); the muxers' sector loops sum
their steps' ``time.perf_counter_ns`` differences in locals and add them
to counters once a loop (``containers/xa.py::sector_sums``). A thread
that starts after the profile does is not traced by torch's profiler
unless it profiles all threads; its spans still reach the aggregates.
"""

import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

NAMES = frozenset({
    # models/bs_video.py
    "bs.open", "bs.stack", "bs.stage", "bs.launch", "bs.upload", "bs.step",
    "bs.read_back", "bs.wait", "bs.collect",
    # io/ingest.py
    "ingest.open", "ingest.native", "ingest.probe", "ingest.demux",
    "ingest.resample", "ingest.nv21", "ingest.stack", "ingest.finish",
    # containers/strf.py, containers/xa.py
    "str.schedule", "str.sectors", "xa.sectors", "xa.encode", "xa.assemble",
    # batch.py
    "batch.parse", "batch.plan", "batch.encode", "batch.replay",
    # models/adpcm_stream.py
    "adpcm.upload", "adpcm.kernel", "adpcm.read_back",
})

COUNTERS = frozenset({
    "h2d_pageable_bytes", "d2h_pageable_bytes",
    # From K1's stats rows (ops.bs_cuda.STAT_NAMES): the frames a video
    # step searched, of them those on the global-memory reader, and the
    # ladder, fused and exact evaluations (the last two 0 where K1's plain
    # version ran, which zeroes the rows).
    "k1_frames", "k1_global_frames", "k1_evaluations",
    # From K5's stats (ops.adpcm_cuda.STAT_NAMES): the units of its calls,
    # and of them those its serial walk encoded (0 where its plain version
    # ran).
    "k5_units", "k5_walked_units",
    # models/bs_video.py at fetch, on a card: each batch's device
    # nanoseconds between CUDA events on the encoder's stream, from before
    # its upload to after it, to after the step's last launch, to after
    # the read-back.
    "bs_upload_device_ns", "bs_step_device_ns", "bs_read_back_device_ns",
    # ops.bs_cuda.dc_stage: the frames of each K2 launch (v3/v3dc), padded
    # batches included. models/bs_video.py at fetch, from the device
    # tier's step: the DC bits and the whole bitstream's bits (the end of
    # frame included, the header not) of the frames handed back.
    "k2_frames", "dc_bits", "frame_bits",
    # containers/strf.py, containers/xa.py: host nanoseconds of the
    # sector loops' steps, a video sector's and an audio sector's header
    # and payload (checksums apart), the checksums and EDC, the writes,
    # the progress line; and the sectors written.
    "sector_video_ns", "sector_audio_ns", "sector_checksum_ns",
    "sector_write_ns", "sector_progress_ns", "sectors",
})

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
        self.t0 = time.perf_counter_ns()
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

    def __exit__(self, *exc):
        self.record.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        dur = time.perf_counter_ns() - self.t0
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
