"""The traced window: ``torch.profiler`` (CUPTI) over whole units of work,
read back from its Chrome trace.

The harness opens a ``window`` annotation around the traced units and one
annotation around each call into the program (``enqueue``, ``fetch``,
``run_jobs`` ...). From the trace come the device's busy seconds (the
union of kernels, copies and sets inside the window), the kernels' time by
name, and the idle gaps, each named by the innermost annotation open at
its middle."""

import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name):
    return torch.profiler.record_function(name)


class Trace:
    """What the harness reads from one traced window."""

    def __init__(self, events):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        dev = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                a = max(w0, float(e["ts"]))
                b = min(w1, float(e["ts"]) + float(e.get("dur", 0)))
                if b > a:
                    dev.append((a, b, e["name"], e["cat"]))
        self.device = dev
        self.kernels = {}
        for a, b, name, cat in dev:
            if cat == "kernel":
                self.kernels[name] = self.kernels.get(name, 0.0) + \
                    (b - a) / 1e6
        ops = {}
        for a, b, name, _ in dev:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        self.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])
        busy, gaps = _union(sorted((a, b) for a, b, _, _ in dev), w0, w1)
        self.busy_s = busy / 1e6
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") != WINDOW]
        idle = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "no_span"
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        self.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])

    def kernel_seconds(self, *fragments):
        """Device seconds of the kernels whose names hold any fragment."""
        return sum(s for name, s in self.kernels.items()
                   if any(f in name for f in fragments))


def _union(intervals, w0, w1):
    """Busy microseconds of sorted intervals, and the gaps in [w0, w1]."""
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    at = w0
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                at = cur_b
            if a > at:
                gaps.append((at, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        at = cur_b
    if w1 > at:
        gaps.append((at, w1))
    return busy, gaps


def read(prof, directory):
    """Export ``prof``'s trace into ``directory``, parse it, delete it."""
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
