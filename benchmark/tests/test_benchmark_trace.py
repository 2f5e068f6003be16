"""Reading a traced window: busy seconds as the union of device intervals
inside the window, kernels by name, and idle gaps named by the innermost
annotation open at their middle."""

from benchlib import trace


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(trace.WINDOW, "user_annotation", 100, 1000),
    _x("enqueue", "user_annotation", 100, 300),
    _x("fetch", "user_annotation", 400, 700),
    _x("k1", "kernel", 50, 100),           # clipped to the window: 50
    _x("k1", "kernel", 300, 100),
    _x("memcpy", "gpu_memcpy", 350, 100),  # overlaps k1: union 300-450
    _x("k2", "kernel", 900, 50),
    _x("host_op", "cpu_op", 100, 900),     # not a device interval
]


def test_busy_and_kernels():
    t = trace.Trace(EVENTS)
    assert t.window_s == 1000e-6
    assert abs(t.busy_s - (50 + 150 + 50) * 1e-6) < 1e-12
    assert abs(t.kernel_seconds("k1") - 150e-6) < 1e-12
    assert t.device_ops[0][0] == "k1"


def test_idle_gaps_are_named_by_the_open_span():
    t = trace.Trace(EVENTS)
    gaps = dict(t.idle_gaps)
    # 150-300 under enqueue; 450-900 and 950-1100 under fetch.
    assert abs(gaps["enqueue"] - 150e-6) < 1e-12
    assert abs(gaps["fetch"] - 600e-6) < 1e-12
