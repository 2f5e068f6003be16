"""One run of one cell: set-up, the measured window, the traced units, the
check against the plain reference, and the result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

The run measures ``--seconds`` of whole units of work (a pass over a
movie, a job list), each started only after the last one ended. With
``--trace 1`` units of at least the traffic's ``trace_seconds`` run
under ``torch.profiler`` first, and the window of ``--seconds`` untraced
units follows them, for the spans and the host rates; the result line
then carries the cell's per-layer metrics, the device's busy and window
seconds and a breakdown, instead of its end-to-end metrics. The card's
memory peak is reset once set-up has ended, so it covers the program's
units alone.
"""

import argparse
import contextlib
import json
import shutil
import statistics
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "psxavenc_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host-clock spans by name, each also a profiler annotation while a
    trace is on."""

    def __init__(self):
        self.times = {}
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name):
        ctx = contextlib.nullcontext()
        if self.traced:
            from . import trace
            ctx = trace.span(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.record(name, time.perf_counter() - t0)

    def record(self, name, seconds):
        self.times.setdefault((name, self.traced), []).append(seconds)

    def seconds(self, name):
        """Durations of ``name``, from the untraced units where any ran."""
        plain = self.times.get((name, False), [])
        return plain or self.times.get((name, True), [])


class Context:
    """What the metric readers read."""

    def __init__(self, cell, driver, spans):
        self.cell = cell
        self.driver = driver
        self.spans = spans
        self.window_s = None
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.trace = None
        self.traced_units = 0
        self.batches_traced = 0
        self.work = None


def run_unit(driver, spans):
    """One unit: its wall seconds under ``unit``, its main thread's CPU
    seconds (``time.thread_time``) under ``unit_cpu``."""
    c0 = time.thread_time()
    with spans("unit"):
        driver.unit()
    spans.record("unit_cpu", time.thread_time() - c0)


def unit_summary(spans):
    """The window's unit times in a few numbers, for the record: their
    count, the wall seconds' minimum, lower quartile, median and mean, and
    the CPU seconds' median and mean."""
    wall, cpu = spans.seconds("unit"), spans.seconds("unit_cpu")
    if not wall:
        return {"count": 0}
    q1 = statistics.quantiles(wall, n=4)[0] if len(wall) > 1 else wall[0]
    return {"count": len(wall), "wall_min_s": min(wall), "wall_q1_s": q1,
            "wall_median_s": statistics.median(wall),
            "wall_mean_s": statistics.fmean(wall),
            "cpu_median_s": statistics.median(cpu),
            "cpu_mean_s": statistics.fmean(cpu)}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(cell, seed, seconds, trace_on, t_start, device, tmp):
    """Run ``cell`` -> the result dict: the contract's keys, the
    window's unit times (``units``), the reference's seconds
    (``reference_s``), and last ``checks``."""
    import torch

    spans = Spans()
    driver = cell.driver().Driver(cell, seed, device, tmp, spans)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        # The peak from here on is the program's units' alone: set-up's
        # inputs are gone, what the program keeps from its warm-up stays.
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(cell, driver, spans)
    ctx.setup_s = time.perf_counter() - t_start

    w0 = time.perf_counter()
    if trace_on:
        from . import trace
        spans.traced = True
        trace_s = float(cell.traffic.get("trace_seconds", 2))
        with trace.profiler() as prof:
            with trace.span(trace.WINDOW):
                t0 = time.perf_counter()
                while True:
                    run_unit(driver, spans)
                    ctx.traced_units += 1
                    if time.perf_counter() - t0 >= min(trace_s, seconds):
                        break
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        spans.traced = False
        w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        run_unit(driver, spans)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx.window_s = time.perf_counter() - w0
    if trace_on:
        ctx.trace = trace.read(prof, tmp)
        del prof

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(
                       torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)}
    ctx.memory_peak_bytes = device_info["memory_peak_bytes"]
    if trace_on:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        driver.census(ctx)

    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    check_s = time.perf_counter() - t_check
    attempted, failed = driver.attempted, driver.failed

    metrics = {}
    wanted = cell.per_layer if trace_on else cell.end_to_end
    for m in wanted:
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": failed == 0 and all(v <= lim for _, v, lim in
                                              checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace_on:
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in
                           ctx.trace.device_ops[:10]],
            "idle_gaps": [[n, s] for n, s in ctx.trace.idle_gaps[:10]]}
    result["units"] = unit_summary(spans)
    result["reference_s"] = check_s
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result


def main(argv, t_start):
    args = parse(argv)
    import torch

    from . import spec

    cell = spec.Cell(spec.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="psxbench-")
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     t_start, torch.device("cuda", 0), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
