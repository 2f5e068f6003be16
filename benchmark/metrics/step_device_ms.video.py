"""step_device_ms.video: device milliseconds of all kernels a batch in the
traced window (the step's kernels and its glue), from the profiler's
trace."""


def read(ctx):
    if ctx.trace is None or not ctx.batches_traced:
        return None
    s = sum(ctx.trace.kernels.values())
    return s / ctx.batches_traced * 1e3 if s > 0 else None
