"""step_device_ms.movie: device milliseconds of the video kernels (every
kernel but K5's adpcm_*) for each 128 frames of the traced movies, from
the profiler's trace."""


def read(ctx):
    if ctx.trace is None or not ctx.batches_traced:
        return None
    s = sum(t for name, t in ctx.trace.kernels.items()
            if "adpcm_" not in name)
    return s / ctx.batches_traced * 1e3 if s > 0 else None
