"""ingest_ms.movie: host milliseconds a movie of the input's open in the
traced window: the program's span ``ingest.open`` (the AVI demux, I420 to
NV21, the frames stacked, the sound) over the movies (``ingest.open``'s
count). Taken under the profiler, which slows the host: compare it with
the other spans and from change to change, not with the untraced
rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("ingest.open")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
