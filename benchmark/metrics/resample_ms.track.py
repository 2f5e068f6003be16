"""resample_ms.track: host milliseconds a track of the sound's rematrix
and rate conversion in the traced window: the program's span
``ingest.resample`` (44,100 to 37,800 Hz, libswresample's FIR) over the
tracks (the span's count). Taken under the profiler, which slows the
host: compare it with the other spans and from change to change, not with
the untraced rate."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("ingest.resample")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
