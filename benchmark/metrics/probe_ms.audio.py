"""probe_ms.audio: host milliseconds a file of the program's span
``ingest.probe`` in the traced window (the ffprobe CLI where it is on the
path, its validation and loop tags; for a WAV without a loop chunk), over
the files opened (``ingest.open``'s count). Taken under the profiler,
which slows the host: compare it with the other spans and from change to
change. None where the program has no such span."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    p = spans["spans"].get("ingest.probe")
    o = spans["spans"].get("ingest.open")
    return p["total_ns"] / o["count"] / 1e6 if p and o and o["count"] \
        else None
