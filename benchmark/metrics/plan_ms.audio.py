"""plan_ms.audio: host milliseconds a file of the batch runner's planning
in the traced window: the program's span ``batch.plan`` (the input's open
and the container's run to the capture of its units) over the files
(``batch.plan``'s count). Taken under the profiler, which slows the host:
compare it with the other spans and from change to change, not with the
untraced rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("batch.plan")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
