"""launch_ms.video: host milliseconds a batch of the program's span
``bs.launch`` in the traced window, its self time: the uploads, the
step's launches, the read-back copies and events, over the batches
(``bs.launch``'s count). Taken under the profiler, which slows the host:
compare it with the other spans and from change to change, not with the
untraced rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("bs.launch")
    return s["self_ns"] / s["count"] / 1e6 if s and s["count"] else None
