"""collect_ms.video: host milliseconds a batch of the program's span
``bs.collect`` in the traced window: the frame headers and buffers built
on the host after the read-back, over the batches (``bs.collect``'s
count). Taken under the profiler, which slows the host: compare it with
the other spans and from change to change, not with the untraced
rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("bs.collect")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
