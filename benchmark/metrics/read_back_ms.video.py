"""read_back_ms.video: host milliseconds a batch of the program's span
``bs.read_back`` in the traced window: the pinned host buffers, the
enqueued copies into them and the event after them, inside
``bs.launch``, over the batches (``bs.read_back``'s count). Taken under
the profiler, which slows the host: compare it with the other spans and
from change to change, not with the untraced rates. None where the
program has no such span."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("bs.read_back")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
