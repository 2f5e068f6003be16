"""step_launch_ms.video: host milliseconds a batch of the program's span
``bs.step`` in the traced window: the host side of the video step (the
NV21 kernel's, K1-K4's and the tail's launches and their torch glue),
inside ``bs.launch``, over the batches (``bs.step``'s count). Taken under
the profiler, which slows the host: compare it with the other spans and
from change to change, not with the untraced rates. None where the
program has no such span."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("bs.step")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
