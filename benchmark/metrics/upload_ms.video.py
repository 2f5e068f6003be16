"""upload_ms.video: host milliseconds a batch of the program's span
``bs.upload`` in the traced window: the frames' and budgets' enqueued
copies to the card and the event after them, inside ``bs.launch``, over
the batches (``bs.upload``'s count). Taken under the profiler, which
slows the host: compare it with the other spans and from change to
change, not with the untraced rates. None where the program has no such
span."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("bs.upload")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
