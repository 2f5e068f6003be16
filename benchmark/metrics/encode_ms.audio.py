"""encode_ms.audio: host milliseconds a job list of the batch runner's
grouped encode in the traced window: the program's span ``batch.encode``
(the requests stacked, the upload, K5, the read-back) over the traced
lists (``ctx.traced_units``). Taken under the profiler, which slows the
host: compare it with the other spans and from change to change, not with
the untraced rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("batch.encode")
    if not s or not ctx.traced_units:
        return None
    return s["total_ns"] / ctx.traced_units / 1e6
