"""step_span_ms.video: device milliseconds a batch from the video step's
first kernel able to start to its last kernel's end, in the traced
window: the program's counter ``bs_step_device_ns`` (CUDA events on the
encoder's stream after the upload and after the step's last launch, read
once the batch is done) over the batches (``bs.step``'s count). Its gaps
beside ``step_device_ms`` are the card waiting on the host's launches.
None where the program has no such counter or span."""

from benchlib import spec


def read(ctx):
    try:
        snap = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    ns = snap["counters"].get("bs_step_device_ns")
    s = snap["spans"].get("bs.step")
    return ns / s["count"] / 1e6 if ns and s and s["count"] else None
