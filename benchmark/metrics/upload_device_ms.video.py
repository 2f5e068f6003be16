"""upload_device_ms.video: device milliseconds a batch of the frames' and
budgets' copies to the card, in the traced window: the program's counter
``bs_upload_device_ns`` (CUDA events on the encoder's stream before the
upload and after it, read once the batch is done) over the batches
(``bs.upload``'s count). Beside ``upload_ms.video``, the host's time to
enqueue the same copies. None where the program has no such counter or
span."""

from benchlib import spec


def read(ctx):
    try:
        snap = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    ns = snap["counters"].get("bs_upload_device_ns")
    s = snap["spans"].get("bs.upload")
    return ns / s["count"] / 1e6 if ns and s and s["count"] else None
