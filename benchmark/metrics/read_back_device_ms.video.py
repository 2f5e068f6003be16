"""read_back_device_ms.video: device milliseconds a batch of the outputs'
copies to pinned host buffers, in the traced window: the program's counter
``bs_read_back_device_ns`` (CUDA events on the encoder's stream after the
step's last launch and after the copies, read once the batch is done)
over the batches (``bs.read_back``'s count). Beside
``read_back_ms.video``, the host's time to enqueue the same copies. None
where the program has no such counter or span."""

from benchlib import spec


def read(ctx):
    try:
        snap = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    ns = snap["counters"].get("bs_read_back_device_ns")
    s = snap["spans"].get("bs.read_back")
    return ns / s["count"] / 1e6 if ns and s and s["count"] else None
