"""step_busy_pct.video: the share of the video steps' device span that
kernels fill, in the traced window: 100 x the trace's kernel seconds over
the program's counter ``bs_step_device_ns`` (the steps' device time from
their first kernel able to start to their last kernel's end, from CUDA
events on the encoder's stream). The rest is the card waiting on the
host's launches. None where the program has no such counter or the
window had no kernel."""

from benchlib import spec


def read(ctx):
    try:
        c = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()[
            "counters"]
    except (ImportError, AttributeError):
        return None
    ns = c.get("bs_step_device_ns")
    if ctx.trace is None or not ns:
        return None
    k = sum(ctx.trace.kernels.values())
    return 100.0 * k / (ns / 1e9) if k > 0 else None
