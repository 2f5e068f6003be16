"""k1_global_pct.str640: the share of the frames K1 searched in the traced
window that took its global-memory reader (a frame's 16-bit magnitudes
over the shared memory), from the program's counters
``k1_global_frames`` and ``k1_frames``. None where the program has no
such counters."""

from benchlib import spec


def read(ctx):
    try:
        c = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()[
            "counters"]
    except (ImportError, AttributeError):
        return None
    n = c.get("k1_frames", 0)
    return 100.0 * c.get("k1_global_frames", 0) / n \
        if n and "k1_global_frames" in c else None
