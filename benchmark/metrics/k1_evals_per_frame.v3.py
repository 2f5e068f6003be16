"""k1_evals_per_frame.v3: K1's ladder, fused and exact evaluations a frame
over the traced window, from the program's counters ``k1_evaluations``
and ``k1_frames`` (K1's own statistics rows, read back only while a
profile runs). None where the program has no such counters."""

from benchlib import spec


def read(ctx):
    try:
        c = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()[
            "counters"]
    except (ImportError, AttributeError):
        return None
    n = c.get("k1_frames", 0)
    return c.get("k1_evaluations", 0) / n if n and "k1_evaluations" in c \
        else None
