"""k5_walked_pct.tone: the share of K5's units in the traced window that
its serial walk encoded (the segments' guessed states never met the
serial encode's), from the program's counters ``k5_walked_units`` and
``k5_units`` (K5's own statistics, read back only while a profile runs).
None where the program has no such counters."""

from benchlib import spec


def read(ctx):
    try:
        c = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()[
            "counters"]
    except (ImportError, AttributeError):
        return None
    n = c.get("k5_units", 0)
    return 100.0 * c.get("k5_walked_units", 0) / n \
        if n and "k5_walked_units" in c else None
