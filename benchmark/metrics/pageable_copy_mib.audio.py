"""pageable_copy_mib.audio: MiB a job list that the program copies between
the host's pageable memory and the card in the traced window: its
counters ``h2d_pageable_bytes`` and ``d2h_pageable_bytes`` summed, over
the traced lists (``ctx.traced_units``). None where nothing was copied
that way (as on the CPU)."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    c = spans["counters"]
    n = c.get("h2d_pageable_bytes", 0) + c.get("d2h_pageable_bytes", 0)
    if not n or not ctx.traced_units:
        return None
    return n / 2**20 / ctx.traced_units
