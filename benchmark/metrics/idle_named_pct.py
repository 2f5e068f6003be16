"""idle_named_pct: the share of the traced window's idle device seconds
(``ctx.trace.idle_gaps``, each gap named by the innermost annotation open
at its middle) whose name is one of the program's spans
(``psxavenc_tpu_torch.utils.spans.NAMES``); the rest fall under the
benchmark's own spans or none. None where the program has no such module
or the window had no idle time."""

from benchlib import spec


def read(ctx):
    try:
        names = spec.program("psxavenc_tpu_torch.utils.spans").NAMES
    except (ImportError, AttributeError):
        return None
    if ctx.trace is None:
        return None
    idle = sum(s for _, s in ctx.trace.idle_gaps)
    if idle <= 0:
        return None
    return 100.0 * sum(s for n, s in ctx.trace.idle_gaps
                       if n in names) / idle
