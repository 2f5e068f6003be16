"""k2_v3_roofline: K2 (dc_chain_kernel, the v3 DC chain) as a share of
its roofline: the bound of the traced passes' work
(benchlib/roofline_dc.py's dc_work over the passes' frames) over K2's
traced device time. None where the trace holds no such kernel."""

from benchlib import roofline

KERNEL = "dc_chain_kernel"


def read(ctx):
    if ctx.trace is None or KERNEL not in (getattr(ctx, "work", None)
                                           or {}):
        return None
    t = ctx.trace.kernel_seconds(KERNEL)
    return 100.0 * roofline.bound_s(*ctx.work[KERNEL]) / t if t > 0 \
        else None
