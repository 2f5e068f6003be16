"""k1_str640_roofline: K1 (select_pix_kernel, FDCT and scale search) alone
as a share of its roofline on 640x480 frames: the bound of the traced
passes' work (benchlib/roofline.py's fdct_select_work, counted from the
frames and their chosen scales) over K1's traced device time."""

from benchlib import roofline

KERNEL = "select_pix_kernel"


def read(ctx):
    if ctx.trace is None or KERNEL not in (getattr(ctx, "work", None)
                                           or {}):
        return None
    t = ctx.trace.kernel_seconds(KERNEL)
    return 100.0 * roofline.bound_s(*ctx.work[KERNEL]) / t if t > 0 \
        else None
