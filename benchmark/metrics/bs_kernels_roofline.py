"""bs_kernels_roofline: the video step's kernels K1 (select_pix_kernel),
K3 (emit_prep_kernel), K4 (place_kernel) and the tail emission
(emit_tail_kernel) as a share of their roofline: the sum of each kernel's
bound for the traced passes' work (benchlib/roofline.py, counted from the
frames and their chosen scales) over the sum of their traced device
time."""

from benchlib import roofline


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "work", None):
        return None
    bound = spent = 0.0
    for kernel, (n_bytes, ops) in ctx.work.items():
        t = ctx.trace.kernel_seconds(kernel)
        if t <= 0:
            return None
        bound += roofline.bound_s(n_bytes, ops)
        spent += t
    return 100.0 * bound / spent
