"""k5_track_roofline: K5 (csrc/adpcm_units.cu, every adpcm_* kernel) as a
share of its roofline in the -t xa track: the bound of the traced tracks'
units, both channels' streams through XA's four filters' candidates
(benchlib/roofline.py), over K5's traced device time."""

from benchlib import roofline


def read(ctx):
    if ctx.trace is None or not getattr(ctx, "work", None):
        return None
    n_bytes, ops = ctx.work["adpcm_"]
    t = ctx.trace.kernel_seconds("adpcm_")
    return 100.0 * roofline.bound_s(n_bytes, ops) / t if t > 0 else None
