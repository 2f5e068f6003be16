"""xa_msps.host: frames of the 44,100 Hz master encoded through the CLI's
-t xa a second, in millions, over the whole tracks of the window that ran
untraced and their host-clock time (each track's read-back included)."""


def read(ctx):
    units = ctx.spans.seconds("unit")
    frames = ctx.driver.frames
    return frames * len(units) / sum(units) / 1e6 if units else None
