"""video_fps.host: frames encoded a second through BsFrameEncoder, over
the passes of the window that ran untraced: whole passes over their
host-clock time."""


def read(ctx):
    units = ctx.spans.seconds("unit")
    frames = len(ctx.driver.budgets)
    return frames * len(units) / sum(units) if units else None
