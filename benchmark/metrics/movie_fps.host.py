"""movie_fps.host: the frames of whole movies encoded through the CLI a
second, over the movies of the window that ran untraced and their
host-clock time (each movie's read-back included)."""


def read(ctx):
    units = ctx.spans.seconds("unit")
    frames = len(ctx.driver.frames)
    return frames * len(units) / sum(units) if units else None
