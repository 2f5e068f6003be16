"""k5_launches_per_list.audio: K5 launches a job list over the window,
from the program's counter ops.adpcm_cuda.LAUNCHES."""


def read(ctx):
    d = ctx.driver
    return d.launches / d.lists if d.lists else None
