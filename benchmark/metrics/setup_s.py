"""setup_s: seconds from the process's start to the window's: imports,
inputs, the kernels' load (and build, on a checkout's first run) and the
warm-up units."""


def read(ctx):
    return ctx.setup_s
