"""memory_peak_mib: the most device memory the run's tensors held at
once, from set-up to the window's close (torch.cuda.max_memory_allocated
on the card, before the plain reference runs), in MiB: the share of the
card an encode takes from whatever else runs on it."""


def read(ctx):
    b = ctx.memory_peak_bytes
    return b / 2**20 if b else None
