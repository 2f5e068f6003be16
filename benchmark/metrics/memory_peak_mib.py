"""memory_peak_mib: the most device memory the program's units held at
once, in MiB: torch.cuda.max_memory_allocated on the card over every unit
after set-up (the peak is reset once set-up has ended, so the inputs that
set-up makes on the card are not in it; what the program still holds from
its warm-up is), read before the plain reference runs. The share of the
card an encode takes from whatever else runs on it."""


def read(ctx):
    b = ctx.memory_peak_bytes
    return b / 2**20 if b else None
