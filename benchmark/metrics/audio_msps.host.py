"""audio_msps.host: input samples of whole job lists a second, in
millions, over the lists of the window that ran untraced and their
host-clock time (each list's read-back included)."""


def read(ctx):
    units = ctx.spans.seconds("unit")
    samples = ctx.driver.list_samples
    return samples * len(units) / sum(units) / 1e6 if units else None
