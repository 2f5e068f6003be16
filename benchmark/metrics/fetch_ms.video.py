"""fetch_ms.video: mean host milliseconds of fetch a batch (the wait for
the read-back and the headers' assembly), from the benchmark's span
around each call in the untraced part of the window."""


def read(ctx):
    s = ctx.spans.seconds("fetch")
    return sum(s) / len(s) * 1e3 if s else None
