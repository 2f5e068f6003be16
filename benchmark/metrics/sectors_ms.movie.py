"""sectors_ms.movie: host milliseconds a movie of the muxer's sector loop
in the traced window, its self time: the program's span ``str.sectors``
less the frame batches and audio chunks it pulls (their own spans), that
is the per-sector host work (headers, checksums, writes), over the movies
(``str.sectors``'s count). Taken under the profiler, which slows the
host: compare it with the other spans and from change to change, not with
the untraced rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("str.sectors")
    return s["self_ns"] / s["count"] / 1e6 if s and s["count"] else None
