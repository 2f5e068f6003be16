"""xa_sectors_ms.track: host milliseconds a track of the .xa muxer's
sector loop in the traced window, its self time: the program's span
``xa.sectors`` less the audio chunks it pulls (their own spans), that is
the per-sector host work (subheaders, EDC, writes), over the tracks
(``xa.sectors``' count). Taken under the profiler, which slows the host:
compare it with the other spans and from change to change, not with the
untraced rate."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("xa.sectors")
    return s["self_ns"] / s["count"] / 1e6 if s and s["count"] else None
