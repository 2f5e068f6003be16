"""sector_us.track: host microseconds a sector of the .xa muxer's
per-sector work in the traced window: ``xa.sectors``' self time (the loop
less the audio chunks it pulls) over the program's counter ``sectors``,
the sectors the loop wrote. ``xa_sectors_ms.track`` a sector, to set
beside ``sector_us.movie``. Taken under the profiler, which slows the
host: compare it from change to change. None where the program has no
such counter."""

from benchlib import spec


def read(ctx):
    try:
        snap = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    n = snap["counters"].get("sectors")
    s = snap["spans"].get("xa.sectors")
    return s["self_ns"] / n / 1e3 if n and s else None
