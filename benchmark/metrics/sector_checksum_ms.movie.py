"""sector_checksum_ms.movie: host milliseconds a movie of the muxer's
sector checksums (EDC/ECC) in the traced window: the program's counter
``sector_checksum_ns``, timed inside ``str.sectors``' self time, over the
movies (``str.sectors``' count). Taken under the profiler, which slows
the host: compare it from change to change. None where the program has
no such counter."""

from benchlib import spec


def read(ctx):
    try:
        snap = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    ns = snap["counters"].get("sector_checksum_ns")
    s = snap["spans"].get("str.sectors")
    return ns / s["count"] / 1e6 if ns and s and s["count"] else None
