"""sector_timed_pct.movie: the share of the muxer's per-sector host work
that the program's timed sector steps name, in the traced window: 100 x the
counters ``sector_video_ns``, ``sector_audio_ns``, ``sector_checksum_ns``,
``sector_write_ns`` and ``sector_progress_ns`` over ``str.sectors``' self
time. None where the program has no such counters."""

from benchlib import spec

TIMERS = ("sector_video_ns", "sector_audio_ns", "sector_checksum_ns",
          "sector_write_ns", "sector_progress_ns")


def read(ctx):
    try:
        snap = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    timed = sum(snap["counters"].get(k, 0) for k in TIMERS)
    s = snap["spans"].get("str.sectors")
    return 100.0 * timed / s["self_ns"] if timed and s and s["self_ns"] \
        else None
