"""open_self_pct.audio: the share of the input's open that no child span
of the program names, in the traced window: 100 x the self time over the
total of the program's span ``ingest.open`` (its children: the native
tier's checks, the probe, the WAV reader, the resampler, the sound's
final row). None where the program has no such span."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("ingest.open")
    return 100.0 * s["self_ns"] / s["total_ns"] \
        if s and s["total_ns"] else None
