"""replay_ms.audio: host milliseconds a file of the batch runner's replay
in the traced window: the program's span ``batch.replay`` (the container
run again on the grouped encode's results, the .vag write) over the files
(``batch.replay``'s count). Taken under the profiler, which slows the
host: compare it with the other spans and from change to change, not with
the untraced rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"].get("batch.replay")
    return s["total_ns"] / s["count"] / 1e6 if s and s["count"] else None
