"""prep_ms.video: host milliseconds a batch of the encoder's own work
before its launches in the traced window: the self time of the program's
spans ``bs.stack`` (the frames stacked, the budgets) and ``bs.stage`` (the
pinned staging copy, its wait on the last upload), over the batches
(``bs.stack``'s count). Taken under the profiler, which slows the host:
compare it with the other spans and from change to change, not with the
untraced rates."""

from benchlib import spec


def read(ctx):
    try:
        spans = spec.program("psxavenc_tpu_torch.utils.spans").snapshot()
    except (ImportError, AttributeError):
        return None
    s = spans["spans"]
    n = s.get("bs.stack", {}).get("count", 0)
    if not n:
        return None
    ns = sum(s.get(k, {}).get("self_ns", 0) for k in ("bs.stack", "bs.stage"))
    return ns / n / 1e6
