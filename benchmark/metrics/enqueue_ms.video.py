"""enqueue_ms.video: mean host milliseconds of encode_frames_async a batch
(stacking, staging, upload and the step's launches), from the benchmark's
span around each call in the untraced part of the window."""


def read(ctx):
    s = ctx.spans.seconds("enqueue")
    return sum(s) / len(s) * 1e3 if s else None
