"""video_batch_p95_ms: the 95th percentile (numpy's linear interpolation)
of the waits of the batches of the untraced part of the window, each from
the call that enqueues the batch to the return of the fetch that hands
back its frames. A batch takes milliseconds, under what the host's clock
reads steadily, so this tail is a per-layer metric beside video_fps.host."""

import numpy as np


def read(ctx):
    waits = ctx.spans.seconds("batch_wait")
    return float(np.percentile(waits, 95) * 1e3) if waits else None
