"""Host time of BsFrameEncoder's batches on one CUDA card, and the
encoder's stream pipeline against an uploader thread (the JAX encoder's
design), on chip_smoke.py's phase 6 inputs.

    python tools/torch_pipeline_bench.py [--pairs N] [--mix video]
        [--tree DIR]

Each run encodes 1,024 frames of eight different 128-frame batches
(BS v2 320x240, 18,144-byte budgets). Four ways, run in turn, N times:

- ``stream``: ``BsFrameEncoder.encode_frames``, batch k+1 enqueued on the
  encoder's stream before batch k is fetched, all in the calling thread;
- ``one at a time``: each batch fetched before the next is enqueued;
- ``thread``: an uploader thread enqueues batch k+1 (``_launch``) while
  the calling thread fetches batch k and builds its headers;
- ``thread, one at a time``: the same thread, each batch fetched first.

Prints each way's median ms per batch (least, greatest) and frames/s,
and the median ms per batch of the host stages as each way ran them:
the frames' stacking, the staging copy, the whole enqueue of a batch,
the wait for it and the header assembly. Every way's bytes must equal
the first run's. ``--tree DIR`` times another checkout's encoder (for
example the parent commit unpacked under build/) the one way every
version has, ``encode_frames``, on the same frames; run each tree in
turn in one chip call to compare them. Exits 1 without a CUDA device.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--mix", default="video",
                        choices=("video", "video+noise", "noise"))
    parser.add_argument("--tree", help="the checkout whose encoder is "
                        "timed (encode_frames only); default: this one")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_pipeline_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # this checkout's inputs
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "psxavenc_tpu_torch"]:
            del sys.modules[name]
    from psxavenc_tpu_torch.models import bs_video
    from psxavenc_tpu_torch.ops import _build
    from psxavenc_tpu_torch.utils import synth

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.lib()
    frames = list(cs.e2e_frames(np, synth, args.mix))
    budgets = [cs.BUDGET] * len(frames)
    batch = cs.B
    stages = {}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            stages.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    enc = bs_video.BsFrameEncoder(0, cs.W, cs.H, "cuda")
    if not args.tree:
        bs_video._stack_frames = timed("stack", bs_video._stack_frames)
        bs_video._Staging.fill = timed("staging copy",
                                       bs_video._Staging.fill)
        enc._launch = timed("enqueue", enc._launch)
        enc._collect = timed("headers", enc._collect)
        enc.fetch = timed("fetch", enc.fetch)
    uploader = ThreadPoolExecutor(max_workers=1)

    def stream():
        return enc.encode_frames(frames, budgets)

    def one_at_a_time():
        out = []
        for base in range(0, len(frames), batch):
            out += enc.fetch(enc.encode_frames_async(
                frames[base:base + batch], budgets[base:base + batch]))
        return out

    def thread_pipelined():
        # batch k+1 handed to the thread before batch k is fetched, as
        # psxavenc_tpu's BsFrameEncoder.encode_frames does
        out = []
        bases = list(range(0, len(frames), batch))
        fut = uploader.submit(enc.encode_frames_async, frames[:batch],
                              budgets[:batch])
        for base in bases:
            current = fut
            nxt = base + batch
            fut = uploader.submit(enc.encode_frames_async,
                                  frames[nxt:nxt + batch],
                                  budgets[nxt:nxt + batch]) \
                if nxt < len(frames) else None
            out += enc.fetch(current.result())
        return out

    def thread_serial():
        out = []
        for base in range(0, len(frames), batch):
            out += enc.fetch(uploader.submit(
                enc.encode_frames_async, frames[base:base + batch],
                budgets[base:base + batch]).result())
        return out

    ways = {"stream": stream, "one at a time": one_at_a_time,
            "thread": thread_pipelined, "thread, one at a time":
            thread_serial}
    if args.tree:
        ways = {f"encode_frames of {args.tree}": stream}
    want = None
    for fn in ways.values():                            # warm-up
        got = b"".join(b.tobytes() for b, _ in fn())
        want = want or got
        if got != want:
            raise AssertionError("the ways' bytes differ")
    times = {name: [] for name in ways}
    per_stage = {name: {} for name in ways}
    for i in range(args.pairs):
        order = list(ways) if i % 2 == 0 else list(ways)[::-1]
        for name in order:
            stages.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ways[name]()
            times[name].append(time.perf_counter() - t0)
            if b"".join(b.tobytes() for b, _ in got) != want:
                raise AssertionError(f"{name}: bytes differ")
            for k, v in stages.items():
                per_stage[name].setdefault(k, []).extend(v)
    uploader.shutdown()
    n_batches = len(frames) // batch
    for name, ts in times.items():
        ts = sorted(t * 1e3 / n_batches for t in ts)
        med = statistics.median(ts)
        text = ", ".join(f"{k} {statistics.median(v) * 1e3:.3f}"
                         for k, v in per_stage[name].items())
        print(f"{args.mix} {name}: {med:.3f} ms a batch (least {ts[0]:.3f},"
              f" greatest {ts[-1]:.3f}) = {batch / med * 1e3:.1f} frames/s "
              f"over {args.pairs} runs of {len(frames)} frames; host ms a "
              f"batch: {text}; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
