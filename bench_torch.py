#!/usr/bin/env python
"""Benchmark of psxavenc_tpu_torch on one CUDA card: the port of bench.py.

    python bench_torch.py [--quick] [--device cuda|cpu]

Headline: BS v2 320x240 frames/s on the device (NV21 frames already on
the card in, packed bitstream words out: ``api.bs_encode_frames_packed``
with the ``fused_mxu`` packer, 18,144-byte budgets, B = 128 noise frames
of rng(3), bench.py's inputs), timed by CUDA events over back-to-back
calls after a warm-up. The host enqueues each step while the card runs
the one before, so the figure includes the host's enqueue wherever that
is longer than the card's work. Beside it, the same step replayed as one
CUDA graph: the card's own time, without the host. Both are reported;
neither replaces the other.

Also measured, with bench.py's inputs and sizes: the step at B = 32 and
64 and for v3dc; SPU-ADPCM Msamples/s through ``api.spu_encode_batch``
(CUDA events) and K5 alone (a CUDA-graph replay) on 4,096 streams x
1,000 units; end to end through ``BsFrameEncoder`` (host frames to frame
buffers, H2D included) against a serial pass of 32-frame chunks; one
file's ADPCM streams through ``models.adpcm_stream.encode_unit_streams``
on the card against the native unit encoder on the host; the batch
runner grouped against serial on 32 ``-t spu`` jobs; the native frame
encoder on the host's cores; the speed of light from ``utils/roofline.py``.
The repo holds no reference binary, so ``vs_baseline`` is null.

Every figure is the median of ``REPS`` (5) repetitions, with
the least and the greatest beside it in the details; two things that are
compared run as interleaved pairs. Device times come from CUDA events or
graph replays, host wall times from the host's clock, each under its own
key. The kernel build, the graph captures and the warm-ups are outside
every timed window.

Before any timing, each kernel is held to its plain version on the card
(K5 for three variants, also with its segments forced; K1 and K6; every
packer against ``fused_mxu``, and ``fused_mxu`` against ``blocks`` on the
plain versions); each measured batch (v2 and v3dc at B = 128, the ADPCM
batch, one file's streams) is held to the native tiers
(``native/tiers.py``) before it is timed. A mismatch exits 1.

Output: the card's name and power limit on one line, then, as the last
line of stdout, one JSON object: ``metric``, ``value``, ``unit``,
``vs_baseline`` and ``device``. A full run writes
``BENCH_TORCH_DETAILS.json`` (never bench.py's ``BENCH_DETAILS.json``).
``--quick`` runs one repetition of short loops and writes no details.
``--device cpu`` measures the native tiers only, runs no CUDA code and
writes no details. Without a CUDA device and without ``--device cpu`` it
exits 1 and prints no figure.
"""

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from psxavenc_tpu_torch import api
from psxavenc_tpu_torch.io.ingest import _scale_frame_nv21
from psxavenc_tpu_torch.native import tiers
from psxavenc_tpu_torch.ops import adpcm_cuda, bs_cuda
from psxavenc_tpu_torch.ops import bs as bs_ops
from psxavenc_tpu_torch.utils import roofline as rl
from psxavenc_tpu_torch.utils import synth

REPO = pathlib.Path(__file__).resolve().parent
DETAILS = REPO / "BENCH_TORCH_DETAILS.json"

VIDEO_W, VIDEO_H = 320, 240
VIDEO_FRAMES = 60                   # the reference's video input
FRAME_BUDGET = 18144                # 9 sectors x 2,016 bytes (bench.py:27)
CAP_WORDS = (FRAME_BUDGET - 8) // 2
HEADLINE_BATCH = 128
SWEEP_BATCHES = (32, 64)
SERIAL_CHUNK = 32
E2E_UNIQUE = 16                     # unique frames tiled to the batch
NATIVE_FRAMES = 32
AUDIO_RATE = 22050
AUDIO_SECONDS = 60                  # the reference's audio input
ADPCM_STREAMS, ADPCM_UNITS = 4096, 1000
NATIVE_ADPCM_STREAMS, NATIVE_ADPCM_UNITS = 64, 500
CLI_SECONDS = 20
BATCH_FILES, BATCH_SECONDS = 32, 2
VALIDATE_FRAMES = 8
ADPCM_VARIANTS = ((5, 12), (4, 12), (4, 8))
CHECK_PACKERS = ("fused_pallas", "fused_gather", "blocks_pallas")

REPS = 5                            # repetitions of each figure
# Loop lengths: (full run, --quick).
ITERS = {"step": (200, 20), "adpcm": (40, 5), "e2e": (20, 3),
         "native": (5, 1), "native_adpcm": (20, 2)}


class Mismatch(Exception):
    """An output differs from its reference."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def expect(ok, msg):
    if not ok:
        raise Mismatch(msg)


def summary(values):
    """{median, least, greatest} of a list of figures."""
    return {"median": statistics.median(values), "least": min(values),
            "greatest": max(values)}


def interleaved(runs, reps):
    """Run each fn of the dict ``runs`` ``reps`` times, in turns whose
    order alternates (a, b, b, a, ...); -> {label: [results]}."""
    labels = list(runs)
    out = {label: [] for label in labels}
    for i in range(reps):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            out[label].append(runs[label]())
    return out


def text(s, unit, digits=1):
    return (f"{s['median']:,.{digits}f} {unit} "
            f"(least {s['least']:,.{digits}f}, "
            f"greatest {s['greatest']:,.{digits}f})")


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timers

def events_ms(fn, iters):
    """(device ms, host ms) per call of ``iters`` back-to-back calls of
    ``fn``: the CUDA events around them, and the host's clock from the
    first enqueue to the synchronisation that closes the window."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    return a.elapsed_time(b) / iters, host


class Graph:
    """One call of ``fn`` captured as a CUDA graph (after a warm-up off
    the capture); ``ms(reps)`` replays it ``reps`` times back to back
    between CUDA events -> the device ms of one call."""

    def __init__(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            fn()
        self.graph.replay()
        torch.cuda.synchronize()

    def ms(self, reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps


def wall_s(fn, sync):
    """Host seconds of ``fn``, the device idle before it (``sync``)."""
    sync()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ------------------------------------------------------------ inputs

def noise_frames(batch, seed=3):
    """bench.py's device frames: uniform noise NV21 bytes of rng(seed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, VIDEO_W * VIDEO_H * 3 // 2)) \
        .astype(np.uint8)


def video_frames(n, seed=3):
    """n synthetic frames (utils.synth) as NV21 rows."""
    w, h = VIDEO_W, VIDEO_H
    return np.stack([_scale_frame_nv21(y, cb, cr, w, h, w, h)
                     for y, cb, cr in synth.rand_frames(w, h, n, seed=seed)])


def adpcm_units(streams, units, seed=1):
    """bench.py's ADPCM batch: cumulative sums of rng(seed) steps, clipped
    to int16, as (streams, units, 28) int32; full limits, zero states."""
    rng = np.random.default_rng(seed)
    pcm = np.cumsum(rng.integers(-800, 800, (streams, units * 28)), axis=1)
    u = np.clip(pcm, -32768, 32767).astype(np.int32).reshape(streams, units,
                                                              28)
    return u, np.full((streams, units), 28, np.int32), \
        np.zeros(streams, np.int32)


# ------------------------------------------------------------ checks

def words_equal(got, ref, total_bits):
    """Two packers' words, up to each frame's bits."""
    n = (total_bits.to(torch.int64) + 15) // 16
    live = torch.arange(ref.shape[1], device=ref.device)[None, :] < n[:, None]
    return torch.equal(torch.where(live, got, 0), torch.where(live, ref, 0))


def validate_adpcm(dev):
    """K5 against its plain version for the three variants on 128 x 3
    units with one limit of 9 (bench.py:228-240), on the plan's route and
    with 3 segments forced; then one file's two streams of 720 units with
    masked trailing units, on the plan's segmented route, the serial
    route and 4 segments, against the plain version and the native unit
    encoder through ``encode_unit_streams``."""
    from psxavenc_tpu_torch.models import adpcm_stream as streams

    rng = np.random.default_rng(7)
    for fc, sr in ADPCM_VARIANTS:
        units = rng.integers(-20000, 20000, (128, 3, 28)).astype(np.int32)
        limits = np.full((128, 3), 28, np.int32)
        limits[0, -1] = 9
        z = np.zeros(128, np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (units, limits, z, z)]
        kw = dict(filter_count=fc, shift_range=sr)
        want = adpcm_cuda.encode_units_plain(*args, **kw)
        for segments in (None, 3):
            got = adpcm_cuda.encode_units(*args, segments=segments, **kw)
            expect(all(torch.equal(g, w) for g, w in zip(got, want)),
                   f"K5 ({fc}, {sr}), segments={segments}, differs from "
                   "its plain version")
    log("validate: K5 equals its plain version for (5, 12), (4, 12) and "
        "(4, 8), on the plan's route and with 3 segments forced")

    n = 28 * 700
    pcm = np.clip(np.cumsum(rng.integers(-900, 900, (2, n)), axis=1),
                  -32768, 32767).astype(np.int16)
    offs, lims = streams.uniform_unit_layout(720, n - 13)
    offs2, lims2 = np.stack([offs, offs]), np.stack([lims, lims])
    units = adpcm_cuda.gather_units_plain(
        torch.from_numpy(pcm).to(dev), torch.from_numpy(offs2).to(dev), 720)
    lim = adpcm_cuda.clip_limits(torch.from_numpy(lims2).to(dev))
    z = torch.zeros(2, dtype=torch.int32, device=dev)
    kw = dict(filter_count=4, shift_range=12)
    want = adpcm_cuda.encode_units_plain(units, lim, z, z, **kw)
    for segments in (None, 1, 4):
        got = adpcm_cuda.encode_units(units, lim, z, z, segments=segments,
                                      **kw)
        expect(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"K5 on two streams of 720 units, segments={segments}, "
               "differs from its plain version")
    card = streams.encode_unit_streams(pcm, offs2, lims2, 4, 12, device=dev)
    host = streams.encode_unit_streams(pcm, offs2, lims2, 4, 12,
                                       device="cpu")
    expect(all(np.array_equal(g, w) for g, w in zip(card, host)),
           "encode_unit_streams on the device differs from the native unit "
           "encoder")
    log("validate: K5 on two streams of 720 units with masked trailing "
        "units equals its plain version (planned, serial and 4 segments) "
        "and encode_unit_streams equals the native unit encoder")


def validate_video(dev, frames, width, height, budget):
    """On the NV21 ``frames`` (host uint8): K1 and K6 against their plain
    versions; for v2 and v3dc, ``fused_mxu`` (K1-K4 and the tail
    emission) against ``blocks`` on the plain versions, then
    ``fused_pallas`` (K7, K9), ``fused_gather`` (K8) and ``blocks_pallas``
    (K6, K9, K10) against ``fused_mxu``: equal scales and equal words up
    to each frame's bits."""
    fr = torch.from_numpy(frames).to(dev)
    n = fr.shape[0]
    budgets = torch.full((n,), budget, dtype=torch.int32, device=dev)
    cap = (budget - 8) // 2
    pix = bs_ops.rearrange_nv21_rows(fr, width, height)
    dc_bits, _ = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pix),
                                  bs_ops.BS_V2)
    thr = bs_ops.ac_threshold(budgets, dc_bits.sum(dim=1, dtype=torch.int32),
                              pix.shape[2])
    got = bs_cuda.select_scale_pix(pix, thr)
    want = bs_cuda.select_scale_pix_plain(pix, thr)
    expect(all(torch.equal(g, w) for g, w in zip(got, want)),
           "K1 differs from its plain version")
    c = bs_ops.pixrows_to_coefs_zz(pix).to(torch.int32).contiguous()
    got = bs_cuda.select_scale(c, thr)
    want = bs_cuda.select_scale_plain(c, thr)
    expect(all(torch.equal(g, w) for g, w in zip(got, want)),
           "K6 differs from its plain version")
    for codec in (bs_ops.BS_V2, bs_ops.BS_V3DC):
        def packed(packer, use_kernels=True):
            return api.bs_encode_frames_packed(
                fr, budgets, codec=codec, width=width, height=height,
                capacity_words=cap, packer=packer, use_kernels=use_kernels)
        ref = packed("fused_mxu")
        for label, out in [("blocks on the plain versions",
                            packed("blocks", use_kernels=False))] + \
                [(p, packed(p)) for p in CHECK_PACKERS]:
            expect(torch.equal(out["scale"], ref["scale"])
                   and words_equal(out["words"], ref["words"],
                                   ref["total_bits"]),
                   f"fused_mxu differs from {label} (codec {codec})")
    log(f"validate: K1 and K6 equal their plain versions on {n} frames; "
        f"fused_mxu equals blocks on the plain versions, and fused_pallas, "
        f"fused_gather and blocks_pallas equal fused_mxu, v2 and v3dc")


def check_video_native(out, frames, codec):
    """A device batch's scales and words against the native frame
    encoder on the same frames (every frame fits its budget)."""
    nat = tiers.bs_encode_frames(
        frames, np.full(len(frames), FRAME_BUDGET, np.int32), codec=codec,
        width=VIDEO_W, height=VIDEO_H, capacity_words=CAP_WORDS)
    expect(np.array_equal(out["scale"].cpu().numpy(), nat["scale"])
           and np.array_equal(out["words"].cpu().numpy().view(np.uint16),
                              nat["words"]),
           f"the device batch (codec {codec}) differs from the native tier")


def check_adpcm_native(out, units, limits, z):
    """The ADPCM batch's headers and sample values against the native
    unit encoder."""
    h, values, _, _ = out
    nh, nv, _, _ = tiers.adpcm_encode_units(units, limits, z, z, 5, 12)
    expect(np.array_equal(h.cpu().numpy(), nh.astype(np.int32))
           and np.array_equal(values.cpu().numpy(), nv.astype(np.int32)),
           "the ADPCM batch differs from the native unit encoder")


# ------------------------------------------------------------ measurements

def video_device(dev, batch, codec, reps, iters, check=False):
    """The device step on ``batch`` noise frames: frames/s by CUDA events
    over ``iters`` back-to-back calls (and the host's clock around them),
    and by a CUDA-graph replay of one call, one of each a repetition."""
    host = noise_frames(batch)
    frames = torch.from_numpy(host).to(dev)
    budgets = torch.full((batch,), FRAME_BUDGET, dtype=torch.int32,
                         device=dev)

    def step():
        return api.bs_encode_frames_packed(
            frames, budgets, codec=codec, width=VIDEO_W, height=VIDEO_H,
            capacity_words=CAP_WORDS)

    out = step()
    if check:
        check_video_native(out, host, codec)
    graph = Graph(step)
    fps = {"events": [], "host": [], "graph": []}
    for _ in range(reps):
        dev_ms, host_ms = events_ms(step, iters)
        fps["events"].append(batch / dev_ms * 1e3)
        fps["host"].append(batch / host_ms * 1e3)
        fps["graph"].append(batch / graph.ms(iters) * 1e3)
    del graph
    return {k: summary(v) for k, v in fps.items()}, (frames, budgets)


def audio_device(dev, reps, iters, check=False):
    """SPU-ADPCM Msamples/s on the ADPCM batch: ``api.spu_encode_batch``
    by CUDA events (and the host's clock), K5 alone by a CUDA-graph
    replay."""
    units, limits, z = adpcm_units(ADPCM_STREAMS, ADPCM_UNITS)
    args = [torch.from_numpy(a).to(dev) for a in (units, limits, z, z)]
    out = api.spu_encode_batch(*args)
    if check:
        check_adpcm_native(out, units, limits, z)
    del out
    samples = units.size
    graph = Graph(lambda: adpcm_cuda.encode_units(
        *args, filter_count=5, shift_range=12))
    msps = {"events": [], "host": [], "graph": []}
    for _ in range(reps):
        dev_ms, host_ms = events_ms(lambda: api.spu_encode_batch(*args),
                                    iters)
        msps["events"].append(samples / dev_ms / 1e3)
        msps["host"].append(samples / host_ms / 1e3)
        msps["graph"].append(samples / graph.ms(iters) / 1e3)
    return {k: summary(v) for k, v in msps.items()}


def video_e2e(dev, reps, iters):
    """End to end through BsFrameEncoder: 16 synthetic frames tiled to
    128, host NV21 frames to frame buffers (H2D, the step, D2H, headers),
    against a serial pass of 32-frame chunks (upload, step, read-back of
    each chunk's words and scales), in interleaved pairs; host frames/s."""
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    batch = HEADLINE_BATCH
    nv21 = np.tile(video_frames(E2E_UNIQUE), (batch // E2E_UNIQUE, 1))
    frame_list = list(nv21)
    sizes = [FRAME_BUDGET] * batch
    budgets = torch.full((SERIAL_CHUNK,), FRAME_BUDGET, dtype=torch.int32,
                         device=dev)
    enc = BsFrameEncoder(bs_ops.BS_V2, VIDEO_W, VIDEO_H, dev)
    expect(enc.tier == "device", f"the encoder's tier is {enc.tier}")

    def pipelined():
        for _ in range(iters):
            enc.encode_frames(frame_list, sizes)

    def serial():
        for _ in range(iters):
            for base in range(0, batch, SERIAL_CHUNK):
                out = api.bs_encode_frames_packed(
                    torch.from_numpy(nv21[base:base + SERIAL_CHUNK]).to(dev),
                    budgets, codec=bs_ops.BS_V2, width=VIDEO_W,
                    height=VIDEO_H, capacity_words=CAP_WORDS)
                out["words"].cpu()
                out["scale"].cpu()

    pipelined()
    serial()
    secs = interleaved({"pipelined": lambda: wall_s(
        pipelined, torch.cuda.synchronize), "serial": lambda: wall_s(
        serial, torch.cuda.synchronize)}, reps)
    enc.close()
    fps = {k: summary([batch * iters / s for s in v])
           for k, v in secs.items()}
    t_serial = statistics.median(secs["serial"])
    gain = 100.0 * (t_serial - statistics.median(secs["pipelined"])) \
        / t_serial
    return fps, gain


def audio_cli_path(dev, reps):
    """One file's two ADPCM streams (20 s of ~37.8 kHz units, XA 4-bit)
    through ``encode_unit_streams``, on the card against the native unit
    encoder on the host, in interleaved pairs; host Msamples/s."""
    from psxavenc_tpu_torch.models import adpcm_stream as streams

    n = 28 * 1350 * CLI_SECONDS
    rng = np.random.default_rng(5)
    pcm = np.clip(np.cumsum(rng.integers(-900, 900, (2, n)), axis=1),
                  -32768, 32767).astype(np.int16)
    offs, lims = streams.uniform_unit_layout(n // 28, n)
    offs2, lims2 = np.stack([offs, offs]), np.stack([lims, lims])

    def run(device):
        return streams.encode_unit_streams(pcm, offs2, lims2, 4, 12,
                                           device=device)

    card = run(dev)                                 # warm-up: K5's build
    calls = tiers.COUNTERS["adpcm_encode_units"]
    host = run("cpu")
    expect(tiers.COUNTERS["adpcm_encode_units"] == calls + 1,
           "the CPU's ADPCM did not run the native unit encoder "
           "(PSXAVENC_NO_NATIVE_ADPCM is set)")
    expect(all(np.array_equal(g, w) for g, w in zip(card, host)),
           "one file's streams on the device differ from the native tier")
    secs = interleaved({"cuda": lambda: wall_s(lambda: run(dev),
                                               torch.cuda.synchronize),
                        "cpu": lambda: wall_s(lambda: run("cpu"),
                                              torch.cuda.synchronize)}, reps)
    return {k: summary([2 * n / s / 1e6 for s in v])
            for k, v in secs.items()}


def batch_runner(dev, reps):
    """32 ``-t spu`` jobs of 2 s at 22,050 Hz through ``batch.run_jobs``
    on the card, grouped against serial, after a warm pass of each, in
    interleaved pairs; files/s. Neither is expected to be faster."""
    from psxavenc_tpu_torch import batch

    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        jobs = []
        for i in range(BATCH_FILES):
            wav = synth.write_wav(
                td / f"j{i}.wav",
                synth.rand_pcm(AUDIO_RATE * BATCH_SECONDS, seed=100 + i),
                AUDIO_RATE)
            jobs.append(["-q", "-t", "spu", "-f", str(AUDIO_RATE), str(wav),
                         str(td / f"j{i}.spu")])

        def run(group):
            rcs = batch.run_jobs(jobs, group=group, quiet=True, device=dev)
            expect(all(rc == 0 for rc in rcs), f"batch runner: {rcs}")

        run(True)
        run(False)
        secs = interleaved({
            "grouped": lambda: wall_s(lambda: run(True),
                                      torch.cuda.synchronize),
            "serial": lambda: wall_s(lambda: run(False),
                                     torch.cuda.synchronize)}, reps)
    return {k: summary([BATCH_FILES / s for s in v])
            for k, v in secs.items()}


def video_native(reps, iters):
    """The native frame encoder on the host's cores (32 synthetic
    frames), frames/s."""
    frames = video_frames(NATIVE_FRAMES)
    budgets = np.full(NATIVE_FRAMES, FRAME_BUDGET, np.int32)

    def run():
        for _ in range(iters):
            tiers.bs_encode_frames(frames, budgets, codec=bs_ops.BS_V2,
                                   width=VIDEO_W, height=VIDEO_H,
                                   capacity_words=CAP_WORDS)

    run()
    return summary([NATIVE_FRAMES * iters / wall_s(run, lambda: None)
                    for _ in range(reps)])


def audio_native(reps, iters):
    """The native unit encoder on the host's cores (64 streams x 500 SPU
    units, bench.py:169), Msamples/s."""
    units, limits, z = adpcm_units(NATIVE_ADPCM_STREAMS, NATIVE_ADPCM_UNITS)

    def run():
        for _ in range(iters):
            tiers.adpcm_encode_units(units, limits, z, z, 5, 12)

    run()
    return summary([units.size * iters / wall_s(run, lambda: None) / 1e6
                    for _ in range(reps)])


def density(frames, budgets):
    """The share of AC levels nonzero at their frame's scale (v2), for
    the speed of light of the emission."""
    sel = api._select_pixels(frames, budgets, bs_ops.BS_V2, VIDEO_W,
                             VIDEO_H, api._KERNELS)
    return rl.nonzero_share(sel["c"], sel["scale_idx"] + 1,
                            sel["dc_code"].shape[1])


# ------------------------------------------------------------ runs

def run_cpu(quick, reps):
    """The native tiers on the host's cores, as bench.py measures a host
    without an accelerator; no CUDA call."""
    at = 1 if quick else 0
    audio = audio_native(reps, ITERS["native_adpcm"][at])
    log(f"native unit encoder: {text(audio, 'Msamples/s')}")
    video = video_native(reps, ITERS["native"][at])
    log(f"native frame encoder: {text(video, 'frames/s')} "
        f"({os.cpu_count()} cores)")
    return {"metric": "BS v2 320x240 encode throughput (frames/sec, the "
                      "native tier on the host's cores)",
            "value": round(video["median"], 2), "unit": "frames/sec",
            "vs_baseline": None, "device": "cpu"}


def run_cuda(quick, reps):
    """Every measurement on card 0 -> (the last line, the details)."""
    from psxavenc_tpu_torch.ops import _build

    at = 1 if quick else 0
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.lib()
    tiers.lib()
    build_s = time.perf_counter() - t0
    log(f"bench device: {name} ({card}); kernels and the native library "
        f"built or loaded in {build_s:.1f} s")

    validate_adpcm(dev)
    validate_video(dev, video_frames(VALIDATE_FRAMES), VIDEO_W, VIDEO_H,
                   FRAME_BUDGET)

    iters = {k: v[at] for k, v in ITERS.items()}
    cli = audio_cli_path(dev, reps)
    log(f"one file's streams: device {text(cli['cuda'], 'Msamples/s')}, "
        f"native {text(cli['cpu'], 'Msamples/s')} (host clock)")
    head, (frames, budgets) = video_device(dev, HEADLINE_BATCH,
                                           bs_ops.BS_V2, reps,
                                           iters["step"], check=True)
    log(f"video device step, B = {HEADLINE_BATCH}: "
        f"{text(head['events'], 'frames/s')} back to back (CUDA events); "
        f"{text(head['graph'], 'frames/s')} as one CUDA graph; host clock "
        f"{text(head['host'], 'frames/s')}")
    sweep = {str(b): video_device(dev, b, bs_ops.BS_V2, reps,
                                  iters["step"])[0] for b in SWEEP_BATCHES}
    sweep[str(HEADLINE_BATCH)] = head
    for b, s in sweep.items():
        log(f"video device step, B = {b}: {text(s['events'], 'frames/s')} "
            f"(events), {text(s['graph'], 'frames/s')} (graph)")
    v3dc = video_device(dev, HEADLINE_BATCH, bs_ops.BS_V3DC, reps,
                        iters["step"], check=True)[0]
    log(f"video device step v3dc: {text(v3dc['events'], 'frames/s')} "
        f"(events), {text(v3dc['graph'], 'frames/s')} (graph)")
    audio = audio_device(dev, reps, iters["adpcm"], check=True)
    log(f"SPU-ADPCM {ADPCM_STREAMS} x {ADPCM_UNITS} units: API "
        f"{text(audio['events'], 'Msamples/s')} (events); K5 "
        f"{text(audio['graph'], 'Msamples/s')} (graph)")
    e2e, gain = video_e2e(dev, reps, iters["e2e"])
    log(f"video end to end: BsFrameEncoder "
        f"{text(e2e['pipelined'], 'frames/s')}, serial 32-frame chunks "
        f"{text(e2e['serial'], 'frames/s')}; gain {gain:.1f}%")
    native = video_native(reps, iters["native"])
    log(f"native frame encoder: {text(native, 'frames/s')} "
        f"({os.cpu_count()} host cores)")
    runner = batch_runner(dev, reps)
    log(f"batch runner, {BATCH_FILES} spu jobs: grouped "
        f"{text(runner['grouped'], 'files/s')}, serial "
        f"{text(runner['serial'], 'files/s')}")

    roofline = {}
    try:
        chip = rl.chip_for(name)
    except ValueError as e:
        log(f"roofline: {e}")
    else:
        dens = density(frames, budgets)
        sol = rl.video_report(1.0, chip, VIDEO_W, VIDEO_H, HEADLINE_BATCH,
                              CAP_WORDS, 0, dens)[0]
        roofline = {"video_sol_ms_per_128": sol, "nonzero_density": dens}
        for key, s in (("video", head["events"]),
                       ("video_graph", head["graph"])):
            ms = HEADLINE_BATCH / s["median"] * 1e3
            roofline[f"{key}_ms_per_128"] = ms
            roofline[f"{key}_pct_of_roofline"] = 100.0 * sol / ms
        a_sol, a_pct = rl.audio_report(audio["events"]["median"], chip)
        roofline.update(audio_sol_msps=a_sol, audio_pct_of_roofline=a_pct,
                        audio_kernel_pct_of_roofline=rl.audio_report(
                            audio["graph"]["median"], chip)[1])
        log(f"roofline: video {roofline['video_ms_per_128']:.4f} ms a batch "
            f"(events) and {roofline['video_graph_ms_per_128']:.4f} (graph) "
            f"against {sol:.4f} ms at the speed of light; audio "
            f"{a_pct:.1f}% of {a_sol:.0f} Msamples/s")

    head_fps = head["events"]["median"]
    details = {
        "device": name,
        "card": card,
        "host_cores": os.cpu_count(),
        "reps": reps,
        "kernel_build_s": build_s,
        "video_fps": e2e["pipelined"],
        "video_fps_serial": e2e["serial"],
        "video_fps_device": head["events"],
        "video_fps_device_graph": head["graph"],
        "video_fps_device_host_clock": head["host"],
        "video_fps_native_cpu": native,
        "audio_msps_device": audio["events"],
        "audio_msps_kernel_graph": audio["graph"],
        "audio_msps_device_host_clock": audio["host"],
        "audio_cli_path_msps": cli,
        "video_e2e_overlap_gain_pct": gain,
        "video_device_batch_sweep_fps": {b: s["events"]
                                         for b, s in sweep.items()},
        "video_device_batch_sweep_fps_graph": {b: s["graph"]
                                               for b, s in sweep.items()},
        "video_fps_device_v3dc": v3dc["events"],
        "video_fps_device_v3dc_graph": v3dc["graph"],
        "batch_runner_files_per_sec": runner,
        "roofline": roofline,
        "reference": "no reference binary in the repo",
        "notes": "video_fps_device (the headline) is the fused_mxu step on "
                 "frames already on the card, back-to-back calls timed by "
                 "CUDA events: the host's enqueue of each step is in it; "
                 "*_graph is the same work replayed as one CUDA graph, the "
                 "card's own time; *_host_clock is the host's clock around "
                 "the same loop; video_fps is end to end through "
                 "BsFrameEncoder from host frames (H2D, D2H and headers "
                 "included); figures are {median, least, greatest} of "
                 "`reps` repetitions, compared pairs interleaved",
    }
    line = {"metric": "BS v2 320x240 encode throughput (frames/sec on the "
                      "device, back-to-back steps)",
            "value": round(head_fps, 2), "unit": "frames/sec",
            "vs_baseline": None,
            "device": name}
    return line, details


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="one repetition of short loops; no details "
                             "file")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu: the native tiers only, no CUDA call")
    args = parser.parse_args(argv)
    reps = 1 if args.quick else REPS
    try:
        if args.device == "cpu":
            line = run_cpu(args.quick, reps)
        else:
            if not torch.cuda.is_available():
                log("bench_torch: no CUDA device; pass --device cpu to "
                    "measure the native tiers on the host")
                return 1
            line, details = run_cuda(args.quick, reps)
            if not args.quick:
                DETAILS.write_text(json.dumps(details, indent=1) + "\n")
    except Mismatch as e:
        log(f"bench_torch: MISMATCH: {e}")
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
