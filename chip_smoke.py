"""Chip smoke run of psxavenc_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, one or more lines each:

1. the card and toolchain;
2. the kernel build (nvcc, from psxavenc_tpu_torch/csrc);
3. each CUDA kernel against its plain PyTorch version at the main path's
   shapes (BS 320x240, 128 frames, 18,144-byte budgets), v2 and v3dc:
   exact equality, kernel and plain times (CUDA events, median);
4. the main path: BsFrameEncoder on the card over 256 frames for v2, v3
   and v3dc, byte-equal to the native C++ tier, every kernel launched;
5. the CLI (-t sbs, -t strv) as subprocesses on a synthetic AVI;
6. frames/s: device, end to end, and the plain path on the card, with a
   torch.profiler breakdown of the device step.

The ptxas report and the profiler tables are written under ``--out``
(default ``smoke_out/``).

Any failure ends the run with a nonzero exit and no result; so does a
machine without a CUDA device. The last three lines are the kernel table
as JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

W, H = 320, 240
B = 128
BUDGET = 18144                       # 9 sectors x 2,016 bytes
CAP_WORDS = (BUDGET - 8 + 1) // 2
MAIN_FRAMES = 256

# (wrapper name, source, TPU kernel it replaces)
KERNELS = [
    ("select_scale_pix", "psxavenc_tpu_torch/csrc/bs_select.cu",
     "psxavenc_tpu/ops/bs_pallas.py:412"),
    ("dc_stage", "psxavenc_tpu_torch/csrc/bs_dc.cu",
     "psxavenc_tpu/ops/bs_pallas.py:542"),
    ("emit_prep", "psxavenc_tpu_torch/csrc/bs_emit.cu",
     "psxavenc_tpu/ops/bs_pallas.py:891"),
    ("place_vals", "psxavenc_tpu_torch/csrc/bitpack_place.cu",
     "psxavenc_tpu/ops/bitpack_pallas.py:315"),
]


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def nv21(np, planes):
    y, cb, cr = planes
    c = np.stack([cr.reshape(H // 2, W // 2), cb.reshape(H // 2, W // 2)],
                 axis=-1).reshape(-1)
    return np.concatenate([y, c]).astype(np.uint8)


def smoke_frames(np, synth, n, seed, noise_every=8):
    """n NV21 frames: synthetic video with every ``noise_every``-th frame
    noise (0: none). Noise frames take the overflow path at 18,144
    bytes."""
    rng = np.random.default_rng(seed)
    out = []
    for i, planes in enumerate(synth.rand_frames(W, H, n, seed=seed)):
        if noise_every and i % noise_every == noise_every - 1:
            out.append(rng.integers(0, 256, W * H * 3 // 2).astype(np.uint8))
        else:
            out.append(nv21(np, planes))
    return np.stack(out)


def time_ms(torch, fn, reps=10):
    """Median milliseconds of fn on the card (CUDA events), after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def native_buffers(np, native, enc, frames, budgets, codec):
    """The native C++ tier's frame buffers, headers added by ``enc``."""
    cap = (max(budgets) - 8 + 1) // 2
    out = native.bs_encode_frames(frames, np.array(budgets, np.int32),
                                  codec=codec, width=W, height=H,
                                  capacity_words=cap)
    return [enc._assemble(int(out["scale"][j]), out["words"][j],
                          int(out["total_bits"][j]), int(out["nz_count"][j]),
                          budgets[j])[0] for j in range(len(frames))]


def check_kernels(torch, np, synth, card):
    """Phase 3: each kernel == its plain version; returns the timings."""
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    dev = torch.device("cuda", 0)
    frames = torch.from_numpy(smoke_frames(np, synth, B, seed=5)).to(dev)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    pix = bs_ops.rearrange_nv21_rows(frames, W, H)
    nb = pix.shape[2]
    dc_q = bs_ops.dc_quant_from_pixrows(pix)
    results = {}

    def compare(name, label, kernel_fn, plain_fn):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                     f"{tuple(w.shape)}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
        ms = time_ms(torch, kernel_fn)
        plain_ms = time_ms(torch, plain_fn, reps=3)
        say(f"[3] {name} {label}: max |kernel - plain| = {err}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (B={B}, {W}x{H}) on "
            f"{card}")
        if err:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version")
        results.setdefault(name, {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms})
        return got

    for codec, label in ((bs_ops.BS_V2, "v2"), (bs_ops.BS_V3DC, "v3dc")):
        if codec == bs_ops.BS_V2:
            dc_bits, dc_code = bs_ops._dc_stage(dc_q, codec)
        else:
            dc_bits, dc_code = compare(
                "dc_stage", label, lambda: bs_cuda.dc_stage(dc_q, codec),
                lambda: bs_cuda.dc_stage_plain(dc_q, codec))
        thr = bs_ops.ac_threshold(
            budgets, dc_bits.sum(dim=1, dtype=torch.int32), nb)
        scale, _, _, coefs = compare(
            "select_scale_pix", label,
            lambda: bs_cuda.select_scale_pix(pix, thr),
            lambda: bs_cuda.select_scale_pix_plain(pix, thr))
        sidx = torch.where(scale <= 63, scale, 1)
        eof = 0x1FF if codec == bs_ops.BS_V2 else 0x3FF
        vals32, e0, _, _ = compare(
            "emit_prep", label,
            lambda: bs_cuda.emit_prep(coefs, sidx, dc_code, dc_bits, eof=eof),
            lambda: bs_cuda.emit_prep_plain(coefs, sidx, dc_code, dc_bits,
                                            eof=eof))
        compare("place_vals", label,
                lambda: bitpack_cuda.place_vals(vals32, e0,
                                                capacity_words=CAP_WORDS),
                lambda: bitpack_cuda.place_vals_plain(
                    vals32, e0, capacity_words=CAP_WORDS))
    return results


def main_path(torch, np, synth, native, card):
    """Phase 4: the encoder on the card == the native tier; returns the
    launch counts of this phase."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda

    frames = smoke_frames(np, synth, MAIN_FRAMES, seed=9)
    budgets = [BUDGET] * MAIN_FRAMES
    for counts in (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES, api.COUNTERS):
        for k in counts:
            counts[k] = 0
    for codec, label in ((0, "v2"), (1, "v3"), (2, "v3dc")):
        enc = BsFrameEncoder(codec, W, H, "cuda")
        got = enc.encode_frames(list(frames), budgets)
        want = native_buffers(np, native, BsFrameEncoder(codec, W, H, "cpu"),
                              frames, budgets, codec)
        bad = [j for j in range(MAIN_FRAMES)
               if got[j][0].tobytes() != want[j].tobytes()]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} frames differ from "
                                 f"the native tier (first {bad[0]})")
        say(f"[4] {label}: {MAIN_FRAMES} frames {W}x{H} byte-equal to the "
            f"native tier; mean quant scale "
            f"{enc.quant_scale_sum / MAIN_FRAMES:.2f}")
    launches = dict(bs_cuda.LAUNCHES, **bitpack_cuda.LAUNCHES)
    say(f"[4] launches in the main path: {launches}; frames on the "
        f"overflow path: {api.COUNTERS['overflow_frames']} of "
        f"{3 * MAIN_FRAMES}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return launches


def cli_phase(np, synth, native, tmp):
    """Phase 5: the port's CLI as a user runs it."""
    from psxavenc_tpu import cli_args as ca
    from psxavenc_tpu.io import ingest
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    n = 40
    avi = os.path.join(tmp, "in.avi")
    synth.write_avi_sized(avi, W, H, synth.rand_frames(W, H, n, seed=12),
                          15)

    def run(argv, platform):
        env = dict(os.environ, PSXAVENC_PLATFORM=platform)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "psxavenc_tpu_torch.cli", "-q", *argv],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"cli {argv} ({platform}) exited "
                                 f"{proc.returncode}: {proc.stderr}")
        return time.time() - t0

    sbs = os.path.join(tmp, "out.sbs")
    secs = run(["-t", "sbs", "-v", "v3dc", avi, sbs], "cuda")
    args = ca.Args()
    assert ca.parse_args(args, ["-t", "sbs", "-v", "v3dc", avi, sbs])
    dec = ingest.open_av_data(
        args, ingest.DECODER_USE_VIDEO | ingest.DECODER_VIDEO_REQUIRED)
    n = dec.video_frame_count
    frames = np.stack(ingest.source_for(dec).take_frames(n))
    want = b"".join(b.tobytes() for b in native_buffers(
        np, native, BsFrameEncoder(2, W, H, "cpu"), frames,
        [args.alignment] * n, 2))
    with open(sbs, "rb") as f:
        if f.read() != want:
            raise AssertionError("cli -t sbs differs from the native tier")
    say(f"[5] cli -t sbs -v v3dc: {n} frames byte-equal to the native tier "
        f"({secs:.1f} s incl. start-up)")

    outs = {}
    for platform in ("cuda", "cpu"):
        outs[platform] = os.path.join(tmp, f"{platform}.str")
        secs = run(["-t", "strv", avi, outs[platform]], platform)
        say(f"[5] cli -t strv on {platform}: {secs:.1f} s incl. start-up")
    with open(outs["cuda"], "rb") as a, open(outs["cpu"], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("cli -t strv: card and cpu bytes differ")
    say("[5] cli -t strv: card bytes == cpu bytes")


def profile_step(torch, step, label, step_ms, card, out_dir, reps=5):
    """Device time by kernel over ``reps`` steps (torch.profiler), against
    the step's CUDA-event time; the full table goes to
    <out_dir>/profile_<label>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(rows.table(sort_by="self_device_time_total", row_limit=40))
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1000 / reps
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    say(f"[6] profile {label}: kernels busy {busy_ms:.3f} ms per step "
        f"({100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms step); "
        "top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / 1000 / reps:.3f} ms"
            for e in top) + f" (on {card})")


def throughput(torch, np, synth, card, out_dir):
    """Phase 6: BS v2 320x240 frames/s at B=128, on synthetic video and
    on the same with every eighth frame noise (overflow path)."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    dev = torch.device("cuda", 0)
    budgets = torch.full((B,), BUDGET, dtype=torch.int32, device=dev)
    for label, noise_every in (("video", 0), ("video+noise", 8)):
        host = smoke_frames(np, synth, B, seed=14, noise_every=noise_every)
        frames = torch.from_numpy(host).to(dev)

        def step(use_kernels=True):
            return api.bs_encode_frames_packed(
                frames, budgets, codec=0, width=W, height=H,
                capacity_words=CAP_WORDS, use_kernels=use_kernels)

        before = api.COUNTERS["overflow_frames"]
        step()
        overflow = api.COUNTERS["overflow_frames"] - before
        ms = time_ms(torch, step, reps=20)
        say(f"[6] {label} device: {B / ms * 1000:.1f} frames/s ({ms:.4f} ms "
            f"per {B}-frame batch, kernels + glue, no H2D; {overflow} of "
            f"{B} frames on the overflow path) on {card}")
        profile_step(torch, step, label.replace("+", "_"), ms, card, out_dir)
        plain_ms = time_ms(torch, lambda: step(False), reps=3)
        say(f"[6] {label} plain path on the card: "
            f"{B / plain_ms * 1000:.1f} frames/s ({plain_ms:.4f} ms per "
            f"batch) on {card}")

        enc = BsFrameEncoder(0, W, H, dev)
        frame_list = list(np.concatenate([host] * 8))
        enc.encode_frames(frame_list[:B], [BUDGET] * B)         # warm-up
        t0 = time.perf_counter()
        enc.encode_frames(frame_list, [BUDGET] * len(frame_list))
        dt = time.perf_counter() - t0
        say(f"[6] {label} end to end: {len(frame_list) / dt:.1f} frames/s "
            f"({len(frame_list)} frames, H2D + device + D2H + headers) on "
            f"{card}")


def main():
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="smoke_out",
                        help="directory for the ptxas report and profiles")
    out_dir = parser.parse_args().out

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from psxavenc_tpu import native
    from psxavenc_tpu.utils import synth
    from psxavenc_tpu_torch.ops import _build

    card = card_line()
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    try:
        import triton
        has_triton = f"triton {triton.__version__}"
    except ImportError:
        has_triton = "no triton"
    say(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {has_triton} | nvcc: "
        f"{nvcc_ver.splitlines()[-1]}")

    t0 = time.time()
    _build.lib()
    say(f"[2] built {', '.join(_build.SOURCES)} in {time.time() - t0:.1f} s")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(_build.build_log)

    timings = check_kernels(torch, np, synth, card)
    launches = main_path(torch, np, synth, native, card)
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(np, synth, native, tmp)
    throughput(torch, np, synth, card, out_dir)

    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **timings[name]}
               for name, source, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
