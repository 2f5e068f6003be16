"""Device times of the port's kernels on one CUDA card, through
chip_smoke.py's own inputs and checks, without the rest of the smoke.

    python tools/torch_kernel_bench.py
        [--kernels dc,pack,emit,small,select,adpcm] [--reps N] [--tree DIR]

dc: K2 on phase 3's batch (BS 320x240, 128 frames, v3dc) and chip_smoke's
further K2 cases (v3, all ties, 640x480) beside the floor of a launch.
pack: K10 on phase 10's symbols (128 frames of 1,801 blocks of 65 symbols,
int32), its GB/s and cycle sections, and the adversarial rows. emit: K3
(with its cycle sections), K7 in both coefficient forms and the tail
emission on phase 3's and phase 4's video+noise batches, on noise frames
and on video frames without noise. small: K4, K8, K9 (its u16 wrapper, and
its u32 entry point beside one scatter_add_ where the tree has one) and
the tail emission at one and at ten calls a graph, beside an empty launch
of each one's grid (see small_rows). select: K1 on phase 3's batches
(v2 and v3dc) and K6 on the FDCT coefficients of the same pixels and on
phase 10's symbols. adpcm: K5 at 4,096 x 1,000 SPU units (its first 64
units held to the plain version) and on the two streams of a 60 s stereo
37,800 Hz XA track of synthetic audio and of a 440 Hz tone at 30,000
(81,000 units each, held to the native C++ unit encoder), with ms, bound,
% of the bound and ns a unit, each beside the serial route
(segments=1), and the batch's first 512, 1,024, 2,048 and 4,096 streams
on the plan's route and at 1, 2 and 4 segments a stream (ports
tools/audio_kernel_bench.py). --tree measures another checkout's
package (for example the parent commit unpacked under build/) with this
checkout's checks and timers (it needs that package's
``utils/roofline.py`` with its ``*_work`` functions, which chip_smoke.py
imports); where that package
names no launch grid, the empty launches are left out. Each kernel is held to its plain version as
chip_smoke holds it (a mismatch raises) and timed as its rows are
(``chip_smoke.graph_ms``); chip_smoke's lines are printed as they come, and
one JSON line per case and repetition holds the case's rows. Exits 1
without a CUDA device. To compare two commits, run each one's own
chip_smoke.py in one chip call.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dc_rows(torch, np, synth, cs, card):
    from psxavenc_tpu_torch.ops import bs as bs_ops

    frames = torch.from_numpy(cs.smoke_frames(np, synth, cs.B, seed=5))
    dc_q = bs_ops.dc_quant_from_pixrows(
        bs_ops.rearrange_nv21_rows(frames.cuda(), cs.W, cs.H))
    rows = {}
    cs.check_dc(torch, rows, card, dc_q)
    cs.dc_checks(torch, np, synth, card, rows["dc_stage"], dc_q)
    yield "phase 3", rows


def pack_rows(torch, np, synth, cs, card):
    from psxavenc_tpu_torch.ops import bs_cuda

    _, c, thr, dc_bits, dc_code = cs.symbol_inputs(torch, np, synth)
    scale = bs_cuda.select_scale(c, thr)[0]
    rows = {}
    cs.check_pack(torch, rows, card, c,
                  (torch.where(scale <= 63, scale, 1), dc_code, dc_bits))
    yield "phase 10", rows


def emit_rows(torch, np, synth, cs, card):
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    rng = np.random.default_rng(3)
    mixes = {
        "video+noise (phase 3)": cs.smoke_frames(np, synth, cs.B, seed=5),
        "video+noise (phase 4)": cs.phase4_frames(np, synth)[:cs.B],
        "all noise": rng.integers(0, 256, (cs.B, cs.W * cs.H * 3 // 2))
        .astype(np.uint8),
        "video": cs.smoke_frames(np, synth, cs.B, seed=14, noise_every=0),
    }
    budgets = torch.full((cs.B,), cs.BUDGET, dtype=torch.int32,
                         device="cuda")
    for label, host in mixes.items():
        pix, thr = cs.select_inputs(torch, torch.from_numpy(host).cuda(),
                                    budgets)
        dc_bits, dc_code = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pix),
                                            bs_ops.BS_V2)
        scale, _, _, c64 = bs_cuda.select_scale_pix(pix, thr)
        sidx = torch.where(scale <= 63, scale, 1)
        nb = pix.shape[2]
        args = (sidx, dc_code, dc_bits)
        rows = {}
        vals32, e0, block_bits, _ = cs.compare(
            torch, rows, "bench", "emit_prep", label,
            lambda: bs_cuda.emit_prep(c64, *args, eof=0x1FF),
            lambda: bs_cuda.emit_prep_plain(c64, *args, eof=0x1FF),
            cs.emit_work_of(cs.rl.emit_prep_work, c64, sidx, nb), card)
        cs.emit_stats_line(torch, "bench", c64, args, 0x1FF, card)
        c63 = c64[:, :63, :nb].to(torch.int32).contiguous()
        for form, c in (("(63, NB) int32", c63), ("(64, nb_pad) int16", c64)):
            row = {}
            cs.compare(torch, row, "bench", "emit_pack", f"{label}, {form}",
                       lambda: bs_cuda.emit_pack(c, *args),
                       lambda: bs_cuda.emit_pack_plain(c, *args),
                       cs.emit_work_of(cs.rl.emit_pack_work, c, sidx, nb),
                       card)
            rows[f"emit_pack {form}"] = row["emit_pack"]
        placed = bitpack_cuda.place_vals(vals32, e0,
                                         capacity_words=cs.CAP_WORDS)
        cs.check_tail(torch, rows, "bench", label, placed, c64, args,
                      block_bits, 0x1FF, card)
        yield label, rows


def _grid(module, name, **kw):
    """A wrapper's launch grid, or None where its module does not name it
    (a tree read with --tree may predate the grid functions); each grid
    function is given the keywords its signature names (a tree's K9 grid
    may take the blocks, ``nbe``, or the capacity)."""
    import inspect

    fn = getattr(module, name, None)
    if fn is None:
        return None
    names = inspect.signature(fn).parameters
    return fn(**{k: v for k, v in kw.items() if k in names})


def small_rows(torch, np, synth, cs, card):
    """K4, K8, K9 and the tail emission at one and at ten calls a graph,
    on phase 3's video+noise batch, on it with frame 5 unfittable and on
    noise frames (no block over 256 bits)."""
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    rng = np.random.default_rng(3)
    video = torch.from_numpy(cs.smoke_frames(np, synth, cs.B, seed=5)).cuda()
    noise = torch.from_numpy(rng.integers(
        0, 256, (cs.B, cs.W * cs.H * 3 // 2)).astype(np.uint8)).cuda()
    budgets = torch.full((cs.B,), cs.BUDGET, dtype=torch.int32,
                         device="cuda")
    unfit = budgets.clone()
    unfit[cs.UNFIT_FRAME] = cs.UNFIT_BUDGET
    cases = (("video+noise (phase 3)", video, budgets),
             ("video+noise, frame 5 unfittable", video, unfit),
             ("all noise", noise, budgets))
    kw = dict(capacity_words=cs.CAP_WORDS)
    for label, frames, bud in cases:
        pix, thr = cs.select_inputs(torch, frames, bud)
        dc_bits, dc_code = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pix),
                                            bs_ops.BS_V2)
        scale, _, _, c64 = bs_cuda.select_scale_pix(pix, thr)
        args = (torch.where(scale <= 63, scale, 1), dc_code, dc_bits)
        vals32, e0, block_bits, _ = bs_cuda.emit_prep(c64, *args, eof=0x1FF)
        b, nbe = e0.shape
        lib_fn, _ = cs.scatter_add_call(torch, vals32, e0)
        rows = {}
        placed = cs.compare(
            torch, rows, "bench", "place_vals", label,
            lambda: bitpack_cuda.place_vals(vals32, e0, **kw),
            lambda: bitpack_cuda.place_vals_plain(vals32, e0, **kw),
            cs.place_work_of(e0), card, library_fn=lib_fn,
            grid=_grid(bitpack_cuda, "place_vals_grid", batch=b,
                       capacity_words=cs.CAP_WORDS))
        cs.compare(
            torch, rows, "bench", "place_vals_gather", label,
            lambda: bitpack_cuda.place_vals_gather(vals32, e0, **kw),
            lambda: bitpack_cuda.place_vals_gather_plain(vals32, e0, **kw),
            cs.place_work_of(e0), card, library_fn=lib_fn,
            grid=_grid(bitpack_cuda, "place_vals_gather_grid", batch=b,
                       capacity_words=cs.CAP_WORDS))
        cs.tail_compare(torch, rows, "bench", label, placed, c64, args,
                        block_bits, card,
                        _grid(bs_cuda, "emit_tail_grid", batch=b))
        streams, bb = bitpack_ops.with_eof_block(
            *bs_cuda.emit_pack(c64, *args), 0x1FF)
        goff = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb
        total = goff[:, -1] + bb[:, -1]
        k9_grid = _grid(bitpack_cuda, "place_streams_grid", batch=b,
                        nbe=nbe, capacity_words=cs.CAP_WORDS)
        cs.compare(
            torch, rows, "bench", "place_streams", f"{label}, u16 values",
            lambda: bitpack_cuda.place_streams(streams, goff, total, **kw),
            lambda: bitpack_cuda.place_streams_plain(streams, goff, total,
                                                     **kw),
            cs.place_streams_work_of(goff), card, grid=k9_grid, ten=True)
        if hasattr(bitpack_cuda, "place_streams_u32"):
            vals, e0s = bitpack_ops.streams_to_u32(streams, goff)
            lib_fn, _ = cs.scatter_add_call(
                torch, bitpack_ops.u32_to_i32(vals), e0s)
            row = {}
            cs.compare(
                torch, row, "bench", "place_streams", f"{label}, u32 words",
                lambda: bitpack_cuda.place_streams_u32(streams, goff, **kw),
                lambda: bitpack_cuda.place_streams_u32_plain(streams, goff,
                                                             **kw),
                cs.place_streams_work_of(goff), card, library_fn=lib_fn,
                grid=k9_grid, ten=True)
            rows["place_streams_u32"] = row["place_streams"]
        yield label, rows


def select_rows(torch, np, synth, cs, card):
    """K1 and K6 on phase 3's batches, K6 also on phase 10's symbols."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bs_cuda
    from psxavenc_tpu_torch.ops import bs as bs_ops

    frames = torch.from_numpy(cs.smoke_frames(np, synth, cs.B,
                                              seed=5)).cuda()
    budgets = torch.full((cs.B,), cs.BUDGET, dtype=torch.int32,
                         device="cuda")
    for codec, label in ((bs_ops.BS_V2, "v2"), (bs_ops.BS_V3DC, "v3dc")):
        # K1's inputs as the step makes them: its stages before K1.
        stages = api.step_stages(codec=codec, width=cs.W, height=cs.H,
                                 capacity_words=cs.CAP_WORDS)
        upto = [name for name, _ in stages].index("k1")
        state = api.run_stages(stages[:upto], {"frames": frames,
                                               "budgets": budgets})
        pix, thr = state["pix"], state["thr"]
        nb = pix.shape[2]
        c = bs_ops.pixrows_to_coefs_zz(pix).contiguous()
        rows = {}
        cs.compare(torch, rows, "bench", "select_scale_pix",
                   f"phase 3, {label}",
                   lambda: bs_cuda.select_scale_pix(pix, thr),
                   lambda: bs_cuda.select_scale_pix_plain(pix, thr),
                   cs.select_work_of(torch, nb, True), card)
        cs.compare(torch, rows, "bench", "select_scale",
                   f"phase 3's pixels as coefficient rows, {label}",
                   lambda: bs_cuda.select_scale(c, thr),
                   lambda: bs_cuda.select_scale_plain(c, thr),
                   cs.select_work_of(torch, nb, False), card)
        yield f"phase 3, {label}", rows
    _, c, thr, _, _ = cs.symbol_inputs(torch, np, synth)
    rows = {}
    cs.compare(torch, rows, "bench", "select_scale", "phase 10",
               lambda: bs_cuda.select_scale(c, thr),
               lambda: bs_cuda.select_scale_plain(c, thr),
               cs.select_work_of(torch, c.shape[2], False), card)
    yield "phase 10", rows


def adpcm_rows(torch, np, synth, cs, card):
    """K5 at 4,096 x 1,000 SPU units, on a 60 s stereo XA track of
    synthetic audio and of a 440 Hz tone, each beside the serial route
    (segments=1), and the plan over the batch's first B streams."""
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.ops import adpcm_cuda

    dev = torch.device("cuda", 0)
    n = cs.ADPCM_CHECK_UNITS
    batch_host = cs.adpcm_units(np, synth, cs.ADPCM_STREAMS,
                                cs.ADPCM_UNITS)
    plan = getattr(adpcm_cuda, "plan_segments", None)

    def plain_head(host, args, out, fc, sr):
        head = [a[:, :n].contiguous() for a in args[:2]] + args[2:]
        return (tuple(o[:, :n] for o in out),
                adpcm_cuda.encode_units_plain(*head, filter_count=fc,
                                              shift_range=sr))

    def native(host, args, out, fc, sr):
        return ((out[0], adpcm_cuda.unpack_words(out[1], sr), *out[2:]),
                tiers.adpcm_encode_units(*host, fc, sr))

    cases = (("4,096 x 1,000 SPU units", batch_host, 5, 12, plain_head,
              f"the plain version on the first {n} units"),
             ("60 s stereo XA track, 2 x 81,000 units",
              cs.xa_track_units(np, synth), 4, 12, native,
              "the native C++ unit encoder"),
             ("60 s stereo XA 440 Hz tone, 2 x 81,000 units",
              cs.tone_track_units(np, _with_tone(synth)), 4, 12, native,
              "the native C++ unit encoder"))
    for label, host, fc, sr, reference, check in cases:
        args = [torch.from_numpy(a).to(dev) for a in host]

        def kernel_fn(**kw):
            return adpcm_cuda.encode_units(*args, filter_count=fc,
                                           shift_range=sr, **kw)

        out = kernel_fn()
        B, T = args[1].shape
        got, want = reference(host, args, out, fc, sr)
        err = max(int((torch.as_tensor(g).to("cpu", torch.int64)
                       - torch.as_tensor(w).to("cpu", torch.int64))
                      .abs().max()) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"K5 on {label} differs from {check}")
        ms = cs.graph_ms(torch, kernel_fn, reps=5)
        serial_ms = cs.graph_ms(
            torch, lambda: kernel_fn(segments=1), reps=3) if plan else None
        bound_ms, bound_by = cs.rl.bound(*cs.rl.adpcm_work(
            B, T, fc, out[1].shape[2]))
        serial = (f"; segments=1 {serial_ms:.4f} ms, the plan's "
                  f"{plan(B, T)} segments a stream "
                  f"{ms / serial_ms:.4f}x of it" if plan else "")
        print(f"[bench] adpcm_encode_units ({fc}, {sr}) {label}: equal to "
              f"{check}; kernel {ms:.4f} ms on the device (graph replay), "
              f"bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.2f}% of the bound; "
              f"{ms * 1e6 / (B * T):.2f} ns a unit, {ms * 1e6 / T:.1f} ns "
              f"a unit of one stream{serial}, on {card}", flush=True)
        yield label, {"adpcm_encode_units": {
            "max_abs_err": err, "ms": ms, "serial_ms": serial_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "pct_of_bound": 100 * bound_ms / ms,
            "ns_per_unit": ms * 1e6 / (B * T),
            "ns_per_stream_unit": ms * 1e6 / T}}
    if not plan:
        return
    args = [torch.from_numpy(a).to(dev) for a in batch_host]
    for B in PLAN_STREAMS:
        sub = [a[:B].contiguous() for a in args]
        times = {segs: cs.graph_ms(torch, lambda: adpcm_cuda.encode_units(
            *sub, filter_count=5, shift_range=12, segments=segs), reps=10)
            for segs in (None, 1, 2, 4)}
        text = ", ".join(f"{'plan' if k is None else k}: {v:.4f} ms"
                         for k, v in times.items())
        print(f"[bench] adpcm_encode_units (5, 12) {B} x "
              f"{cs.ADPCM_UNITS} SPU units, the plan's "
              f"{plan(B, cs.ADPCM_UNITS)} segments a stream; by segments a "
              f"stream in a CUDA graph: {text}, on {card}", flush=True)
        yield f"{B} x {cs.ADPCM_UNITS} SPU units", {"adpcm_encode_units": {
            "plan_segments": plan(B, cs.ADPCM_UNITS),
            "ms_by_segments": {str(k): v for k, v in times.items()}}}


def _with_tone(synth):
    """``synth``, or this checkout's where the measured tree's has no
    ``tone`` (a tree from before it)."""
    if hasattr(synth, "tone"):
        return synth
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_synth", os.path.join(ROOT, "psxavenc_tpu_torch", "utils",
                                    "synth.py"))
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return own


# The batch sizes of the plan's sweep (adpcm_rows).
PLAN_STREAMS = (512, 1024, 2048, 4096)


GROUPS = {"dc": dc_rows, "pack": pack_rows, "emit": emit_rows,
          "small": small_rows, "select": select_rows, "adpcm": adpcm_rows}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default=",".join(GROUPS),
                        help="comma-separated groups of " + ", ".join(GROUPS))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--tree", default=ROOT,
                        help="the checkout whose psxavenc_tpu_torch is "
                        "measured (default: this one); chip_smoke.py's "
                        "checks and timers are this checkout's")
    args = parser.parse_args()
    groups = args.kernels.split(",")
    if not set(groups) <= set(GROUPS):
        parser.error(f"--kernels: choose from {', '.join(GROUPS)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 1

    import importlib.util

    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from psxavenc_tpu_torch.ops import _build
    from psxavenc_tpu_torch.utils import synth

    card = cs.card_line()
    _build.lib()
    for rep in range(args.reps):
        for group in groups:
            for case, rows in GROUPS[group](torch, np, synth, cs, card):
                print(json.dumps({"rep": rep, "group": group, "case": case,
                                  "card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
