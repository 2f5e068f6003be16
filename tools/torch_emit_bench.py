"""Times of the port's emission kernels (K3, K7, the tail emission) on one
CUDA card, for comparing two trees in one process each on the same card.

    python tools/torch_emit_bench.py [--root DIR] [--reps N]

Imports ``psxavenc_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
the tree this file is in), builds the kernels there, checks K3 and K7 (both
coefficient forms) against their plain versions on chip_smoke's phase 3
batch (BS v2 320x240, 128 frames, 18,144-byte budgets) and on phase 4's
first 128 frames (video+noise), and prints one JSON line per measurement:
the kernel's device time from a CUDA-graph replay (chip_smoke.graph_ms), K3's
cycle sections, and the tail emission's time on the video+noise batch, on a
batch without a long block and on a batch of noise frames, each equal to the
exact flat path. Exits nonzero on any mismatch or without a CUDA device.
"""

import argparse
import json
import os
import sys


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_emit_bench: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import _build, bitpack_cuda, bs_cuda
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bs as bs_ops
    from psxavenc_tpu_torch.utils import synth

    card = cs.card_line()
    _build.lib()
    dev = torch.device("cuda", 0)
    budgets = torch.full((cs.B,), cs.BUDGET, dtype=torch.int32, device=dev)

    def say(**row):
        print(json.dumps({"root": args.root, "card": card, **row}),
              flush=True)

    def equal(got, want, what):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{what}: kernel != plain")

    def emit_inputs(host):
        frames = torch.from_numpy(host).to(dev)
        pix, thr = cs.select_inputs(torch, frames, budgets)
        dc_bits, dc_code = bs_ops._dc_stage(bs_ops.dc_quant_from_pixrows(pix),
                                            bs_ops.BS_V2)
        scale, _, _, c64 = bs_cuda.select_scale_pix(pix, thr)
        sidx = torch.where(scale <= 63, scale, 1)
        nb = pix.shape[2]
        c63 = c64[:, :63, :nb].to(torch.int32).contiguous()
        return c64, c63, (sidx, dc_code, dc_bits)

    mixes = {
        "video+noise (phase 3)": cs.smoke_frames(np, synth, cs.B, seed=5),
        "video+noise (phase 4)": cs.phase4_frames(np, synth)[:cs.B],
    }
    for label, host in mixes.items():
        c64, c63, rest = emit_inputs(host)
        prep = lambda: bs_cuda.emit_prep(c64, *rest, eof=0x1FF)
        equal(prep(), bs_cuda.emit_prep_plain(c64, *rest, eof=0x1FF), "K3")
        for form, c in (("int32", c63), ("int16", c64)):
            equal(bs_cuda.emit_pack(c, *rest),
                  bs_cuda.emit_pack_plain(c, *rest), f"K7 {form}")
        for _ in range(args.reps):
            say(mix=label, kernel="emit_prep",
                ms=cs.graph_ms(torch, prep),
                emit_pack_int32_ms=cs.graph_ms(
                    torch, lambda: bs_cuda.emit_pack(c63, *rest)),
                emit_pack_int16_ms=cs.graph_ms(
                    torch, lambda: bs_cuda.emit_pack(c64, *rest)))
        stats = torch.zeros((cs.B, len(bs_cuda.EMIT_STAT_NAMES)),
                            dtype=torch.int32, device=dev)
        bs_cuda.emit_prep(c64, *rest, eof=0x1FF, stats_out=stats)
        torch.cuda.synchronize()
        st = stats.to(torch.float64)
        say(mix=label, kernel="emit_prep cycles, mean over frames",
            **dict(zip(bs_cuda.EMIT_STAT_NAMES, st.mean(dim=0).tolist())),
            slowest_frame_cycles=float(st[:, [0, 3, 4, 5]].sum(dim=1).max()))
        tail_case(torch, cs, api, bs_cuda, bitpack_cuda, bitpack_ops, say,
                  label, c64, rest, args.reps)

    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, (cs.B, cs.W * cs.H * 3 // 2)).astype(
        np.uint8)
    quiet = cs.smoke_frames(np, synth, cs.B, seed=14, noise_every=0)
    for label, host in (("all noise", noise), ("video", quiet)):
        c64, _, rest = emit_inputs(host)
        tail_case(torch, cs, api, bs_cuda, bitpack_cuda, bitpack_ops, say,
                  label, c64, rest, args.reps)
    return 0


def tail_case(torch, cs, api, bs_cuda, bitpack_cuda, bitpack_ops, say, label,
              c64, rest, reps):
    """The tail emission on K3's and K4's output for one batch: equal to
    its plain version and to the exact flat path; its device time."""
    vals32, e0, block_bits, _ = bs_cuda.emit_prep(c64, *rest, eof=0x1FF)
    placed = bitpack_cuda.place_vals(vals32, e0, capacity_words=cs.CAP_WORDS)
    got, count = bs_cuda.emit_tail(placed.clone(), c64, *rest, block_bits,
                                   capacity_words=cs.CAP_WORDS)
    want, _ = bs_cuda.emit_tail_plain(placed, c64, *rest, block_bits,
                                      capacity_words=cs.CAP_WORDS)
    flat = api._overflow_words(c64, rest[0] - 1, rest[2], rest[1], 0x1FF,
                               cs.CAP_WORDS)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(
            bitpack_ops.words_u16(got, cs.CAP_WORDS), flat)):
        raise AssertionError(f"tail emission on {label}: kernel != plain or "
                             "!= the flat path")
    long_blocks = block_bits > 256
    scratch = placed.clone()
    for _ in range(reps):
        say(mix=label, kernel="emit_tail",
            ms=cs.graph_ms(torch, lambda: bs_cuda.emit_tail(
                scratch, c64, *rest, block_bits,
                capacity_words=cs.CAP_WORDS, count=count)),
            long_frames=int(long_blocks.any(dim=1).sum()),
            long_blocks=int(long_blocks.sum()),
            longest_block_bits=int(block_bits.max()))


if __name__ == "__main__":
    sys.exit(main())
