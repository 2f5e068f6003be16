"""Batch tensor API example on PyTorch: encode many streams and frames in
single device calls, and the same step split over several devices.

Run: python examples/torch_batch_api.py [cuda|cpu]   (default: cuda)

On a CUDA device the calls launch the hand-written kernels, and the split
runs over every visible card; on the CPU the kernels' plain versions run
and the split takes the CPU twice.
"""

import pathlib
import sys

import numpy as np
import torch


def main(argv=None):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.ops import bs as bs_ops
    from psxavenc_tpu_torch.parallel import mesh

    argv = sys.argv[1:] if argv is None else argv
    device = torch.device(argv[0] if argv else "cuda")
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(device)

    # --- 256 independent SPU-ADPCM streams, 100 units (2800 samples) each.
    units = rng.integers(-20000, 20000, (256, 100, 28)).astype(np.int32)
    limits = np.full((256, 100), 28, np.int32)
    zero = np.zeros(256, np.int32)
    blocks, p1, p2 = api.spu_encode_blocks(put(units), put(limits),
                                           put(zero), put(zero))
    print("SPU blocks:", tuple(blocks.shape), blocks.dtype)  # (256, 100, 16)

    # --- a batch of BS v2 frames with per-frame byte budgets.
    frames = rng.integers(0, 256, (8, 64 * 64 * 3 // 2)).astype(np.uint8)
    budgets = np.full(8, 4 * 2016, np.int32)
    out = api.bs_encode_frames_packed(put(frames), put(budgets),
                                      codec=bs_ops.BS_V2, width=64,
                                      height=64,
                                      capacity_words=(4 * 2016 - 8) // 2)
    print("BS scales:", out["scale"].tolist())
    print("packed words:", tuple(out["words"].shape), out["words"].dtype)

    # --- the same step split over every visible card (the CPU: twice).
    devices = mesh.make_mesh() if device.type == "cuda" \
        else mesh.make_mesh([device, device])
    step = mesh.encode_step_sharded(devices, codec=bs_ops.BS_V2, width=64,
                                    height=64)
    B = 2 * len(devices)
    codes, bits, hdrs, values, stats = step(
        put(np.tile(frames[:1], (B, 1))),
        put(np.full(B, 4 * 2016, np.int32)),
        put(np.tile(units[:1], (B, 1, 1))),
        put(np.full((B, 100), 28, np.int32)),
        put(np.zeros(B, np.int32)), put(np.zeros(B, np.int32)))
    print(f"split over {len(devices)} device(s) "
          f"({', '.join(str(d) for d in devices)}); stats = "
          f"{stats.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
