"""Stage profile of the port's video step on one CUDA card: where the
device time of ``api.bs_encode_frames_packed`` (``fused_mxu`` with the
kernel sweep, the main path) goes.

    python tools/torch_profile_stages.py [--codecs v2,v3,v3dc]
        [--mixes video,video+noise,noise] [--reps N]

Each stage of the step (``api.step_stages``, the stages the step itself
runs: the NV21 rearrangement, the DC sums and K2, K1, K3, K4, the tail
emission, and the glue between them) is captured alone as a CUDA graph
on the inputs the stages before it made and timed as chip_smoke.py times
a kernel row (``graph_ms``); the whole
step is timed the same way, and "the rest" is the whole step less the
named stages (the glue, and what one graph saves over several). Inputs
are chip_smoke.py's phase 6: BS 320x240, B = 128 frames of synthetic
video, video with every eighth frame noise, or noise, 18,144-byte
budgets. Prints one line per stage and one JSON line per (codec, mix,
repetition), beside the card's name and power limit. Exits 1 without a
CUDA device. Ports tools/profile_video.py and tools/profile_stages.py of
psxavenc_tpu.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = {"v2": 0, "v3": 1, "v3dc": 2}
MIXES = ("video", "video+noise", "noise")
# The stages whose times are named in the profile, with their labels; the
# others (``api.step_stages``' glue) are timed alone too and counted in
# "the rest".
NAMED = ("nv21", "dc", "k1", "k3", "k4", "tail")
LABELS = {"nv21": "NV21 rearrangement", "dc": "DC sums and K2",
          "threshold": "glue: AC threshold",
          "k1": "K1 (FDCT + scale search)",
          "totals": "glue: scale index, totals",
          "k3": "K3 (emission + placement prep)", "k4": "K4 (placement)",
          "tail": "tail emission", "words": "glue: u16 words"}


def label(name, codec):
    if name == "dc" and codec == 0:
        return "DC sums and the DC stage (v2: no kernel)"
    return LABELS[name]


def state_before(api, stages, frames, budgets, name):
    """The state after running the stages before the one named ``name``."""
    upto = [n for n, _ in stages].index(name)
    return api.run_stages(stages[:upto], {"frames": frames,
                                          "budgets": budgets})


def profile(torch, cs, codec, frames, budgets):
    """{stage: ms} for one batch, with "step" and "rest"."""
    from psxavenc_tpu_torch import api

    kw = dict(codec=codec, width=cs.W, height=cs.H,
              capacity_words=cs.CAP_WORDS)
    stages = api.step_stages(**kw)
    if set(LABELS) != {name for name, _ in stages}:
        raise AssertionError("api.step_stages' stages are not the "
                             "profile's")
    ms = {}
    for name, fn in stages:
        before = state_before(api, stages, frames, budgets, name)
        ms[name] = cs.graph_ms(torch, lambda: fn(dict(before)))
    ms["step"] = cs.graph_ms(torch, lambda: api.bs_encode_frames_packed(
        frames, budgets, **kw))
    ms["rest"] = ms["step"] - sum(ms[n] for n in NAMED)
    return stages, ms


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--codecs", default=",".join(CODECS))
    parser.add_argument("--mixes", default=",".join(MIXES))
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    codecs = args.codecs.split(",")
    mixes = args.mixes.split(",")
    if not set(codecs) <= set(CODECS) or not set(mixes) <= set(MIXES):
        parser.error(f"--codecs from {', '.join(CODECS)}, --mixes from "
                     f"{', '.join(MIXES)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_stages: no CUDA device", file=sys.stderr)
        return 1

    import importlib.util

    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from psxavenc_tpu_torch.ops import _build
    from psxavenc_tpu_torch.utils import synth

    card = cs.card_line()
    _build.lib()
    dev = torch.device("cuda", 0)
    budgets = torch.full((cs.B,), cs.BUDGET, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(3)
    hosts = {
        "video": cs.smoke_frames(np, synth, cs.B, seed=14, noise_every=0),
        "video+noise": cs.smoke_frames(np, synth, cs.B, seed=14,
                                       noise_every=8),
        "noise": rng.integers(0, 256, (cs.B, cs.W * cs.H * 3 // 2))
        .astype(np.uint8)}
    for rep in range(args.reps):
        for codec_name in codecs:
            for mix in mixes:
                frames = torch.from_numpy(hosts[mix]).to(dev)
                stages, ms = profile(torch, cs, CODECS[codec_name], frames,
                                     budgets)
                head = f"[stages] {codec_name} {mix}, B = {cs.B}, rep {rep}"
                for name, _ in stages:
                    print(f"{head}: {label(name, CODECS[codec_name])} "
                          f"{ms[name]:.4f} ms", flush=True)
                named = sum(ms[n] for n in NAMED)
                print(f"{head}: whole step {ms['step']:.4f} ms in one graph;"
                      f" named stages {named:.4f} ms; the rest (glue and "
                      f"what one graph saves) {ms['rest']:.4f} ms on {card}",
                      flush=True)
                print(json.dumps({"rep": rep, "codec": codec_name,
                                  "mix": mix, "batch": cs.B, "card": card,
                                  "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
