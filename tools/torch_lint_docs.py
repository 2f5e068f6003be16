#!/usr/bin/env python
"""Doc-consistency lint of the PyTorch/CUDA port: the port's claims must
match its artifacts. The port's counterpart of tools/lint_docs.py.

    python tools/torch_lint_docs.py

Checks, each read from the port's files:
  1. The swresample bank count of psxavenc_tpu_torch/data/swr_banks.npz
     matches the "N probed ratio banks" claim in COVERAGE.md and the "N
     shipped pairs" claim in PARITY.md.
  2. PARITY.md describes the streaming tier as covering all containers.
  3. The README port section's "~N frames/s device-side (card)" figure is
     within 25% of BENCH_TORCH_DETAILS.json's video_fps_device_graph
     median (the step as one CUDA graph: the card's own time; the
     headline, back-to-back calls, is the host's enqueue rate and moves
     with the host), when that file exists, and names the card the file
     was measured on.
  4. The same for its "~N Msamples/s device-side (card)" figure against
     audio_msps_device (``api.spu_encode_batch``, whose 3 ms of card work
     a call outlast its enqueue).
  5. Every bound of PERF.md section 6's kernel table ("bound ms (by)")
     equals psxavenc_tpu_torch/utils/roofline.py's bound for that row's
     shapes (``rows`` below), to the printed digits, and says what
     bounds it.
Exit 0 = consistent, 1 = drift (each failure printed).
"""
import importlib.util
import json
import pathlib
import re
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "psxavenc_tpu_torch"
DRIFT = 0.25


def _roofline():
    """utils/roofline.py loaded from its file (it imports nothing at load
    time), so that the lint needs no torch."""
    spec = importlib.util.spec_from_file_location(
        "torch_roofline", PORT / "utils" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The shapes of PERF.md section 6's rows, as chip_smoke.py runs them: BS v2
# 320x240, B = 128, 18,144-byte budgets (capacity 9,068 u16 words), NB =
# 1,800 blocks, padded to 2,048 in K1's int16 coefficients (the NV21
# kernel makes the pixel rows and DCs of those frames); K5 on 4,096
# streams x 64 units (5, 12) and on a 60 s stereo XA track (2 x 81,000
# units, (4, 12)), four packed words a unit. The counts that the data
# sets: K1 two scale evaluations a frame; K6 two on each of phase 10's
# frames but the unfittable one, which takes one; the emission at
# utils/roofline.py's nonzero density. Each entry lists the (bytes,
# operations) of each figure of the row's cell, in its order, from
# utils/roofline.py's work function for the kernel.
B, NB, NB_PAD, CAP = 128, 1800, 2048, 9068


def rows(rl):
    cap32, nbe = (CAP + 1) // 2, NB + 1
    nonzero = rl.NONZERO_DENSITY * 63 * B * NB
    int16_coefs, int32_coefs = B * 64 * NB_PAD * 2, B * 63 * NB * 4
    return {
        "nv21": [rl.nv21_pix_dc_work(B, 320, 240)],
        "K1": [rl.fdct_select_work(B, NB, NB_PAD, rl.EVALS_PER_FRAME * B)],
        "K2": [rl.dc_work(B, NB)],
        "K3": [rl.emit_prep_work(B, NB, int16_coefs, nonzero)],
        "K4": [rl.place_work(B, nbe, cap32)],
        "K5": [rl.adpcm_work(4096, 64, 5, 4)],
        "K5, one file": [rl.adpcm_work(2, 81000, 4, 4)],
        "K6": [rl.select_work(B, NB, 2 * B - 1)],
        "K7": [rl.emit_pack_work(B, NB, int32_coefs, nonzero),
               rl.emit_pack_work(B, NB, int16_coefs, nonzero)],
        "K8": [rl.place_work(B, nbe, cap32)],
        "K9": [rl.place_streams_work(B, nbe, cap32),
               rl.place_streams_work(B, nbe, CAP)],
        "K10": [rl.pack_work(B, nbe, 65)],
        "tail": [rl.tail_work(B, NB)],
    }


def section(text, heading):
    """The text of the markdown section whose heading starts with
    ``heading``, up to the next heading of its level or above."""
    level = len(heading) - len(heading.lstrip("#"))
    m = re.search(rf"^{re.escape(heading)}.*$", text, re.M)
    if m is None:
        return None
    end = re.search(rf"^#{{1,{level}}} ", text[m.end():], re.M)
    return text[m.end():m.end() + end.start()] if end else text[m.end():]


def check_banks(fails):
    banks = np.load(PORT / "data" / "swr_banks.npz")
    n_banks = len({k.rsplit("_", 1)[0] for k in banks.keys()
                   if not k.startswith("mix_")})
    for doc, pattern, what in (("COVERAGE.md", r"(\d+) probed ratio banks",
                                "banks"),
                               ("PARITY.md", r"(\d+) shipped pairs",
                                "pairs")):
        m = re.search(pattern, (REPO / doc).read_text())
        if m is None:
            fails.append(f"{doc}: no '{pattern}' claim")
        elif int(m.group(1)) != n_banks:
            fails.append(f"{doc} claims {m.group(1)} {what}, the port's "
                         f"npz ships {n_banks}")
    if "all containers) switches" not in (REPO / "PARITY.md").read_text():
        fails.append("PARITY.md streaming-tier note regressed from 'all "
                     "containers'")
    return n_banks


def check_readme(fails):
    details = REPO / "BENCH_TORCH_DETAILS.json"
    if not details.exists():
        return
    bench = json.loads(details.read_text())
    port = section((REPO / "README.md").read_text(), "## PyTorch/CUDA port")
    if port is None:
        fails.append("README.md: no '## PyTorch/CUDA port' section")
        return
    for unit, key in (("frames/s", "video_fps_device_graph"),
                      ("Msamples/s", "audio_msps_device")):
        m = re.search(rf"~([\d,]+)\s+{re.escape(unit)}\s+device-side\s+"
                      r"\(([^)]*)\)", port)
        if m is None:
            fails.append(f"README port section: no '~N {unit} device-side "
                         "(card)' claim")
            continue
        claimed = float(m.group(1).replace(",", ""))
        measured = bench[key]["median"]
        if abs(claimed - measured) / measured >= DRIFT:
            fails.append(f"README port section claims ~{claimed:,.0f} "
                         f"{unit} device-side, BENCH_TORCH_DETAILS.json "
                         f"says {measured:,.0f}")
        beside = " ".join(m.group(2).split())
        if bench["device"] not in beside:
            fails.append(f"README port section's {unit} figure stands "
                         f"beside '{beside}', not the card it was "
                         f"measured on ({bench['device']})")


def check_bounds(fails, rl):
    findings = section((REPO / "PERF.md").read_text(), "## 6.")
    if findings is None:
        fails.append("PERF.md: no section 6")
        return 0
    lines = findings.splitlines()
    first = next((i for i, line in enumerate(lines)
                  if line.startswith("|")), len(lines))
    table = []
    for line in lines[first:]:
        if not line.startswith("|"):
            break
        table.append(line)
    if len(table) < 3:
        fails.append("PERF.md section 6: no kernel table")
        return 0
    cells = [c.strip() for c in table[0].strip("|").split("|")]
    if "bound ms (by)" not in cells:
        fails.append("PERF.md section 6: no 'bound ms (by)' column")
        return 0
    col = cells.index("bound ms (by)")
    specs = rows(rl)
    checked = 0
    for line in table[2:]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        key, cell = cells[0], cells[col]
        if key not in specs:
            fails.append(f"PERF.md section 6: no shapes for row {key!r}")
            continue
        printed = re.findall(r"\d+\.\d+", cell)
        if len(printed) != len(specs[key]):
            fails.append(f"PERF.md section 6, {key}: {len(printed)} bounds "
                         f"printed, {len(specs[key])} expected ({cell!r})")
            continue
        for i, (text, (n_bytes, ops)) in enumerate(zip(printed,
                                                       specs[key])):
            ms, by = rl.bound(n_bytes, ops)
            digits = len(text.split(".")[1])
            if f"{ms:.{digits}f}" != text:
                fails.append(f"PERF.md section 6, {key}: bound {text} ms, "
                             f"utils/roofline.py gives {ms:.{digits}f}")
            if i == 0 and not re.search(rf"\({by}\b", cell):
                fails.append(f"PERF.md section 6, {key}: the bound is by "
                             f"{by}, the table says {cell!r}")
            checked += 1
    return checked


def main():
    fails = []
    n_banks = check_banks(fails)
    check_readme(fails)
    n_bounds = check_bounds(fails, _roofline())
    if fails:
        for f in fails:
            print(f"DOC LINT FAIL: {f}")
        return 1
    print(f"doc lint OK ({n_banks} banks consistent, {n_bounds} kernel "
          f"bounds equal utils/roofline.py's)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
