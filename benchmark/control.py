#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card: for each
seed, a short window of the program at the cell's own size and load and
its compared numbers, then the same numbers for the control, the plain
reference with one guarantee broken in the program's place (a float32
DCT for video, ADPCM segments from guessed states never repaired for
audio). The benchmark's own runs never run the control.

    python benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 1]

Prints one JSON line a seed: {"seed", "program": {...}, "control": {...}}.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["USE_FLAX"] = "0"


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import torch

    from benchlib import runner, spec

    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load_spec(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="psxbench-")
        try:
            driver = cell.driver().Driver(cell, seed, device, tmp,
                                          runner.Spans())
            driver.setup()
            t0 = time.perf_counter()
            while True:
                driver.unit()
                if time.perf_counter() - t0 >= args.seconds:
                    break
            program = driver.check()
            control = driver.control()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"seed": seed, "units": driver.attempted,
                          "failed": driver.failed,
                          "program": {n: v for n, v, _ in program},
                          "control": {n: v for n, v, _ in control}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
