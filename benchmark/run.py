#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run it from the root of a checkout: the program under test,
``psxavenc_tpu_torch``, is imported from there, and its kernels build
into ``psxavenc_tpu_torch/build/`` on the first run.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["USE_FLAX"] = "0"

from benchlib import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
