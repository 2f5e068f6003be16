"""On the card: one short run of each cell of BENCHMARK.json through
run.py, correct and with the contract's last line. Skips without a card
(decided in the fixture)."""

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from benchlib import spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_is_correct(requires_card, cell, traced):
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", cell,
         "--seed", str(2**31 + 77), "--seconds", "2", "--trace",
         str(traced)], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    if traced:
        assert line["device"]["busy_s"] > 0
