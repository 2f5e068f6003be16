"""utils/roofline.py: the one copy of the H100's peaks and the port's
per-kernel operation counts. chip_smoke.py assigns none of its own; the
bounds are the figures PERF.md's kernel table records (K5 at 4,096 x 64
and 4,096 x 1,000 units, the main path's kernels at B = 128, 320x240,
18,144-byte budgets); the JAX module's API (censuses, speed of light,
reports) is counted off the port's kernels."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from psxavenc_tpu_torch import api
from psxavenc_tpu_torch.ops import adpcm_cuda
from psxavenc_tpu_torch.utils import roofline as rl
from psxavenc_tpu_torch.utils import synth

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


def test_chip_smoke_assigns_no_bound_constants():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            names |= {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        if isinstance(node, ast.FunctionDef):
            names.add(node.name)
    own = sorted(n for n in names if n.startswith("OPS_")
                 or n in ("INT32_OPS_PER_S", "HBM_BYTES_PER_S", "bound",
                          "nbytes", "emit_ops", "adpcm_ops"))
    assert own == []
    assert cs.rl is rl


def _k5_bytes(streams, units, shift_range=12):
    """K5's inputs (int32 units, limits, two states) and outputs (int32
    headers, packed words, two state rows), each moved once."""
    words = adpcm_cuda.n_words(shift_range)
    return 4 * (streams * units * 28 + streams * units + 2 * streams
                + streams * units * (1 + words + 2))


@pytest.mark.parametrize("units,ms", [(64, 0.1492), (1000, 2.331)])
def test_k5_bound_is_the_tables(units, ms):
    got, by = rl.bound(_k5_bytes(4096, units), rl.adpcm_ops(4096 * units, 5))
    assert by == "operations"
    assert round(got, 4 if units == 64 else 3) == ms
    # The audio report's speed of light is the same bound.
    sol_msps = rl.audio_roofline_msps(rl.chip_for(H100))
    assert round(4096 * units * 28 / sol_msps / 1e3, 4 if units == 64
                 else 3) == ms


def test_chip_for_takes_the_h100_only():
    assert rl.chip_for(H100) is rl.CHIPS["h100_sxm"]
    assert rl.chip_for(H100)["int32_ops"] == 132 * 64 * 1.98e9
    assert rl.chip_for(H100)["hbm_bytes"] == 3.35e12
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                 "NVIDIA A100-SXM4-80GB", "NVIDIA H200", "TPU v5 lite", ""):
        with pytest.raises(ValueError):
            rl.chip_for(name)


def test_video_census_stages_are_the_tables_bounds():
    """Each stage of a 128-frame 320x240 step at 18,144-byte budgets, as
    PERF.md's kernel table bounds it: K1 0.0471 ms (operations), K2
    0.0008 (bytes, v3dc), K3 0.0136 (bytes), K4 0.0034 (bytes), the tail
    emission's test of every block 0.0003 (bytes)."""
    chip = rl.chip_for(H100)
    census = rl.video_census(320, 240, 128, cs.CAP_WORDS, codec=2)
    want = {"K1": (0.0471, "operations"), "K2": (0.0008, "bytes"),
            "K3": (0.0136, "bytes"), "K4": (0.0034, "bytes"),
            "tail": (0.0003, "bytes")}
    assert list(census) == list(want)
    for stage, (ms, by) in want.items():
        got = rl.bound(census[stage]["bytes"], census[stage]["ops"], chip)
        assert (round(got[0], 4), got[1]) == (ms, by), stage
    assert "K2" not in rl.video_census(320, 240, 128, cs.CAP_WORDS, codec=0)
    sol_s = rl.speed_of_light_s(census, chip)
    assert sol_s == pytest.approx(sum(
        rl.bound(st["bytes"], st["ops"], chip)[0] for st in census.values())
        / 1e3, rel=1e-12)
    sol_ms, pct = rl.video_report(2 * sol_s * 1e3, chip, 320, 240, 128,
                                  cs.CAP_WORDS, codec=2)
    assert sol_ms == pytest.approx(sol_s * 1e3, rel=1e-12)
    assert pct == pytest.approx(50.0, rel=1e-12)


def test_audio_census_and_report():
    assert rl.audio_kernel_census(5, 12) == 3 * 5 * 20 + 5 * 8
    assert rl.audio_kernel_census(4, 8) == 3 * 4 * 20 + 4 * 8
    chip = rl.chip_for(H100)
    sol, pct = rl.audio_report(rl.audio_roofline_msps(chip) / 4, chip)
    assert sol == rl.audio_roofline_msps(chip)
    assert pct == pytest.approx(25.0, rel=1e-12)


def test_default_density_is_the_smoke_videos():
    """NONZERO_DENSITY: the first 16 frames of chip_smoke.py's phase 6
    video mix, selected as the main path selects them (plain versions),
    to four places."""
    n = 16
    frames = torch.from_numpy(cs.smoke_frames(np, synth, n, seed=14,
                                              noise_every=0))
    budgets = torch.full((n,), cs.BUDGET, dtype=torch.int32)
    sel = api._select_pixels(frames, budgets, 0, cs.W, cs.H, api._PLAIN)
    share = rl.nonzero_share(sel["c"], sel["scale_idx"] + 1,
                             sel["dc_code"].shape[1])
    assert round(share, 4) == rl.NONZERO_DENSITY


def test_emit_ops_counts_this_runs_nonzero_levels():
    rng = np.random.default_rng(3)
    coefs = torch.from_numpy(rng.integers(-60, 60, (2, 64, 512)).astype(
        np.int16))
    scale = torch.tensor([1, 20], dtype=torch.int32)
    nb = 300
    share = rl.nonzero_share(coefs, scale, nb)
    assert 0 < share < 1
    ops = rl.emit_ops(coefs, scale, nb)
    assert ops == (2 * nb * (63 * rl.OPS_EMIT_ZERO + rl.OPS_EMIT_BLOCK)
                   + round(share * 2 * 63 * nb) * rl.OPS_EMIT_NONZERO)
    blocks = torch.zeros((2, nb), dtype=torch.bool)
    blocks[1, :10] = True
    assert rl.emit_ops(coefs, scale, nb, blocks) < ops
