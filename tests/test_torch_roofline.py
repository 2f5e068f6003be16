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
                          "nbytes", "nonzero_count", "emit_block_ops",
                          "adpcm_ops")
                 or (n.endswith("_work") and hasattr(rl, n)))
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
    work = rl.adpcm_work(4096, units, 5, adpcm_cuda.n_words(12))
    assert work == (_k5_bytes(4096, units), rl.adpcm_ops(4096 * units, 5))
    got, by = rl.bound(*work)
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
    n = rl.nonzero_count(coefs, scale, nb)
    assert n == round(share * 2 * 63 * nb)
    ops = rl.emit_prep_work(2, nb, rl.nbytes(coefs), n)[1]
    assert ops == (2 * nb * (63 * rl.OPS_EMIT_ZERO + rl.OPS_EMIT_BLOCK)
                   + n * rl.OPS_EMIT_NONZERO)
    assert rl.emit_pack_work(2, nb, rl.nbytes(coefs), n)[1] == ops
    blocks = torch.zeros((2, nb), dtype=torch.bool)
    blocks[0, :10] = True
    n_long = rl.nonzero_count(coefs, scale, nb, blocks)
    assert 0 < n_long < n
    assert rl.tail_work(2, nb, 10, n_long)[1] == (
        2 * nb * rl.OPS_TAIL_BLOCK + rl.emit_block_ops(10, n_long))


def _video_case():
    """Three 32x32 noise frames of a numpy seed, the last unfittable, as
    the main path selects them on the plain versions (BS v2)."""
    from psxavenc_tpu_torch.ops import bs as bs_ops
    from psxavenc_tpu_torch.ops import bs_cuda

    frames = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (3, 32 * 32 * 3 // 2)).astype(np.uint8))
    budgets = torch.tensor([900, 1500, 60], dtype=torch.int32)
    pix = bs_ops.rearrange_nv21_rows(frames, 32, 32)
    dc_q = bs_ops.dc_quant_from_pixrows(pix)
    dc_bits, dc_code = bs_ops._dc_stage(dc_q, bs_ops.BS_V2)
    thr = bs_ops.ac_threshold(budgets, dc_bits.sum(dim=1, dtype=torch.int32),
                              pix.shape[2])
    k1 = bs_cuda.select_scale_pix_plain(pix, thr)
    assert k1[0].tolist()[2] == 64 and 1 < min(k1[0].tolist()[:2])
    sidx = torch.where(k1[0] <= 63, k1[0], 1)
    return {"pix": pix, "thr": thr, "dc_q": dc_q, "k1": k1,
            "c": bs_ops.pixrows_to_coefs_zz(pix).contiguous(),
            "emit_args": (sidx, dc_code, dc_bits)}


def _calls(v):
    """kernel -> (inputs, plain version's outputs, chip_smoke's work
    function for the call) on ``_video_case``'s data."""
    from psxavenc_tpu_torch.ops import bitpack as bitpack_ops
    from psxavenc_tpu_torch.ops import bitpack_cuda, bs_cuda

    cap = 400
    nb = v["pix"].shape[2]
    c64, (sidx, dc_code, dc_bits) = v["k1"][3], v["emit_args"]
    prep = bs_cuda.emit_prep_plain(c64, *v["emit_args"], eof=0x1FF)
    pack = bs_cuda.emit_pack_plain(v["c"], *v["emit_args"])
    streams, bb = bitpack_ops.with_eof_block(*pack, 0x1FF)
    goff = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb
    codes, bits = torch.zeros((3, nb + 1, 65), dtype=torch.int32), \
        torch.zeros((3, nb + 1, 65), dtype=torch.int32)
    units = torch.zeros((2, 3, 28), dtype=torch.int32)
    limits = torch.full((2, 3), 28, dtype=torch.int32)
    z = torch.zeros((2,), dtype=torch.int32)
    k5 = adpcm_cuda.encode_units_plain(units, limits, z, z, filter_count=5,
                                       shift_range=12)
    return {
        "K1": ((v["pix"], v["thr"]), v["k1"],
               cs.select_work_of(torch, nb, True)),
        "K2": ((v["dc_q"],), bs_cuda.dc_stage_plain(v["dc_q"], 2),
               lambda out: rl.dc_work(*v["dc_q"].shape)),
        "K3": ((c64, *v["emit_args"]), prep,
               cs.emit_work_of(rl.emit_prep_work, c64, sidx, nb)),
        "K4": (prep[:2], bitpack_cuda.place_vals_plain(
            *prep[:2], capacity_words=cap), cs.place_work_of(prep[1])),
        "K5": ((units, limits, z, z), k5,
               lambda out: rl.adpcm_work(2, 3, 5, out[1].shape[2])),
        "K6": ((v["c"], v["thr"]), bs_cuda.select_scale_plain(v["c"],
                                                              v["thr"]),
               cs.select_work_of(torch, nb, False)),
        "K7": ((v["c"], *v["emit_args"]), pack,
               cs.emit_work_of(rl.emit_pack_work, v["c"], sidx, nb)),
        "K8": (prep[:2], bitpack_cuda.place_vals_gather_plain(
            *prep[:2], capacity_words=cap), cs.place_work_of(prep[1])),
        "K9": ((streams, goff), bitpack_cuda.place_streams_u32_plain(
            streams, goff, capacity_words=cap),
            cs.place_streams_work_of(goff)),
        "K10": ((codes, bits), bitpack_cuda.pack_block_streams_plain(
            codes, bits), lambda out: rl.pack_work(*codes.shape)),
        "tail": ((prep[2], sidx), None,
                 lambda out: rl.tail_work(*prep[2].shape)),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6",
                                    "K7", "K8", "K9", "K10", "tail"])
def test_work_bytes_are_the_calls_inputs_and_outputs(kernel):
    """Each kernel's work function, as chip_smoke.py calls it, counts
    every input and output of the call once at its dtype (the tail
    emission with no block over 256 bits reads the block totals and the
    scales only)."""
    inputs, out, work = _calls(_video_case())[kernel]
    outs = () if out is None else out if isinstance(out, tuple) else (out,)
    assert work(out)[0] == rl.nbytes(*inputs, *outs)


def test_select_work_counts_the_datas_evaluations():
    """K1 and K6 evaluate two scales a fitting frame and one for the
    unfittable frame (the 2B - 1 of PERF.md's K6 row)."""
    v = _video_case()
    nb = v["pix"].shape[2]
    k1 = cs.select_work_of(torch, nb, True)(v["k1"])
    assert k1 == rl.fdct_select_work(3, nb, v["k1"][3].shape[2], 5)
    assert k1[1] == nb * (3 * rl.OPS_FDCT_BLOCK + 63 * rl.OPS_SCALE_EVAL * 5)
    assert cs.select_work_of(torch, nb, False)(v["k1"])[1] == \
        nb * 63 * rl.OPS_SCALE_EVAL * 5
