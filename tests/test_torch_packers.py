"""Every packer of the port's bs_encode_frames_packed, on both sweeps,
equals psxavenc_tpu's (Pallas kernels in interpret mode): on a batch with
a noise frame whose busy blocks overflow the 256-bit window (the JAX
package then packs the whole batch flat) and on a batch without one (the
packers' own placement runs on both sides). Each batch holds an
unfittable frame, whose words are not compared: the caller raises for it,
and the JAX K9 clamps its writes instead of dropping them."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu import api as japi
from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch import api as tapi

from test_torch_parity import assert_same, video_frames

W, H = 48, 32
CAP = (4000 - 8 + 1) // 2
PORTED = list(tapi.PACKERS)


@pytest.fixture
def interpret_kernels(monkeypatch):
    for fn in ("select_scale_pix_pallas", "dc_stage_pallas",
               "emit_prep_pallas", "select_scale_pallas", "emit_pack_pallas"):
        monkeypatch.setattr(jbsp, fn, functools.partial(getattr(jbsp, fn),
                                                        interpret=True))
    for fn in ("place_vals_mxu_pallas", "place_streams_mxu_pallas",
               "place_vals_gather_pallas", "place_streams_gather_pallas",
               "place_streams_pallas", "pack_block_streams_pallas"):
        monkeypatch.setattr(jbpk, fn, functools.partial(getattr(jbpk, fn),
                                                        interpret=True))


def _batch(noise):
    """With ``noise``: two synthetic frames at a tight and a generous
    budget, a noise frame (its busy blocks overflow) and noise at 200
    bytes (unfittable). Without: three synthetic frames at budgets that
    keep every block inside its window, and a flat frame whose budget is
    below its DC bits (unfittable)."""
    frames = video_frames(W, H, 3, seed=8, noise=2)
    if noise:
        return frames[[0, 1, 3, 4]], np.array([1216, 4000, 4000, 200],
                                              np.int32)
    flat = np.full((1, frames.shape[1]), 77, np.uint8)
    return np.concatenate([frames[:3], flat]), np.array(
        [600, 450, 300, 20], np.int32)


@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("kernel_sweep", [True, False])
@pytest.mark.parametrize("packer", PORTED)
def test_packed_matches_jax(interpret_kernels, packer, kernel_sweep, noise):
    frames, budgets = _batch(noise)
    want = japi.bs_encode_frames_packed(
        jnp.asarray(frames), jnp.asarray(budgets), codec=0, width=W,
        height=H, capacity_words=CAP, pallas_sweep=kernel_sweep,
        packer=packer)
    before = tapi.COUNTERS["overflow_frames"]
    got = tapi.bs_encode_frames_packed(
        torch.from_numpy(frames), torch.from_numpy(budgets), codec=0,
        width=W, height=H, capacity_words=CAP, kernel_sweep=kernel_sweep,
        packer=packer)
    for k in ("scale", "total_bits", "nz_count"):
        assert_same(want[k], got[k], name=k)
    scale = got["scale"].numpy()
    assert scale[3] == 64 and (scale[:3] <= 63).all()
    assert_same(np.asarray(want["words"])[:3],
                got["words"].numpy().view(np.uint16)[:3], name="words")
    if packer.startswith("fused"):
        ovf = tapi.COUNTERS["overflow_frames"] - before
        assert ovf >= 1 if noise else ovf == 0


@pytest.mark.parametrize("packer", PORTED)
def test_plain_stages_equal_kernel_stages(packer):
    """use_kernels=False gives the same dict for every packer (on the CPU
    both run the plain versions)."""
    frames, budgets = _batch(True)
    args = (torch.from_numpy(frames), torch.from_numpy(budgets))
    kw = dict(codec=2, width=W, height=H, capacity_words=CAP, packer=packer)
    a = tapi.bs_encode_frames_packed(*args, **kw)
    b = tapi.bs_encode_frames_packed(*args, use_kernels=False, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_default_packer_follows_the_sweep():
    """packer=None: fused_mxu with the kernel sweep, blocks without."""
    frames, budgets = _batch(False)
    args = (torch.from_numpy(frames), torch.from_numpy(budgets))
    kw = dict(codec=0, width=W, height=H, capacity_words=CAP)
    for sweep, packer in ((True, "fused_mxu"), (False, "blocks")):
        a = tapi.bs_encode_frames_packed(*args, kernel_sweep=sweep, **kw)
        b = tapi.bs_encode_frames_packed(*args, kernel_sweep=sweep,
                                         packer=packer, **kw)
        for k in a:
            assert torch.equal(a[k], b[k]), (sweep, k)


def test_fused_gather_raises():
    """Every packer of psxavenc_tpu runs (fused_gather through K8): only
    an unknown packer name raises."""
    frames, budgets = _batch(False)
    with pytest.raises(ValueError, match="unknown packer"):
        tapi.bs_encode_frames_packed(
            torch.from_numpy(frames), torch.from_numpy(budgets), codec=0,
            width=W, height=H, capacity_words=CAP, packer="gather")
