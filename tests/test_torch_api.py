"""The port's bs_encode_frames_packed equals psxavenc_tpu's fused_mxu path
(Pallas kernels in interpret mode) for v2, v3 and v3dc, including frames
that take the overflow path and an unfittable frame."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu import api as japi
from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch import api as tapi

from test_torch_parity import assert_same, video_frames

W, H = 48, 32


@pytest.fixture
def interpret_kernels(monkeypatch):
    for fn in ("select_scale_pix_pallas", "dc_stage_pallas",
               "emit_prep_pallas"):
        monkeypatch.setattr(jbsp, fn, functools.partial(getattr(jbsp, fn),
                                                        interpret=True))
    monkeypatch.setattr(jbpk, "place_vals_mxu_pallas", functools.partial(
        jbpk.place_vals_mxu_pallas, interpret=True))


def _batch():
    """Two synthetic frames and two noise frames. Budgets: one tight, one
    generous for noise (its busy blocks overflow the 256-bit window) and
    one too small for any scale (unfittable)."""
    frames = video_frames(W, H, 2, seed=8, noise=2)
    budgets = np.array([4000, 1216, 4000, 200], np.int32)
    return frames, budgets, (4000 - 8 + 1) // 2


@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3, jbs.BS_V3DC])
def test_packed_matches_jax_fused_mxu(interpret_kernels, codec):
    frames, budgets, cap = _batch()
    want = japi.bs_encode_frames_packed(
        jnp.asarray(frames), jnp.asarray(budgets), codec=codec, width=W,
        height=H, capacity_words=cap, pallas_sweep=True, packer="fused_mxu")
    before = tapi.COUNTERS["overflow_frames"]
    got = tapi.bs_encode_frames_packed(
        torch.from_numpy(frames), torch.from_numpy(budgets), codec=codec,
        width=W, height=H, capacity_words=cap)
    for k in ("scale", "total_bits", "nz_count"):
        assert_same(want[k], got[k], name=k)
    assert_same(want["words"], got["words"].numpy().view(np.uint16),
                name="words")
    scale = got["scale"].numpy()
    assert scale[3] == 64 and (scale[:3] <= 63).all()
    assert tapi.COUNTERS["overflow_frames"] - before >= 1


def test_plain_path_equals_kernel_path():
    """use_kernels=False (the plain stages on any device) gives the same
    dict; on the CPU both run the plain versions."""
    frames, budgets, cap = _batch()
    args = (torch.from_numpy(frames), torch.from_numpy(budgets))
    kw = dict(codec=jbs.BS_V3DC, width=W, height=H, capacity_words=cap)
    a = tapi.bs_encode_frames_packed(*args, **kw)
    b = tapi.bs_encode_frames_packed(*args, use_kernels=False, **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k
