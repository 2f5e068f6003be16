"""The port's bs_encode_frames_packed equals psxavenc_tpu's fused_mxu path
(Pallas kernels in interpret mode) for v2, v3 and v3dc, including frames
that take the overflow path and an unfittable frame."""

import functools
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu import api as japi
from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.models import bs_video
from psxavenc_tpu_torch.utils import spans

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


SHAPES = [(48, 32), (64, 48)]


def _owned_batch(w, h):
    """_batch's mix at w x h, the budgets scaled with the blocks: two
    synthetic frames, two noise frames, one budget unfittable."""
    frames = video_frames(w, h, 2, seed=w + h, noise=2)
    big = 4000 * (w * h) // (W * H)
    budgets = torch.tensor([big, 1216 * (w * h) // (W * H), big, 200],
                           dtype=torch.int32)
    return torch.from_numpy(frames), budgets, (big - 8 + 1) // 2


def _watch_rows(monkeypatch, refs):
    """Wrap the kernel stages' K1 and K3: at K1's call ``refs["pix"]``
    becomes a weak reference to the rows it reads, and K3's call records
    in ``refs["k3"]`` whether they were alive then; at K1's call
    ``refs["k1"]`` records whether ``refs["frames"]`` was."""
    select, emit_prep = tapi._KERNELS.select, tapi._KERNELS.emit_prep

    def k1(pix, thr, **kw):
        refs["k1"] = "frames" in refs and refs["frames"]() is not None
        refs["pix"] = weakref.ref(pix)
        return select(pix, thr, **kw)

    def k3(*args, **kw):
        refs["k3"] = refs["pix"]() is not None
        return emit_prep(*args, **kw)

    monkeypatch.setattr(tapi._KERNELS, "select", k1)
    monkeypatch.setattr(tapi._KERNELS, "emit_prep", k3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3, jbs.BS_V3DC])
def test_owned_step_frees_frames_after_nv21_and_rows_after_k1(
        monkeypatch, codec, shape):
    """On frames handed over in a dict, the step's stages let go of the
    frames after ``nv21`` and of the pixel rows after ``k1``, stage by
    stage (``step_stages``) and in ``bs_encode_frames_owned``, which
    empties the dict; the words, scales, totals and nonzero counts equal
    ``bs_encode_frames_packed``'s on the same inputs."""
    w, h = shape
    frames, budgets, cap = _owned_batch(w, h)
    kw = dict(codec=codec, width=w, height=h, capacity_words=cap)
    want = tapi.bs_encode_frames_packed(frames, budgets, **kw)
    keys = ("words", "scale", "total_bits", "nz_count")

    state = {"frames": frames.clone(), "budgets": budgets}
    refs = {"frames": weakref.ref(state["frames"])}
    for name, fn in tapi.step_stages(**kw):
        fn(state)
        assert refs["frames"]() is None, name       # from nv21 on
        if name == "nv21":
            refs["pix"] = weakref.ref(state["pix"])
        elif name == "k1":
            assert refs["pix"]() is None and "pix" not in state
    assert "frames" not in state and state["nb"] == 6 * (w // 16) * (h // 16)
    for k in keys:
        assert torch.equal(state[k], want[k]), k

    _watch_rows(monkeypatch, refs)
    batch = {"frames": frames.clone(), "budgets": budgets}
    refs["frames"] = weakref.ref(batch["frames"])
    got = tapi.bs_encode_frames_owned(batch, **kw)
    assert refs["k1"] is False and refs["k3"] is False
    assert batch == {} and refs["frames"]() is None
    assert set(got) == set(keys)
    for k in keys:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3, jbs.BS_V3DC])
def test_packed_keeps_the_callers_frames_and_frees_its_rows(
        monkeypatch, codec, shape):
    """``bs_encode_frames_packed`` leaves the caller's frames tensor as it
    was, byte for byte, and lets go of its pixel rows after K1 (with K1's
    statistics asked for too); its dict equals the owned step's."""
    w, h = shape
    frames, budgets, cap = _owned_batch(w, h)
    before = frames.clone()
    kw = dict(codec=codec, width=w, height=h, capacity_words=cap,
              k1_stats=True)
    refs = {}
    _watch_rows(monkeypatch, refs)
    got = tapi.bs_encode_frames_packed(frames, budgets, **kw)
    assert refs["k3"] is False
    assert torch.equal(frames, before)
    owned = tapi.bs_encode_frames_owned(
        {"frames": frames.clone(), "budgets": budgets}, **kw)
    assert set(got) == set(owned)
    for k in got:
        assert torch.equal(got[k], owned[k]), k


def test_the_encoder_counts_one_dropped_frames_step_a_batch(monkeypatch):
    """On one device (the CPU, the device tier) every BsFrameEncoder batch
    runs the owned step, ``api.bs_encode_frames_owned``, once, and under a
    profile the span ``bs.step`` counts one a batch, enqueued alone or by
    ``encode_frames``; the bytes equal the public API's."""
    from torch.profiler import ProfilerActivity, profile

    owned = []
    real_owned = tapi.bs_encode_frames_owned

    def spy(batch, **kw):
        owned.append(batch["frames"].shape[0])
        return real_owned(batch, **kw)

    monkeypatch.setattr(tapi, "bs_encode_frames_owned", spy)
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", "device")
    frames = video_frames(W, H, 10, seed=31, noise=0)
    sizes = [2000] * 10
    spans.reset()
    enc = bs_video.BsFrameEncoder(jbs.BS_V2, W, H, "cpu")
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            one = enc.fetch(enc.encode_frames_async(list(frames[:3]),
                                                    sizes[:3]))
            two = enc.encode_frames(list(frames), sizes)   # 8 + 2 frames
        counted = spans.snapshot()["spans"]
    finally:
        enc.close()
        spans.reset()
    assert counted["bs.step"]["count"] == len(owned) == 3
    want = tapi.bs_encode_frames_packed(
        torch.from_numpy(frames), torch.tensor(sizes, dtype=torch.int32),
        codec=jbs.BS_V2, width=W, height=H, capacity_words=996)
    words = want["words"].numpy().astype("<u2").view(np.uint8)
    for j, (buf, info) in enumerate(one + two):
        k = j if j < 3 else j - 3
        assert info["quant_scale"] == int(want["scale"][k])
        assert buf[8:].tobytes() == words[k, :2000 - 8].tobytes(), j
