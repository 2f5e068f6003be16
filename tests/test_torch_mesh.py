"""parallel.mesh on the CPU: the batch split over a list of devices (the
CPU named two and four times) equals the single-device API, and
``encode_step_sharded`` equals psxavenc_tpu's on the JAX tests' virtual
8-device CPU mesh; a batch that does not divide raises; the encoder and
the batch runner given several devices route through the split and write
the same bytes as with one."""

import pathlib

import numpy as np
import pytest
import torch

from psxavenc_tpu.models import adpcm_stream as jstreams
from psxavenc_tpu.parallel import mesh as jmesh
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch import batch as tbatch
from psxavenc_tpu_torch.models import adpcm_stream as tstreams
from psxavenc_tpu_torch.models import bs_video
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.parallel import mesh

from test_torch_batch import _jobs, _mixed_specs
from psxavenc_tpu_torch.native import tiers

from test_torch_parity import assert_same, plain_tiers, video_frames

CPU = torch.device("cpu")
SPLITS = {"cpu x2": [CPU, CPU], "cpu x4": [CPU] * 4}


def _video_batch(w=48, h=32, n=8, seed=1):
    """n frames (one of them noise, so a block runs past 256 bits) and
    generous budgets, one of them too small for any scale."""
    frames = video_frames(w, h, n - 1, seed, noise=1)
    budgets = np.full(n, 4000, np.int32)
    budgets[2] = 200
    return torch.from_numpy(frames), torch.from_numpy(budgets), \
        (4000 - 8 + 1) // 2


def _units(B=8, T=3, seed=2):
    rng = np.random.default_rng(seed)
    units = rng.integers(-3000, 3000, (B, T, 28)).astype(np.int32)
    limits = np.full((B, T), 28, np.int32)
    limits[1, 2] = 5
    prev = rng.integers(-2000, 2000, (2, B)).astype(np.int32)
    return [torch.from_numpy(a) for a in (units, limits, prev[0], prev[1])]


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("codec", [tbs.BS_V2, tbs.BS_V3DC])
def test_packed_video_step(split, codec):
    frames, budgets, cap = _video_batch()
    kw = dict(codec=codec, width=48, height=32, capacity_words=cap)
    tapi.COUNTERS["overflow_frames"] = 0
    want = tapi.bs_encode_frames_packed(frames, budgets, **kw)
    want_overflow = tapi.COUNTERS["overflow_frames"]
    step = mesh.packed_video_step(SPLITS[split], **kw)
    assert step.shard_shapes(8) == [8 // len(SPLITS[split])] * \
        len(SPLITS[split])
    _equal(step(frames, budgets), want)
    assert tapi.COUNTERS["overflow_frames"] == 2 * want_overflow > 0


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("variant", [(5, 12), (4, 8)])
def test_unit_encode_step(split, variant):
    fc, sr = variant
    args = _units()
    want = tapi._adpcm_batch(*args, fc, sr)
    step = mesh.unit_encode_step(SPLITS[split], filter_count=fc,
                                 shift_range=sr)
    _equal(step(*args), want)


@pytest.mark.parametrize("split", SPLITS)
def test_encode_step_sharded_matches_single_device_and_jax(split):
    """The JAX test's step (psxavenc_tpu tests/test_parallel.py): 8 frames
    of 32x32 and 8 streams of 3 units, on the 8-device CPU mesh there."""
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (8, 32 * 32 * 3 // 2)).astype(np.uint8)
    budgets = np.full(8, 4 * 2016, dtype=np.int32)
    units = rng.integers(-3000, 3000, (8, 3, 28)).astype(np.int32)
    limits = np.full((8, 3), 28, dtype=np.int32)
    z = np.zeros(8, np.int32)
    args = [frames, budgets, units, limits, z, z]

    jm = jmesh.make_mesh()
    jstep = jmesh.encode_step_sharded(jm, codec=tbs.BS_V2, width=32,
                                      height=32)
    want = [np.asarray(a) for a in jstep(
        *[jmesh.shard_batch(jm, a) for a in args])]

    step = mesh.encode_step_sharded(SPLITS[split], codec=tbs.BS_V2,
                                    width=32, height=32)
    got = step(*[torch.from_numpy(a) for a in args])
    one = mesh.encode_step_sharded([CPU], codec=tbs.BS_V2, width=32,
                                   height=32)(
        *[torch.from_numpy(a) for a in args])
    _equal(got, one)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), w)
    video = tapi.bs_encode_frames(torch.from_numpy(frames),
                                  torch.from_numpy(budgets), codec=tbs.BS_V2,
                                  width=32, height=32)
    assert got[4].tolist() == [int(video["total_bits"].sum()),
                               int(video["scale"].sum()),
                               int((got[2] & 0xF).sum())]


def test_indivisible_batch_raises():
    frames, budgets, cap = _video_batch(n=6)
    step = mesh.packed_video_step([CPU] * 4, codec=0, width=48, height=32,
                                  capacity_words=cap)
    with pytest.raises(ValueError, match="does not divide"):
        step(frames, budgets)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.unit_encode_step([CPU] * 4, filter_count=5,
                              shift_range=12)(*_units(B=6))
    with pytest.raises(ValueError, match="batch sizes differ"):
        mesh.packed_video_step([CPU, CPU], codec=0, width=48, height=32,
                               capacity_words=cap)(frames, budgets[:4])


def test_a_shard_that_returns_another_batch_raises(monkeypatch):
    """A step whose shards came back replicated (the whole batch from
    each) is refused, not concatenated."""
    frames, budgets, cap = _video_batch()
    step = mesh.packed_video_step([CPU, CPU], codec=0, width=48, height=32,
                                  capacity_words=cap)
    whole = tapi.bs_encode_frames_packed(frames, budgets, codec=0, width=48,
                                         height=32, capacity_words=cap)
    monkeypatch.setattr(tapi, "bs_encode_frames_packed",
                        lambda *a, **k: whole)
    with pytest.raises(RuntimeError, match="returned batches"):
        step(frames, budgets)


def test_make_mesh_lists_devices():
    assert mesh.make_mesh(["cpu", CPU]) == [CPU, CPU]
    assert mesh.device_list("cpu") == [CPU]
    with pytest.raises(ValueError):
        mesh.device_list([])
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()


def test_encoder_with_several_devices(monkeypatch):
    """BsFrameEncoder over three CPU devices: batches of 9 (8 rounded up to
    a multiple of 3), split by packed_video_step; the same bytes and
    quant-scale sum as one device."""
    frames = list(video_frames(64, 48, 20, seed=3, noise=3))
    budgets = [4608] * len(frames)
    split_calls = []
    step = mesh.packed_video_step

    def spy(devices, **kw):
        split_calls.append(len(devices))
        return step(devices, **kw)

    monkeypatch.setattr(mesh, "packed_video_step", spy)
    with plain_tiers():
        three = bs_video.BsFrameEncoder(0, 64, 48, [CPU] * 3)
        one = bs_video.BsFrameEncoder(0, 64, 48, "cpu")
        got = three.encode_frames(frames, budgets)
        async_got = three.fetch(three.encode_frames_async(frames[:7],
                                                          budgets[:7]))
        want = one.encode_frames(frames, budgets)
    assert split_calls == [3]
    assert [b.tobytes() for b, _ in got] == [b.tobytes() for b, _ in want]
    assert [b.tobytes() for b, _ in async_got] == \
        [b.tobytes() for b, _ in want[:7]]
    assert [i for _, i in got] == [i for _, i in want]
    assert three.quant_scale_sum - sum(
        i["quant_scale"] for _, i in async_got) == one.quant_scale_sum


def test_batch_runner_with_several_devices(tmp_path, monkeypatch):
    """The batch runner over four CPU devices: the grouped audio calls get
    the four devices (``encode_prepared_units`` splits the 6 SPU streams,
    padded to 8; the 2 XA streams are fewer than the devices and run
    unsplit) and the video groups split their batches; every file equals
    the one-device run."""
    jobs = _jobs(tmp_path, _mixed_specs(tmp_path))
    calls = []
    real_video = mesh.packed_video_step

    def video_spy(devices, **kw):
        calls.append(("packed_video_step", len(devices)))
        return real_video(devices, **kw)

    real_units = tstreams.encode_prepared_units

    def units_spy(*a, device, **kw):
        calls.append(("encode_prepared_units", list(device)))
        return real_units(*a, device=device, **kw)

    monkeypatch.setattr(mesh, "packed_video_step", video_spy)
    monkeypatch.setattr(tstreams, "encode_prepared_units", units_spy)
    with plain_tiers():
        rcs_split = tbatch.run_jobs(jobs["s"], group=True, quiet=True,
                                    device=[CPU] * 4)
        rcs_one = tbatch.run_jobs(jobs["g"], group=True, quiet=True,
                                  device="cpu")
    assert rcs_split == rcs_one == [0] * len(jobs["g"])
    assert ("encode_prepared_units", [CPU] * 4) in calls
    assert ("packed_video_step", 4) in calls
    for k in range(len(jobs["g"])):
        one = pathlib.Path(jobs["g"][k][-1]).read_bytes()
        assert pathlib.Path(jobs["s"][k][-1]).read_bytes() == one
        assert len(one) > 0


@pytest.mark.parametrize("tier", ["native", "plain"])
@pytest.mark.parametrize("n_dev", [4, 3])
def test_grouped_unit_call_over_devices(monkeypatch, n_dev, tier):
    """``encode_prepared_units`` over ``[cpu] * n_dev`` with 10 rows (a
    batch that does not divide, padded with masked rows): the same
    headers, values and final states as one device and as the JAX
    package's, a K5 call a shard; 2 rows, fewer than the devices, run in
    one call on the first."""
    if tier == "plain":
        monkeypatch.setenv("PSXAVENC_NO_NATIVE_ADPCM", "1")
    else:
        monkeypatch.delenv("PSXAVENC_NO_NATIVE_ADPCM", raising=False)
    units, lim, p1, p2 = (t.numpy() for t in _units(B=10, T=6, seed=5))
    lim[3, 4:] = 0
    lim[7, 1] = -4
    state_t = np.array([5, 0, 3, 3, 5, 1, 2, 5, 4, 0])
    want = jstreams.encode_prepared_units(units, lim, 5, 12, prev1=p1,
                                          prev2=p2, state_t=state_t)
    for rows in (slice(None), slice(0, 2)):
        kw = dict(prev1=p1[rows], prev2=p2[rows], state_t=state_t[rows])
        one = tstreams.encode_prepared_units(units[rows], lim[rows], 5, 12,
                                             device="cpu", **kw)
        before = tiers.COUNTERS["adpcm_encode_units"]
        got = tstreams.encode_prepared_units(units[rows], lim[rows], 5, 12,
                                             device=[CPU] * n_dev, **kw)
        calls = tiers.COUNTERS["adpcm_encode_units"] - before
        assert calls == (0 if tier == "plain" else
                         n_dev if rows.stop is None else 1)
        for w, o, g in zip(want, one, got, strict=True):
            assert g.dtype == o.dtype and np.array_equal(g, o)
            assert_same(np.asarray(w)[rows], g)


@pytest.mark.parametrize("split", SPLITS)
def test_shard_batch_matches_jax(split):
    """shard_batch over the CPU named two and four times gives the shards
    of psxavenc_tpu's shard_batch on a mesh of as many of the JAX tests'
    virtual CPU devices: the same shapes and contents, shard for shard,
    each on its device; a batch that does not divide raises."""
    import jax

    devices = SPLITS[split]
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (8, 3, 5)).astype(np.uint8)
    jarr = jmesh.shard_batch(jmesh.make_mesh(jax.devices()[:len(devices)]),
                             frames)
    want = [np.asarray(s.data) for s in sorted(
        jarr.addressable_shards, key=lambda s: s.index[0].start or 0)]
    got = mesh.shard_batch(devices, torch.from_numpy(frames))
    assert len(got) == len(want) == len(devices)
    for g, w, dev in zip(got, want, devices):
        assert g.device == dev and g.dtype == torch.uint8
        assert g.shape == w.shape and np.array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch(devices, frames[:len(devices) + 1])
