"""The port's native C++ tiers (``psxavenc_tpu_torch/native/tiers.py``) on
the CPU: the frame encoder equals psxavenc_tpu's native tier and the
port's plain device tier integer for integer (all three codecs, fuzzed
geometries, budgets and content, 16x16, an unfittable frame), its search
seeds never change a byte, bad geometry and bad seeds raise; the unit
encoder equals the JAX native tier and the plain scan; ``BsFrameEncoder``
and the ADPCM stream layer pick their tier as documented, give equal
bytes on both, and say through ``tiers.COUNTERS`` which one ran; a failed
build raises with no fall-back; ``close()`` is idempotent."""

import numpy as np
import pytest
import torch

from psxavenc_tpu import native as jnative
from psxavenc_tpu.models import adpcm_stream as jstreams
from psxavenc_tpu.utils.synth import rand_frames, rand_pcm
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.models import adpcm_stream as tstreams
from psxavenc_tpu_torch.models import bs_video
from psxavenc_tpu_torch.native import tiers
from psxavenc_tpu_torch.ops import adpcm as tops

from test_torch_parity import assert_same, nv21, video_frames

CODECS = (0, 1, 2)
KEYS = ("scale", "words", "total_bits", "nz_count")


def _cap(budgets):
    return max(1, (int(np.max(budgets)) - 8 + 1) // 2)


def _plain(frames, budgets, codec, w, h):
    """The port's device tier on the CPU (the kernels' plain versions),
    its int16 words read as uint16."""
    out = tapi.bs_encode_frames_packed(
        torch.from_numpy(frames), torch.from_numpy(budgets), codec=codec,
        width=w, height=h, capacity_words=_cap(budgets))
    out = {k: v.numpy() for k, v in out.items()}
    out["words"] = out["words"].view(np.uint16)
    return out


def _three_tiers(frames, budgets, codec, w, h):
    """The port's native tier == the JAX native tier (every output of
    every frame) == the port's plain device tier (the scale of every
    frame, the rest where the frame fits: an unfittable frame's other
    outputs are left unspecified, the caller raises). Returns the port's
    native outputs."""
    kw = dict(codec=codec, width=w, height=h, capacity_words=_cap(budgets))
    got = tiers.bs_encode_frames(frames, budgets, **kw)
    want = jnative.bs_encode_frames(frames, budgets, **kw)
    plain = _plain(frames, budgets, codec, w, h)
    fit = plain["scale"] <= 63
    for k in KEYS:
        assert_same(want[k], got[k], k)
        if k == "scale":
            assert_same(plain[k], got[k], k)
        else:
            assert_same(plain[k][fit], got[k][fit], k)
    return got


@pytest.mark.parametrize("codec", CODECS)
def test_frames_match_jax_native_and_plain(codec):
    """Video and noise frames at 64x48 with generous, tight and
    unfittable budgets."""
    frames = video_frames(64, 48, 5, seed=31, noise=2)
    budgets = np.array([4608, 1200, 4608, 700, 2304, 4608, 60], np.int32)
    got = _three_tiers(frames, budgets, codec, 64, 48)
    assert got["scale"][-1] == 64 and (got["scale"][:-1] <= 63).all()


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_matches_jax_native_and_plain(seed):
    """Seeded geometries, codecs, budgets and content (smooth video, flat
    frames with hard edges, saturated noise), as
    tests/test_native_video.py draws them."""
    rng = np.random.default_rng(4100 + seed)
    w, h = 16 * int(rng.integers(1, 6)), 16 * int(rng.integers(1, 4))
    codec = CODECS[seed % 3]
    frames = []
    for k in rng.integers(0, 3, 4):
        if k == 0:
            frames.append(nv21(rand_frames(w, h, 1, seed=seed)[0], w, h))
        elif k == 1:
            f = np.full(w * h * 3 // 2, 128, np.uint8)
            f[: w * 4] = 255
            frames.append(f)
        else:
            frames.append(rng.integers(0, 256, w * h * 3 // 2)
                          .astype(np.uint8))
    nbytes = w * h // 256 * 6
    budgets = rng.integers(max(16, nbytes), max(64, nbytes * 40),
                           4).astype(np.int32)
    _three_tiers(np.stack(frames), budgets, codec, w, h)


@pytest.mark.parametrize("codec", CODECS)
def test_one_macroblock(codec):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3, 16 * 16 * 3 // 2)).astype(np.uint8)
    _three_tiers(frames, np.array([2016, 96, 512], np.int32), codec, 16, 16)


def test_unfittable_frame_is_scale_64():
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (2, 48 * 32 * 3 // 2)).astype(np.uint8)
    got = _three_tiers(frames, np.array([40, 2016], np.int32), 0, 48, 32)
    assert got["scale"][0] == 64 and got["scale"][1] <= 63


def test_seeds_never_change_bytes():
    """Chunked calls with a carried seeds array give the bytes of one cold
    call, across a budget change and an unfittable frame."""
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (8, 48 * 32 * 3 // 2)).astype(np.uint8)
    budgets = np.array([2304, 2304, 1200, 40, 2304, 2304, 1200, 2304],
                       np.int32)
    kw = dict(codec=0, width=48, height=32, capacity_words=_cap(budgets))
    cold = tiers.bs_encode_frames(frames, budgets, **kw)
    seeds = np.zeros((1, 2), np.int32)
    parts = [tiers.bs_encode_frames(frames[b:b + 2], budgets[b:b + 2],
                                    n_threads=1, seeds=seeds, **kw)
             for b in range(0, 8, 2)]
    assert (seeds != 0).any()
    for k in KEYS:
        assert_same(cold[k], np.concatenate([p[k] for p in parts]), k)
    two = tiers.bs_encode_frames(frames, budgets, n_threads=2,
                                 seeds=np.full((2, 2), 40, np.int32), **kw)
    for k in KEYS:
        assert_same(cold[k], two[k], k)


@pytest.mark.parametrize("case", ["width", "height", "zero", "frame_bytes",
                                  "budgets", "seeds_shape", "seeds_dtype",
                                  "seeds_order", "codec", "capacity"])
def test_bad_arguments_raise(case):
    frames = np.zeros((2, 32 * 32 * 3 // 2), np.uint8)
    budgets = np.full(2, 800, np.int32)
    kw = dict(codec=0, width=32, height=32, capacity_words=396)
    seeds = np.zeros((2, 2), np.int32)
    if case == "width":
        kw["width"] = 40
    elif case == "height":
        kw["height"] = 24
    elif case == "zero":
        kw["width"] = 0
    elif case == "frame_bytes":
        frames = frames[:, :-1]
    elif case == "budgets":
        budgets = budgets[:1]
    elif case == "seeds_shape":
        seeds = np.zeros((3, 2), np.int32)
    elif case == "seeds_dtype":
        seeds = np.zeros((2, 2), np.int64)
    elif case == "codec":
        kw["codec"] = 3
    elif case == "capacity":
        kw["capacity_words"] = 0
    else:
        seeds = np.zeros((2, 2), np.int32, order="F")[:, ::-1]
    with pytest.raises(ValueError):
        tiers.bs_encode_frames(frames, budgets, n_threads=2, seeds=seeds,
                               **kw)


def test_bs_pack_matches_jax_native():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 26, 400).astype(np.uint8)
    codes = (rng.integers(0, 1 << 30, 400) & ((1 << lens.astype(np.int64))
                                              - 1)).astype(np.uint32)
    for size in (2048, 64):
        want = jnative.bs_pack(codes, lens, size)
        got = tiers.bs_pack(codes, lens, size)
        assert got[0] == want[0]
        if want[1] is None:
            assert got[1] is None
        else:
            assert_same(want[1], got[1])


@pytest.mark.parametrize("shape,fc,sr", [((2, 3, 27), 5, 12),
                                         ((2, 3, 28), 6, 12),
                                         ((2, 3, 28), 5, 13)])
def test_bad_unit_arguments_raise(shape, fc, sr):
    with pytest.raises(ValueError):
        tiers.adpcm_encode_units(np.zeros(shape, np.int16),
                                 np.full(shape[:2], 28), np.zeros(2),
                                 np.zeros(2), fc, sr)


def _units(B, T, seed):
    rng = np.random.default_rng(seed)
    units = rand_pcm(B * T * 28, seed=seed).astype(np.int32).reshape(
        B, T, 28)
    units[1] = np.clip(units[1] * 6, -32768, 32767)
    lim = np.full((B, T), 28, np.int32)
    lim[0, 3] = 17
    lim[1, 5] = 0
    lim[2, 6] = -9
    lim[3, 2] = 40
    lim[3, -3:] = 0
    p1 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    return units, lim, p1, p2


@pytest.mark.parametrize("filter_count,shift_range",
                         [(5, 12), (4, 12), (4, 8), (2, 12)])
def test_units_match_jax_native_and_scan(filter_count, shift_range):
    units, lim, p1, p2 = _units(5, 12, seed=7 + filter_count + shift_range)
    got = tiers.adpcm_encode_units(units, lim, p1, p2, filter_count,
                                   shift_range)
    want = jnative.adpcm_encode_units(units, lim, p1, p2, filter_count,
                                      shift_range)
    scan = tops.encode_units_scan(
        *(torch.from_numpy(a) for a in (units, np.clip(lim, -(1 << 30), 28),
                                        p1, p2)),
        filter_count=filter_count, shift_range=shift_range)
    for name, w, s, g in zip(("headers", "values", "s1", "s2"), want, scan,
                             got):
        assert_same(w, g, name)
        assert_same(s, g, name)


def test_stream_layer_takes_the_native_tier_on_the_cpu(monkeypatch):
    """encode_prepared_units with state_t and encode_unit_streams on a CPU
    device run the native unit encoder and equal the JAX stream layer
    (its native tier) and the plain K5 (PSXAVENC_NO_NATIVE_ADPCM)."""
    monkeypatch.delenv("PSXAVENC_NO_NATIVE_ADPCM", raising=False)
    units, lim, p1, p2 = _units(4, 10, seed=17)
    state_t = np.array([9, 3, 0, 6])
    want = jstreams.encode_prepared_units(units, lim, 5, 12, prev1=p1,
                                          prev2=p2, state_t=state_t)
    pcm = rand_pcm(420 * 2, channels=2, seed=9).T.copy()
    offs, lims = jstreams.chunk_unit_layout([60, 29, 112, 5, 140, 74])
    offs, lims = np.stack([offs, offs]), np.stack([lims, lims - 3])
    want_s = jstreams.encode_unit_streams(pcm, offs, lims, 4, 8,
                                          prev1=p1[:2], prev2=p2[:2])
    results = {}
    for tier in ("native", "plain"):
        if tier == "plain":
            monkeypatch.setenv("PSXAVENC_NO_NATIVE_ADPCM", "1")
        before = tiers.COUNTERS["adpcm_encode_units"]
        results[tier] = (
            tstreams.encode_prepared_units(units, lim, 5, 12, prev1=p1,
                                           prev2=p2, state_t=state_t,
                                           device="cpu"),
            tstreams.encode_unit_streams(pcm, offs, lims, 4, 8,
                                         prev1=p1[:2], prev2=p2[:2],
                                         device="cpu"))
        calls = tiers.COUNTERS["adpcm_encode_units"] - before
        assert calls == (2 if tier == "native" else 0), tier
    for prepared, streams in results.values():
        for w, g in zip(want, prepared):
            assert_same(w, g)
        for w, g in zip(want_s, streams):
            assert np.asarray(w).dtype == np.asarray(g).dtype
            assert_same(w, g)


def _encode(tier, codec, frames, sizes, monkeypatch):
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", tier)
    enc = bs_video.BsFrameEncoder(codec, 64, 48, "cpu")
    assert enc.tier == tier
    sync = enc.encode_frames(frames, sizes)
    handle = enc.encode_frames_async(frames[:5], sizes[:5])
    handle2 = enc.encode_frames_async(frames[5:], sizes[5:])
    async_out = enc.fetch(handle) + enc.fetch(handle2)
    enc.close()
    return enc, sync, async_out


@pytest.mark.parametrize("codec", CODECS)
def test_encoder_tiers_equal(codec, monkeypatch):
    """BsFrameEncoder on both tiers: equal frame buffers and infos, sync
    and async, equal quant-scale sums; the counter shows the tier."""
    frames = list(video_frames(64, 48, 9, seed=40 + codec, noise=2))
    sizes = [4608, 2304, 4608, 1400, 4608, 4608, 2304, 4608, 3000, 4608,
             4608]
    out = {}
    for tier in ("native", "device"):
        before = tiers.COUNTERS["bs_encode_frames"]
        out[tier] = _encode(tier, codec, frames, sizes, monkeypatch)
        calls = tiers.COUNTERS["bs_encode_frames"] - before
        assert calls == (3 if tier == "native" else 0), tier
    (enc_n, sync_n, async_n), (enc_d, sync_d, async_d) = out.values()
    for got in (sync_n, async_n, async_d):
        assert len(got) == len(sync_d)
        for (buf, info), (wbuf, winfo) in zip(got, sync_d):
            assert info == winfo
            assert buf.tobytes() == wbuf.tobytes()
    assert enc_n.quant_scale_sum == enc_d.quant_scale_sum > 0


@pytest.mark.parametrize("tier", ["native", "device"])
def test_unfittable_frame_raises_on_both_tiers(tier, monkeypatch):
    frames = list(video_frames(48, 32, 3, seed=4, noise=1))
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", tier)
    enc = bs_video.BsFrameEncoder(1, 48, 32, "cpu")
    with pytest.raises(RuntimeError, match="does not fit"):
        enc.encode_frames(frames, [2000, 1000, 2000, 30])
    with pytest.raises(RuntimeError, match="does not fit"):
        enc.fetch(enc.encode_frames_async(frames, [2000, 1000, 2000, 30]))


def test_tier_resolution(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.delenv("PSXAVENC_VIDEO_TIER", raising=False)
    assert bs_video.video_tier([cpu]) == "native"
    assert bs_video.video_tier([cpu, cpu, cpu]) == "native"
    assert bs_video.video_tier([cuda]) == "device"
    assert bs_video.video_tier([cuda, cuda]) == "device"
    assert bs_video.video_tier([cpu, cuda]) == "device"
    for value, want in (("auto", "native"), ("device", "device"),
                        ("native", "native")):
        monkeypatch.setenv("PSXAVENC_VIDEO_TIER", value)
        assert bs_video.video_tier([cpu]) == want
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", "auto")
    assert bs_video.video_tier([cuda]) == "device"


@pytest.mark.parametrize("devices", [["cuda"], ["cuda", "cuda"],
                                     ["cpu", "cuda:0"]])
def test_native_tier_refuses_a_cuda_device(devices, monkeypatch):
    """An encoder on the card never runs the native tier, even when it is
    asked for by name: the host's figures can never stand for the card's."""
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", "native")
    with pytest.raises(ValueError, match="PSXAVENC_VIDEO_TIER=native"):
        bs_video.video_tier([torch.device(d) for d in devices])


@pytest.mark.parametrize("value", ["xla", "Native", ""])
def test_unknown_tier_raises(value, monkeypatch):
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", value)
    with pytest.raises(ValueError, match="PSXAVENC_VIDEO_TIER"):
        bs_video.BsFrameEncoder(0, 32, 32, "cpu")


def test_failed_build_raises_with_no_fall_back(monkeypatch, tmp_path):
    """A compiler that fails both flag sets: the loader raises with its
    messages, and a native encoder is not made on the device tier
    instead."""
    monkeypatch.setattr(tiers, "_lib", None)
    monkeypatch.setattr(tiers, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tiers, "COMPILER", "false")
    with pytest.raises(RuntimeError, match="every flag set"):
        tiers.lib()
    monkeypatch.delenv("PSXAVENC_VIDEO_TIER", raising=False)
    with pytest.raises(RuntimeError, match="false failed"):
        bs_video.BsFrameEncoder(0, 32, 32, "cpu")
    monkeypatch.setattr(tiers, "COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        tiers.adpcm_encode_units(np.zeros((1, 1, 28), np.int16),
                                 np.full((1, 1), 28), [0], [0], 5, 12)
    assert list((tmp_path / "build").glob("*.so")) == []


def test_close_is_idempotent(monkeypatch):
    """close() twice is fine; a handle enqueued before it still fetches;
    enqueueing after it raises."""
    frames = list(video_frames(32, 32, 3, seed=2, noise=0))
    for tier in ("native", "device"):
        monkeypatch.setenv("PSXAVENC_VIDEO_TIER", tier)
        enc = bs_video.BsFrameEncoder(0, 32, 32, "cpu")
        handle = enc.encode_frames_async(frames, [1500] * 3)
        enc.close()
        enc.close()
        assert len(enc.fetch(handle)) == 3
        with pytest.raises(RuntimeError, match="closed"):
            enc.encode_frames(frames, [1500] * 3)
        with pytest.raises(RuntimeError, match="closed"):
            enc.encode_frames_async(frames, [1500] * 3)
        enc.__del__()
