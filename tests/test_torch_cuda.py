"""The port's CUDA kernels on a card: each equals its plain version (the
BS and block-stream kernels at the video path's shapes, K5 on a ragged
stream batch and, segmented, against the native tier and the plain model
of its scheme), and the encoder's bytes equal the native C++ tier.

Skipped without a CUDA device. This file imports no JAX, so it runs on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from psxavenc_tpu_torch.ops import _build
from psxavenc_tpu_torch.ops import adpcm_cuda
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

from torch_dc_pack_cases import (DC_CASES, DC_SHAPES, PACK_CASES,
                                 PACK_SYMBOLS, dc_case, pack_case)
from torch_emit_cases import (EDGE_BITS, code_table_inputs, edge_inputs,
                              select_form)
from torch_place_cases import boundaries_inside, tied_frames, tied_streams

pytestmark = pytest.mark.requires_cuda

W, H = 320, 240
NB = (W // 16) * (H // 16) * 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _emit_inputs(rng, B, dev, scales):
    c = rng.integers(-900, 900, (B, 63, NB)).astype(np.int16)
    c[:, 10:, :NB // 2] = 0
    c64 = np.zeros((B, 64, bs_cuda.nb_padded(NB)), np.int16)
    c64[:, :63, :NB] = c
    dc_bits = rng.integers(2, 11, (B, NB)).astype(np.int32)
    dc_code = (rng.integers(0, 1 << 10, (B, NB)).astype(np.int32)
               & ((1 << dc_bits) - 1))
    return [torch.from_numpy(a).to(dev) for a in (
        c64, np.array(scales, np.int32), dc_code, dc_bits)]


def _cases(dev):
    rng = np.random.default_rng(7)
    pix = torch.from_numpy(rng.integers(-128, 128, (6, 64, NB)).astype(
        np.int8)).to(dev)
    thr = torch.tensor([20000, 60000, 150000, -1, 10 ** 8, 40000],
                       dtype=torch.int32, device=dev)
    emit = _emit_inputs(rng, 3, dev, [2, 31, 63])
    vals32, e0, _, _ = bs_cuda.emit_prep_plain(*emit, eof=0x1FF)
    c63 = emit[0][:, :63, :NB].to(torch.int32).contiguous()
    streams, goff, total = _streams(*bs_cuda.emit_pack_plain(*emit))
    codes, bits = tbs.emit_symbols_at(c63, emit[1] - 1, emit[3], emit[2])
    return {
        "select_scale": (bs_cuda.select_scale, bs_cuda.select_scale_plain,
                         (tbs.pixrows_to_coefs_zz(pix), thr), {}),
        "emit_pack_coefs63": (bs_cuda.emit_pack, bs_cuda.emit_pack_plain,
                              [c63, *emit[1:]], {}),
        "emit_pack_select64": (bs_cuda.emit_pack, bs_cuda.emit_pack_plain,
                               emit, {}),
        "place_streams": (bitpack_cuda.place_streams,
                          bitpack_cuda.place_streams_plain,
                          (streams, goff, total), {"capacity_words": 9067}),
        "pack_block_streams": (bitpack_cuda.pack_block_streams,
                               bitpack_cuda.pack_block_streams_plain,
                               (codes, bits), {}),
        "select_scale_pix": (bs_cuda.select_scale_pix,
                             bs_cuda.select_scale_pix_plain, (pix, thr), {}),
        "dc_stage": (bs_cuda.dc_stage, bs_cuda.dc_stage_plain,
                     (tbs.dc_quant_from_pixrows(pix), tbs.BS_V3DC), {}),
        "emit_prep": (bs_cuda.emit_prep, bs_cuda.emit_prep_plain, emit,
                      {"eof": 0x1FF}),
        "place_vals": (bitpack_cuda.place_vals,
                       bitpack_cuda.place_vals_plain, (vals32, e0),
                       {"capacity_words": 9068}),
        "place_vals_gather": (bitpack_cuda.place_vals_gather,
                              bitpack_cuda.place_vals_gather_plain,
                              (vals32, e0), {"capacity_words": 9068}),
    }


def _streams(streams, block_bits):
    """Streams with the EOF block, their int32 global offsets and
    totals."""
    streams, bb = tbp.with_eof_block(streams, block_bits, 0x1FF)
    goff = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb
    return streams, goff, goff[:, -1] + bb[:, -1]


@pytest.mark.parametrize("name", [
    "select_scale_pix", "dc_stage", "emit_prep", "place_vals",
    "place_vals_gather", "select_scale", "emit_pack_coefs63", "emit_pack_select64",
    "place_streams", "pack_block_streams"])
def test_kernel_matches_plain(dev, name):
    kernel, plain, args, kw = _cases(dev)[name]
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))


def _select_inputs(dev, nb, batch=6):
    """Pixel rows and thresholds for K1, their coefficients for K6, the
    plain answers (scale, bits, nz) and the coefficient output."""
    rng = np.random.default_rng(13)
    pix = rng.integers(-128, 128, (batch, 64, nb)).astype(np.int8)
    pix[1] //= 4                                   # a smoother frame
    pix = torch.from_numpy(pix).to(dev)
    thr = (torch.tensor([20000, 60000, 150000, -1, 10 ** 8, 40000][:batch],
                        device=dev) * nb // NB).to(torch.int32)
    c = tbs.pixrows_to_coefs_zz(pix).contiguous()
    want = bs_cuda.select_scale_pix_plain(pix, thr)
    return pix, thr, c, want


def _seed_cases(answers):
    """Seed tensors by name: none, the answers (64 becomes 63), and wrong
    ones: off by one and by seven either way, 1, 63, out of range."""
    b = answers.shape[0]
    k = torch.arange(b, device=answers.device)
    off = torch.tensor([1, -1, 7, -7], device=answers.device)[k % 4]
    const = torch.tensor([1, 63, 0, 64, -5], device=answers.device)[k % 5]
    return {"none": None, "hit": answers.clamp(max=63),
            "shifted": answers + off, "constant": const.to(torch.int32)}


def _check_select(kernel, args, seeds, want, c, thr, threads, reader):
    """The kernel equals the plain answers and does, evaluation for
    evaluation, what the plain model of the search does."""
    stats = torch.full((c.shape[0], len(bs_cuda.STAT_NAMES)), -1,
                       dtype=torch.int32, device=c.device)
    got = kernel(*args, seeds, stats_out=stats)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    model = bs_cuda.select_search_plain(
        c.abs(), thr, seeds, bs_cuda.search_groups(c.shape[2], threads))
    assert all(torch.equal(m, w) for m, w in zip(model[:3], want))
    assert torch.equal(stats[:, :4], model[3][:, :4])
    assert stats[:, 4].tolist() == reader
    # Cycles: before the search and in evaluations always, in self-seeding
    # rounds where there were any.
    assert (stats[:, 5] > 0).all() and (stats[:, 7] > 0).all()
    assert torch.equal(stats[:, 6] > 0, stats[:, 3] > 0)
    return stats


@pytest.mark.parametrize("seeds", ["none", "hit", "shifted", "constant"])
@pytest.mark.parametrize("name", ["select_scale_pix", "select_scale"])
def test_select_seeds(dev, name, seeds):
    """K1 and K6 give the plain answers for any seeds, from shared memory,
    in the evaluations the plain model counts; a seed that is the answer
    costs one self-seeding round and the fused pass."""
    pix, thr, c, want = _select_inputs(dev, NB)
    seed_t = _seed_cases(want[0])[seeds]
    if name == "select_scale_pix":
        stats = _check_select(bs_cuda.select_scale_pix, (pix, thr), seed_t,
                              want, c, thr, bs_cuda.K1_THREADS, [0] * 6)
    else:
        stats = _check_select(bs_cuda.select_scale, (c, thr), seed_t,
                              want[:3], c, thr, bs_cuda.K6_THREADS, [0] * 6)
    assert (stats[:, 1] >= 1).all()               # a fused pass, always
    if seeds == "hit":
        assert stats[4, :4].tolist() == [0, 1, 0, 1]   # loose: scale 1


@pytest.mark.parametrize("seeds", ["none", "shifted"])
@pytest.mark.parametrize("name", ["select_scale_pix", "select_scale"])
def test_select_global_reader(dev, name, seeds):
    """A 640x480 frame's rows do not fit shared memory: the same search
    reads global memory."""
    nb = 40 * 30 * 6
    pix, thr, c, want = _select_inputs(dev, nb, batch=4)
    seed_t = _seed_cases(want[0])[seeds]
    if name == "select_scale_pix":
        _check_select(bs_cuda.select_scale_pix, (pix, thr), seed_t, want, c,
                      thr, bs_cuda.K1_THREADS, [1] * 4)
    else:
        _check_select(bs_cuda.select_scale, (c, thr), seed_t, want[:3], c,
                      thr, bs_cuda.K6_THREADS, [1] * 4)


@pytest.mark.parametrize("seeds", ["none", "shifted"])
@pytest.mark.parametrize("name", ["select_scale_pix", "select_scale"])
def test_select_gallop_and_bisect(dev, name, seeds):
    """Frames whose subsample misleads the search by many scales, both
    ways: the kernels' ladder gallops and bisects (full ladder evaluations
    are counted for every frame), evaluation for evaluation as the plain
    model, and the answers are the plain ones."""
    pix, _, _, _ = _select_inputs(dev, NB)
    pix, thr = bs_cuda.misleading_frames(pix, scale=12)
    c = tbs.pixrows_to_coefs_zz(pix).contiguous()
    want = bs_cuda.select_scale_pix_plain(pix, thr)
    assert ((want[0] >= 4) & (want[0] <= 12)).all()
    seed_t = _seed_cases(want[0])[seeds]
    if name == "select_scale_pix":
        stats = _check_select(bs_cuda.select_scale_pix, (pix, thr), seed_t,
                              want, c, thr, bs_cuda.K1_THREADS, [0] * 6)
    else:
        stats = _check_select(bs_cuda.select_scale, (c, thr), seed_t,
                              want[:3], c, thr, bs_cuda.K6_THREADS, [0] * 6)
    assert (stats[:, 0] >= 4).all()
    assert (stats[0::2, 1] == 1).all()            # upward: exact steps
    assert (stats[1::2, 1] == bs_cuda.MAX_FUSED).all()


@pytest.mark.parametrize("nb", [NB, 6 * 37, 585])
def test_select_scale_wide_frame(dev, nb):
    """K6 with a magnitude over 16 bits in one frame: that frame alone is
    read from global memory; also a row length that is not a multiple of
    four, and an odd one."""
    pix, thr, c, _ = _select_inputs(dev, max(nb, 600))
    c = c[:, :, :nb].contiguous()
    c[2, 5, 7] = -70000
    want = bs_cuda.select_scale_plain(c, thr)
    _check_select(bs_cuda.select_scale, (c, thr), None, want, c, thr,
                  bs_cuda.K6_THREADS, [0, 0, 1, 0, 0, 0])


def test_select_writes_only_its_rows(dev):
    """K1 and K6 leave a guard row after every output untouched, the
    statistics included."""
    pix, thr, c, want = _select_inputs(dev, NB)
    B = pix.shape[0]
    nb_pad = bs_cuda.nb_padded(NB)
    for name in ("psx_select_scale_pix", "psx_select_scale"):
        outs = [torch.full((B + 1,), -9, dtype=torch.int32, device=dev)
                for _ in range(3)]
        coefs = torch.full((B + 1, 64, nb_pad), 0x5A5A, dtype=torch.int16,
                           device=dev)
        stats = torch.full((B + 1, len(bs_cuda.STAT_NAMES)), -9,
                           dtype=torch.int32, device=dev)
        ptrs = [_build.ptr(t) for t in outs]
        if name == "psx_select_scale_pix":
            _build.launch(name, pix, _build.ptr(pix), _build.ptr(thr), None,
                          B, NB, nb_pad, bs_cuda.K1_THREADS, *ptrs,
                          _build.ptr(coefs), _build.ptr(stats))
        else:
            _build.launch(name, c, _build.ptr(c), _build.ptr(thr), None, B,
                          NB, bs_cuda.K6_THREADS, *ptrs, _build.ptr(stats))
        torch.cuda.synchronize()
        for t, w in zip(outs, want):
            assert torch.equal(t[:B], w) and int(t[B]) == -9
        assert (stats[B] == -9).all() and (stats[:B] >= 0).all()
        if name == "psx_select_scale_pix":
            assert torch.equal(coefs[:B], want[3])
            assert (coefs[B] == 0x5A5A).all()


def test_select_refused_launch_raises(dev, monkeypatch):
    """A thread count the kernel does not take is an error, not a
    fallback."""
    pix, thr, c, _ = _select_inputs(dev, 600, batch=2)
    monkeypatch.setattr(bs_cuda, "K1_THREADS", 1024)
    with pytest.raises(RuntimeError):
        bs_cuda.select_scale_pix(pix, thr)
    monkeypatch.setattr(bs_cuda, "K6_THREADS", 100)
    with pytest.raises(RuntimeError):
        bs_cuda.select_scale(c, thr)


@pytest.mark.parametrize("range_words", [4, 64, 908, 4096])
def test_place_streams_writes_only_its_rows(dev, range_words):
    """K9 on frames whose streams run far past the capacity (scale 2), for
    ranges of any size: the kernel drops those words, writes every word of
    its (B, cap32) output, zeros included, and leaves a guard row after
    the output untouched (cap32 = 4,534 is no multiple of 4, so frames
    start off 16-byte boundaries)."""
    rng = np.random.default_rng(9)
    streams, goff, _ = _streams(*bs_cuda.emit_pack_plain(
        *_emit_inputs(rng, 3, dev, [2, 2, 40])))
    B, nbe, _ = streams.shape
    cap32 = 4534
    out = torch.full((B + 1, cap32), -1, dtype=torch.int32, device=dev)
    out[B] = 0x5A5A5A5A
    _build.launch("psx_place_streams", streams, _build.ptr(streams),
                  _build.ptr(goff), B, nbe, cap32, range_words,
                  _build.ptr(out))
    torch.cuda.synchronize()
    assert int(goff[0, -1]) > 32 * cap32
    assert (out[B] == 0x5A5A5A5A).all()
    want = bitpack_cuda.place_streams_u32_plain(streams, goff,
                                                capacity_words=2 * cap32)
    assert torch.equal(out[:B], want)


def _placed(dev, scales):
    """K3's placed contributions for three frames at ``scales`` (scale 2
    runs far past a 4,534-word capacity)."""
    rng = np.random.default_rng(10)
    vals32, e0, _, _ = bs_cuda.emit_prep_plain(
        *_emit_inputs(rng, 3, dev, scales), eof=0x3FF)
    return vals32, e0


def test_place_vals_gather_equals_k4(dev):
    """K8's words equal K4's, on frames that fit and frames that run past
    the capacity."""
    vals32, e0 = _placed(dev, [2, 31, 63])
    for cap in (9068, 2 * int(e0.max()) + 40):
        got = bitpack_cuda.place_vals_gather(vals32, e0, capacity_words=cap)
        want = bitpack_cuda.place_vals(vals32, e0, capacity_words=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cap


@pytest.mark.parametrize("range_words", [4, 64, 908, 1020])
def test_place_vals_gather_writes_only_its_rows(dev, range_words):
    """K8 writes every word of its (B, cap32) output, zeros included, and
    nothing after it, for ranges of any size: a guard row stays untouched
    and a poisoned output is fully overwritten (frames start off 16-byte
    boundaries)."""
    vals32, e0 = _placed(dev, [2, 2, 40])
    B, nbe, _ = vals32.shape
    cap32 = 4534
    out = torch.full((B + 1, cap32), -1, dtype=torch.int32, device=dev)
    out[B] = 0x5A5A5A5A
    _build.launch("psx_place_vals_gather", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, range_words,
                  _build.ptr(out))
    torch.cuda.synchronize()
    assert int(e0[0, -1]) > cap32
    assert (out[B] == 0x5A5A5A5A).all()
    want = bitpack_cuda.place_vals_plain(vals32, e0,
                                         capacity_words=2 * cap32)
    assert torch.equal(out[:B], want)


def test_place_vals_gather_refused_launch_raises(dev):
    """A launch K8 does not take is an error, not a fallback: a range over
    4 x 256 - 4 words, and one that is no multiple of 4."""
    vals32, e0 = _placed(dev, [31, 31, 40])
    out = torch.empty((3, 4534), dtype=torch.int32, device=dev)
    for words in (1024, 6):
        with pytest.raises(RuntimeError):
            _build.launch("psx_place_vals_gather", vals32, _build.ptr(vals32),
                          _build.ptr(e0), 3, e0.shape[1], 4534, words,
                          _build.ptr(out))
    torch.cuda.synchronize()


def _place_case(dev, kind):
    """(vals32, e0, capacity_words) of K4's cases: K3's prep (its plain
    version) of one frame, of 128 and of 300 frames, of six 640x480
    frames, of three frames of which scale 2's run past the capacity, and
    16 frames of hand-made offsets that tie."""
    rng = np.random.default_rng(11)
    if kind == "ties":
        vals, e0 = tied_frames(16, NB + 1)
        return (torch.from_numpy(vals).to(dev), torch.from_numpy(e0).to(dev),
                2 * int(e0.max()) + 20)
    if kind == "unfittable":
        return (*_placed(dev, [2, 31, 40]), 9068)
    if kind == "640x480":
        c64 = np.zeros((6, 64, bs_cuda.nb_padded(BIG_NB)), np.int16)
        c64[:, :63, :BIG_NB] = rng.integers(-900, 900, (6, 63, BIG_NB))
        dc_bits = rng.integers(2, 11, (6, BIG_NB)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (
            c64, np.array([5, 9, 20, 31, 50, 63], np.int32),
            np.zeros_like(dc_bits), dc_bits)]
        vals32, e0 = bs_cuda.emit_prep_plain(*args, eof=0x1FF)[:2]
        return vals32, e0, 4 * 9068 + 4
    frames = {"one frame": 1, "128 frames": 128, "300 frames": 300}[kind]
    emit = _emit_inputs(rng, min(frames, 128), dev,
                        [2 + 61 * (i % 7) // 6 for i in range(
                            min(frames, 128))])
    vals32, e0 = bs_cuda.emit_prep_plain(*emit, eof=0x1FF)[:2]
    if frames == 300:
        vals32 = torch.cat([vals32] * 3)[:300].contiguous()
        e0 = torch.cat([e0] * 3)[:300].contiguous()
    return vals32, e0, 9068


PLACE_CASES = ["one frame", "128 frames", "300 frames", "640x480",
               "unfittable", "ties"]


@pytest.mark.parametrize("kind", PLACE_CASES)
def test_place_vals_cases(dev, kind):
    """K4 == its plain version on one, 128 and 300 frames, at 640x480, on
    frames past cap32 and on offsets that tie; and range starts fall
    inside blocks' nine words."""
    vals32, e0, cap = _place_case(dev, kind)
    before = bitpack_cuda.LAUNCHES["place_vals"]
    got = bitpack_cuda.place_vals(vals32, e0, capacity_words=cap)
    want = bitpack_cuda.place_vals_plain(vals32, e0, capacity_words=cap)
    torch.cuda.synchronize()
    assert bitpack_cuda.LAUNCHES["place_vals"] == before + 1
    assert got.is_cuda and torch.equal(got, want) and want.any()
    cap32 = tbp.cap32_of(cap)
    words = bitpack_cuda.place_range_words(
        e0.shape[0], cap, bs_cuda.sm_count(dev))
    assert boundaries_inside(e0.cpu().numpy(), cap32, words) > 0
    if kind == "unfittable":
        assert int(e0[:, -1].max()) > cap32


MODEL_FRAMES = 4           # frames of a case that the plain models run


@pytest.mark.parametrize("kind", PLACE_CASES)
def test_place_vals_gather_cases(dev, kind):
    """K8 == its plain version on K4's cases, and its first frames ==
    the plain model of its decomposition at the kernel's own ranges."""
    vals32, e0, cap = _place_case(dev, kind)
    before = bitpack_cuda.LAUNCHES["place_vals_gather"]
    got = bitpack_cuda.place_vals_gather(vals32, e0, capacity_words=cap)
    want = bitpack_cuda.place_vals_gather_plain(vals32, e0,
                                                capacity_words=cap)
    torch.cuda.synchronize()
    assert bitpack_cuda.LAUNCHES["place_vals_gather"] == before + 1
    assert got.is_cuda and torch.equal(got, want) and want.any()
    words = bitpack_cuda.gather_range_words(
        e0.shape[0], cap, bs_cuda.sm_count(dev))
    n = MODEL_FRAMES
    model = bitpack_cuda.place_vals_gather_ranges_plain(
        vals32[:n], e0[:n], capacity_words=cap, range_words=words)
    assert torch.equal(got[:n], model)
    assert boundaries_inside(e0.cpu().numpy(), tbp.cap32_of(cap), words) > 0


def _stream_case(dev, kind):
    """(streams, goff, total, capacity_words) of K9's cases: K7's streams
    (plain version) of frames like K4's cases (one frame, 128, 300, six
    640x480 frames, three of which scale 2's runs past the capacity) and
    16 frames of streams whose offsets tie (tests/torch_place_cases.py)."""
    if kind == "ties":
        streams, goff = tied_streams(16, NB + 1)
        streams = torch.from_numpy(streams).to(dev)
        goff = torch.from_numpy(goff).to(dev)
        total = goff[:, -1] + 256
        return streams, goff, total, int(total.max()) // 16 + 20
    rng = np.random.default_rng(12)
    cap = 9068
    if kind == "unfittable":
        emit = _emit_inputs(rng, 3, dev, [2, 31, 40])
    elif kind == "640x480":
        c64 = np.zeros((6, 64, bs_cuda.nb_padded(BIG_NB)), np.int16)
        c64[:, :63, :BIG_NB] = rng.integers(-900, 900, (6, 63, BIG_NB))
        dc_bits = rng.integers(2, 11, (6, BIG_NB)).astype(np.int32)
        emit = [torch.from_numpy(a).to(dev) for a in (
            c64, np.array([5, 9, 20, 31, 50, 63], np.int32),
            np.zeros_like(dc_bits), dc_bits)]
        cap = 4 * 9068 + 4
    else:
        frames = {"one frame": 1, "128 frames": 128, "300 frames": 128}[kind]
        emit = _emit_inputs(rng, frames, dev,
                            [2 + 61 * (i % 7) // 6 for i in range(frames)])
    streams, goff, total = _streams(*bs_cuda.emit_pack_plain(*emit))
    if kind == "300 frames":
        streams, goff, total = (torch.cat([t] * 3)[:300].contiguous()
                                for t in (streams, goff, total))
    return streams, goff, total, cap


@pytest.mark.parametrize("kind", PLACE_CASES)
def test_place_streams_cases(dev, kind):
    """K9 == its plain versions (u32 words and u16 values) on one, 128 and
    300 frames, at 640x480, on frames past cap32 and on offsets that tie,
    and its first
    frames == the plain model of its decomposition at the kernel's own
    ranges, whose starts fall inside blocks' nine words."""
    streams, goff, total, cap = _stream_case(dev, kind)
    before = bitpack_cuda.LAUNCHES["place_streams"]
    got = bitpack_cuda.place_streams_u32(streams, goff, capacity_words=cap)
    want = bitpack_cuda.place_streams_u32_plain(streams, goff,
                                                capacity_words=cap)
    u16 = bitpack_cuda.place_streams(streams, goff, total,
                                     capacity_words=cap)
    torch.cuda.synchronize()
    assert bitpack_cuda.LAUNCHES["place_streams"] == before + 2
    assert got.is_cuda and torch.equal(got, want) and want.any()
    assert torch.equal(u16, bitpack_cuda.place_streams_plain(
        streams, goff, total, capacity_words=cap))
    words = bitpack_cuda.place_range_words(
        goff.shape[0], cap, bs_cuda.sm_count(dev))
    n = MODEL_FRAMES
    model = bitpack_cuda.place_streams_ranges_plain(
        streams[:n], goff[:n], capacity_words=cap, range_words=words)
    assert torch.equal(got[:n], model)
    assert boundaries_inside((goff >> 5).cpu().numpy(), tbp.cap32_of(cap),
                             words) > 0
    if kind == "unfittable":
        assert int(goff[:, -1].max()) // 32 > tbp.cap32_of(cap)


def test_place_streams_refused_launch_raises(dev):
    """A launch K9 does not take is an error, not a fallback: a range over
    4,096 words, and one that is no multiple of 4."""
    rng = np.random.default_rng(9)
    streams, goff, _ = _streams(*bs_cuda.emit_pack_plain(
        *_emit_inputs(rng, 3, dev, [31, 31, 40])))
    out = torch.empty((3, 4534), dtype=torch.int32, device=dev)
    for words in (4100, 6):
        with pytest.raises(RuntimeError):
            _build.launch("psx_place_streams", streams, _build.ptr(streams),
                          _build.ptr(goff), 3, goff.shape[1], 4534, words,
                          _build.ptr(out))
    torch.cuda.synchronize()


@pytest.mark.parametrize("range_words", [4, 64, 908, 4096])
def test_place_vals_writes_only_its_rows(dev, range_words):
    """K4 writes every word of its (B, cap32) output, zeros included, and
    nothing after it, for ranges of any size: a guard row stays untouched
    and a poisoned output is fully overwritten (cap32 = 4,534 is no
    multiple of 4, so frames start off 16-byte boundaries)."""
    vals32, e0 = _placed(dev, [2, 2, 40])
    B, nbe, _ = vals32.shape
    cap32 = 4534
    out = torch.full((B + 1, cap32), -1, dtype=torch.int32, device=dev)
    out[B] = 0x5A5A5A5A
    _build.launch("psx_place_vals", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, range_words,
                  _build.ptr(out))
    torch.cuda.synchronize()
    assert int(e0[0, -1]) > cap32
    assert (out[B] == 0x5A5A5A5A).all()
    want = bitpack_cuda.place_vals_plain(vals32, e0,
                                         capacity_words=2 * cap32)
    assert torch.equal(out[:B], want)


def test_place_vals_unaligned_input(dev):
    """vals32 off a 16-byte boundary: plain loads take the bulk copies'
    place."""
    vals32, e0 = _placed(dev, [2, 31, 40])
    flat = torch.empty(vals32.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(vals32.shape)
    shifted.copy_(vals32)
    assert shifted.data_ptr() % 16
    got = bitpack_cuda.place_vals(shifted, e0, capacity_words=9068)
    _same((got,), (bitpack_cuda.place_vals_plain(vals32, e0,
                                                 capacity_words=9068),))


def test_place_vals_refused_launch_raises(dev):
    """A launch the kernel does not take is an error, not a fallback: a
    range that is no multiple of 4 words."""
    vals32, e0 = _placed(dev, [31, 31, 40])
    out = torch.empty((3, 4534), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        _build.launch("psx_place_vals", vals32, _build.ptr(vals32),
                      _build.ptr(e0), 3, e0.shape[1], 4534, 6,
                      _build.ptr(out))
    torch.cuda.synchronize()


# ------------------------------------------- K3, K7 and the tail emission

BIG_NB = 40 * 30 * 6            # 640x480: K3 parks its windows in vals32


def _edge(dev, nb, form="int16"):
    """The hand-made blocks of torch_emit_cases on the card, in either
    coefficient form; the int32 form with magnitudes over 16 bits."""
    c, scale, dc_code, dc_bits = edge_inputs(nb)
    if form == "int32":
        c[1, 5, nb - 1], c[1, 9, nb - 2] = -70000, 131071
    coefs = c if form == "int32" else select_form(c)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (coefs, scale, dc_code, dc_bits)]


def _same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("nb", [6, 222, 585, BIG_NB])
def test_emit_prep_on_edge_blocks(dev, nb):
    """K3 == its plain version on the hand-made blocks (an escape across
    bit 256, 256 and 257 bits, 63 clamped levels, runs over 31), on frames
    of one trip, of an uneven last trip, and too large to park in shared
    memory."""
    args = _edge(dev, nb)
    got = bs_cuda.emit_prep(*args, eof=0x3FF)
    _same(got, bs_cuda.emit_prep_plain(*args, eof=0x3FF))
    assert got[2][0, :6].tolist() == EDGE_BITS


@pytest.mark.parametrize("form", ["int16", "int32"])
@pytest.mark.parametrize("nb", [6, 222, 585, BIG_NB])
def test_emit_pack_on_edge_blocks(dev, nb, form):
    """K7 == its plain version on the same blocks, either coefficient
    form; the int32 form's rows start on no 16-byte boundary where NB is
    not a multiple of four."""
    args = _edge(dev, nb, form)
    got = bs_cuda.emit_pack(*args)
    _same(got, bs_cuda.emit_pack_plain(*args))
    assert got[1][0, :6].tolist() == EDGE_BITS


@pytest.mark.parametrize("form", ["int16", "int32"])
def test_emit_kernels_on_every_code(dev, form):
    """K3 and K7, whose CTAs make their code tables themselves, == their
    plain versions (the closed-form codes of ops/bs.py) on blocks that
    hold one level each: every (run, level) with a variable-length code,
    both signs, and the escapes around them."""
    c, scale, dc_code, dc_bits = code_table_inputs()
    coefs = c if form == "int32" else select_form(c)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (coefs, scale, dc_code, dc_bits)]
    _same(bs_cuda.emit_pack(*args), bs_cuda.emit_pack_plain(*args))
    if form == "int16":
        _same(bs_cuda.emit_prep(*args, eof=0x1FF),
              bs_cuda.emit_prep_plain(*args, eof=0x1FF))


def _placed_edge(dev, nb, form, cap):
    """The tail emission's inputs: K4's words of K3's prep, the emission's
    arguments in ``form``, K7's block totals."""
    prep = bs_cuda.emit_prep_plain(*_edge(dev, nb), eof=0x1FF)
    placed = bitpack_cuda.place_vals_plain(prep[0], prep[1],
                                           capacity_words=cap)
    args = _edge(dev, nb, form)
    return placed, args, bs_cuda.emit_pack_plain(*args)[1]


@pytest.mark.parametrize("form", ["int16", "int32"])
@pytest.mark.parametrize("nb,cap", [(6, 400), (6, 33), (222, 20000),
                                    (222, 2001), (585, 20001),
                                    (BIG_NB, 250000), (BIG_NB, 90001)])
def test_emit_tail_on_edge_blocks(dev, nb, cap, form):
    """The tail emission == its plain version, with capacities that hold
    everything, that cut a frame inside a long block (odd and even) and
    that end before the first tail; with the int16 form the words equal
    the exact flat packer's."""
    from psxavenc_tpu_torch import api

    placed, args, block_bits = _placed_edge(dev, nb, form, cap)
    count = torch.tensor([5], dtype=torch.int32, device=dev)
    before = bs_cuda.LAUNCHES["emit_tail"]
    got, n = bs_cuda.emit_tail(placed.clone(), *args, block_bits,
                               capacity_words=cap, count=count)
    assert bs_cuda.LAUNCHES["emit_tail"] == before + 1 and n is count
    want, _ = bs_cuda.emit_tail_plain(placed, *args, block_bits,
                                      capacity_words=cap)
    _same((got,), (want,))
    assert int(count) == 5 + int((block_bits > 256).any(dim=1).sum()) >= 6
    if form == "int16":
        flat = api._overflow_words(args[0], args[1] - 1, args[3], args[2],
                                   0x1FF, cap)
        assert torch.equal(tbp.words_u16(got, cap), flat)


def test_emit_kernels_write_only_their_rows(dev):
    """K3, K7 and the tail emission leave a guard row after every output
    untouched; the tail emission changes no word of a frame without a long
    block and no count when there is none."""
    nb = 222
    coefs, scale, dc_code, dc_bits = _edge(dev, nb)
    want = bs_cuda.emit_prep_plain(coefs, scale, dc_code, dc_bits, eof=0x1FF)
    B, nbe = 2, nb + 1

    def guarded(*shape):
        return torch.full((B + 1, *shape), 0x5A5A5A5A, dtype=torch.int32,
                          device=dev)

    outs = [guarded(nbe, 9), guarded(nbe), guarded(nb), guarded()]
    stats = guarded(len(bs_cuda.EMIT_STAT_NAMES))
    _build.launch("psx_emit_prep", coefs, _build.ptr(coefs), B,
                  coefs.shape[2], nb, _build.ptr(scale), _build.ptr(dc_code),
                  _build.ptr(dc_bits), 0x1FF, bs_cuda.emit_threads(nb),
                  *[_build.ptr(t) for t in outs], _build.ptr(stats))
    torch.cuda.synchronize()
    for t, w in zip(outs, want):
        assert torch.equal(t[:B], w) and (t[B] == 0x5A5A5A5A).all()
    assert (stats[B] == 0x5A5A5A5A).all() and (stats[:B, :6] > 0).all()

    streams, bbits = guarded(nb, 16), guarded(nb)
    _build.launch("psx_emit_pack", coefs, _build.ptr(coefs), 1, B, 64,
                  coefs.shape[2], nb, _build.ptr(scale), _build.ptr(dc_code),
                  _build.ptr(dc_bits), _build.ptr(streams), _build.ptr(bbits))
    torch.cuda.synchronize()
    pack = bs_cuda.emit_pack_plain(coefs, scale, dc_code, dc_bits)
    for t, w in zip((streams, bbits), pack):
        assert torch.equal(t[:B], w) and (t[B] == 0x5A5A5A5A).all()

    # Frame 1 at scale 40 has no long block: its words stay as they were.
    scale = torch.tensor([1, 40], dtype=torch.int32, device=dev)
    block_bits = bs_cuda.emit_pack_plain(coefs, scale, dc_code, dc_bits)[1]
    assert int(block_bits[1].max()) <= 256 < int(block_bits[0].max())
    cap32 = 3000
    out = guarded(cap32)
    count = guarded()[:2]
    for batch, frames in ((B, slice(0, 2)), (1, slice(1, 2))):
        before = out.clone(), count.clone()
        _build.launch("psx_emit_tail", coefs, _build.ptr(coefs[frames]), 1,
                      batch, 64, coefs.shape[2], nb, _build.ptr(scale[frames]),
                      _build.ptr(dc_bits[frames]),
                      _build.ptr(block_bits[frames]), 3, cap32, 2 * cap32,
                      _build.ptr(out), _build.ptr(count))
        torch.cuda.synchronize()
        if batch == B:
            assert not torch.equal(out[0], before[0][0])
            assert torch.equal(out[1:], before[0][1:])
            assert count.tolist() == [0x5A5A5A5A + 1, 0x5A5A5A5A]
        else:
            assert torch.equal(out, before[0])
            assert torch.equal(count, before[1])


def _tail_case(dev, kind):
    """(the placed words, the emission's int16 arguments, block_bits,
    capacity_words) of the tail emission's cases: edge_inputs at 320x240
    (frame 0 at scale 1 runs past the capacity, so its later tails drop
    whole), an unfittable frame alone (noise at scale 1), and the noise
    of edge_inputs at scales 40 and 63 (no block over 256 bits)."""
    args = _edge(dev, NB)
    cap = 9068
    if kind == "unfittable":
        args = [a[1:] for a in args]
        args[1] = torch.ones_like(args[1])
    elif kind == "no_long":
        args[0][0, :, :6] = 0
        args[1] = torch.tensor([40, 63], dtype=torch.int32, device=dev)
    prep = bs_cuda.emit_prep_plain(*args, eof=0x1FF)
    placed = bitpack_cuda.place_vals_plain(prep[0], prep[1],
                                           capacity_words=cap)
    return placed, args, prep[2], cap


@pytest.mark.parametrize("ctas", [None, 1, 2, 5])
@pytest.mark.parametrize("kind", ["edge", "unfittable", "no_long"])
def test_emit_tail_cases(dev, kind, ctas):
    """The tail emission == its plain version on edge_inputs, an
    unfittable frame and a batch with no long block, through its wrapper
    (None) and launched with 1, 2 and 5 CTAs a frame; the count comes out
    once per frame with a long block."""
    placed, args, block_bits, cap = _tail_case(dev, kind)
    want, _ = bs_cuda.emit_tail_plain(placed, *args, block_bits,
                                      capacity_words=cap)
    frames = int((block_bits > 256).any(dim=1).sum())
    assert (frames == 0) == (kind == "no_long")
    got = placed.clone()
    count = torch.tensor([7], dtype=torch.int32, device=dev)
    if ctas is None:
        bs_cuda.emit_tail(got, *args, block_bits, capacity_words=cap,
                          count=count)
    else:
        coefs, scale, _, dc_bits = args
        _build.launch("psx_emit_tail", coefs, _build.ptr(coefs), 1,
                      coefs.shape[0], 64, coefs.shape[2], NB,
                      _build.ptr(scale), _build.ptr(dc_bits),
                      _build.ptr(block_bits), ctas, got.shape[1], cap,
                      _build.ptr(got), _build.ptr(count))
    _same((got,), (want,))
    assert int(count) == 7 + frames


def test_emit_tail_refused_launch_raises(dev):
    """No CTA a frame is refused."""
    placed, args, block_bits, cap = _tail_case(dev, "edge")
    coefs, scale, _, dc_bits = args
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        _build.launch("psx_emit_tail", coefs, _build.ptr(coefs), 1, 2, 64,
                      coefs.shape[2], NB, _build.ptr(scale),
                      _build.ptr(dc_bits), _build.ptr(block_bits), 0,
                      placed.shape[1], cap, _build.ptr(placed),
                      _build.ptr(count))
    torch.cuda.synchronize()


def test_emit_refused_launch_raises(dev, monkeypatch):
    """A launch the kernels do not take is an error, not a fallback: K3
    with a CTA width that is no multiple of 96, the tail emission on a
    frame whose block totals do not fit shared memory."""
    args = _edge(dev, 222)
    monkeypatch.setattr(bs_cuda, "emit_threads", lambda nb: 100)
    with pytest.raises(RuntimeError):
        bs_cuda.emit_prep(*args, eof=0x1FF)
    monkeypatch.undo()
    nb = 40000
    coefs = torch.zeros((1, 64, bs_cuda.nb_padded(nb)), dtype=torch.int16,
                        device=dev)
    ints = torch.ones((1, nb), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        bs_cuda.emit_tail(torch.zeros((1, 50), dtype=torch.int32, device=dev),
                          coefs, ints[:, 0], ints, ints, 300 * ints,
                          capacity_words=100)
    torch.cuda.synchronize()


# Each fused route: (packer, kernel_sweep) and the launches of one call.
FUSED_ROUTES = [
    ("fused_mxu", True, {"select_scale_pix": 1, "emit_prep": 1,
                         "place_vals": 1, "emit_tail": 1}),
    ("fused_gather", True, {"select_scale_pix": 1, "emit_prep": 1,
                            "place_vals_gather": 1, "emit_tail": 1}),
    ("fused", True, {"select_scale_pix": 1, "emit_pack": 1,
                     "emit_tail": 1}),
    ("fused_pallas", True, {"select_scale_pix": 1, "emit_pack": 1,
                            "place_streams": 1, "emit_tail": 1}),
    ("fused_mxu", False, {"emit_pack": 1, "place_vals": 1, "emit_tail": 1}),
    ("fused_gather", False, {"emit_pack": 1, "place_vals_gather": 1,
                             "emit_tail": 1}),
]


def test_fused_noise_batch_runs_no_plain_packing(dev, monkeypatch):
    """Every fused route (K3 and K4 or K8; K7's streams placed by the
    plain stream placement, K9, or K4 or K8) on noise frames at generous
    budgets (low scales: every frame has blocks over 256 bits; the last is
    unfittable and runs past the capacity) == the flat packer, with the
    plain packing functions removed and every operation that waits for the
    device an error; it launches its kernels and the tail emission once,
    and the device counter holds the number of such frames. Without the
    kernel sweep the selection (the plain chunked sweep, which waits for
    the device by design) runs before the checked part, the emission and
    the placement (``api._fused_words``)."""
    from psxavenc_tpu_torch import api

    rng = np.random.default_rng(21)
    budgets = [150000, 110000, 80000, 60000, 18144, 200]
    frames = torch.from_numpy(rng.integers(
        0, 256, (len(budgets), W * H * 3 // 2)).astype(np.uint8)).to(dev)
    budgets = torch.tensor(budgets, dtype=torch.int32, device=dev)
    cap = (150000 - 8) // 2
    kw = dict(codec=0, width=W, height=H, capacity_words=cap)
    flat = api.bs_encode_frames_packed(frames, budgets, packer="flat", **kw)
    sel = api._select_pixels(frames, budgets, 0, W, H, api._KERNELS)
    block_bits = bs_cuda.emit_pack_plain(sel["c"], sel["scale_idx"] + 1,
                                         sel["dc_code"], sel["dc_bits"])[1]
    long_frames = int((block_bits > 256).any(dim=1).sum())
    assert flat["scale"].tolist()[-1] == 64 and 4 <= long_frames < 6
    swept = tbs.encode_frames_symbols(
        api._frames_to_coefs(frames, W, H), budgets, codec=0,
        kernel_sweep=False, emit=False)
    assert torch.equal(swept["scale"], flat["scale"])

    def forbidden(*a, **k):
        raise AssertionError("plain packing on the card")

    def run(packer, sweep):
        if sweep:
            return api.bs_encode_frames_packed(frames, budgets,
                                               packer=packer, **kw)["words"]
        return api._fused_words(swept, packer, False, 0x1FF, cap,
                                api._KERNELS)

    counters = (bs_cuda.LAUNCHES, bitpack_cuda.LAUNCHES)
    for packer, sweep, launches in FUSED_ROUTES:
        run(packer, sweep)
        torch.cuda.synchronize()                         # warm
        api.COUNTERS["overflow_frames"] = 0
        before = [dict(c) for c in counters]
        with monkeypatch.context() as m:
            m.setattr(api, "_overflow_words", forbidden)
            m.setattr(tbs, "emit_symbols_at", forbidden)
            m.setattr(tbp, "pack_bits", forbidden)
            torch.cuda.set_sync_debug_mode("error")
            try:
                words = run(packer, sweep)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ran = {k: v - b[k] for c, b in zip(counters, before)
               for k, v in c.items() if v - b[k]}
        assert ran == launches, (packer, sweep)
        assert api.COUNTERS["overflow_frames"] == long_frames
        assert api.COUNTERS["overflow_frames"] == long_frames   # read once
        assert torch.equal(words, flat["words"]), (packer, sweep)
    got = api.bs_encode_frames_packed(frames, budgets, packer="fused_pallas",
                                      **kw)
    for k in ("scale", "nz_count"):
        assert torch.equal(got[k], flat[k])
    assert torch.equal(got["total_bits"][:-1], flat["total_bits"][:-1])


@pytest.mark.parametrize("filter_count,shift_range",
                         adpcm_cuda.KERNEL_VARIANTS)
def test_adpcm_kernel_matches_plain(dev, filter_count, shift_range):
    """K5 on 37 streams (a ragged last warp) x 40 units, with partial,
    zero and negative limits, a masked tail, full-scale spikes and
    nonzero prev states."""
    from psxavenc_tpu_torch.utils.synth import rand_pcm

    rng = np.random.default_rng(filter_count + shift_range)
    Bs, T = 37, 40
    units = rand_pcm(Bs * T * 28, seed=shift_range).astype(
        np.int32).reshape(Bs, T, 28)
    units[1] = np.clip(units[1] * 8, -32768, 32767)
    units[2, :, 5::7] = 0
    lim = np.full((Bs, T), 28, np.int32)
    lim[0, 3] = 17
    lim[1, 5] = 0
    lim[2, 6] = -4
    lim[3, T - 6:] = 0
    lim[4, 9] = 99
    p1 = rng.integers(-0x8000, 0x8000, Bs).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, Bs).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (units, lim, p1, p2)]
    before = adpcm_cuda.LAUNCHES["adpcm_encode_units"]
    got = adpcm_cuda.encode_units(*args, filter_count=filter_count,
                                  shift_range=shift_range)
    want = adpcm_cuda.encode_units_plain(*args, filter_count=filter_count,
                                         shift_range=shift_range)
    torch.cuda.synchronize()
    assert adpcm_cuda.LAUNCHES["adpcm_encode_units"] == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("codec", [tbs.BS_V2, tbs.BS_V3, tbs.BS_V3DC])
def test_encoder_matches_native(dev, codec):
    """BsFrameEncoder on the card == the native tier, byte for byte."""
    from psxavenc_tpu import native
    from psxavenc_tpu.utils.synth import rand_frames
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    rng = np.random.default_rng(11)
    frames = []
    for y, cb, cr in rand_frames(W, H, 14, seed=3):
        c = np.stack([cr.reshape(H // 2, W // 2), cb.reshape(H // 2, W // 2)],
                     axis=-1).reshape(-1)
        frames.append(np.concatenate([y, c]).astype(np.uint8))
    frames.append(rng.integers(0, 256, W * H * 3 // 2).astype(np.uint8))
    frames = np.stack(frames)
    budgets = [18144, 8064] * 7 + [18144]
    cap = (18144 - 8 + 1) // 2
    nat = native.bs_encode_frames(frames, np.array(budgets, np.int32),
                                  codec=codec, width=W, height=H,
                                  capacity_words=cap)
    out = BsFrameEncoder(codec, W, H, dev).encode_frames(list(frames),
                                                         budgets)
    for j, (buf, info) in enumerate(out):
        assert info["quant_scale"] == nat["scale"][j]
        payload = nat["words"][j].astype("<u2").tobytes()
        assert buf[8:].tobytes() == payload[:budgets[j] - 8]


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert torch.equal(g, w.to(g.device))


@pytest.mark.parametrize("codec", [tbs.BS_V3, tbs.BS_V3DC])
@pytest.mark.parametrize("nb,batch", DC_SHAPES)
@pytest.mark.parametrize("case", DC_CASES)
def test_dc_stage_on_adversarial_dcs(dev, case, nb, batch, codec):
    """K2 == its plain version: every step depending on the last, tie runs
    across the lanes' segments, the range's ends and the v3dc wrap; NB = 6
    to 640x480."""
    dc = torch.from_numpy(dc_case(case, batch, nb)).to(dev)
    before = bs_cuda.LAUNCHES["dc_stage"]
    got = bs_cuda.dc_stage(dc, codec)
    assert bs_cuda.LAUNCHES["dc_stage"] == before + 1
    _equal(got, bs_cuda.dc_stage_plain(dc, codec))


@pytest.mark.parametrize("nb,batch", [(6, 1000), (1800, 300), (7200, 200)])
def test_dc_stage_many_frames_a_cta(dev, nb, batch):
    """Batches larger than the SM count put several frames in a CTA."""
    assert batch > torch.cuda.get_device_properties(dev).multi_processor_count
    dc = torch.from_numpy(dc_case("tie runs", batch, nb)).to(dev)
    _equal(bs_cuda.dc_stage(dc, tbs.BS_V3DC),
           bs_cuda.dc_stage_plain(dc, tbs.BS_V3DC))


def test_dc_empty_launch_runs(dev):
    x = torch.zeros(1, device=dev)
    bs_cuda.empty_launch(x)
    bs_cuda.empty_launch(x, grid=128, threads=192)
    torch.cuda.synchronize()


@pytest.mark.parametrize("nsym", PACK_SYMBOLS + (600,))
@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_block_streams_on_adversarial_rows(dev, case, nsym):
    """K10 == its plain version on 111 rows (a ragged last tile whose
    bytes are no multiple of 16): codes with their top bit set or garbage
    above their length, 0-bit symbols between, rows of 256, 257 and far
    over 256 bits, all-zero rows; S = 600 reads its rows from global
    memory."""
    codes, bits = pack_case(case, 3, 37, nsym)
    c, b = torch.from_numpy(codes).to(dev), torch.from_numpy(bits).to(dev)
    before = bitpack_cuda.LAUNCHES["pack_block_streams"]
    got = bitpack_cuda.pack_block_streams(c, b)
    assert bitpack_cuda.LAUNCHES["pack_block_streams"] == before + 1
    _equal(got, bitpack_cuda.pack_block_streams_plain(c, b))


@pytest.mark.parametrize("rows", [1, 4, 32, 33, 4096 + 7])
@pytest.mark.parametrize("offset", [0, 1])
def test_pack_block_streams_tiles_and_alignment(dev, rows, offset):
    """Row counts on and off the tile, and tensors that do not start on a
    16-byte boundary (plain loads in place of the bulk copies)."""
    codes, bits = pack_case("0-bit symbols between", 1, rows + offset, 65)
    c = tbp.u32_to_i32(torch.from_numpy(codes)).to(dev).reshape(-1)
    b = torch.from_numpy(bits).to(dev).reshape(-1)
    n = rows * 65
    c = c[offset * 65:offset * 65 + n].view(1, rows, 65)
    b = b[offset * 65:offset * 65 + n].view(1, rows, 65)
    assert (c.data_ptr() % 16 == 0) == (offset == 0)
    _equal(bitpack_cuda.pack_block_streams(c, b),
           bitpack_cuda.pack_block_streams_plain(c, b))


def _distinct_frames(n, seed, noise_every=8):
    """n distinct 320x240 NV21 frames, every ``noise_every``-th one noise
    (its busy blocks run past 256 bits at 18,144 bytes)."""
    from psxavenc_tpu_torch.utils.synth import rand_frames

    rng = np.random.default_rng(seed)
    frames = []
    for i, (y, cb, cr) in enumerate(rand_frames(W, H, n, seed=seed)):
        if i % noise_every == noise_every - 1:
            frames.append(rng.integers(0, 256, W * H * 3 // 2)
                          .astype(np.uint8))
            continue
        c = np.stack([cr.reshape(H // 2, W // 2), cb.reshape(H // 2, W // 2)],
                     axis=-1).reshape(-1)
        frames.append(np.concatenate([y, c]).astype(np.uint8))
    return np.stack(frames)


def test_pipelined_encoder_equals_one_batch_at_a_time(dev):
    """384 distinct frames, three 128-frame batches: the pipelined
    encode_frames equals fetching each batch before the next is launched
    (bytes, infos, quant-scale sums, frames with a block over 256 bits);
    two batches are enqueued with no host wait (sync debug mode "error")
    before either is fetched."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    frames = list(_distinct_frames(384, seed=21))
    budgets = [18144] * len(frames)
    pipe = BsFrameEncoder(tbs.BS_V2, W, H, dev)
    one = BsFrameEncoder(tbs.BS_V2, W, H, dev)
    api.COUNTERS["overflow_frames"] = 0
    want = []
    for base in range(0, len(frames), 128):
        want += one.fetch(one.encode_frames_async(
            frames[base:base + 128], budgets[base:base + 128]))
    want_overflow = api.COUNTERS["overflow_frames"]
    got = pipe.encode_frames(frames, budgets)
    got_overflow = api.COUNTERS["overflow_frames"] - want_overflow
    assert [b.tobytes() for b, _ in got] == [b.tobytes() for b, _ in want]
    assert [i for _, i in got] == [i for _, i in want]
    assert pipe.quant_scale_sum == one.quant_scale_sum
    assert got_overflow == want_overflow > 0

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = pipe.encode_frames_async(frames[:128], budgets[:128])
        second = pipe.encode_frames_async(frames[128:256], budgets[128:256])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = pipe.fetch(first) + pipe.fetch(second)
    assert [b.tobytes() for b, _ in again] == \
        [b.tobytes() for b, _ in want[:256]]


def test_split_over_the_card_twice(dev):
    """parallel.mesh over [cuda:0, cuda:0] (two shards, each on its own
    stream) equals the single-device calls, and counts the same frames
    with a block over 256 bits."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.parallel import mesh

    frames = torch.from_numpy(_distinct_frames(64, seed=22)).to(dev)
    budgets = torch.full((64,), 18144, dtype=torch.int32, device=dev)
    kw = dict(codec=tbs.BS_V3DC, width=W, height=H,
              capacity_words=(18144 - 8 + 1) // 2)
    api.COUNTERS["overflow_frames"] = 0
    want = api.bs_encode_frames_packed(frames, budgets, **kw)
    want_overflow = api.COUNTERS["overflow_frames"]
    step = mesh.packed_video_step([dev, dev], **kw)
    got = step(frames, budgets)
    got_overflow = api.COUNTERS["overflow_frames"] - want_overflow
    for k, w in want.items():
        assert got[k].device == dev
        assert torch.equal(got[k], w), k
    assert got_overflow == want_overflow > 0
    with pytest.raises(ValueError, match="does not divide"):
        step(frames[:63], budgets[:63])

    rng = np.random.default_rng(23)
    units = torch.from_numpy(rng.integers(-3000, 3000, (64, 5, 28)).astype(
        np.int32)).to(dev)
    limits = torch.full((64, 5), 28, dtype=torch.int32, device=dev)
    prev = torch.zeros(64, dtype=torch.int32, device=dev)
    audio = mesh.unit_encode_step([dev, dev], filter_count=5,
                                  shift_range=12)
    for g, w in zip(audio(units, limits, prev, prev),
                    api.spu_encode_batch(units, limits, prev, prev)):
        assert torch.equal(g, w)


def _fuzz_batch(seed, n=12):
    """Seeded geometry and content (video, flat frames with hard edges,
    noise) and budgets from half a byte to 20 bytes a block, so some
    frames fit at no scale."""
    from psxavenc_tpu_torch.utils.synth import rand_frames

    rng = np.random.default_rng(seed)
    w, h = 16 * int(rng.integers(1, 21)), 16 * int(rng.integers(1, 16))
    frames = []
    for k in rng.integers(0, 3, n):
        if k == 0:
            y, cb, cr = rand_frames(w, h, 1, seed=seed)[0]
            c = np.stack([cr.reshape(h // 2, w // 2),
                          cb.reshape(h // 2, w // 2)], axis=-1).reshape(-1)
            frames.append(np.concatenate([y, c]).astype(np.uint8))
        elif k == 1:
            f = np.full(w * h * 3 // 2, 128, np.uint8)
            f[: w * 4] = 255
            frames.append(f)
        else:
            frames.append(rng.integers(0, 256, w * h * 3 // 2)
                          .astype(np.uint8))
    nbytes = w * h // 256 * 6
    budgets = rng.integers(max(16, nbytes // 2), nbytes * 20,
                           n).astype(np.int32)
    return np.stack(frames), budgets, w, h


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("codec", [tbs.BS_V2, tbs.BS_V3, tbs.BS_V3DC])
def test_card_equals_native_tier_on_fuzz(dev, codec, seed):
    """api.bs_encode_frames_packed on the card == the port's native tier:
    every frame's scale, and words, total bits and nonzero count where
    the frame fits."""
    from psxavenc_tpu_torch import api
    from psxavenc_tpu_torch.native import tiers

    frames, budgets, w, h = _fuzz_batch(100 * codec + seed)
    kw = dict(codec=codec, width=w, height=h,
              capacity_words=(int(budgets.max()) - 8 + 1) // 2)
    got = api.bs_encode_frames_packed(torch.from_numpy(frames).to(dev),
                                      torch.from_numpy(budgets).to(dev),
                                      **kw)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    got["words"] = got["words"].view(np.uint16)
    want = tiers.bs_encode_frames(frames, budgets, **kw)
    fit = want["scale"] <= 63
    assert np.array_equal(got["scale"], want["scale"])
    for k in ("words", "total_bits", "nz_count"):
        assert np.array_equal(got[k][fit], want[k][fit]), k


@pytest.mark.parametrize("filter_count,shift_range",
                         [(5, 12), (4, 12), (4, 8)])
def test_adpcm_kernel_matches_native_tier(dev, filter_count, shift_range):
    """K5 == the native unit encoder: headers, sample values and the state
    after every unit, with partial, empty and masked units."""
    from psxavenc_tpu_torch.native import tiers

    rng = np.random.default_rng(filter_count + shift_range)
    B, T = 96, 150
    units = np.cumsum(rng.integers(-3000, 3000, (B, T * 28)), axis=1)
    units = np.clip(units, -32768, 32767).astype(np.int32).reshape(B, T, 28)
    lim = np.full((B, T), 28, np.int32)
    lim[0, 7], lim[1, 9], lim[2, 11], lim[3, -20:] = 13, 0, -4, 0
    p1 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    h, words, s1, s2 = adpcm_cuda.encode_units(
        *(torch.from_numpy(a).to(dev) for a in (units, lim, p1, p2)),
        filter_count=filter_count, shift_range=shift_range)
    got = (h, adpcm_cuda.unpack_words(words, shift_range), s1, s2)
    want = tiers.adpcm_encode_units(units, lim, p1, p2, filter_count,
                                    shift_range)
    for g, w in zip(got, want):
        assert np.array_equal(g.cpu().numpy().astype(np.int64),
                              w.astype(np.int64))


def _segment_streams(T, seed):
    """Five streams with nonzero states: synthetic audio, a 440 Hz tone at
    30,000 in two phases, silence, and synthetic audio with masked units
    every 37 units and partial ones every 11."""
    from psxavenc_tpu_torch.utils.synth import rand_pcm, tone

    rng = np.random.default_rng(seed)
    pcm = rand_pcm(T * 28, channels=2, seed=seed).reshape(-1, 2).T
    tones = tone(T * 28, channels=2).T
    units = np.stack([pcm[0], tones[0], tones[1], np.zeros(T * 28),
                      pcm[1]]).astype(np.int32).reshape(5, T, 28)
    lim = np.full((5, T), 28, np.int32)
    lim[4, ::37] = 0
    lim[4, 5::11] = 9
    lim[4, 18::37] = -3
    p1 = rng.integers(-0x8000, 0x8000, 5).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, 5).astype(np.int32)
    return units, lim, p1, p2


@pytest.mark.parametrize("segments", [None, 2, 9, 64])
@pytest.mark.parametrize("filter_count,shift_range",
                         adpcm_cuda.KERNEL_VARIANTS)
def test_adpcm_segmented_matches_model(dev, filter_count, shift_range,
                                       segments):
    """The segmented K5 (the plan's S, and S forced) equals the native
    tier's whole-stream encode, and its stats equal the plain model's
    count for count; 2 + ROUNDS launches a segmented call."""
    from psxavenc_tpu_torch.native import tiers

    T = 1000
    host = _segment_streams(T, seed=filter_count * 7 + shift_range)
    args = [torch.from_numpy(a).to(dev) for a in host]
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    before = adpcm_cuda.LAUNCHES["adpcm_encode_units"]
    got = adpcm_cuda.encode_units(*args, filter_count=filter_count,
                                  shift_range=shift_range,
                                  segments=segments, stats_out=stats)
    S = segments or adpcm_cuda.plan_segments(5, T)
    assert adpcm_cuda.LAUNCHES["adpcm_encode_units"] - before == (
        1 if S == 1 else 2 + adpcm_cuda.ROUNDS)
    *model, want_stats = adpcm_cuda.encode_units_segmented_plain(
        *(torch.from_numpy(a) for a in host), filter_count=filter_count,
        shift_range=shift_range, segments=segments, rows="native")
    want = tiers.adpcm_encode_units(*host, filter_count, shift_range)
    got = (got[0], adpcm_cuda.unpack_words(got[1], shift_range), *got[2:])
    for g, m, w in zip(got, (model[0], adpcm_cuda.unpack_words(
            model[1], shift_range), *model[2:]), want):
        assert np.array_equal(g.cpu().numpy().astype(np.int64),
                              w.astype(np.int64))
        assert torch.equal(g.cpu(), m)
    assert stats.cpu().tolist() == want_stats.tolist()


def test_adpcm_segmented_replays_in_a_graph(dev):
    """A segmented K5 call makes no host sync and a fixed number of
    launches: captured in a CUDA graph it replays to the eager outputs."""
    T = 4096
    args = [torch.from_numpy(a).to(dev) for a in _segment_streams(T, 3)]
    assert adpcm_cuda.plan_segments(5, T) > 1
    eager = adpcm_cuda.encode_units(*args, filter_count=4, shift_range=12)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adpcm_cuda.encode_units(*args, filter_count=4, shift_range=12)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = adpcm_cuda.encode_units(*args, filter_count=4, shift_range=12)
    for o in out:
        o.fill_(-1)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(out, eager):
        assert torch.equal(o, e)


def _chunked_pcm(T, seed):
    """_segment_streams' five streams as int16 PCM read through ragged
    chunks: offsets off the 28-grid (a different one each stream),
    partial units, masked ones, and the last units at or past the end of
    the samples."""
    from psxavenc_tpu_torch.models import adpcm_stream as streams

    units, _, p1, p2 = _segment_streams(T, seed)
    pcm = units.reshape(5, -1).astype(np.int16)
    rng = np.random.default_rng(seed)
    offs, lim = streams.chunk_unit_layout(rng.integers(1, 120, T))
    offs, lim = offs[:T], lim[:T]
    offs[-3:] = pcm.shape[1] - 40 + np.array([0, 30, 60])
    offs = np.stack([offs + b for b in range(5)])
    lim = np.stack([lim] * 5)
    lim[4, ::37] = 0
    lim[3, 18::37] = -3
    return pcm, offs, lim, p1, p2


@pytest.mark.parametrize("segments", [1, None, 7])
@pytest.mark.parametrize("filter_count,shift_range",
                         adpcm_cuda.KERNEL_VARIANTS)
def test_adpcm_pcm_units_match_model(dev, filter_count, shift_range,
                                     segments):
    """K5 reading units from int16 PCM by ragged chunk offsets (the
    serial route, the plan's segments, 7 forced) equals the native tier
    on the units gathered on the host, and its stats the plain model's;
    the call counts as the offsets layout."""
    from psxavenc_tpu_torch.native import tiers

    T = 1000
    pcm, offs, lim, p1, p2 = _chunked_pcm(T, filter_count + shift_range)
    units = adpcm_cuda.gather_units_plain(
        torch.from_numpy(pcm), torch.from_numpy(offs), T)
    host = (units.numpy(), lim.astype(np.int32), p1, p2)
    want = tiers.adpcm_encode_units(*host, filter_count, shift_range)
    *model, want_stats = adpcm_cuda.encode_units_segmented_plain(
        *(torch.from_numpy(a) for a in host), filter_count=filter_count,
        shift_range=shift_range, segments=segments, rows="native")
    stats = torch.zeros(5, dtype=torch.int64, device=dev)
    inputs = dict(adpcm_cuda.INPUTS)
    got = adpcm_cuda.encode_pcm_units(
        torch.from_numpy(pcm).to(dev),
        torch.from_numpy(adpcm_cuda.unit_offsets(offs)).to(dev),
        *(torch.from_numpy(a).to(dev) for a in host[1:]),
        filter_count=filter_count, shift_range=shift_range,
        segments=segments, stats_out=stats)
    assert adpcm_cuda.INPUTS == {"offsets": inputs["offsets"] + 1,
                                 "dense": inputs["dense"]}
    got = (got[0], adpcm_cuda.unpack_words(got[1], shift_range), *got[2:])
    for g, m, w in zip(got, (model[0], adpcm_cuda.unpack_words(
            model[1], shift_range), *model[2:]), want):
        assert np.array_equal(g.cpu().numpy().astype(np.int64),
                              w.astype(np.int64))
        assert torch.equal(g.cpu(), m)
    assert stats.cpu().tolist() == want_stats.tolist()


def test_xa_chunk_call_peak_is_k5_working_set(dev, monkeypatch):
    """One ``encode_unit_streams`` call of the XA CLI's largest chunk
    (1,024 stereo sectors: 2 x 73,728 units, offsets broadcast as
    ``XaAudioSectors`` passes them) holds at most the int16 PCM, the int32
    offsets, two limit copies and K5's outputs (14,155,776 B) plus 64 KiB
    on the card, gathers nothing (K5 reads the PCM) and gives the native
    tier's headers, values and final state."""
    from psxavenc_tpu_torch.models import adpcm_stream as streams
    from psxavenc_tpu_torch.native import tiers
    from psxavenc_tpu_torch.utils.synth import rand_pcm

    T = 73728
    N = 28 * T
    pcm = rand_pcm(N, channels=2, seed=21).T.copy()
    offs, lim = streams.uniform_unit_layout(T, N - 100)
    offs, lim = (np.broadcast_to(a, (2, T)) for a in (offs, lim))
    units = adpcm_cuda.gather_units_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (pcm, offs)), T)
    lim32 = adpcm_cuda.clip_limits(torch.from_numpy(lim))
    zero = np.zeros(2, np.int32)
    want = tiers.adpcm_encode_units(units.numpy(), lim32.numpy(), zero, zero,
                                    4, 12)

    def no_gather(*_args, **_kwargs):
        raise AssertionError("a unit gather on the card path")

    monkeypatch.setattr(adpcm_cuda, "gather_units_plain", no_gather)
    inputs = dict(adpcm_cuda.INPUTS)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    h, v, f1, f2 = streams.encode_unit_streams(pcm, offs, lim, 4, 12,
                                               device=dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"peak {peak} B")
    assert peak <= 14155776 + (64 << 10)
    assert adpcm_cuda.INPUTS["offsets"] == inputs["offsets"] + 1
    assert np.array_equal(h, want[0].astype(np.uint8))
    assert np.array_equal(v, want[1].astype(np.uint8))
    assert f1.tolist() == want[2][:, -1].tolist()
    assert f2.tolist() == want[3][:, -1].tolist()


def _bank_units(B=256, T=7816):
    """A bank's zero-padded (B, T) SPU units as the batch runner groups
    them: int32 units, limits with masked tails, the final-state index
    and carried-in states."""
    rng = np.random.default_rng(18)
    amp = rng.uniform(30, 20000, (B, 1, 1))
    units = np.clip(rng.standard_normal((B, T, 28)) * amp, -32768,
                    32767).astype(np.int32)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    lim = np.where(np.arange(T) < lens[:, None], 28, 0).astype(np.int32)
    lim[np.arange(B), lens - 1] = rng.integers(1, 29, B)
    p1 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    return units, lim, lens - 1, p1, p2


def _grouped_peak(dev, device, units, lim, state_t, p1, p2):
    """``encode_prepared_units`` on ``device`` -> (its outputs, the most
    memory it held on ``dev`` at once, in bytes)."""
    from psxavenc_tpu_torch.models import adpcm_stream as streams

    units_t, lim_t = torch.from_numpy(units), torch.from_numpy(lim)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = streams.encode_prepared_units(units_t, lim_t, 5, 12, prev1=p1,
                                        prev2=p2, state_t=state_t,
                                        device=device)
    return got, torch.cuda.max_memory_allocated(dev) - base


def test_grouped_unit_call_peak_is_k5_working_set(dev):
    """One ``encode_prepared_units`` call on a bank's zero-padded (256,
    7,816) SPU units holds at most 94 bytes a unit on the card (the units
    as int16 samples 56, two clipped limits 8, K5's outputs 28: the unpack
    runs after the samples are freed), takes K5's dense layout and gives
    K5's headers, values and states."""
    units, lim, state_t, p1, p2 = _bank_units()
    B, T = lim.shape
    inputs = dict(adpcm_cuda.INPUTS)
    got, peak = _grouped_peak(dev, dev, units, lim, state_t, p1, p2)
    print(f"peak {peak} B, {peak / (B * T):.2f} B a unit")
    assert peak <= 94 * B * T + (1 << 20)
    assert adpcm_cuda.INPUTS == {"offsets": inputs["offsets"],
                                 "dense": inputs["dense"] + 1}
    h, w, s1, s2 = adpcm_cuda.encode_units(
        *(torch.from_numpy(a).to(dev) for a in (units, lim, p1, p2)),
        filter_count=5, shift_range=12)
    rows = torch.arange(B, device=dev)
    t_idx = torch.from_numpy(state_t).to(dev)
    want = (h.to(torch.uint8), adpcm_cuda.unpack_words(w, 12).to(torch.uint8),
            s1[rows, t_idx], s2[rows, t_idx])
    for name, g, wnt in zip(("headers", "values", "prev1", "prev2"), got,
                            want):
        wnt = wnt.cpu().numpy()
        assert g.dtype == wnt.dtype and np.array_equal(g, wnt), name


def test_grouped_unit_call_split_on_one_card(dev):
    """The grouped call over ``[cuda:0, cuda:0]`` (a shard a listed device,
    both enqueued before either is read back) gives the one-device call's
    bytes, a K5 call a shard, and holds no more memory at once."""
    args = _bank_units()
    one, one_peak = _grouped_peak(dev, dev, *args)
    inputs = dict(adpcm_cuda.INPUTS)
    two, two_peak = _grouped_peak(dev, [dev, dev], *args)
    print(f"peak one device {one_peak} B, two shards {two_peak} B")
    assert adpcm_cuda.INPUTS["dense"] == inputs["dense"] + 2
    for name, g, w in zip(("headers", "values", "prev1", "prev2"), two, one,
                          strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert two_peak <= one_peak


def test_cuda_encoder_under_auto_makes_no_native_call(dev, monkeypatch):
    """The default tier of an encoder on the card is the card's kernels;
    ``native`` asked for by name is refused on the card and runs on the
    host only for an encoder given the CPU."""
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    from psxavenc_tpu_torch.native import tiers

    frames = list(_distinct_frames(40, seed=24))
    budgets = [18144] * len(frames)
    before = dict(tiers.COUNTERS)
    for value in (None, "auto", "device"):
        if value is None:
            monkeypatch.delenv("PSXAVENC_VIDEO_TIER", raising=False)
        else:
            monkeypatch.setenv("PSXAVENC_VIDEO_TIER", value)
        enc = BsFrameEncoder(tbs.BS_V2, W, H, dev)
        assert enc.tier == "device"
        got = enc.encode_frames(frames, budgets)
        enc.close()
    assert tiers.COUNTERS == before
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", "native")
    with pytest.raises(ValueError, match="PSXAVENC_VIDEO_TIER=native"):
        BsFrameEncoder(tbs.BS_V2, W, H, dev)
    assert tiers.COUNTERS == before
    enc = BsFrameEncoder(tbs.BS_V2, W, H, "cpu")
    assert enc.tier == "native"
    want = enc.encode_frames(frames, budgets)
    assert tiers.COUNTERS["bs_encode_frames"] == \
        before["bs_encode_frames"] + 1
    assert [b.tobytes() for b, _ in got] == [b.tobytes() for b, _ in want]


def test_close_with_a_batch_in_flight(dev):
    """close() waits for the enqueued batch: its handle still fetches the
    right frames; a second close() is a no-op; enqueueing raises."""
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder

    frames = list(_distinct_frames(256, seed=25))
    budgets = [18144] * len(frames)
    want = BsFrameEncoder(tbs.BS_V3DC, W, H, dev).encode_frames(frames,
                                                                budgets)
    enc = BsFrameEncoder(tbs.BS_V3DC, W, H, dev)
    first = enc.encode_frames_async(frames[:128], budgets[:128])
    second = enc.encode_frames_async(frames[128:], budgets[128:])
    enc.close()
    assert enc._stream is None and enc._staging is None
    enc.close()
    got = enc.fetch(first) + enc.fetch(second)
    assert [b.tobytes() for b, _ in got] == [b.tobytes() for b, _ in want]
    with pytest.raises(RuntimeError, match="closed"):
        enc.encode_frames(frames[:8], budgets[:8])
