"""The port's symbols API and the kernels of its selection and packing
stages equal the JAX package: ``encode_frames_symbols`` and
``bs_encode_frames`` on both sweeps, and the plain versions of K6, K7, K9
and K10 against the Pallas kernels they replace, run in interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu import api as japi
from psxavenc_tpu.ops import bitpack as jbp
from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_parity import assert_same, video_frames

W, H = 48, 32


@pytest.fixture
def interpret_select(monkeypatch):
    monkeypatch.setattr(jbsp, "select_scale_pallas", functools.partial(
        jbsp.select_scale_pallas, interpret=True))


def _coef_batch():
    """(4, 36, 64) int32 coefficients and budgets: two fitting frames, one
    that fits no scale with a positive AC threshold and one whose
    threshold is negative (a budget below its DC bits)."""
    rng = np.random.default_rng(7)
    coefs = rng.integers(-2000, 2000, (4, 36, 64)).astype(np.int32)
    coefs[3] //= 8
    return coefs, np.array([1800, 700, 300, 20], np.int32)


def _compare(want, got, keys):
    for k in keys:
        assert_same(want[k], got[k], name=k, u32=k == "codes")


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("kernel_sweep", [True, False])
def test_encode_frames_symbols_matches_jax(interpret_select, kernel_sweep,
                                           emit):
    coefs, budgets = _coef_batch()
    want = jbs.encode_frames_symbols(
        jnp.asarray(coefs), jnp.asarray(budgets), codec=jbs.BS_V3DC,
        pallas_sweep=kernel_sweep, emit=emit)
    got = tbs.encode_frames_symbols(
        torch.from_numpy(coefs), torch.from_numpy(budgets),
        codec=tbs.BS_V3DC, kernel_sweep=kernel_sweep, emit=emit)
    assert sorted(want) == sorted(got)
    _compare(want, got, want)
    scale = got["scale"].numpy()
    assert (scale[2:] == 64).all() and (scale[:2] <= 63).all()
    dc_bits = tbs.encode_frames_symbols(
        torch.from_numpy(coefs), torch.from_numpy(budgets),
        codec=tbs.BS_V3DC, kernel_sweep=False, emit=False)["dc_bits"]
    thr = tbs.ac_threshold(torch.from_numpy(budgets),
                           dc_bits.sum(dim=1, dtype=torch.int32), 36)
    assert int(thr[2]) > 0 > int(thr[3])
    # The two sweeps' own numbers for a frame that fits nowhere.
    if kernel_sweep:
        assert int(got["nz_count"][2]) == 0
    else:
        assert int(got["nz_count"][2]) > 0


def test_encode_frame_symbols_matches_jax():
    coefs, budgets = _coef_batch()
    want = jbs.encode_frame_symbols(jnp.asarray(coefs[0]), int(budgets[0]),
                                    codec=jbs.BS_V2)
    got = tbs.encode_frame_symbols(torch.from_numpy(coefs[0]),
                                   int(budgets[0]), codec=tbs.BS_V2,
                                   kernel_sweep=False)
    _compare(want, got, want)


def _frame_batch():
    """Two synthetic frames, a noise frame and a flat frame; the flat one
    with a budget below its DC bits, the noise one unfittable too."""
    frames = video_frames(W, H, 2, seed=8, noise=1)
    flat = np.full((1, frames.shape[1]), 77, np.uint8)
    return np.concatenate([frames, flat]), np.array([900, 400, 200, 20],
                                                    np.int32)


@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3])
@pytest.mark.parametrize("kernel_sweep", [True, False])
def test_bs_encode_frames_matches_jax(interpret_select, kernel_sweep, codec):
    frames, budgets = _frame_batch()
    want = japi.bs_encode_frames(jnp.asarray(frames), jnp.asarray(budgets),
                                 codec=codec, width=W, height=H,
                                 pallas_sweep=kernel_sweep)
    got = tapi.bs_encode_frames(torch.from_numpy(frames),
                                torch.from_numpy(budgets), codec=codec,
                                width=W, height=H, kernel_sweep=kernel_sweep)
    assert sorted(want) == sorted(got)
    _compare(want, got, want)
    assert (got["scale"].numpy()[2:] == 64).all()


# ------------------------------------------------------------------- K6

def test_select_scale_matches_pallas():
    """K6's plain version: a negative threshold (nothing fits), a loose
    one (scale 1), an all-zero frame, tight and mid thresholds, over two
    512-lane chunks with a ragged tail."""
    rng = np.random.default_rng(3)
    c = rng.integers(-3000, 3000, (5, 63, 512 + 73)).astype(np.int32)
    c[2] = 0
    totals = torch.stack([bs_cuda._exact_totals(torch.from_numpy(c).abs(),
                                                s)[0]
                          for s in (1, 20, 63)], dim=1)
    thr = np.array([-5, 10 ** 8, 0, int(totals[3, 2]) - 1,
                    int(totals[4, 1])], np.int32)
    want = jbsp.select_scale_pallas(jnp.asarray(c), jnp.asarray(thr),
                                    interpret=True)
    got = bs_cuda.select_scale(torch.from_numpy(c), torch.from_numpy(thr))
    for name, w, g in zip(("scale", "bits", "nz"), want, got):
        assert_same(w, g, name=name)
    scale = got[0].numpy()
    assert scale[0] == 64 and scale[1] == 1 and scale[2] == 1
    assert scale[3] == 64 and 1 < scale[4] <= 20


# ------------------------------------------------------------------- K7

def _emit_inputs(seed, B, nb):
    rng = np.random.default_rng(seed)
    c = rng.integers(-900, 900, (B, 63, nb)).astype(np.int32)
    c[:, 10:, :nb // 2] = 0                   # short blocks beside long ones
    c64 = np.zeros((B, 64, bs_cuda.nb_padded(nb)), np.int16)
    c64[:, :63, :nb] = c
    scale = np.array([2, 31, 63][:B], np.int32)
    dc_bits = rng.integers(2, 11, (B, nb)).astype(np.int32)
    dc_code = (rng.integers(0, 1 << 10, (B, nb)).astype(np.int32)
               & ((1 << dc_bits) - 1))
    return c, c64, scale, dc_code, dc_bits


@pytest.mark.parametrize("form", ["coefs63_int32", "select64_int16"])
def test_emit_pack_matches_pallas(form):
    """K7 on both coefficient forms; frame 0 (scale 2) has blocks over 256
    bits, whose streams are cut."""
    nb = 222
    c, c64, scale, dc_code, dc_bits = _emit_inputs(43, 3, nb)
    coefs = c if form == "coefs63_int32" else c64
    want = jbsp.emit_pack_pallas(jnp.asarray(coefs), jnp.asarray(scale),
                                 jnp.asarray(dc_code), jnp.asarray(dc_bits),
                                 interpret=True)
    got = bs_cuda.emit_pack(*(torch.from_numpy(a) for a in (coefs, scale,
                                                            dc_code,
                                                            dc_bits)))
    assert got[0].shape == (3, nb, 16)
    assert_same(want[0], got[0], name="streams", u32=True)
    assert_same(want[1], got[1], name="block_bits")
    assert int(got[1][0].max()) > 256


# ------------------------------------------------------------ K9 and K10

def _symbols(rng, B, nbe, s=65, keep_in_window=True):
    """(B, nbe, s) uint32 codes and int32 bits like
    tests/test_bitpack_pallas.py's, optionally with blocks over 256
    bits."""
    bits = rng.integers(0, 23, (B, nbe, s)).astype(np.int32)
    bits[rng.random((B, nbe, s)) < 0.6] = 0
    if keep_in_window:
        for f in range(B):
            while True:
                over = bits[f].sum(axis=1) > 16 * tbp.BLOCK_CAP_WORDS
                if not over.any():
                    break
                bits[f, over, rng.integers(0, s)] = 0
    codes = np.zeros((B, nbe, s), np.uint32)
    mask = bits > 0
    codes[mask] = rng.integers(0, 1 << 30, mask.sum())
    codes[mask] &= (1 << bits[mask].astype(np.uint32)) - 1
    return codes, bits


def test_pack_block_streams_matches_pallas():
    """K10's plain version, blocks over 256 bits included (cut windows)."""
    rng = np.random.default_rng(4)
    codes, bits = _symbols(rng, 2, 40, keep_in_window=False)
    assert (bits.sum(axis=2) > 256).any()
    want = jbpk.pack_block_streams_pallas(jnp.asarray(codes),
                                          jnp.asarray(bits), interpret=True)
    got = bitpack_cuda.pack_block_streams(
        torch.from_numpy(codes.astype(np.int64)), torch.from_numpy(bits))
    assert_same(want[0], got[0], name="streams", u32=True)
    assert_same(want[1], got[1], name="block_bits")


def _streams_and_offsets(seed, B, nbe):
    rng = np.random.default_rng(seed)
    codes, bits = _symbols(rng, B, nbe)
    streams, block_bits = bitpack_cuda.pack_block_streams_plain(
        torch.from_numpy(codes.astype(np.int64)), torch.from_numpy(bits))
    goff = torch.cumsum(block_bits, dim=1) - block_bits
    total = goff[:, -1] + block_bits[:, -1]
    return streams, goff.to(torch.int32), total.to(torch.int32)


@pytest.mark.parametrize("odd", [False, True])
def test_place_streams_matches_pallas(odd):
    """K9's plain version on fitting frames; an odd capacity drops the
    last u32's high half."""
    streams, goff, total = _streams_and_offsets(5, 3, 40)
    cap = (int(total.max()) + 15) // 16 + 4
    cap += (cap % 2) != odd
    want = jbpk.place_streams_pallas(
        jnp.asarray(streams.numpy()), jnp.asarray(goff.numpy()),
        jnp.asarray(total.numpy()), capacity_words=cap, interpret=True)
    got = bitpack_cuda.place_streams(streams, goff, total,
                                     capacity_words=cap)
    assert got.shape == (3, cap)
    assert_same(want, got)


def test_place_streams_mxu_matches_pallas():
    """streams_to_u32 + K4's plain version == the JAX MXU wrapper."""
    streams, goff, total = _streams_and_offsets(6, 2, 60)
    cap = (int(total.max()) + 15) // 16 + 3
    want = jbpk.place_streams_mxu_pallas(
        jnp.asarray(streams.numpy()), jnp.asarray(goff.numpy()),
        jnp.asarray(total.numpy()), capacity_words=cap, interpret=True)
    got = bitpack_cuda.place_streams_mxu(streams, goff, total,
                                         capacity_words=cap)
    assert_same(want, got)


def test_place_streams_drops_past_capacity():
    """Offsets past cap32 drop: a capacity that cuts the stream short
    gives the uncut words' head."""
    streams, goff, total = _streams_and_offsets(7, 2, 40)
    full = (int(total.max()) + 15) // 16 + 2
    cut = full // 3
    whole = bitpack_cuda.place_streams(streams, goff, total,
                                       capacity_words=full)
    head = bitpack_cuda.place_streams(streams, goff, total,
                                      capacity_words=cut)
    assert torch.equal(head, whole[:, :cut])


# ---------------------------------------------------- the per-block packer

@pytest.fixture
def interpret_packers(monkeypatch):
    for fn in ("pack_block_streams_pallas", "place_streams_pallas"):
        monkeypatch.setattr(jbpk, fn, functools.partial(getattr(jbpk, fn),
                                                        interpret=True))


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("kernels", [False, True])
def test_pack_frames_blocks_matches_jax(interpret_packers, kernels,
                                        overflow):
    """pack_frames_blocks (the plain stages, or K10 + K9) == the JAX
    per-block packer; with a block over 256 bits in the batch, JAX packs
    the whole batch flat and the port that frame."""
    rng = np.random.default_rng(8 + overflow)
    codes, bits = _symbols(rng, 3, 30)
    if overflow:
        bits[1, 4, :40] = 20
        codes[1, 4, :40] = 0xABCDE & ((1 << 20) - 1)
    total = int(bits.sum(axis=(1, 2)).max())
    cap = (total + 15) // 16 + 3
    want = jbp.pack_frames_blocks(jnp.asarray(codes), jnp.asarray(bits),
                                  capacity_words=cap, pallas_place=kernels,
                                  pallas_pack=kernels)
    got = tbp.pack_frames_blocks(torch.from_numpy(codes.astype(np.int64)),
                                 torch.from_numpy(bits), capacity_words=cap,
                                 kernel_place=kernels, kernel_pack=kernels)
    assert_same(want[0], got[0], name="words")
    assert_same(want[1], got[1], name="total_bits")


def test_pack_bits_blocks_and_words_to_bytes_match_jax():
    rng = np.random.default_rng(12)
    codes, bits = _symbols(rng, 1, 25)
    cap = (int(bits.sum()) + 15) // 16 + 1
    want = jbp.pack_bits_blocks(jnp.asarray(codes[0]), jnp.asarray(bits[0]),
                                capacity_words=cap)
    got = tbp.pack_bits_blocks(torch.from_numpy(codes[0].astype(np.int64)),
                               torch.from_numpy(bits[0]), capacity_words=cap)
    assert_same(want[0], got[0], name="words")
    assert_same(want[1], got[1], name="total_bits")
    assert_same(jbp.words_to_bytes(want[0]), tbp.words_to_bytes(got[0]))
