"""The port's plain ops equal psxavenc_tpu's on identical seeded inputs:
FDCT, NV21 rearranges, DC chain, symbol emission and bit packing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu.ops import bitpack as jbp
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu.ops import fdct as jfdct
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import fdct as tfdct

from test_torch_parity import assert_same, run_both, video_frames


def test_fdct_rows_matches_jax():
    """Row-form FDCT on valid centered pixels (ragged block count)."""
    rng = np.random.default_rng(1)
    pix = rng.integers(-128, 128, (64, 2, 203)).astype(np.int32)
    want = jfdct.fdct_rows([jnp.asarray(r) for r in pix])
    got = tfdct.fdct_rows([torch.from_numpy(r) for r in pix])
    for i, (w, g) in enumerate(zip(want, got)):
        assert_same(w, g, name=f"coef {i}")


def test_fdct_islow_matches_jax_with_wrap():
    """Block-form FDCT, with inputs wide enough to hit the pass-1 int16
    wrap (the reference's int16 store)."""
    rng = np.random.default_rng(2)
    blocks = rng.integers(-3000, 3000, (37, 8, 8)).astype(np.int32)
    run_both(jfdct.fdct_islow, tfdct.fdct_islow, blocks)


@pytest.mark.parametrize("wh", [(16, 16), (48, 32)])
def test_rearranges_match_jax(wh):
    w, h = wh
    frames = video_frames(w, h, 2, seed=3)
    want_rows = np.stack([np.asarray(jbs.rearrange_nv21_rows(
        jnp.asarray(f), w, h)) for f in frames])
    want_blocks = np.stack([np.asarray(jbs.rearrange_nv21_frame(
        jnp.asarray(f), w, h)) for f in frames])
    ft = torch.from_numpy(frames)
    rows = tbs.rearrange_nv21_rows(ft, w, h)
    assert rows.dtype == torch.int8
    assert_same(want_rows, rows)
    assert_same(want_blocks, tbs.rearrange_nv21_frame(ft, w, h))
    # The DC of the FDCT is the centered pixel sum (the DC-stage shortcut).
    coefs = tfdct.fdct_islow(tbs.rearrange_nv21_frame(ft, w, h))
    assert_same(coefs[..., 0, 0].reshape(len(frames), -1),
                rows.to(torch.int32).sum(dim=1))
    run_both(jbs.pixrows_to_coefs_zz, tbs.pixrows_to_coefs_zz,
             want_rows.astype(np.int32))


@pytest.mark.parametrize("codec", [jbs.BS_V3, jbs.BS_V3DC])
def test_dc_chain_matches_jax(codec):
    """The v3/v3dc DC chain and DC stage, incl. exact halves and the
    +-256 wrap deltas."""
    rng = np.random.default_rng(31)
    dc_q = rng.integers(-512, 511, (3, 6 * 37)).astype(np.int32)
    dc_q[0, :12] = [510, -510, 2, -2, 254, -254, 6, 510, -2, 2, -510, 254]
    want = jax.vmap(lambda d: jbs.dc_chain(d, codec)[0])(jnp.asarray(dc_q))
    got, _ = tbs.dc_chain(torch.from_numpy(dc_q), codec)
    assert_same(want, got)
    run_both(functools.partial(jbs._dc_stage, codec=codec),
             functools.partial(tbs._dc_stage, codec=codec), dc_q, u32=True)


def _symbols_inputs(seed, B=2, nb=90):
    rng = np.random.default_rng(seed)
    c = rng.integers(-900, 900, (B, 63, nb)).astype(np.int32)
    c[:, 20:, : nb // 3] = 0                      # long zero runs
    scale_idx = np.array([0, 30], np.int32)[:B]
    dc_bits = rng.integers(2, 11, (B, nb)).astype(np.int32)
    dc_code = (rng.integers(0, 1 << 10, (B, nb)).astype(np.int32)
               & ((1 << dc_bits) - 1))
    return c, scale_idx, dc_bits, dc_code


def test_emit_symbols_and_pack_bits_match_jax():
    """emit_symbols_at at two scales, then the flat packer with a
    capacity that cuts the stream short."""
    c, scale_idx, dc_bits, dc_code = _symbols_inputs(4)
    (codes, bits), _ = run_both(jbs.emit_symbols_at, tbs.emit_symbols_at,
                                c, scale_idx, dc_bits, dc_code, u32=True)
    codes = np.array(codes).reshape(2, -1)
    bits = np.array(bits).reshape(2, -1)
    cap = int(bits.sum(axis=1).max()) // 16 - 40
    want_w, want_t = jax.vmap(functools.partial(
        jbp.pack_bits, capacity_words=cap))(jnp.asarray(codes),
                                            jnp.asarray(bits))
    got_w, got_t = tbp.pack_bits(torch.from_numpy(codes.astype(np.int64)),
                                 torch.from_numpy(bits), capacity_words=cap)
    assert_same(want_w, got_w)
    assert_same(want_t, got_t)


def test_streams_to_u32_matches_jax():
    rng = np.random.default_rng(5)
    streams = rng.integers(0, 1 << 16, (2, 40, 16)).astype(np.int64)
    bb = rng.integers(10, 200, (2, 40))
    goff = (np.cumsum(bb, axis=1) - bb).astype(np.int32)
    want = jbp.streams_to_u32(jnp.asarray(streams.astype(np.uint32)),
                              jnp.asarray(goff))
    got = tbp.streams_to_u32(torch.from_numpy(streams),
                             torch.from_numpy(goff))
    assert_same(want[0], got[0], u32=True)
    assert_same(want[1], got[1])


@pytest.mark.parametrize("codec", [jbs.BS_V2, jbs.BS_V3, jbs.BS_V3DC])
def test_select_frames_pixels_matches_jax(monkeypatch, codec):
    """ops.bs.select_frames_pixels equals psxavenc_tpu's (its Pallas
    kernels in interpret mode) key for key on 32x32 frames, one of them
    noise and one with a budget too small for any scale."""
    from psxavenc_tpu.ops import bs_pallas as jbsp

    for fn in ("select_scale_pix_pallas", "dc_stage_pallas"):
        monkeypatch.setattr(jbsp, fn, functools.partial(getattr(jbsp, fn),
                                                        interpret=True))
    frames = video_frames(32, 32, 3, seed=9)
    budgets = np.array([900, 400, 1500, 60], np.int32)
    pix = np.stack([np.asarray(jbs.rearrange_nv21_rows(jnp.asarray(f), 32,
                                                       32)) for f in frames])
    want = jbs.select_frames_pixels(jnp.asarray(pix), jnp.asarray(budgets),
                                    codec=codec)
    got = tbs.select_frames_pixels(
        tbs.rearrange_nv21_rows(torch.from_numpy(frames), 32, 32),
        torch.from_numpy(budgets), codec=codec)
    assert got.keys() == want.keys()
    for k in want:
        assert_same(want[k], got[k], name=k, u32=k == "dc_code")
    assert int(got["scale"][3]) == 64
