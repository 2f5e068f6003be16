"""Each kernel of the port (its plain version on the CPU) equals the Pallas
kernel it replaces, run in interpret mode. The CUDA kernels themselves are
held against these plain versions in test_torch_cuda.py, on a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_parity import assert_same

NB_RAGGED = 512 + 73   # two 512-lane chunks on the TPU side, ragged tail


def _pix(seed, B, nb):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (B, 64, nb)).astype(np.int8)


def _thresholds(pix):
    """Per frame: its tightest fitting total (fits only at its best
    scale), a mid-range one, unfittable (-1) and loose."""
    ca = tbs.pixrows_to_coefs_zz(torch.from_numpy(pix)).abs()
    totals = torch.stack([bs_cuda._exact_totals(ca, s)[0]
                          for s in range(1, 64)], dim=1)
    lo, hi = totals.min(dim=1).values, totals.max(dim=1).values
    return np.array([int(lo[0]), int(0.4 * lo[1] + 0.6 * hi[1]), -1,
                     10 ** 8], np.int32)


def test_select_scale_pix_matches_pallas():
    """K1: scale, bits, nz and the coefficient output, incl. unfittable
    and loose thresholds and a ragged multi-chunk block count."""
    pix = _pix(21, 4, NB_RAGGED)
    thr = _thresholds(pix)
    want = jbsp.select_scale_pix_pallas(jnp.asarray(pix.astype(np.int32)),
                                        jnp.asarray(thr), interpret=True)
    got = bs_cuda.select_scale_pix(torch.from_numpy(pix),
                                   torch.from_numpy(thr))
    for name, w, g in zip(("scale", "bits", "nz", "coefs"), want, got):
        assert_same(w, g, name=name)
    scale = got[0].numpy()
    assert scale[2] == 64 and scale[3] == 1 and 1 <= scale[0] <= 63


@pytest.mark.parametrize("codec", [jbs.BS_V3, jbs.BS_V3DC])
def test_dc_stage_matches_pallas(codec):
    """K2 for v3 and v3dc with forced exact halves and +-256 wraps."""
    rng = np.random.default_rng(31)
    dc_q = rng.integers(-512, 511, (5, 6 * 37)).astype(np.int32)
    dc_q[0, :12] = [510, -510, 2, -2, 254, -254, 6, 510, -2, 2, -510, 254]
    want = jbsp.dc_stage_pallas(jnp.asarray(dc_q), codec, interpret=True)
    got = bs_cuda.dc_stage(torch.from_numpy(dc_q), codec)
    assert_same(want[0], got[0])
    assert_same(want[1], got[1], u32=True)


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


def test_emit_prep_matches_pallas():
    """K3 on the first NB + 1 entries (the EOF block at NB)."""
    nb = 222
    c, c64, scale, dc_code, dc_bits = _emit_inputs(41, 3, nb)
    want = jbsp.emit_prep_pallas(jnp.asarray(c), jnp.asarray(scale),
                                 jnp.asarray(dc_code), jnp.asarray(dc_bits),
                                 eof=0x3FF, interpret=True)
    got = bs_cuda.emit_prep(*(torch.from_numpy(a) for a in (c64, scale,
                                                            dc_code,
                                                            dc_bits)),
                            eof=0x3FF)
    n1 = nb + 1
    assert_same(np.asarray(want[0])[:, :n1], got[0], name="vals32", u32=True)
    assert_same(np.asarray(want[1])[:, :n1], got[1], name="e0")
    assert_same(want[2], got[2], name="block_bits")
    assert_same(want[3], got[3], name="total_bits")
    # Frame 0 (scale 2) has blocks over the 256-bit window: the gate the
    # overflow path keys on.
    assert int(got[2][0].max()) > 256


def test_place_vals_matches_pallas():
    """K4 on placed contributions of real emitted streams, with a
    capacity that cuts the longest frame short."""
    nb = 222
    _, c64, scale, dc_code, dc_bits = _emit_inputs(42, 3, nb)
    scale[0] = 40                               # no block over 256 bits
    vals32, e0, _, total = bs_cuda.emit_prep_plain(
        *(torch.from_numpy(a) for a in (c64, scale, dc_code, dc_bits)),
        eof=0x1FF)
    cap = int(total.max()) // 16 - 30
    want = jbpk.place_vals_mxu_pallas(jnp.asarray(vals32.numpy()),
                                      jnp.asarray(e0.numpy()),
                                      capacity_words=cap, interpret=True)
    got = bitpack_cuda.place_vals(vals32, e0, capacity_words=cap)
    assert got.shape == (3, (cap + 1) // 2)
    assert_same(want, tbp.words_u16(got, cap).numpy().view(np.uint16))


def _tied_offsets():
    """Placed contributions of real emitted streams (scale 40: no block
    over 256 bits), plus a frame of hand-made contributions whose
    offsets tie: runs of blocks at one u32 offset, zero-bit blocks, and
    a block at the offset eight words before a tie, so one output word
    gathers slot 8 of one block and slot 0 of several others."""
    nb = 222
    _, c64, scale, dc_code, dc_bits = _emit_inputs(43, 3, nb)
    scale[0] = 40
    vals32, e0, _, total = bs_cuda.emit_prep_plain(
        *(torch.from_numpy(a) for a in (c64, scale, dc_code, dc_bits)),
        eof=0x3FF)
    rng = np.random.default_rng(44)
    n1 = nb + 1
    steps = rng.choice([0, 0, 0, 1, 2, 8], n1 - 1)
    e_tied = np.concatenate([[0], np.cumsum(steps)]).astype(np.int32)
    v_tied = np.zeros((n1, 9), np.int64)
    for j in range(n1):
        # Bit-disjoint words: block j owns bit (j % 32) of every slot.
        v_tied[j, :] = rng.integers(0, 2, 9) << (j % 32)
    # Blocks 32 apart never share a word, so no two candidates of one
    # word own the same bit.
    assert (e_tied[32:] - e_tied[:-32] > 8).all()
    vals = np.concatenate([vals32.numpy(), tbp.u32_to_i32(
        torch.from_numpy(v_tied))[None].numpy()])
    e0s = np.concatenate([e0.numpy(), e_tied[None]])
    return vals, e0s, int(total.max())


@pytest.mark.parametrize("cut", [False, True])
def test_place_vals_gather_matches_pallas(cut):
    """K8's plain version == place_vals_gather_pallas in interpret mode,
    with tied offsets, with and without a capacity that cuts the longest
    frame short."""
    vals, e0s, total_max = _tied_offsets()
    assert (np.diff(e0s, axis=1) == 0).any(axis=1).all()
    cap = total_max // 16 - 30 if cut else total_max // 16 + 40
    want = jbpk.place_vals_gather_pallas(jnp.asarray(vals), jnp.asarray(e0s),
                                         capacity_words=cap, interpret=True)
    got = bitpack_cuda.place_vals_gather(torch.from_numpy(vals),
                                         torch.from_numpy(e0s),
                                         capacity_words=cap)
    assert got.shape == (4, (cap + 1) // 2)
    assert_same(want, tbp.words_u16(got, cap).numpy().view(np.uint16))
    assert np.asarray(want).any()
