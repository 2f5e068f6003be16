"""The port's ADPCM path equals psxavenc_tpu's on the CPU, exactly.

- ``ops.adpcm.encode_units_scan`` (the plain version of K5) against the
  JAX scan for the three production variants;
- ``ops.adpcm_cuda``'s packed-word layout against the layout of
  ``psxavenc_tpu/ops/adpcm_pallas.py`` (decoded as its own tests decode
  it); the Pallas kernel itself is not run here, its interpret mode takes
  minutes (tests/test_adpcm_pallas.py);
- the stream layer (``models/adpcm_stream.py``) and the batch API.

The native tier of the JAX stream layer runs on the CPU; the JAX package's
own tests hold it to the JAX scan.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psxavenc_tpu import api as japi
from psxavenc_tpu.models import adpcm_stream as jstreams
from psxavenc_tpu.ops import adpcm as jops
from psxavenc_tpu.utils.synth import rand_pcm
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.models import adpcm_stream as tstreams
from psxavenc_tpu_torch.ops import adpcm as tops
from psxavenc_tpu_torch.ops import adpcm_cuda

from test_torch_parity import assert_same, plain_tiers

VARIANTS = [(5, 12), (4, 12), (4, 8)]


def _units(B, T, seed):
    """Seeded (B, T, 28) units, limits (full, partial, 0, negative, > 28
    and a masked tail) and nonzero prev states."""
    rng = np.random.default_rng(seed)
    units = rand_pcm(B * T * 28, seed=seed).astype(np.int32).reshape(
        B, T, 28)
    units[1] = np.clip(units[1] * 6, -32768, 32767)     # shift-range edges
    units[2, :, ::3] = 0
    lim = np.full((B, T), 28, np.int32)
    lim[0, 3] = 17
    lim[1, 5] = 0
    lim[2, 6] = -9
    lim[3, 2] = 40
    lim[3, -3:] = 0
    p1 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    p2 = rng.integers(-0x8000, 0x8000, B).astype(np.int32)
    return units, lim, p1, p2


@pytest.mark.parametrize("filter_count,shift_range", VARIANTS)
def test_plain_scan_matches_jax(filter_count, shift_range):
    units, lim, p1, p2 = _units(5, 14, seed=21)
    want = jops.encode_units_scan(
        jnp.asarray(units), jnp.asarray(lim), jnp.asarray(p1),
        jnp.asarray(p2), filter_count=filter_count, shift_range=shift_range)
    got = tops.encode_units_scan(
        torch.from_numpy(units), torch.from_numpy(lim), torch.from_numpy(p1),
        torch.from_numpy(p2), filter_count=filter_count,
        shift_range=shift_range)
    for name, w, g in zip(("headers", "values", "s1", "s2"), want, got):
        assert_same(w, g, name)


@pytest.mark.parametrize("filter_count", [1, 2, 3])
def test_plain_scan_other_filter_counts(filter_count):
    """Any filter_count from 1 to 5 works, as in the JAX scan."""
    units, lim, p1, p2 = _units(4, 8, seed=filter_count)
    want = jops.encode_units_scan(
        jnp.asarray(units), jnp.asarray(lim), jnp.asarray(p1),
        jnp.asarray(p2), filter_count=filter_count, shift_range=12)
    got = tops.encode_units_scan(
        torch.from_numpy(units), torch.from_numpy(lim), torch.from_numpy(p1),
        torch.from_numpy(p2), filter_count=filter_count, shift_range=12)
    for w, g in zip(want, got):
        assert_same(w, g)


def _pallas_unpack(words, shift_range):
    """The sample values of Pallas-layout words, decoded as
    tests/test_adpcm_pallas.py decodes them."""
    w = np.asarray(words).astype(np.uint32)
    vbits = 4 if shift_range == 12 else 8
    per_word = 32 // vbits
    vals = np.zeros(w.shape[:2] + (28,), np.uint32)
    for k in range(w.shape[2]):
        for m in range(per_word):
            if per_word * k + m < 28:
                vals[:, :, per_word * k + m] = (w[:, :, k] >> (vbits * m)) \
                    & ((1 << vbits) - 1)
    return vals


@pytest.mark.parametrize("filter_count,shift_range", VARIANTS)
def test_wrapper_layout_matches_pallas(filter_count, shift_range):
    """On CPU tensors the K5 wrapper gives the Pallas kernel's outputs:
    headers and states of the JAX scan, and its values packed W = 4 or 7
    words per unit."""
    units, lim, p1, p2 = _units(4, 8, seed=5)
    h_ref, v_ref, s1_ref, s2_ref = jops.encode_units_scan(
        jnp.asarray(units), jnp.asarray(np.clip(lim, -(1 << 30), 28)),
        jnp.asarray(p1), jnp.asarray(p2), filter_count=filter_count,
        shift_range=shift_range)
    h, words, s1, s2 = adpcm_cuda.encode_units(
        *(torch.from_numpy(a) for a in (units, lim, p1, p2)),
        filter_count=filter_count, shift_range=shift_range)
    assert words.dtype == torch.int32
    assert words.shape == (4, 8, 4 if shift_range == 12 else 7)
    assert_same(h_ref, h)
    assert_same(s1_ref, s1)
    assert_same(s2_ref, s2)
    mask = 0xFFFF >> shift_range
    assert_same(np.asarray(v_ref) & mask,
                _pallas_unpack(words.numpy(), shift_range))
    assert_same(adpcm_cuda.unpack_words(words, shift_range),
                np.asarray(v_ref) & mask)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (2, 37)])
@pytest.mark.parametrize("shift_range", [12, 8])
def test_unpack_words_u8_matches_unpack_words(shift_range, shape):
    """The byte unpack equals the int32 unpack cast to uint8 on words over
    every bit pattern (bit 31 set included), as a contiguous (B, T, 28)
    uint8 tensor; for 8-bit it is a view of the words."""
    W = adpcm_cuda.n_words(shift_range)
    rng = np.random.default_rng(shift_range * 100 + shape[1])
    words = rng.integers(0, 1 << 32, (*shape, W), dtype=np.uint64)
    words = words.astype(np.uint32).view(np.int32)
    words.reshape(-1)[:4] = [0, -1, -(1 << 31), (1 << 31) - 1]
    words = torch.from_numpy(words)
    got = adpcm_cuda.unpack_words_u8(words, shift_range)
    assert got.dtype == torch.uint8
    assert got.shape == (*shape, 28)
    assert got.is_contiguous()
    assert torch.equal(got, adpcm_cuda.unpack_words(words, shift_range).to(
        torch.uint8))
    if shift_range == 8:
        assert got.data_ptr() == words.data_ptr()


def test_spu_words_are_block_bytes():
    """4-bit words in little-endian byte order are bytes 2..15 of the SPU
    block (adpcm_pallas.py:14-16)."""
    units, lim, p1, p2 = _units(4, 8, seed=8)
    blocks, _, _ = tapi.spu_encode_blocks(
        *(torch.from_numpy(a) for a in (units, lim, p1, p2)))
    h, v, _, _ = tapi.spu_encode_batch(
        *(torch.from_numpy(a) for a in (units, lim, p1, p2)))
    for b in range(4):
        want = tstreams.pack_spu_blocks(h[b].numpy().astype(np.uint8),
                                        v[b].numpy().astype(np.uint8))
        assert_same(want, blocks[b])


def test_api_matches_jax():
    units, lim, p1, p2 = _units(4, 9, seed=13)
    jargs = [jnp.asarray(a) for a in (units, lim, p1, p2)]
    targs = [torch.from_numpy(a) for a in (units, lim, p1, p2)]
    for w, g in zip(japi.spu_encode_batch(*jargs),
                    tapi.spu_encode_batch(*targs)):
        assert_same(w, g)
    for w, g in zip(japi.spu_encode_blocks(*jargs),
                    tapi.spu_encode_blocks(*targs)):
        assert_same(w, g)
    for bits8 in (False, True):
        for w, g in zip(japi.xa_encode_batch(*jargs, bits8=bits8),
                        tapi.xa_encode_batch(*targs, bits8=bits8)):
            assert_same(w, g)


def test_layouts_match_jax():
    lens = [28, 0, 13, 57, 84, 1, 30]
    for w, g in zip(jstreams.chunk_unit_layout(lens),
                    tstreams.chunk_unit_layout(lens)):
        assert_same(w, g)
    for w, g in zip(jstreams.uniform_unit_layout(9, 200),
                    tstreams.uniform_unit_layout(9, 200)):
        assert_same(w, g)


def test_gather_units_matches_jax():
    pcm = rand_pcm(300 * 2, channels=2, seed=4).T.copy()
    offs, lims = jstreams.chunk_unit_layout([50, 3, 90, 0, 100, 57])
    offs = np.stack([offs, offs])
    lims = np.stack([lims, lims - 5])
    want = jstreams.gather_units(pcm, offs, lims)
    got = (adpcm_cuda.gather_units_plain(torch.from_numpy(pcm),
                                         torch.from_numpy(offs),
                                         offs.shape[1]),
           adpcm_cuda.clip_limits(torch.from_numpy(lims)))
    for w, g in zip(want, got):
        assert_same(w, g)


@pytest.mark.parametrize("filter_count,shift_range", [(5, 12), (4, 8)])
def test_encode_unit_streams_matches_jax(filter_count, shift_range):
    """Non-uniform chunk offsets, partial units, carried-in state."""
    pcm = rand_pcm(420 * 2, channels=2, seed=9).T.copy()
    offs, lims = jstreams.chunk_unit_layout([60, 29, 112, 5, 140, 74])
    B = 2
    offs = np.broadcast_to(offs, (B, len(offs)))
    lims = np.broadcast_to(lims, (B, len(lims)))
    p1 = np.array([1200, -700], np.int32)
    p2 = np.array([-30, 9000], np.int32)
    want = jstreams.encode_unit_streams(pcm, offs, lims, filter_count,
                                        shift_range, prev1=p1, prev2=p2)
    with plain_tiers():
        got = tstreams.encode_unit_streams(pcm, offs, lims, filter_count,
                                           shift_range, prev1=p1, prev2=p2,
                                           device="cpu")
    for name, w, g in zip(("headers", "values", "prev1", "prev2"), want,
                          got):
        assert np.asarray(w).dtype == np.asarray(g).dtype, name
        assert_same(w, g, name)


def test_encode_prepared_units_state_t_matches_jax():
    units, lim, p1, p2 = _units(4, 10, seed=17)
    state_t = np.array([9, 3, 0, 6])
    want = jstreams.encode_prepared_units(units, lim, 5, 12, prev1=p1,
                                          prev2=p2, state_t=state_t)
    with plain_tiers():
        got = tstreams.encode_prepared_units(units, lim, 5, 12, prev1=p1,
                                             prev2=p2, state_t=state_t,
                                             device="cpu")
    for w, g in zip(want, got):
        assert_same(w, g)


def test_negative_offsets_rejected():
    with plain_tiers(), pytest.raises(ValueError, match="non-negative"):
        tstreams.encode_unit_streams(np.zeros((1, 56), np.int16),
                                     np.array([[-1, 27]]),
                                     np.array([[28, 28]]), 5, 12,
                                     device="cpu")


def _pcm_layout(layout, seed):
    """(pcm (2, N) int16, offsets (2, T) int64 or None, limits (2, T)) for
    K5's PCM input: ``chunk`` (chunks of ragged lengths, so offsets off
    the 28-grid and partial units), ``past_end`` (units that start at or
    past N, unmasked), ``empty`` (N == 0) and ``dense`` (no offsets, unit
    t at 28 t; masked units in the tail)."""
    if layout == "dense":
        T = 11
        pcm = rand_pcm(2 * T * 28, seed=seed).reshape(2, -1)
        lims = np.full((2, T), 28, np.int64)
        lims[0, -3:] = 0
        lims[1, 4] = 9
        return pcm, None, lims
    offs, lims = jstreams.chunk_unit_layout([50, 3, 90, 0, 100, 57])
    N = 300
    if layout == "past_end":
        offs = np.concatenate([offs, [N - 10, N, N + 40]])
        lims = np.concatenate([lims, [28, 28, 5]])
    elif layout == "empty":
        N = 0
    pcm = rand_pcm(2 * N, seed=seed).reshape(2, -1) if N else \
        np.zeros((2, 0), np.int16)
    offs = np.stack([offs, offs + 1])
    lims = np.stack([lims, lims - 5])
    return pcm, offs, lims


@pytest.mark.parametrize("layout", ["chunk", "past_end", "empty", "dense"])
@pytest.mark.parametrize("filter_count,shift_range", VARIANTS)
def test_encode_pcm_units_plain_matches_jax_gather_and_scan(
        filter_count, shift_range, layout):
    """K5's PCM entry point on the CPU (its plain route) == the JAX
    package's gather_units and scan: headers, values and the state after
    every unit."""
    pcm, offs, lims = _pcm_layout(layout, seed=filter_count + shift_range)
    B, T = lims.shape
    grid = np.broadcast_to(28 * np.arange(T), (B, T))
    if pcm.shape[1]:
        units, lim = jstreams.gather_units(
            pcm, grid if offs is None else offs, lims)
    else:   # every sample of a stream with none reads 0
        units = np.zeros((B, T, 28), np.int32)
        lim = np.clip(lims, -(1 << 30), 28).astype(np.int32)
    p1 = np.array([700, -12000], np.int32)
    p2 = np.array([-3, 4100], np.int32)
    want = jops.encode_units_scan(
        *(jnp.asarray(a) for a in (units, lim, p1, p2)),
        filter_count=filter_count, shift_range=shift_range)
    stats = torch.ones(len(adpcm_cuda.STAT_NAMES), dtype=torch.int64)
    h, words, s1, s2 = adpcm_cuda.encode_pcm_units(
        torch.from_numpy(pcm),
        None if offs is None else torch.from_numpy(
            adpcm_cuda.unit_offsets(offs)),
        torch.from_numpy(lims), torch.from_numpy(p1), torch.from_numpy(p2),
        filter_count=filter_count, shift_range=shift_range, segments=3,
        stats_out=stats)
    got = (h, adpcm_cuda.unpack_words(words, shift_range), s1, s2)
    for name, w, g in zip(("headers", "values", "s1", "s2"), want, got):
        assert_same(w, g, name)
    assert not stats.any()
    if offs is None:   # the tensor API's units take the same route
        for w, g in zip((h, words, s1, s2), adpcm_cuda.encode_units(
                torch.from_numpy(units), torch.from_numpy(lims),
                torch.from_numpy(p1), torch.from_numpy(p2),
                filter_count=filter_count, shift_range=shift_range)):
            assert torch.equal(w, g)


@pytest.mark.parametrize("top,ok", [((1 << 31) - 28, True),
                                    ((1 << 31) - 27, False),
                                    (1 << 40, False)])
def test_unit_offsets_fit_int32(top, ok):
    """K5 takes int32 offsets: the host conversion passes an offset whose
    unit's last sample index fits int32 and raises past it, also through
    encode_unit_streams."""
    offs = np.array([[0, 28, top]], np.int64)
    if ok:
        got = adpcm_cuda.unit_offsets(offs)
        assert got.dtype == np.int32 and got.flags.c_contiguous
        assert got.tolist() == offs.tolist()
        return
    with pytest.raises(ValueError, match="unit offsets must"):
        adpcm_cuda.unit_offsets(offs)
    with plain_tiers(), pytest.raises(ValueError, match="unit offsets must"):
        tstreams.encode_unit_streams(np.zeros((1, 56), np.int16), offs,
                                     np.full((1, 3), 28), 5, 12,
                                     device="cpu")


def test_dense_gather_is_the_offset_grid():
    """The dense layout's units (the samples reshaped) are the gather at
    offsets 28 t; a dense call whose row is not 28 T samples raises."""
    pcm = torch.from_numpy(rand_pcm(2 * 5 * 28, seed=3).reshape(2, -1))
    grid = (28 * torch.arange(5)).expand(2, 5)
    assert torch.equal(adpcm_cuda.gather_units_plain(pcm, None, 5),
                       adpcm_cuda.gather_units_plain(pcm, grid, 5))
    lims = torch.full((2, 6), 28, dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="dense layout takes 28 T"):
        adpcm_cuda.encode_pcm_units(pcm, None, lims, zero, zero,
                                    filter_count=5, shift_range=12)


@pytest.mark.parametrize("sample,ok", [(-32768, True), (32767, True),
                                       (-32769, False), (32768, False)])
def test_units_past_s16_raise(sample, ok):
    """The tensor API's units are s16 samples: int32 units at the range's
    ends encode as the JAX scan does, one sample past it raises (int16
    would wrap it), through ``encode_units``, the API, the grouped call
    and ``encode_unit_streams``."""
    units = torch.zeros((2, 3, 28), dtype=torch.int32)
    units[1, 2, 5] = sample
    lims = torch.full((2, 3), 28, dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    calls = (lambda: adpcm_cuda.encode_units(units, lims, zero, zero,
                                             filter_count=5,
                                             shift_range=12),
             lambda: tapi.spu_encode_batch(units, lims, zero, zero),
             lambda: tstreams.encode_prepared_units(units.numpy(),
                                                    lims.numpy(), 5, 12,
                                                    device="cpu"),
             lambda: tstreams.encode_unit_streams(
                 units.reshape(2, -1).numpy(),
                 np.broadcast_to(28 * np.arange(3), (2, 3)), lims.numpy(),
                 5, 12, device="cpu"))
    if not ok:
        for call in calls:
            with plain_tiers(), pytest.raises(ValueError, match="s16"):
                call()
        return
    want = jops.encode_units_scan(
        *(jnp.asarray(t.numpy()) for t in (units, lims, zero, zero)),
        filter_count=5, shift_range=12)
    h, words, s1, s2 = calls[0]()
    got = (h, adpcm_cuda.unpack_words(words, 12), s1, s2)
    for name, w, g in zip(("headers", "values", "s1", "s2"), want, got):
        assert_same(w, g, name)
