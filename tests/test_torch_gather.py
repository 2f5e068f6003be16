"""The decompositions of K8 (placement as a gather) and K9 (placement of
per-block streams) on the card, checked on the CPU through their plain
models: place_vals_gather_ranges_plain (a CTA per range of a frame's
words, four words a thread, each found by a search of the staged offsets)
equals place_vals_gather_plain and the Pallas kernel K8 replaces,
place_vals_gather_pallas; place_streams_ranges_plain (a CTA per range,
the streams that reach it found by a search of goff) equals
place_streams_u32_plain, and as u16 values place_streams_plain and
place_streams_pallas; both Pallas kernels run in interpret mode. Exact:
equal integers, no tolerance. Also: every stream route of
bs_encode_frames_packed ends with the tail emission's plain version on
the CPU, not the exact flat path."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_parity import assert_same, video_frames
from torch_place_cases import boundaries_inside, tied_frames, tied_streams

NB = 222


@functools.lru_cache(maxsize=None)
def _emitted():
    """The emission inputs of three frames at scales 4, 31 and 63 (no
    block over 256 bits)."""
    rng = np.random.default_rng(42)
    c64 = np.zeros((3, 64, bs_cuda.nb_padded(NB)), np.int16)
    c64[:, :63, :NB] = rng.integers(-900, 900, (3, 63, NB))
    c64[:, 10:, :NB // 2] = 0
    dc_bits = rng.integers(2, 11, (3, NB)).astype(np.int32)
    dc_code = rng.integers(0, 1 << 10, (3, NB)).astype(np.int32) & (
        (1 << dc_bits) - 1)
    return (torch.from_numpy(c64), torch.tensor([4, 31, 63],
                                                dtype=torch.int32),
            torch.from_numpy(dc_code), torch.from_numpy(dc_bits))


def _past(total_bits):
    """A capacity that the longest frame runs 300 words past."""
    return int(total_bits.max()) // 16 - 300


@functools.lru_cache(maxsize=None)
def _vals(kind):
    """K8's (vals32, e0, capacity_words): K3's placement prep of the
    emitted frames, frames of offsets that tie, or the emitted frames with
    a capacity that the longest runs past."""
    if kind == "ties":
        vals, e0 = tied_frames(3, NB + 1)
        return (torch.from_numpy(vals), torch.from_numpy(e0),
                2 * int(e0.max()) + 20)
    vals32, e0, _, total = bs_cuda.emit_prep_plain(*_emitted(), eof=0x1FF)
    if kind == "past_cap32":
        cap = _past(total)
        assert int(e0[:, -1].max()) > tbp.cap32_of(cap)
        return vals32, e0, cap
    return vals32, e0, int(total.max()) // 16 + 40


@functools.lru_cache(maxsize=None)
def _streams(kind):
    """K9's (streams, goff, total_bits, capacity_words): K7's streams of the
    emitted frames with the EOF block, streams whose offsets tie, or the
    emitted frames with a capacity that the longest runs past."""
    if kind == "ties":
        streams, goff = tied_streams(3, NB + 1)
        streams, goff = torch.from_numpy(streams), torch.from_numpy(goff)
        total = goff[:, -1] + 256
        return streams, goff, total, int(total.max()) // 16 + 20
    streams, bb = tbp.with_eof_block(*bs_cuda.emit_pack_plain(*_emitted()),
                                     0x1FF)
    goff = torch.cumsum(bb, dim=1, dtype=torch.int32) - bb
    total = goff[:, -1] + bb[:, -1]
    cap = int(total.max()) // 16 + 40
    if kind == "past_cap32":
        cap = _past(total)
        assert int(goff[:, -1].max()) // 32 > tbp.cap32_of(cap)
    return streams, goff, total, cap


@functools.lru_cache(maxsize=None)
def _gather_pallas(kind):
    vals32, e0, cap = _vals(kind)
    return np.asarray(jbpk.place_vals_gather_pallas(
        jnp.asarray(vals32.numpy()), jnp.asarray(e0.numpy()),
        capacity_words=cap, interpret=True))


@functools.lru_cache(maxsize=None)
def _streams_pallas(kind):
    streams, goff, total, cap = _streams(kind)
    return np.asarray(jbpk.place_streams_pallas(
        jnp.asarray(streams.numpy()), jnp.asarray(goff.numpy()),
        jnp.asarray(total.numpy()), capacity_words=cap, interpret=True))


def _range_words(ranges, cap32, limit):
    """Words a range for ``ranges`` ranges a frame (a multiple of 4, at
    most ``limit``); 0 asks for more ranges than the frame has blocks."""
    if ranges == 0:
        return 4
    return min(-(-(-(-cap32 // ranges)) // 4) * 4, limit)


KINDS = ["emitted", "ties", "past_cap32"]


@pytest.mark.parametrize("ranges,base", [(1, 0), (2, 3), (7, 1), (0, 2)])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_ranges_plain_equals_plain_and_pallas(kind, ranges, base):
    """K8's model with 1 range a frame (as many as its longest range
    allows), 2, 7 and more ranges than blocks (4 words each), with the
    output at every offset from a 16-byte boundary, staging 16 blocks a
    chunk and searching with 4 threads a CTA (so that a range takes
    several chunks and the search several rounds)."""
    vals32, e0, cap = _vals(kind)
    cap32 = tbp.cap32_of(cap)
    words = _range_words(ranges, cap32, bitpack_cuda.GATHER_RANGE_MAX)
    if ranges in (7, 0):
        assert boundaries_inside(e0.numpy(), cap32, words) > 0
    got = bitpack_cuda.place_vals_gather_ranges_plain(
        vals32, e0, capacity_words=cap, range_words=words, base=base,
        threads=4, chunk=16)
    want = bitpack_cuda.place_vals_gather_plain(vals32, e0,
                                                capacity_words=cap)
    assert got.shape == (3, cap32) and torch.equal(got, want)
    assert_same(_gather_pallas(kind), tbp.words_u16(got, cap).numpy().view(
        np.uint16))
    assert want.any()


@pytest.mark.parametrize("ranges", [1, 2, 7, 0])
@pytest.mark.parametrize("kind", KINDS)
def test_streams_ranges_plain_equals_plain_and_pallas(kind, ranges):
    """K9's model with 1, 2, 7 and more ranges a frame than blocks, on
    K7's streams, on offsets that tie and on frames past cap32."""
    streams, goff, total, cap = _streams(kind)
    cap32 = tbp.cap32_of(cap)
    words = _range_words(ranges, cap32, bitpack_cuda.PLACE_RANGE_MAX)
    if ranges in (7, 0):
        assert boundaries_inside((goff >> 5).numpy(), cap32, words) > 0
    got = bitpack_cuda.place_streams_ranges_plain(
        streams, goff, capacity_words=cap, range_words=words, threads=4)
    want = bitpack_cuda.place_streams_u32_plain(streams, goff,
                                                capacity_words=cap)
    assert got.shape == (3, cap32) and torch.equal(got, want)
    u16 = tbp.u16_values(got, cap)
    assert torch.equal(u16, bitpack_cuda.place_streams_plain(
        streams, goff, total, capacity_words=cap))
    if kind != "past_cap32":
        # The JAX K9 clamps its writes for a frame past the capacity
        # instead of dropping them; its words are compared where it fits.
        assert_same(_streams_pallas(kind), u16)
    else:
        fit = (goff[:, -1] // 32 < cap32 - 8).numpy()
        assert fit.any() and not fit.all()
        assert_same(_streams_pallas(kind)[fit], u16[fit])
    assert want.any()


def test_place_wrappers_on_cpu_take_the_plain_versions():
    """K8's and K9's wrappers on CPU tensors launch nothing and give the
    plain versions' words."""
    vals32, e0, cap = _vals("emitted")
    streams, goff, total, scap = _streams("emitted")
    before = dict(bitpack_cuda.LAUNCHES)
    assert torch.equal(
        bitpack_cuda.place_vals_gather(vals32, e0, capacity_words=cap),
        bitpack_cuda.place_vals_plain(vals32, e0, capacity_words=cap))
    assert torch.equal(
        bitpack_cuda.place_streams_u32(streams, goff, capacity_words=scap),
        bitpack_cuda.place_streams_u32_plain(streams, goff,
                                             capacity_words=scap))
    assert torch.equal(
        bitpack_cuda.place_streams(streams, goff, total, capacity_words=scap),
        bitpack_cuda.place_streams_plain(streams, goff, total,
                                         capacity_words=scap))
    assert bitpack_cuda.LAUNCHES == before


@pytest.mark.parametrize("batch", [1, 128, 300])
def test_grids(batch):
    """K8's ranges fit its 256 threads of four words at any alignment; K9
    launches K4's ranges."""
    for cap in (9068, 36284, 13):
        words = bitpack_cuda.gather_range_words(batch, cap, 132)
        assert words % 4 == 0 and words <= bitpack_cuda.GATHER_RANGE_MAX
        assert -(-(words + 3) // 4) <= bitpack_cuda.PLACE_THREADS
        ctas, threads = bitpack_cuda.place_vals_gather_grid(batch, cap,
                                                            sms=132)
        assert ctas == batch * -(-tbp.cap32_of(cap) // words)
        assert threads == bitpack_cuda.PLACE_THREADS
        assert bitpack_cuda.place_streams_grid(batch, cap, sms=132) == \
            bitpack_cuda.place_vals_grid(batch, cap, sms=132)


STREAM_ROUTES = [("fused", True), ("fused_pallas", True), ("fused", False),
                 ("fused_pallas", False), ("fused_mxu", False),
                 ("fused_gather", False)]


@pytest.mark.parametrize("packer,sweep", STREAM_ROUTES)
def test_stream_routes_take_the_tail_emission(monkeypatch, packer, sweep):
    """Every stream route (K7's streams placed, then the tail emission) on
    two frames at generous budgets (noise: blocks over 256 bits), a
    synthetic frame and an unfittable one: the tail emission's plain
    version runs once and the flat path not at all, the counter adds the
    frames with a long block, and the words equal fused_mxu's (K3, K4 and
    the tail) and the flat packer's where the frame fits."""
    frames = torch.from_numpy(video_frames(48, 32, 2, seed=8, noise=2))
    budgets = torch.tensor([4000, 1216, 4000, 200], dtype=torch.int32)
    kw = dict(codec=0, width=48, height=32, capacity_words=1996)
    ref = tapi.bs_encode_frames_packed(frames, budgets, **kw)
    flat = tapi.bs_encode_frames_packed(frames, budgets, packer="flat",
                                        **kw)
    sel = tapi._select_pixels(frames, budgets, 0, 48, 32, tapi._PLAIN)
    long_frames = int((bs_cuda.emit_pack_plain(
        sel["c"], sel["scale_idx"] + 1, sel["dc_code"],
        sel["dc_bits"])[1] > 256).any(dim=1).sum())
    assert long_frames >= 2 and ref["scale"].tolist()[-1] == 64

    tails = []
    plain_tail = bs_cuda.emit_tail_plain

    def tail(*a, **k):
        tails.append(1)
        return plain_tail(*a, **k)

    def forbidden(*a, **k):
        raise AssertionError("the flat path ran")

    monkeypatch.setattr(bs_cuda, "emit_tail_plain", tail)
    monkeypatch.setattr(tapi, "_overflow_words", forbidden)
    tapi.COUNTERS["overflow_frames"] = 0
    got = tapi.bs_encode_frames_packed(frames, budgets, packer=packer,
                                       kernel_sweep=sweep, **kw)
    assert len(tails) == 1
    assert tapi.COUNTERS["overflow_frames"] == long_frames
    assert torch.equal(got["words"], ref["words"])
    assert torch.equal(got["words"][:3], flat["words"][:3])
    assert torch.equal(got["scale"], ref["scale"])
