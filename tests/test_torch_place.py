"""K4's decomposition on the card, checked on the CPU through its plain
model: place_vals_ranges_plain (a frame's words cut into ranges, each
computed alone from the blocks that the kernel's search over e0 finds, the
images concatenated) equals place_vals_plain and the Pallas kernel K4
replaces, place_vals_mxu_pallas, run in interpret mode. Exact: equal
integers, no tolerance."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_parity import assert_same
from torch_place_cases import boundaries_inside, tied_frames

NB = 222


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    """(vals32, e0, capacity_words) of a kind of input: K3's placement prep
    of three emitted frames, the frames with offsets that tie, or the
    emitted frames with a capacity that the longest runs past."""
    if kind == "ties":
        vals, e0 = tied_frames(3, NB + 1)
        return (torch.from_numpy(vals), torch.from_numpy(e0),
                2 * int(e0.max()) + 20)
    rng = np.random.default_rng(42)
    c64 = np.zeros((3, 64, bs_cuda.nb_padded(NB)), np.int16)
    c64[:, :63, :NB] = rng.integers(-900, 900, (3, 63, NB))
    c64[:, 10:, :NB // 2] = 0
    dc_bits = rng.integers(2, 11, (3, NB)).astype(np.int32)
    dc_code = rng.integers(0, 1 << 10, (3, NB)).astype(np.int32) & (
        (1 << dc_bits) - 1)
    vals32, e0, _, total = bs_cuda.emit_prep_plain(
        torch.from_numpy(c64), torch.tensor([4, 31, 63], dtype=torch.int32),
        torch.from_numpy(dc_code), torch.from_numpy(dc_bits), eof=0x1FF)
    cap = int(total.max()) // 16 + 40
    if kind == "past_cap32":
        cap = int(total.max()) // 16 - 300
        assert int(e0[:, -1].max()) > tbp.cap32_of(cap)
    return vals32, e0, cap


@functools.lru_cache(maxsize=None)
def _pallas(kind):
    vals32, e0, cap = _inputs(kind)
    return np.asarray(jbpk.place_vals_mxu_pallas(
        jnp.asarray(vals32.numpy()), jnp.asarray(e0.numpy()),
        capacity_words=cap, interpret=True))


def _range_words(ranges, cap32):
    """Words a range for ``ranges`` ranges a frame (a multiple of 4); 0
    asks for more ranges than the frame has blocks."""
    if ranges == 0:
        return 4
    return -(-(-(-cap32 // ranges)) // 4) * 4


@pytest.mark.parametrize("ranges", [1, 2, 7, 0])
@pytest.mark.parametrize("kind", ["emitted", "ties", "past_cap32"])
def test_ranges_plain_equals_plain_and_pallas(kind, ranges):
    """1, 2, 7 ranges a frame and more ranges than blocks (4 words each),
    on emitted frames, on offsets that tie and on frames past cap32; the
    search with 4 threads a CTA, so that it takes several rounds."""
    vals32, e0, cap = _inputs(kind)
    cap32 = tbp.cap32_of(cap)
    words = _range_words(ranges, cap32)
    if ranges == 0:
        assert -(-cap32 // words) > NB + 1
    else:
        assert -(-cap32 // words) == ranges
    if ranges in (7, 0):
        assert boundaries_inside(e0.numpy(), cap32, words) > 0
    got = bitpack_cuda.place_vals_ranges_plain(
        vals32, e0, capacity_words=cap, range_words=words, threads=4)
    want = bitpack_cuda.place_vals_plain(vals32, e0, capacity_words=cap)
    assert got.shape == (3, cap32) and torch.equal(got, want)
    assert_same(_pallas(kind), tbp.words_u16(got, cap).numpy().view(
        np.uint16))
    assert want.any()


@pytest.mark.parametrize("threads", [1, 2, 3, 32, 256])
def test_search_plain_finds_the_lower_bound(threads):
    """K4's search == numpy's searchsorted (left) for keys below, inside,
    between and above rows with ties, and takes at most
    ceil(log(n) / log(threads)) + 1 rounds."""
    rng = np.random.default_rng(threads)
    for n in (1, 2, 9, 300, 1801):
        row = np.sort(rng.integers(0, n // 3 + 2, n))
        keys = np.concatenate([[-10, row[0], row[-1], row[-1] + 1],
                               rng.integers(-2, n // 3 + 4, 20)])
        t = torch.from_numpy(row)
        for key in keys:
            got, rounds = bitpack_cuda.cta_lower_bound_plain(t, int(key),
                                                             threads)
            assert got == np.searchsorted(row, key, side="left"), (n, key)
            if threads > 1:
                assert rounds <= int(np.ceil(np.log(n) / np.log(threads)
                                             - 1e-9)) + 1


def test_search_two_rounds_at_256_threads():
    """Rows of up to 65,536 blocks take two rounds at 256 threads."""
    row = torch.arange(65536) // 3
    for key in (-1, 0, 5, 12345, 21845, 10 ** 6):
        got, rounds = bitpack_cuda.cta_lower_bound_plain(row, key, 256)
        assert got == int(torch.searchsorted(row, key)) and rounds <= 2


@pytest.mark.parametrize("capacity_words", [9068, 36284, 13])
@pytest.mark.parametrize("batch", [1, 2, 6, 128, 300, 5000])
def test_range_words(batch, capacity_words):
    """The ranges are multiples of 4 words between the limits (or the
    whole frame, rounded up, where it is smaller), cover the frame, and at
    128 frames give the 132 SMs at least two CTAs each."""
    words = bitpack_cuda.place_range_words(batch, capacity_words, 132)
    cap32 = tbp.cap32_of(capacity_words)
    assert words % 4 == 0 and words <= bitpack_cuda.PLACE_RANGE_MAX
    assert words >= min(bitpack_cuda.PLACE_RANGE_MIN, cap32)
    ctas, threads = bitpack_cuda.place_vals_grid(batch, capacity_words,
                                                 sms=132)
    assert ctas == batch * -(-cap32 // words) and threads == 256
    if batch == 128 and capacity_words == 9068:
        assert ctas >= 2 * 132


def test_place_vals_on_cpu_takes_the_plain_version():
    vals32, e0, cap = _inputs("emitted")
    before = dict(bitpack_cuda.LAUNCHES)
    got = bitpack_cuda.place_vals(vals32, e0, capacity_words=cap)
    assert bitpack_cuda.LAUNCHES == before
    assert torch.equal(got, bitpack_cuda.place_vals_plain(
        vals32, e0, capacity_words=cap))
