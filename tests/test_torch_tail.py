"""The tail emission's decomposition on the card, checked on the CPU
through its plain model: emit_tail_lanes_plain (a warp a long block, two
scan positions a lane, the nonzero mask from two ballots, one scan of the
code lengths, the cut at bit 256, a frame's long blocks spread over
several CTAs) equals emit_tail_plain, and the AC code table that the
kernel takes from csrc/ac_codes.cuh equals the port's closed form and the
JAX package's code table. Exact: equal integers, no tolerance."""

import pathlib
import re

import numpy as np
import pytest
import torch

from psxavenc_tpu.ops import bs as jbs
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs_cuda

from torch_emit_cases import edge_inputs, select_form

TABLE = (pathlib.Path(bs_cuda.__file__).resolve().parent.parent / "csrc"
         / "ac_codes.cuh")


def _case(kind):
    """(K3's inputs, the placed words, block_bits, capacity_words) of a
    kind of batch: edge_inputs (exactly 256 and 257 bits, an escape across
    bit 256, all 63 levels clamped, runs over 31; frame 0 at scale 1,
    frame 1 at scale 3); an unfittable frame (noise at scale 1, running
    far past its capacity, so later tails drop whole); the noise of
    edge_inputs at scales 40 and 63, which has no block over 256 bits."""
    c, scale, dc_code, dc_bits = edge_inputs(300)
    cap = 20000
    if kind == "unfittable":
        c, scale, dc_code, dc_bits = (c[1:], np.array([1], np.int32),
                                      dc_code[1:], dc_bits[1:])
        cap = 2001
    elif kind == "no_long":
        c[0, :, :6] = 0                      # the hand-made blocks
        scale = np.array([40, 63], np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        select_form(c), scale, dc_code, dc_bits)]
    vals32, e0, block_bits, total = bs_cuda.emit_prep_plain(*args, eof=0x1FF)
    placed = bitpack_cuda.place_vals_plain(vals32, e0, capacity_words=cap)
    if kind == "unfittable":
        assert int(total[0]) > 16 * cap + 5000
    return args, placed, block_bits, cap


@pytest.mark.parametrize("ctas", [1, 2, 5])
@pytest.mark.parametrize("kind", ["edge", "unfittable", "no_long"])
def test_lanes_plain_equals_plain(kind, ctas):
    """The model == emit_tail_plain with a frame's long blocks over 1, 2
    and 5 CTAs (of 2 warps, so that every CTA takes blocks, and of 16, as
    the kernel has), counting each frame with a long block once."""
    args, placed, block_bits, cap = _case(kind)
    want, want_count = bs_cuda.emit_tail_plain(placed, *args, block_bits,
                                               capacity_words=cap)
    frames = int((block_bits > 256).any(dim=1).sum())
    assert int(want_count) == frames
    assert (frames == 0) == (kind == "no_long")
    for warps in (2, bs_cuda.TAIL_WARPS):
        count = torch.tensor([3], dtype=torch.int32)
        got, got_count = bs_cuda.emit_tail_lanes_plain(
            placed, *args, block_bits, capacity_words=cap, count=count,
            ctas=ctas, warps=warps)
        assert torch.equal(got, want)
        assert got_count is count and int(count) == 3 + frames
    if kind != "no_long":
        assert not torch.equal(want, placed)


def test_lanes_plain_int32_form():
    """The (B, 63, NB) int32 coefficient form, with magnitudes over 16
    bits."""
    c, scale, dc_code, dc_bits = edge_inputs(222)
    c[1, 5, 7], c[1, 9, 8] = -70000, 131071
    args = [torch.from_numpy(a) for a in (c, scale, dc_code, dc_bits)]
    _, block_bits = bs_cuda.emit_pack_plain(*args)
    placed = torch.zeros((2, tbp.cap32_of(1501)), dtype=torch.int32)
    want, _ = bs_cuda.emit_tail_plain(placed, *args, block_bits,
                                      capacity_words=1501)
    got, count = bs_cuda.emit_tail_lanes_plain(
        placed, *args, block_bits, capacity_words=1501, ctas=3, warps=2)
    assert torch.equal(got, want) and int(count) == 2


@pytest.mark.parametrize("batch", [1, 2, 128, 100000])
def test_tail_ctas(batch):
    ctas = bs_cuda.tail_ctas(batch, 132)
    assert 1 <= ctas <= bs_cuda.TAIL_MAX_CTAS
    assert bs_cuda.emit_tail_grid(batch, sms=132) == (
        batch * ctas, 32 * bs_cuda.TAIL_WARPS)
    if batch == 128:
        assert ctas > 1


def _table_literal():
    body = re.search(r"kAcCodes\[[^\]]*\]\s*=\s*\{(.*?)\};",
                     TABLE.read_text(), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [int(v, 0) for v in body.replace("\n", " ").split(",")
            if v.strip()]


def test_ac_code_table_equals_closed_form():
    """The compile-time table == ac_code_table(), the closed form of
    ops/bs.py (which test_torch_tables.py holds to the JAX closed form and
    psx::ac_bits_code's constants) for every (run, level) it lists."""
    literal = _table_literal()
    assert len(literal) == bs_cuda.AC_LOW + bs_cuda.AC_HIGH
    assert literal == bs_cuda.ac_code_table().tolist()


def test_ac_code_table_equals_jax_table():
    """Every entry == the JAX package's AC_TABLE: a listed pair's (prefix
    bits + 1, prefix << 1), an escape where AC_TABLE has no pair; and every
    pair of AC_TABLE is listed."""
    literal = _table_literal()
    listed = set()
    for i, e in enumerate(literal):
        if i < bs_cuda.AC_LOW:
            run, level = i & 31, (i >> 5) + 1
        else:
            run, level = divmod(i - bs_cuda.AC_LOW, 33)
            level += 8
        listed.add((run, level))
        if (run, level) in jbs.AC_TABLE:
            bits, prefix = jbs.AC_TABLE[(run, level)]
            assert e == ((bits + 1) << 24) | (prefix << 1), (run, level)
        else:
            assert e == 0, (run, level)
    assert set(jbs.AC_TABLE) <= listed
