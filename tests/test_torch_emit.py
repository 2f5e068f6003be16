"""The emission of blocks of any length: the plain version of the tail
emission (the part of a block past its 256-bit window, ORed into the
placed words) and bs_encode_frames_packed equal the exact flat path and
psxavenc_tpu (Pallas kernels in interpret mode), integer for integer, on
noise frames at every scale and on hand-made blocks: a 22-bit escape
across the 256th bit, blocks of exactly 256 and of 257 bits, all 63
levels at the clamp values, runs over 31, frames that run past the
capacity. The plain versions of K3 and K7 equal the Pallas kernels on the
same blocks."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psxavenc_tpu import api as japi
from psxavenc_tpu.ops import bitpack_pallas as jbpk
from psxavenc_tpu.ops import bs_pallas as jbsp
from psxavenc_tpu_torch import api as tapi
from psxavenc_tpu_torch.ops import bitpack as tbp
from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

from test_torch_parity import assert_same, video_frames
from torch_emit_cases import (EDGE_BITS, code_table_inputs, edge_inputs,
                              select_form)

W, H = 48, 32


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _tail_words(coefs, scale, dc_code, dc_bits, eof, cap):
    """K3, K4 and the tail emission, each by its plain version: the (B,
    cap) int16 words, the count of frames with a long block, and K3's
    outputs."""
    prep = bs_cuda.emit_prep_plain(coefs, scale, dc_code, dc_bits, eof=eof)
    placed = bitpack_cuda.place_vals_plain(prep[0], prep[1],
                                           capacity_words=cap)
    out32, count = bs_cuda.emit_tail(placed, coefs, scale, dc_code, dc_bits,
                                     prep[2], capacity_words=cap)
    return tbp.words_u16(out32.contiguous(), cap), int(count), prep


@pytest.mark.parametrize("cap", [20000, 2001, 400, 33])
@pytest.mark.parametrize("nb", [6, 222, 585])
def test_tail_plain_on_edge_blocks(nb, cap):
    """The tail emission's plain version after K3's and K4's == the exact
    flat path, with capacities (odd and even) that hold everything, cut
    the frames inside a long block, and end before the first tail; K3's
    outputs are not touched."""
    c, scale, dc_code, dc_bits = edge_inputs(nb)
    args = _torch(select_form(c), scale, dc_code, dc_bits)
    before = [t.clone() for t in bs_cuda.emit_prep_plain(*args, eof=0x1FF)]
    words, count, prep = _tail_words(*args, 0x1FF, cap)
    assert prep[2][0, :6].tolist() == EDGE_BITS
    assert all(torch.equal(a, b) for a, b in zip(before, prep))
    want = tapi._overflow_words(args[0], args[1] - 1, args[3], args[2], 0x1FF,
                                cap)
    assert torch.equal(words, want)
    assert count == int((prep[2] > 256).any(dim=1).sum()) >= 1
    if cap == 20000:
        assert int(prep[3].max()) <= 16 * cap         # nothing was cut
        assert not torch.equal(words, tbp.words_u16(
            bitpack_cuda.place_vals_plain(prep[0], prep[1],
                                          capacity_words=cap), cap))


@pytest.mark.parametrize("form", ["int16", "int32"])
def test_tail_plain_both_coefficient_forms(form):
    """Either coefficient form, the int32 one with magnitudes over 16
    bits, and a count that is added to."""
    c, scale, dc_code, dc_bits = edge_inputs(222)
    if form == "int32":
        c[1, 5, 7], c[1, 9, 8] = -70000, 131071
    coefs = c if form == "int32" else select_form(c)
    args = _torch(coefs, scale, dc_code, dc_bits)
    _, block_bits = bs_cuda.emit_pack_plain(*args)
    cap32 = tbp.cap32_of(1501)
    placed = torch.zeros((2, cap32), dtype=torch.int32)
    out32, count = bs_cuda.emit_tail(
        placed, *args, block_bits, capacity_words=1501,
        count=torch.tensor([5], dtype=torch.int32))
    assert int(count) == 7 and not placed.any()
    # Only the tails: the flat words minus every block's first 256 bits.
    flat = tapi._overflow_words(*args[:1], args[1] - 1, args[3], args[2],
                                0x1FF, 1501)
    streams, bb = tbp.with_eof_block(*bs_cuda.emit_pack_plain(*args), 0x1FF)
    goff = torch.cumsum(bb, dim=1) - bb
    heads = tbp.u16_to_i16(tbp._place_streams(streams, goff,
                                              capacity_words=1501))
    assert torch.equal(tbp.words_u16(out32.contiguous(), 1501),
                       flat & ~heads)
    assert torch.equal(flat & heads, heads)


def test_tail_rejects_wrong_shapes():
    c, scale, dc_code, dc_bits = edge_inputs(6)
    args = _torch(select_form(c), scale, dc_code, dc_bits)
    bb = bs_cuda.emit_pack_plain(*args)[1]
    good = torch.zeros((2, 50), dtype=torch.int32)
    for out32, block_bits, count in (
            (good[:, :49].contiguous(), bb, None),
            (good.to(torch.int64), bb, None), (good, bb[:, :5], None),
            (good, bb, torch.zeros((2,), dtype=torch.int32))):
        with pytest.raises(ValueError):
            bs_cuda.emit_tail(out32, *args, block_bits, capacity_words=100,
                              count=count)


@pytest.mark.parametrize("nb", [6, 222, 585])
@pytest.mark.parametrize("kernel", ["emit_prep", "emit_pack"])
def test_emit_plain_matches_pallas_on_edge_blocks(kernel, nb):
    """K3's and K7's plain versions == the Pallas kernels on the hand-made
    blocks (cut at 256 bits on both sides, totals uncut)."""
    c, scale, dc_code, dc_bits = edge_inputs(nb)
    jargs = [jnp.asarray(a) for a in (c, scale, dc_code, dc_bits)]
    targs = _torch(select_form(c), scale, dc_code, dc_bits)
    if kernel == "emit_pack":
        want = jbsp.emit_pack_pallas(*jargs, interpret=True)
        got = bs_cuda.emit_pack(*targs)
        assert_same(want[0], got[0], name="streams")
        assert_same(want[1], got[1], name="block_bits")
        assert_same(want[1], bs_cuda.emit_pack(*_torch(c), *targs[1:])[1])
    else:
        want = jbsp.emit_prep_pallas(*jargs, eof=0x3FF, interpret=True)
        got = bs_cuda.emit_prep(*targs, eof=0x3FF)
        n1 = nb + 1
        assert_same(np.asarray(want[0])[:, :n1], got[0], name="vals32",
                    u32=True)
        assert_same(np.asarray(want[1])[:, :n1], got[1], name="e0")
        assert_same(want[2], got[2], name="block_bits")
        assert_same(want[3], got[3], name="total_bits")
    assert got[-2 if kernel == "emit_prep" else -1][0, :6].tolist() \
        == EDGE_BITS


def test_emit_plain_matches_pallas_on_every_code():
    """K7's plain version == the Pallas kernel on blocks that hold one
    level each: every (run, level) with a variable-length code, both
    signs, and the escapes around them. The bit totals are those of the
    closed-form code lengths."""
    c, scale, dc_code, dc_bits = code_table_inputs()
    want = jbsp.emit_pack_pallas(*[jnp.asarray(a) for a in
                                   (c, scale, dc_code, dc_bits)],
                                 interpret=True)
    got = bs_cuda.emit_pack(*_torch(c, scale, dc_code, dc_bits))
    assert_same(want[0], got[0], name="streams")
    assert_same(want[1], got[1], name="block_bits")
    run, level = np.divmod(np.arange(c.shape[2]) // 2, 42)
    bits = tbs.ac_bits_closed_form(torch.from_numpy(run),
                                   torch.from_numpy(level + 1))
    assert torch.equal(got[1][0], (bits + 12).to(torch.int32))
    # The MDEC table's 111 (run, level) pairs, 3 to 17 bits; else escapes.
    assert int((bits < 22).sum()) == 2 * 111 and int(bits.min()) == 3
    assert int(bits[bits < 22].max()) == 17


def _noise_at_every_scale(codec, seed):
    """63 copies of one noise frame's coefficients, one per scale, with
    the codec's DC stage: K3's inputs."""
    rng = np.random.default_rng(seed)
    frame = torch.from_numpy(rng.integers(0, 256, (1, W * H * 3 // 2)).astype(
        np.uint8))
    pix = tbs.rearrange_nv21_rows(frame, W, H)
    dc_bits, dc_code = tbs._dc_stage(tbs.dc_quant_from_pixrows(pix), codec)
    coefs = bs_cuda.select_scale_pix_plain(
        pix, torch.tensor([10 ** 8], dtype=torch.int32))[3]
    return (coefs.expand(63, -1, -1).contiguous(),
            torch.arange(1, 64, dtype=torch.int32),
            dc_code.expand(63, -1).contiguous(),
            dc_bits.expand(63, -1).contiguous())


@pytest.mark.parametrize("cap", [1200, 301])
@pytest.mark.parametrize("codec", [tbs.BS_V2, tbs.BS_V3, tbs.BS_V3DC])
def test_tail_plain_noise_at_every_scale(codec, cap):
    """A noise frame at each scale 1..63: K3 + K4 + the tail emission ==
    the flat path. The low scales have long blocks and the 301-word
    capacity cuts them; the high scales have none."""
    args = _noise_at_every_scale(codec, seed=codec + 20)
    words, count, prep = _tail_words(*args, tapi._eof(codec), cap)
    long_frames = (prep[2] > 256).any(dim=1)
    assert long_frames[0] and not long_frames[62] and count == int(
        long_frames.sum())
    want = tapi._overflow_words(args[0], args[1] - 1, args[3], args[2],
                                tapi._eof(codec), cap)
    assert torch.equal(words, want)


@pytest.fixture
def interpret_kernels(monkeypatch):
    for fn in ("select_scale_pix_pallas", "dc_stage_pallas",
               "emit_prep_pallas", "select_scale_pallas", "emit_pack_pallas"):
        monkeypatch.setattr(jbsp, fn, functools.partial(getattr(jbsp, fn),
                                                        interpret=True))
    for fn in ("place_vals_mxu_pallas", "place_streams_mxu_pallas",
               "place_vals_gather_pallas", "place_streams_gather_pallas",
               "place_streams_pallas", "pack_block_streams_pallas"):
        monkeypatch.setattr(jbpk, fn, functools.partial(getattr(jbpk, fn),
                                                        interpret=True))


# Budgets from generous to tight: the noise frames land on low scales with
# long blocks and on high ones; the last is unfittable (emitted at scale 1,
# running far past the capacity).
NOISE_BUDGETS = np.array([4000, 3000, 2200, 1600, 1216, 200], np.int32)


def _noise_batch(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (len(NOISE_BUDGETS), W * H * 3 // 2)).astype(
        np.uint8)


@pytest.mark.parametrize("cap", [(4000 - 8 + 1) // 2, 1995])
@pytest.mark.parametrize("codec", [tbs.BS_V2, tbs.BS_V3, tbs.BS_V3DC])
def test_packed_noise_matches_jax_and_tail(interpret_kernels, codec, cap):
    """Noise frames over a range of budgets: fused_mxu, fused_gather and
    fused_pallas of the port == psxavenc_tpu's fused_mxu == K3 + K4 + the
    tail emission by their plain versions (the unfittable frame included
    in the last, where the JAX package's words are not defined)."""
    frames = _noise_batch(codec + 30)
    want = japi.bs_encode_frames_packed(
        jnp.asarray(frames), jnp.asarray(NOISE_BUDGETS), codec=codec,
        width=W, height=H, capacity_words=cap, packer="fused_mxu")
    targs = _torch(frames, NOISE_BUDGETS)
    kw = dict(codec=codec, width=W, height=H, capacity_words=cap)
    fit = slice(0, len(NOISE_BUDGETS) - 1)
    outs = []
    for packer in ("fused_mxu", "fused_gather", "fused_pallas"):
        before = tapi.COUNTERS["overflow_frames"]
        got = tapi.bs_encode_frames_packed(*targs, packer=packer, **kw)
        assert tapi.COUNTERS["overflow_frames"] - before >= 2
        assert_same(want["scale"], got["scale"], name="scale")
        assert got["scale"].tolist()[-1] == 64
        assert_same(np.asarray(want["words"])[fit],
                    got["words"].numpy().view(np.uint16)[fit], name=packer)
        outs.append(got["words"])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])

    sel = tapi._select_pixels(*targs, codec, W, H, tapi._PLAIN)
    words, count, _ = _tail_words(sel["c"], sel["scale_idx"] + 1,
                                  sel["dc_code"], sel["dc_bits"],
                                  tapi._eof(codec), cap)
    assert torch.equal(words, outs[0])
    assert count >= 2


def test_no_long_block_counts_nothing(interpret_kernels):
    """Synthetic video at budgets that keep every block inside its window:
    the counter stays where it was, the tail emission changes no word, and
    the words equal psxavenc_tpu's."""
    frames = video_frames(W, H, 3, seed=8, noise=0)
    budgets = np.array([600, 450, 300], np.int32)
    cap = 446
    before = tapi.COUNTERS["overflow_frames"]
    got = tapi.bs_encode_frames_packed(*_torch(frames, budgets), codec=0,
                                       width=W, height=H, capacity_words=cap)
    assert tapi.COUNTERS["overflow_frames"] == before
    want = japi.bs_encode_frames_packed(
        jnp.asarray(frames), jnp.asarray(budgets), codec=0, width=W,
        height=H, capacity_words=cap)
    assert_same(want["words"], got["words"].numpy().view(np.uint16))
    sel = tapi._select_pixels(*_torch(frames, budgets), 0, W, H, tapi._PLAIN)
    words, count, prep = _tail_words(sel["c"], sel["scale_idx"] + 1,
                                     sel["dc_code"], sel["dc_bits"], 0x1FF,
                                     cap)
    assert count == 0 and int(prep[2].max()) <= 256
    assert torch.equal(words, got["words"])


def test_counter_folds_device_counts():
    """COUNTERS["overflow_frames"] adds what the tail emission counted on a
    device when it is read, once; assigning discards it."""
    counters = tapi._Counters()
    dev = torch.device("cpu")
    counters.device_count(dev).add_(3)
    assert counters.device_count(dev) is counters.device_count(dev)
    assert counters["overflow_frames"] == 3
    assert counters["overflow_frames"] == 3
    counters["overflow_frames"] += 2
    counters.device_count(dev).add_(4)
    assert counters["overflow_frames"] == 9
    counters.device_count(dev).add_(1)
    counters["overflow_frames"] = 0
    assert counters["overflow_frames"] == 0


@pytest.mark.parametrize("nb,threads", [(6, 96), (222, 288), (585, 672),
                                        (960, 960), (961, 576),
                                        (1800, 960), (2560, 864),
                                        (7200, 960)])
def test_emit_threads(nb, threads):
    """K3's CTA width: whole groups of 96 threads (whole warps that hold a
    macroblock's six kinds of block equally often), at most 960, the
    blocks spread evenly over the fewest trips."""
    assert bs_cuda.emit_threads(nb) == threads
    assert threads % 32 == 0 and threads % 6 == 0
    trips = -(-nb // threads)
    assert trips == -(-nb // bs_cuda.EMIT_MAX_THREADS)


def test_pack_bits_at_places_codes_at_their_offsets():
    """pack_bits is pack_bits_at at the running sum of the bit lengths;
    codes at scattered offsets land where they are put."""
    rng = np.random.default_rng(2)
    bits = torch.from_numpy(rng.integers(0, 23, (3, 200)))
    codes = torch.from_numpy(rng.integers(0, 1 << 22, (3, 200))) \
        & ((1 << bits) - 1)
    words, total = tbp.pack_bits(codes, bits, capacity_words=150)
    at = torch.cumsum(bits, dim=1) - bits
    assert torch.equal(words, tbp.pack_bits_at(codes, bits, at,
                                               capacity_words=150))
    one = tbp.pack_bits_at(torch.tensor([[0x2AAAAA, 1]]),
                           torch.tensor([[22, 1]]),
                           torch.tensor([[252, 40]]), capacity_words=18)
    assert one[0].tolist() == [0, 0, 0x0080] + [0] * 12 + [0xA, 0xAAAA,
                                                           0x8000]
