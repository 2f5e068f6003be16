"""The port's CUDA kernels on a card: each equals its plain version at the
main path's shapes, and the encoder's bytes equal the native C++ tier.

Skipped without a CUDA device. This file imports no JAX, so it runs on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from psxavenc_tpu_torch.ops import bitpack_cuda
from psxavenc_tpu_torch.ops import bs as tbs
from psxavenc_tpu_torch.ops import bs_cuda

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
    return {
        "select_scale_pix": (bs_cuda.select_scale_pix,
                             bs_cuda.select_scale_pix_plain, (pix, thr), {}),
        "dc_stage": (bs_cuda.dc_stage, bs_cuda.dc_stage_plain,
                     (tbs.dc_quant_from_pixrows(pix), tbs.BS_V3DC), {}),
        "emit_prep": (bs_cuda.emit_prep, bs_cuda.emit_prep_plain, emit,
                      {"eof": 0x1FF}),
        "place_vals": (bitpack_cuda.place_vals,
                       bitpack_cuda.place_vals_plain, (vals32, e0),
                       {"capacity_words": 9068}),
    }


@pytest.mark.parametrize("name", ["select_scale_pix", "dc_stage",
                                  "emit_prep", "place_vals"])
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
