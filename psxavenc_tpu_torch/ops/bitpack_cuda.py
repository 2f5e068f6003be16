"""Wrapper and plain version of the placement kernel K4.

Counterpart of ``place_vals_mxu_pallas`` in
``psxavenc_tpu/ops/bitpack_pallas.py``: each frame's bitstream is the OR
(equal to the sum) of its blocks' bit-disjoint nine-word u32
contributions at u32 offsets ``e0``, cut to capacity. The wrapper takes the
plain version only for CPU tensors and launches ``csrc/bitpack_place.cu``
for CUDA tensors; ``LAUNCHES`` counts the launches.
"""

import torch

from . import _build, bitpack
from .bs_cuda import _on_cuda, _require

LAUNCHES = {"place_vals": 0}


def cap32_of(capacity_words):
    return (capacity_words + 1) // 2


def place_vals_plain(vals32, e0, *, capacity_words):
    """(B, NBe, 9) int32 u32 contributions + (B, NBe) offsets -> (B, cap32)
    int32 placed u32 words (plain torch scatter-add into a spare column
    that collects the dropped writes)."""
    B, nbe, _ = vals32.shape
    cap32 = cap32_of(capacity_words)
    v = vals32.to(torch.int64) & bitpack.U32_MASK
    idx = e0.to(torch.int64)[:, :, None] + torch.arange(
        9, device=vals32.device)
    idx = torch.where((idx >= 0) & (idx < cap32), idx, cap32)
    out = torch.zeros((B, cap32 + 1), dtype=torch.int64,
                      device=vals32.device)
    out.scatter_add_(1, idx.reshape(B, -1), v.reshape(B, -1))
    return bitpack.u32_to_i32(out[:, :cap32])


def place_vals(vals32, e0, *, capacity_words):
    """K4 (``csrc/bitpack_place.cu``): see :func:`place_vals_plain`."""
    if not _on_cuda(vals32, "place_vals"):
        return place_vals_plain(vals32, e0, capacity_words=capacity_words)
    _require(vals32, torch.int32, 3, "place_vals vals32")
    _require(e0, torch.int32, 2, "place_vals e0")
    B, nbe, slots = vals32.shape
    if slots != 9 or e0.shape != (B, nbe) or e0.device != vals32.device:
        raise ValueError("place_vals: expected vals32 (B, NBe, 9) and "
                         "e0 (B, NBe) on one device")
    cap32 = cap32_of(capacity_words)
    out = torch.zeros((B, cap32), dtype=torch.int32, device=vals32.device)
    LAUNCHES["place_vals"] += 1
    _build.launch("psx_place_vals", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, _build.ptr(out))
    return out
