"""Wrapper and plain version of the ADPCM unit kernel K5.

Counterpart of ``encode_units_pallas`` in
``psxavenc_tpu/ops/adpcm_pallas.py``, with its public layout: headers
(B, T), packed sample words (B, T, W) with W = 4 for 4-bit (nibble m of
word k at bit 4m, which are bytes [2+4k, 2+4k+4) of an SPU block) and
W = 7 for 8-bit (byte m of word k at bit 8m), and the decoder state after
each unit, s1 and s2 (B, T), all int32. The wrapper takes the plain
version only for CPU tensors and launches ``csrc/adpcm_units.cu`` for CUDA
tensors; ``LAUNCHES`` counts the launches.
"""

import torch

from . import _build
from . import adpcm
from .bs_cuda import _on_cuda, _require

LAUNCHES = {"adpcm_encode_units": 0}

# (filter_count, shift_range) pairs the kernel is built for: SPU and the
# two XA bit depths.
KERNEL_VARIANTS = ((5, 12), (4, 12), (4, 8))


def n_words(shift_range):
    return 4 if shift_range == adpcm.SHIFT_RANGE_4BPS else 7


def clip_limits(limits):
    """Per-unit limits as the kernel takes them: int32 in
    [-(1 << 30), 28] (adpcm_pallas.py:209-210)."""
    return limits.clamp(-(1 << 30), adpcm.SAMPLES_PER_UNIT).to(torch.int32)


def pack_words(values, shift_range):
    """(B, T, 28) sample values -> (B, T, W) int32 packed words."""
    bits = 4 if shift_range == adpcm.SHIFT_RANGE_4BPS else 8
    per_word = 32 // bits
    B, T, n = values.shape
    W = n_words(shift_range)
    v = torch.zeros((B, T, W * per_word), dtype=torch.int64,
                    device=values.device)
    v[..., :n] = values.to(torch.int64) & ((1 << bits) - 1)
    shifts = bits * torch.arange(per_word, device=values.device)
    words = (v.reshape(B, T, W, per_word) << shifts).sum(dim=3)
    return (words - ((words & 0x80000000) << 1)).to(torch.int32)


def unpack_words(words, shift_range):
    """(B, T, W) packed words -> (B, T, 28) int32 sample values."""
    bits = 4 if shift_range == adpcm.SHIFT_RANGE_4BPS else 8
    per_word = 32 // bits
    shifts = bits * torch.arange(per_word, dtype=torch.int32,
                                 device=words.device)
    v = (words[..., None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(*words.shape[:2], -1)[..., :adpcm.SAMPLES_PER_UNIT]


def encode_units_plain(units, limits, prev1, prev2, *, filter_count,
                       shift_range):
    """(B, T, 28) units, (B, T) limits, (B,) prev1/prev2 -> headers (B, T),
    words (B, T, W), s1, s2 (B, T), int32 (plain torch, any device)."""
    h, values, s1, s2 = adpcm.encode_units_scan(
        units, clip_limits(limits), prev1, prev2, filter_count=filter_count,
        shift_range=shift_range)
    return h, pack_words(values, shift_range), s1, s2


def encode_units(units, limits, prev1, prev2, *, filter_count,
                 shift_range):
    """K5 (``csrc/adpcm_units.cu``): see :func:`encode_units_plain`."""
    if not _on_cuda(units, "encode_units"):
        return encode_units_plain(units, limits, prev1, prev2,
                                  filter_count=filter_count,
                                  shift_range=shift_range)
    if (filter_count, shift_range) not in KERNEL_VARIANTS:
        raise ValueError(f"encode_units: no kernel for filter_count="
                         f"{filter_count}, shift_range={shift_range}")
    _require(units, torch.int32, 3, "encode_units units")
    _require(limits, torch.int32, 2, "encode_units limits")
    _require(prev1, torch.int32, 1, "encode_units prev1")
    _require(prev2, torch.int32, 1, "encode_units prev2")
    B, T, n = units.shape
    if n != adpcm.SAMPLES_PER_UNIT or limits.shape != (B, T) \
            or prev1.shape != (B,) or prev2.shape != (B,) \
            or any(t.device != units.device
                   for t in (limits, prev1, prev2)):
        raise ValueError("encode_units: expected units (B, T, 28), limits "
                         "(B, T) and prev1/prev2 (B,) on one device")
    limits = clip_limits(limits)
    dev = units.device
    hdr = torch.empty((B, T), dtype=torch.int32, device=dev)
    words = torch.empty((B, T, n_words(shift_range)), dtype=torch.int32,
                        device=dev)
    s1 = torch.empty((B, T), dtype=torch.int32, device=dev)
    s2 = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B and T:
        LAUNCHES["adpcm_encode_units"] += 1
        _build.launch("psx_adpcm_encode_units", units, _build.ptr(units),
                      _build.ptr(limits), _build.ptr(prev1),
                      _build.ptr(prev2), B, T, filter_count, shift_range,
                      _build.ptr(hdr), _build.ptr(words), _build.ptr(s1),
                      _build.ptr(s2))
    return hdr, words, s1, s2
