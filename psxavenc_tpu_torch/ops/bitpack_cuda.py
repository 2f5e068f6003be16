"""Wrappers and plain versions of the placement and packing kernels K4,
K8, K9 and K10.

Counterparts in ``psxavenc_tpu/ops/bitpack_pallas.py``:

- K4 ``place_vals_mxu_pallas``: each frame's bitstream is the OR (equal to
  the sum) of its blocks' bit-disjoint nine-word u32 contributions at u32
  offsets ``e0``, cut to capacity (``csrc/bitpack_place.cu``);
- K9 ``place_streams_pallas``: the same placement from per-block u16
  streams and their global bit offsets (``csrc/bitpack_streams.cu``);
- K10 ``pack_block_streams_pallas``: dense per-block packing of symbol
  tensors into 16-word streams (``csrc/bitpack_streams.cu``);
- ``place_streams_mxu`` and ``place_streams_gather``: ``streams_to_u32``
  glue followed by K4 or K8 (wrappers, as ``place_streams_mxu_pallas`` and
  ``place_streams_gather_pallas`` are).

Each wrapper takes the plain version only for CPU tensors and launches its
kernel for CUDA tensors; ``LAUNCHES`` counts the launches.
"""

import torch

from . import _build, bitpack
from .bs_cuda import _on_cuda, _require

LAUNCHES = {"place_vals": 0, "place_vals_gather": 0, "place_streams": 0,
            "pack_block_streams": 0}

BCAP = bitpack.BLOCK_CAP_WORDS
cap32_of = bitpack.cap32_of


# ------------------------------------------------------------------- K4

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


def _check_place_args(vals32, e0, name):
    _require(vals32, torch.int32, 3, f"{name} vals32")
    _require(e0, torch.int32, 2, f"{name} e0")
    B, nbe, slots = vals32.shape
    if slots != 9 or e0.shape != (B, nbe) or e0.device != vals32.device:
        raise ValueError(f"{name}: expected vals32 (B, NBe, 9) and e0 "
                         "(B, NBe) on one device")
    return B, nbe


def place_vals(vals32, e0, *, capacity_words):
    """K4 (``csrc/bitpack_place.cu``): see :func:`place_vals_plain`."""
    if not _on_cuda(vals32, "place_vals"):
        return place_vals_plain(vals32, e0, capacity_words=capacity_words)
    B, nbe = _check_place_args(vals32, e0, "place_vals")
    cap32 = cap32_of(capacity_words)
    out = torch.zeros((B, cap32), dtype=torch.int32, device=vals32.device)
    LAUNCHES["place_vals"] += 1
    _build.launch("psx_place_vals", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, _build.ptr(out))
    return out


def place_streams_mxu(streams, goff, total_bits, *, capacity_words,
                      place=place_vals):
    """Placement of (B, NBe, 16) u16 streams at (B, NBe) global bit
    offsets through K4 (``place``: K4's wrapper, or its plain version):
    -> (B, capacity_words) int32 u16 values. ``total_bits`` is taken for
    the JAX signature; the offsets say everything."""
    vals32, e0 = bitpack.streams_to_u32(streams, goff)
    out32 = place(bitpack.u32_to_i32(vals32), e0.to(torch.int32),
                  capacity_words=capacity_words)
    return bitpack.u16_values(out32, capacity_words)


# ------------------------------------------------------------------- K8

def place_vals_gather_plain(vals32, e0, *, capacity_words):
    """K8's plain version: K4's function, so :func:`place_vals_plain`'s
    scatter-add."""
    return place_vals_plain(vals32, e0, capacity_words=capacity_words)


def place_vals_gather(vals32, e0, *, capacity_words):
    """K8 (``csrc/bitpack_gather.cu``): (B, NBe, 9) int32 u32 contributions
    + (B, NBe) int32 u32 offsets -> (B, cap32) int32 placed u32 words, as
    :func:`place_vals_plain`. Precondition: each frame's ``e0`` row is
    non-decreasing (``emit_prep``'s offsets and a cumsum of block bits
    are); the kernel binary-searches it. Each output word is written once,
    so the output is not zero-filled first."""
    if not _on_cuda(vals32, "place_vals_gather"):
        return place_vals_gather_plain(vals32, e0,
                                       capacity_words=capacity_words)
    B, nbe = _check_place_args(vals32, e0, "place_vals_gather")
    if B > 65535:
        raise ValueError("place_vals_gather: at most 65,535 frames per call "
                         "(one grid row per frame)")
    cap32 = cap32_of(capacity_words)
    out = torch.empty((B, cap32), dtype=torch.int32, device=vals32.device)
    LAUNCHES["place_vals_gather"] += 1
    _build.launch("psx_place_vals_gather", vals32, _build.ptr(vals32),
                  _build.ptr(e0), B, nbe, cap32, _build.ptr(out))
    return out


def place_streams_gather(streams, goff, total_bits, *, capacity_words,
                         place=place_vals_gather):
    """:func:`place_streams_mxu` through K8 (``place``: K8's wrapper, or
    its plain version)."""
    return place_streams_mxu(streams, goff, total_bits,
                             capacity_words=capacity_words, place=place)


# ------------------------------------------------------------------- K9

def place_streams_plain(streams, goff, total_bits, *, capacity_words):
    """(B, NBe, 16) u16 streams + (B, NBe) global bit offsets -> (B,
    capacity_words) int32 u16 words: ``bitpack._place_streams`` (offsets
    past the capacity drop). ``total_bits`` is taken for the JAX
    signature; the offsets say everything."""
    return bitpack._place_streams(streams, goff,
                                  capacity_words=capacity_words).to(
        torch.int32)


def place_streams(streams, goff, total_bits, *, capacity_words):
    """K9 (``csrc/bitpack_streams.cu``): see :func:`place_streams_plain`.
    The kernel writes only the (B, cap32) u32 words of the output."""
    if not _on_cuda(streams, "place_streams"):
        return place_streams_plain(streams, goff, total_bits,
                                   capacity_words=capacity_words)
    _require(streams, torch.int32, 3, "place_streams streams")
    _require(goff, torch.int32, 2, "place_streams goff")
    B, nbe, w = streams.shape
    if w != BCAP or goff.shape != (B, nbe) or goff.device != streams.device \
            or streams.data_ptr() % 16:
        raise ValueError(f"place_streams: expected 16-byte aligned streams "
                         f"(B, NBe, {BCAP}) and goff (B, NBe) on one device")
    cap32 = cap32_of(capacity_words)
    out = torch.zeros((B, cap32), dtype=torch.int32, device=streams.device)
    LAUNCHES["place_streams"] += 1
    _build.launch("psx_place_streams", streams, _build.ptr(streams),
                  _build.ptr(goff), B, nbe, cap32, _build.ptr(out))
    return bitpack.u16_values(out, capacity_words)


# ------------------------------------------------------------------ K10

def pack_block_streams_plain(codes, bits):
    """(B, NBe, S) symbols (u32 codes, bit lengths 0-32) -> (streams (B,
    NBe, 16) int32 u16 values, block bits (B, NBe) int32):
    ``bitpack._pack_block_streams`` on every block. Blocks over 256 bits
    are cut; block bits count them whole."""
    B, nbe, S = codes.shape
    bits64 = bits.to(torch.int64)
    offs = torch.cumsum(bits64, dim=2) - bits64
    streams = bitpack._pack_block_streams(
        codes.reshape(-1, S), bits64.reshape(-1, S), offs.reshape(-1, S),
        bcap=BCAP).reshape(B, nbe, BCAP)
    return (streams.to(torch.int32),
            (offs[..., -1] + bits64[..., -1]).to(torch.int32))


def pack_block_streams(codes, bits):
    """K10 (``csrc/bitpack_streams.cu``): see
    :func:`pack_block_streams_plain`. int64 codes go to the kernel as
    int32 bit patterns."""
    if not _on_cuda(codes, "pack_block_streams"):
        return pack_block_streams_plain(codes, bits)
    codes32 = (bitpack.u32_to_i32(codes) if codes.dtype == torch.int64
               else codes.to(torch.int32).contiguous())
    bits32 = bits.to(device=codes.device, dtype=torch.int32).contiguous()
    if codes32.ndim != 3 or bits32.shape != codes32.shape:
        raise ValueError("pack_block_streams: expected codes and bits "
                         "(B, NBe, S)")
    B, nbe, S = codes32.shape
    streams = torch.empty((B, nbe, BCAP), dtype=torch.int32,
                          device=codes.device)
    block_bits = torch.empty((B, nbe), dtype=torch.int32, device=codes.device)
    LAUNCHES["pack_block_streams"] += 1
    _build.launch("psx_pack_block_streams", codes32, _build.ptr(codes32),
                  _build.ptr(bits32), B * nbe, S, _build.ptr(streams),
                  _build.ptr(block_bits))
    return streams, block_bits
