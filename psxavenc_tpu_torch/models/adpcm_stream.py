"""Stream-level ADPCM encoding: unit layout on the host, one K5 call per
stream batch.

Counterpart of ``psxavenc_tpu/models/adpcm_stream.py``. The unit
boundaries (offset, limit) of a whole stream are computed up front, the
int16 PCM goes to the device, the (B, T, 28) units are gathered there,
and one K5 launch threads the decoder state over time for all B channel
streams. The device is explicit (default: the card). On a CPU device the
units go to the native C++ unit encoder (``native/tiers.py``, bit-exact
with K5), as the JAX module's no-TPU tier does, unless
PSXAVENC_NO_NATIVE_ADPCM is set: then K5's plain version runs. On the
card it is always K5. The TPU-only parts of the JAX module (the 128-lane
pad, the time segments, the power-of-two time buckets, the fused
read-back) have no counterpart here.

Spans (``utils/spans.py``), one each a K5 call: ``adpcm.upload`` (the
host arrays to the device, and the units' gather there), ``adpcm.kernel``
(the states, K5 and the unpack on the device, or the native call on the
CPU) and ``adpcm.read_back``; the copies through pageable host memory
count their bytes.
"""

import os

import numpy as np
import torch

from ..native import tiers
from ..ops import adpcm as ops
from ..ops import adpcm_cuda
from ..utils import spans

SAMPLES_PER_UNIT = ops.SAMPLES_PER_UNIT


def chunk_unit_layout(chunk_lengths):
    """Per-unit (offset, limit) for a channel stream consumed in chunks.

    Each chunk of ``len`` samples becomes ceil(len/28) units; a chunk's last
    unit may be partial (in-block zero padding), and the next chunk starts at
    the next sample — the unit grid is NOT globally 28-aligned
    (adpcm.c:366, filefmt.c:319-341).
    """
    lens = np.asarray(chunk_lengths, np.int64)
    nunits = -(-lens // SAMPLES_PER_UNIT)           # ceil; 0 for ln == 0
    pos = np.concatenate([[0], np.cumsum(lens)[:-1]]) if lens.size \
        else np.zeros(0, np.int64)
    total = int(nunits.sum())
    # Unit u's index within its chunk: global arange minus the chunk's
    # first-unit index, repeated per unit.
    first = np.concatenate([[0], np.cumsum(nunits)[:-1]]) if lens.size \
        else np.zeros(0, np.int64)
    k = np.arange(total, dtype=np.int64) - np.repeat(first, nunits)
    offsets = np.repeat(pos, nunits) + SAMPLES_PER_UNIT * k
    limits = np.minimum(np.repeat(lens, nunits) - SAMPLES_PER_UNIT * k,
                        SAMPLES_PER_UNIT)
    return offsets, limits


def uniform_unit_layout(total_units, samples_available):
    """XA-style layout: unit t covers samples [28t, 28t+28) with limit
    ``available - 28t`` (can be <= 0 for trailing pad units;
    adpcm.c:293-332)."""
    t = np.arange(total_units, dtype=np.int64)
    return t * SAMPLES_PER_UNIT, samples_available - t * SAMPLES_PER_UNIT


def gather_units(channel_samples, offsets, limits):
    """(B, N) samples + (B, T) offsets/limits, tensors on one device ->
    ((B, T, 28) int32 units, (B, T) int32 limits clipped to
    [-(1 << 30), 28]) on that device. Sample indices clip to [0, N-1], so
    a unit past the end repeats the last sample (its limit masks it)."""
    B, N = channel_samples.shape
    T = offsets.shape[1]
    lim = adpcm_cuda.clip_limits(limits)
    if N == 0:
        return (torch.zeros((B, T, SAMPLES_PER_UNIT), dtype=torch.int32,
                            device=channel_samples.device), lim)
    idx = offsets.to(torch.int64)[..., None] + torch.arange(
        SAMPLES_PER_UNIT, device=offsets.device)
    idx = idx.clamp(0, N - 1).reshape(B, -1)
    units = channel_samples.to(torch.int32).gather(1, idx)
    return units.reshape(B, T, SAMPLES_PER_UNIT), lim


def _state(prev, B):
    return np.zeros(B, np.int32) if prev is None \
        else np.asarray(prev, np.int32)


def upload(x, device, dtype=None):
    """A host array or a tensor -> a tensor on ``device`` (of ``dtype``);
    a copy from pageable host memory to a card counts its bytes."""
    t = torch.as_tensor(x)
    spans.count_h2d(t, device)
    return t.to(device=device, dtype=dtype)


def read_back(t):
    """A tensor -> a host numpy array; a copy from a card counts its
    bytes."""
    spans.count_d2h(t)
    return t.cpu().numpy()


def _encode(units, lim, prev1, prev2, filter_count, shift_range, state_t):
    """K5 on device tensors (the native tier on the CPU, unless
    PSXAVENC_NO_NATIVE_ADPCM is set) -> host (headers uint8, values
    uint8, final prev1, final prev2)."""
    B, T = lim.shape
    dev = units.device
    if dev.type == "cpu" and not os.environ.get("PSXAVENC_NO_NATIVE_ADPCM"):
        with spans.span("adpcm.kernel"):
            h, v, s1, s2 = tiers.adpcm_encode_units(
                units.numpy(), lim.numpy(), _state(prev1, B),
                _state(prev2, B), filter_count, shift_range)
        t_idx = np.full(B, T - 1) if state_t is None \
            else np.asarray(state_t, np.int64)
        rows = np.arange(B)
        return h, v, s1[rows, t_idx], s2[rows, t_idx]
    with spans.span("adpcm.kernel"):
        h, w, s1, s2 = adpcm_cuda.encode_units(
            units, lim, upload(_state(prev1, B), dev),
            upload(_state(prev2, B), dev),
            filter_count=filter_count, shift_range=shift_range)
        if state_t is None:
            t_idx = torch.full((B, 1), T - 1, dtype=torch.int64, device=dev)
        else:
            t_idx = upload(np.asarray(state_t, np.int64), dev)[:, None]
        f1 = s1.gather(1, t_idx)[:, 0]
        f2 = s2.gather(1, t_idx)[:, 0]
        h = h.to(torch.uint8)
        values = adpcm_cuda.unpack_words(w, shift_range).to(torch.uint8)
    with spans.span("adpcm.read_back"):
        return read_back(h), read_back(values), read_back(f1), read_back(f2)


def encode_unit_streams(channel_samples, offsets, limits, filter_count,
                        shift_range, prev1=None, prev2=None, device="cuda"):
    """Encode B channel streams' units on ``device``.

    Args:
      channel_samples: (B, N) int16/int32 per-channel contiguous samples
        (uploaded as int16).
      offsets: (B, T) non-negative start sample of each unit.
      limits: (B, T) per-unit limits (values > 28 behave as 28, values
        <= 0 mask the whole unit, which still changes the state).
    Returns:
      headers (B, T) uint8, sample values (B, T, 28) uint8, and the
      decoder state (prev1, prev2) after the last unit, host numpy.
    """
    channel_samples = np.asarray(channel_samples)
    offsets = np.asarray(offsets)
    B = channel_samples.shape[0]
    T = offsets.shape[1]
    if offsets.size and int(offsets.min()) < 0:
        raise ValueError("unit offsets must be non-negative")
    if T == 0:
        # As psxavenc_tpu: an empty stream reports a zero state.
        return (np.zeros((B, 0), np.uint8),
                np.zeros((B, 0, SAMPLES_PER_UNIT), np.uint8),
                np.zeros(B, np.int32), np.zeros(B, np.int32))
    dev = torch.device(device)
    with spans.span("adpcm.upload"):
        pcm = upload(channel_samples.astype(np.int16), dev)
        offs = upload(offsets.astype(np.int64), dev)
        lims = upload(np.clip(np.asarray(limits), -(1 << 30),
                              SAMPLES_PER_UNIT).astype(np.int32), dev)
        units, lim = gather_units(pcm, offs, lims)
    return _encode(units, lim, prev1, prev2, filter_count, shift_range,
                   None)


def whole_file(unit_encoder):
    """True for an injected unit encoder (the batch runner's capture or
    replay) that takes a file's units in one call; the default encoder
    and a ``chunked`` one get the containers' bounded chunk feeds."""
    return (unit_encoder not in (None, encode_unit_streams)
            and not getattr(unit_encoder, "chunked", False))


def encode_prepared_units(units, lim, filter_count, shift_range,
                          prev1=None, prev2=None, state_t=None,
                          device="cuda"):
    """Encode pre-gathered (B, T, 28) units (see encode_unit_streams; the
    batch runner concatenates many files' streams on B before calling):
    numpy arrays or tensors on any device, moved to ``device``.

    ``state_t``: optional (B,) per-row unit index whose post-state to
    return as the final decoder state (rows padded with masked units
    still change the state; adpcm.c:142-191 runs regardless). Default:
    the last column.
    """
    dev = torch.device(device)
    with spans.span("adpcm.upload"):
        units = upload(units, dev, torch.int32).contiguous()
        lim = adpcm_cuda.clip_limits(upload(lim, dev)).contiguous()
    B, T = lim.shape
    if T == 0:
        return (np.zeros((B, 0), np.uint8),
                np.zeros((B, 0, SAMPLES_PER_UNIT), np.uint8),
                _state(prev1, B).copy(), _state(prev2, B).copy())
    return _encode(units, lim, prev1, prev2, filter_count, shift_range,
                   state_t)


def pack_spu_blocks(headers, nibbles, flags=None):
    """(T,) headers + (T, 28) nibbles -> (T, 16) SPU blocks
    (adpcm.c:356-376). ``flags`` fills byte 1 (loop flags)."""
    T = headers.shape[0]
    blocks = np.zeros((T, 16), dtype=np.uint8)
    blocks[:, 0] = headers
    if flags is not None:
        blocks[:, 1] = flags
    pairs = nibbles.reshape(T, 14, 2)
    blocks[:, 2:] = (pairs[:, :, 0] & 0x0F) | (pairs[:, :, 1] << 4)
    return blocks
