"""Stream-level ADPCM encoding: unit layout on the host, one K5 call per
stream batch.

Counterpart of ``psxavenc_tpu/models/adpcm_stream.py``. The unit
boundaries (offset, limit) of a whole stream are computed up front; the
int16 PCM, an int32 offset and a limit a unit go to the device
(:func:`k5_input` converts every route's input, once), and one K5 launch
reads each unit straight from the PCM and threads the decoder state over
time for all B streams. The batch runner's zero-padded units go up in
K5's dense layout, a shard a device where it gives several. On a CPU
device the units are gathered on the host for the native C++ unit
encoder (``native/tiers.py``, bit-exact with K5), as the JAX module's
no-TPU tier does, unless PSXAVENC_NO_NATIVE_ADPCM is set: then K5's
plain version runs. The TPU-only parts of the JAX module (the 128-lane
pad, the time segments, the power-of-two time buckets, the fused
read-back) have no counterpart here.

Spans (``utils/spans.py``), one each a K5 call: ``adpcm.upload`` (the
host arrays to the device), ``adpcm.kernel`` (the states, K5 and the
unpack on the device, or the host gather and the native call on the
CPU) and ``adpcm.read_back``; the copies through pageable host memory
count their bytes.
"""

import os

import numpy as np
import torch

from ..native import tiers
from ..ops import adpcm as ops
from ..ops import adpcm_cuda
from ..parallel import mesh
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


def _state(prev, B):
    return np.zeros(B, np.int32) if prev is None \
        else np.asarray(prev, np.int32)


def k5_input(samples, limits):
    """Every route's ``samples`` and ``limits`` (host arrays or tensors)
    as K5 takes them, contiguous and where they are: the samples int16
    (``adpcm_cuda.s16_units``: ValueError outside s16), the limits int32
    in [-(1 << 30), 28]."""
    samples, limits = (x if torch.is_tensor(x) else torch.from_numpy(
        np.require(x, requirements="W")) for x in (samples, limits))
    return (adpcm_cuda.s16_units(samples).contiguous(),
            adpcm_cuda.clip_limits(limits).contiguous())


def upload(x, device):
    """A host array or a tensor -> a tensor on ``device``; a copy from
    pageable host memory to a card counts its bytes."""
    t = torch.as_tensor(x)
    spans.count_h2d(t, device)
    return t.to(device)


def _encode(dev, pcm, offsets, lim, prev1, prev2, state_t, filter_count,
            shift_range):
    """K5 on ``dev`` -> (headers uint8, values uint8, final prev1, final
    prev2) there, not read back (:func:`_run` does); on the CPU the native
    tier's host arrays, unless PSXAVENC_NO_NATIVE_ADPCM is set.

    ``pcm`` (B, N) int16, ``offsets`` (B, T) int32 or None (K5's dense
    layout) and ``lim`` (B, T) int32 go up here, and their device copies
    are the call's only references: the samples are freed once K5 has
    run, before the unpack, so the call's device peak is K5's own working
    set. ``state_t`` (B,) int64: each row's unit whose post-state is
    final."""
    with spans.span("adpcm.upload"):
        pcm, offsets, lim = (x if x is None else upload(x, dev)
                             for x in (pcm, offsets, lim))
    B, T = lim.shape
    if dev.type == "cpu" and not os.environ.get("PSXAVENC_NO_NATIVE_ADPCM"):
        with spans.span("adpcm.kernel"):
            units = adpcm_cuda.gather_units_plain(pcm, offsets, T)
            h, v, s1, s2 = tiers.adpcm_encode_units(
                units.numpy(), lim.numpy(), _state(prev1, B),
                _state(prev2, B), filter_count, shift_range)
        rows = np.arange(B)
        return h, v, s1[rows, state_t], s2[rows, state_t]
    with spans.span("adpcm.kernel"):
        h, w, s1, s2 = adpcm_cuda.encode_pcm_units(
            pcm, offsets, lim, upload(_state(prev1, B), dev),
            upload(_state(prev2, B), dev),
            filter_count=filter_count, shift_range=shift_range)
        del pcm, offsets, lim
        t_idx = upload(state_t, dev)[:, None]
        f1 = s1.gather(1, t_idx)[:, 0]
        f2 = s2.gather(1, t_idx)[:, 0]
        h = h.to(torch.uint8)
        values = adpcm_cuda.unpack_words_u8(w, shift_range)
    return h, values, f1, f2


def _run(shards, filter_count, shift_range, B):
    """:func:`_encode` on each shard (its arguments up to ``state_t``),
    all enqueued before any read-back (which counts its bytes) -> the
    outputs on the host, the shards' rows concatenated, rows 0..B-1."""
    outs = [_encode(*shard, filter_count, shift_range) for shard in shards]
    for k, out in enumerate(outs):
        if torch.is_tensor(out[0]):     # not the native tier's arrays
            with spans.span("adpcm.read_back"):
                for t in out:
                    spans.count_d2h(t)
                outs[k] = [t.cpu().numpy() for t in out]
    return tuple(outs[0]) if len(outs) == 1 else \
        tuple(np.concatenate(col)[:B] for col in zip(*outs))


def encode_unit_streams(channel_samples, offsets, limits, filter_count,
                        shift_range, prev1=None, prev2=None, device="cuda"):
    """Encode B channel streams' units on ``device``.

    Args:
      channel_samples: (B, N) per-channel contiguous s16 samples, of any
        integer dtype (uploaded as int16; ValueError outside s16).
      offsets: (B, T) non-negative start sample of each unit; an offset
        + 27 must fit int32 (``adpcm_cuda.unit_offsets``: ValueError).
      limits: (B, T) per-unit limits (values > 28 behave as 28, values
        <= 0 mask the whole unit, which still changes the state).
    Returns:
      headers (B, T) uint8, sample values (B, T, 28) uint8, and the
      decoder state (prev1, prev2) after the last unit, host numpy.
    """
    pcm, lim = k5_input(channel_samples, limits)
    offsets = adpcm_cuda.unit_offsets(offsets)
    B = pcm.shape[0]
    T = offsets.shape[1]
    if T == 0:
        # As psxavenc_tpu: an empty stream reports a zero state.
        return (np.zeros((B, 0), np.uint8),
                np.zeros((B, 0, SAMPLES_PER_UNIT), np.uint8),
                np.zeros(B, np.int32), np.zeros(B, np.int32))
    return _run([(torch.device(device), pcm, offsets, lim, prev1, prev2,
                  np.full(B, T - 1))], filter_count, shift_range, B)


def whole_file(unit_encoder):
    """True for an injected unit encoder (the batch runner's capture or
    replay) that takes a file's units in one call; the default encoder
    and a ``chunked`` one get the containers' bounded chunk feeds."""
    return (unit_encoder not in (None, encode_unit_streams)
            and not getattr(unit_encoder, "chunked", False))


def encode_prepared_units(units, lim, filter_count, shift_range,
                          prev1=None, prev2=None, state_t=None,
                          device="cuda"):
    """Encode pre-gathered (B, T, 28) units of s16 samples (see
    encode_unit_streams; the batch runner concatenates many files' streams
    on B before calling): numpy arrays or tensors on any device, made
    K5's input where they are (:func:`k5_input`) and moved to the device
    as (B, T * 28) samples in K5's dense layout.

    ``device``: one, or a list of at most B devices: then B is padded
    with masked rows to a multiple of their count and cut into one equal
    shard a device, each shard's device memory the one-device call's.

    ``state_t``: optional (B,) per-row unit index whose post-state to
    return as the final decoder state (rows padded with masked units
    still change the state; adpcm.c:142-191 runs regardless). Default:
    the last column.
    """
    units, lim = k5_input(units, lim)
    B, T, n = units.shape
    p1, p2 = _state(prev1, B), _state(prev2, B)
    if T == 0:
        return (np.zeros((B, 0), np.uint8),
                np.zeros((B, 0, SAMPLES_PER_UNIT), np.uint8),
                p1.copy(), p2.copy())
    t_idx = np.full(B, T - 1) if state_t is None else state_t
    devices = mesh.device_list(device)
    devices = devices[:1] if B < len(devices) else devices
    b = -(-B // len(devices))
    pad = b * len(devices) - B
    if pad:
        units = torch.cat([units, units.new_zeros((pad, T, n))])
        lim = torch.cat([lim, lim.new_zeros((pad, T))])
    p1, p2, t_idx = (np.concatenate([a, np.zeros(pad, a.dtype)])
                     for a in (p1, p2, np.asarray(t_idx, np.int64)))
    cut = [slice(i * b, (i + 1) * b) for i in range(len(devices))]
    return _run([(dev, units[r].reshape(b, T * n), None, lim[r], p1[r],
                  p2[r], t_idx[r]) for dev, r in zip(devices, cut)],
                filter_count, shift_range, B)


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
