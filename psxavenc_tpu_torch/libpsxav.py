"""libpsxav-equivalent Python API on the torch backend.

Counterpart of ``psxavenc_tpu/libpsxav.py``: function for function the
reference's public library surface (libpsxav/libpsxav.h:73-101,174-176),
for code that linked against libpsxav. The ADPCM units encode through K5
(``models/adpcm_stream.py``) on ``device``, by default the card (a CPU
device runs the native C++ unit encoder, or K5's plain version with
PSXAVENC_NO_NATIVE_ADPCM set); the sector framing and checksums are the
host sector code (``native/host.py``) the containers use.

Covered API (reference -> here):
  psx_audio_xa_encode            -> xa_encode
  psx_audio_xa_encode_finalize   -> xa_encode_finalize
  psx_audio_xa_encode_simple     -> xa_encode_simple
  psx_audio_spu_encode           -> spu_encode
  psx_audio_spu_encode_simple    -> spu_encode_simple
  psx_audio_xa_get_buffer_size   -> xa_get_buffer_size
  psx_audio_spu_get_buffer_size  -> spu_get_buffer_size
  psx_audio_xa_get_buffer_size_per_sector -> xa_get_buffer_size_per_sector
  psx_audio_xa_get_samples_per_sector     -> xa_get_samples_per_sector
  psx_audio_xa_get_sector_interleave      -> xa_get_sector_interleave
  psx_cdrom_init_xa_subheader    -> cdrom_init_xa_subheader
  psx_cdrom_init_sector          -> cdrom_init_sector
  psx_cdrom_calculate_checksums  -> cdrom_calculate_checksums
"""

from dataclasses import dataclass, field

import numpy as np

from . import cli_args as ca
from .models import adpcm_stream as streams
from .native import host
from .ops import adpcm as adpcm_ops

XA_FORMAT_XA = 0      # 2336-byte sectors
XA_FORMAT_XACD = 1    # 2352-byte sectors

SPU_LOOP_END = 1
SPU_LOOP_REPEAT = 3
SPU_LOOP_START = 6
SPU_LOOP_TRAP = 5

SECTOR_TYPE_MODE1 = host.SECTOR_MODE1
SECTOR_TYPE_MODE2_FORM1 = host.SECTOR_MODE2_FORM1
SECTOR_TYPE_MODE2_FORM2 = host.SECTOR_MODE2_FORM2

SPU_BLOCK_SIZE = 16
SPU_SAMPLES_PER_BLOCK = 28
CDROM_SECTOR_SIZE = 2352


@dataclass
class XaSettings:
    """psx_audio_xa_settings_t (libpsxav.h:44-51)."""
    format: int = XA_FORMAT_XA
    stereo: bool = True
    frequency: int = 37800
    bits_per_sample: int = 4
    file_number: int = 0
    channel_number: int = 0


@dataclass
class ChannelState:
    """psx_audio_encoder_channel_state_t (libpsxav.h:53-57)."""
    prev1: int = 0
    prev2: int = 0
    mse: int = 0
    qerr: int = 0


@dataclass
class EncoderState:
    """psx_audio_encoder_state_t (libpsxav.h:59-62)."""
    left: ChannelState = field(default_factory=ChannelState)
    right: ChannelState = field(default_factory=ChannelState)


# ------------------------------------------------------------------ sizing

def xa_get_samples_per_sector(settings):
    base = 112 if settings.bits_per_sample == 8 else 224
    return (base >> (1 if settings.stereo else 0)) * 18


def xa_get_buffer_size_per_sector(settings):
    return 2336 if settings.format == XA_FORMAT_XA else 2352


def xa_get_buffer_size(settings, sample_count):
    sps = xa_get_samples_per_sector(settings)
    sectors = (sample_count + sps - 1) // sps
    return sectors * xa_get_buffer_size_per_sector(settings)


def spu_get_buffer_size(sample_count):
    return ((sample_count + SPU_SAMPLES_PER_BLOCK - 1)
            // SPU_SAMPLES_PER_BLOCK) << 4


def xa_get_sector_interleave(settings):
    interleave = 2 if settings.stereo else 4
    if settings.frequency == 18900:
        interleave <<= 1
    if settings.bits_per_sample == 4:
        interleave <<= 1
    return interleave


# ------------------------------------------------------------------- CD-ROM

def cdrom_init_sector(sector, lba, sector_type):
    """psx_cdrom_init_sector on a (>=2352,) uint8 array, in place."""
    host.sector_init(sector, lba, sector_type)


def cdrom_init_xa_subheader(sector_type):
    """Returns the 8 subheader bytes (both copies)."""
    sub = np.zeros(8, np.uint8)
    submode = 0x08
    if sector_type == SECTOR_TYPE_MODE2_FORM2:
        submode |= 0x20
    sub[2] = sub[6] = submode
    return sub


def cdrom_calculate_checksums(sector, sector_type):
    """psx_cdrom_calculate_checksums in place (ECC left zeroed, as in the
    reference)."""
    host.calc_checksums(sector, sector_type)


# -------------------------------------------------------------------- SPU

def spu_encode(state, samples, sample_count=None, pitch=1, device="cuda"):
    """psx_audio_spu_encode (adpcm.c:356-376): full blocks of 28 samples,
    consuming ``sample_count`` samples with stride ``pitch``. Threads
    ``state`` like the reference. Returns the encoded bytes."""
    samples = np.asarray(samples, np.int32)
    if sample_count is None:
        sample_count = len(samples) // max(pitch, 1)
    if sample_count <= 0:
        return b""
    chan = samples[::pitch] if pitch != 1 else samples
    offsets, limits = streams.chunk_unit_layout([sample_count])
    headers, nibbles, p1, p2 = streams.encode_unit_streams(
        chan[None], offsets[None], limits[None],
        adpcm_ops.SPU_FILTER_COUNT, adpcm_ops.SHIFT_RANGE_4BPS,
        prev1=np.array([state.prev1], np.int32),
        prev2=np.array([state.prev2], np.int32), device=device)
    blocks = streams.pack_spu_blocks(headers[0], nibbles[0])
    state.prev1, state.prev2 = int(p1[0]), int(p2[0])
    return blocks.reshape(-1).tobytes()


def spu_encode_simple(samples, loop_start=-1, device="cuda"):
    """psx_audio_spu_encode_simple (adpcm.c:378-401)."""
    state = ChannelState()
    data = bytearray(spu_encode(state, samples, device=device))
    if len(data) >= SPU_BLOCK_SIZE:
        if loop_start < 0:
            trap = bytearray(SPU_BLOCK_SIZE)
            trap[1] = SPU_LOOP_TRAP
            data += trap
        else:
            off = (loop_start // SPU_SAMPLES_PER_BLOCK) * SPU_BLOCK_SIZE
            data[-SPU_BLOCK_SIZE + 1] |= SPU_LOOP_REPEAT
            data[off + 1] |= SPU_LOOP_START
    return bytes(data)


# --------------------------------------------------------------------- XA

class _ArgsShim:
    """XaSettings presented as the CLI args the sector encoder reads."""

    def __init__(self, settings):
        self.audio_channels = 2 if settings.stereo else 1
        self.audio_bit_depth = settings.bits_per_sample
        self.audio_frequency = settings.frequency
        self.audio_xa_file = settings.file_number
        self.audio_xa_channel = settings.channel_number
        self.format = (ca.FORMAT_XACD if settings.format == XA_FORMAT_XACD
                       else ca.FORMAT_XA)


def xa_encode(settings, state, samples, sample_count, lba, device="cuda"):
    """psx_audio_xa_encode (adpcm.c:293-332): encode ``sample_count``
    samples (per channel) into whole sectors. Returns the sector bytes;
    mutates ``state``."""
    args = _ArgsShim(settings)
    sps = xa_get_samples_per_sector(settings)
    ssize = xa_get_buffer_size_per_sector(settings)
    pcm = np.asarray(samples, np.int16).reshape(-1)

    lengths = []
    remaining = sample_count
    while remaining > 0:
        lengths.append(min(remaining, sps))
        remaining -= lengths[-1]
    if not lengths:
        return b""
    enc = _init_xa_sectors(args, pcm, lengths, state, device)
    out = bytearray()
    buffer = np.zeros(2352, np.uint8)
    for s in range(enc.count):
        enc.write_sector(buffer, s, lba + s, False)
        out += buffer[:ssize].tobytes()
    return bytes(out)


def _init_xa_sectors(args, pcm, lengths, state, device):
    """XaAudioSectors started from the caller's channel state, which gets
    the final state back."""
    from .containers import xa as xamod

    ch = args.audio_channels
    prev1 = [state.left.prev1, state.right.prev1][:ch]
    prev2 = [state.left.prev2, state.right.prev2][:ch]
    enc = xamod.XaAudioSectors(args, pcm, lengths, device, prev1=prev1,
                               prev2=prev2)
    f1, f2 = enc.final_state
    state.left.prev1, state.left.prev2 = int(f1[0]), int(f2[0])
    if ch == 2:
        state.right.prev1, state.right.prev2 = int(f1[1]), int(f2[1])
    return enc


def xa_encode_finalize(settings, output):
    """psx_audio_xa_encode_finalize (adpcm.c:334-340): set the EOF submode
    bit on the last sector. Takes/returns bytes."""
    data = bytearray(output)
    if len(data) >= 2336:
        last = len(data) - CDROM_SECTOR_SIZE
        # Subheader position within the trailing 2352-byte window.
        sub = last + 16
        data[sub + 2] |= 0x80
        data[sub + 6] |= 0x80
    return bytes(data)


def xa_encode_simple(settings, samples, sample_count, lba=0, device="cuda"):
    """psx_audio_xa_encode_simple (adpcm.c:342-354)."""
    state = EncoderState()
    out = xa_encode(settings, state, samples, sample_count, lba, device)
    return xa_encode_finalize(settings, out)
