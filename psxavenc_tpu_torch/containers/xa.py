"""XA-ADPCM sector encoding and the .xa/.xacd muxer.

Counterpart of ``psxavenc_tpu/containers/xa.py``, byte-compatible with
psx_audio_xa_encode (libpsxav/adpcm.c:193-354) and encode_file_xa
(psxavenc/filefmt.c:167-210), including the quirks that are visible in
output bytes:

- the EOF submode bit is set *after* the sector EDC is computed
  (filefmt.c:193-194 runs after adpcm.c:324-328), so EOF sectors carry a
  stale EDC exactly like the reference;
- the muxers reuse one sector buffer across iterations without clearing it,
  so bytes the writers never touch keep their previous-iteration values;
  a persistent zero-initialized buffer reproduces this.

The ADPCM units of a chunk of sectors encode in one K5 call on the device;
sector byte assembly and EDC are host C++ (``native/host.py``). The batch
runner injects its own ``unit_encoder`` (``batch.py``).
"""

import numpy as np

from .. import cli_args as ca
from ..models import adpcm_stream as streams
from ..native import host
from ..ops import adpcm as ops
from ..utils import spans
from ..utils.progress import Progress

SUBMODE_AUDIO_RT_FORM2 = 0x64  # AUDIO | FORM2 | RT (adpcm.c:272-275)
SUBMODE_EOF = 0x80


def xa_sector_size(args):
    return 2352 if args.format in (ca.FORMAT_XACD, ca.FORMAT_STRCD) else 2336


def xa_samples_per_sector(args):
    """Per *channel pair* sample count per sector (adpcm.c:250-252)."""
    base = 112 if args.audio_bit_depth == 8 else 224
    return (base >> (1 if args.audio_channels == 2 else 0)) * 18


def xa_sector_interleave(args):
    """adpcm.c:254-260."""
    interleave = 2 if args.audio_channels == 2 else 4
    if args.audio_frequency == 18900:
        interleave <<= 1
    if args.audio_bit_depth == 4:
        interleave <<= 1
    return interleave


def xa_coding_byte(args):
    coding = 1 if args.audio_channels == 2 else 0
    coding |= 4 if args.audio_frequency == 18900 else 0  # FREQ_SINGLE
    coding |= 16 if args.audio_bit_depth == 8 else 0
    return coding


class XaAudioSectors:
    """Encodes a run of XA sectors' PCM on ``device`` into sector payloads.

    ``lengths`` is the per-sector per-channel sample count sequence the muxer
    consumed (min(available, samples_per_sector) each step); ADPCM state
    threads continuously across sectors exactly as the reference's persistent
    psx_audio_encoder_state_t does.
    """

    def __init__(self, args, pcm_interleaved, lengths, device, prev1=None,
                 prev2=None, unit_encoder=None):
        if unit_encoder is None:
            unit_encoder = streams.encode_unit_streams
        self.args = args
        ch = args.audio_channels
        stereo = ch == 2
        bits8 = args.audio_bit_depth == 8
        upb_pc = (2 if stereo else 4) if bits8 else (4 if stereo else 8)
        self.upb_total = upb_pc * (2 if stereo else 1)
        self.bits8 = bits8
        S = len(lengths)
        self.count = S
        self.final_state = (np.zeros(ch, np.int32), np.zeros(ch, np.int32))
        if prev1 is not None:
            self.final_state = (np.asarray(prev1, np.int32).copy(),
                                np.asarray(prev2, np.int32).copy())
        if S == 0:
            self.payloads = np.zeros((0, 2304), np.uint8)
            return

        with spans.span("xa.encode"):
            units_per_sector = 18 * upb_pc
            pcm = np.asarray(pcm_interleaved, dtype=np.int32)
            chans = np.stack([pcm[c::ch] for c in range(ch)]) if ch > 1 \
                else pcm[None, :]

            prefix = np.concatenate([[0], np.cumsum(lengths)[:-1]])
            k = 28 * np.arange(units_per_sector, dtype=np.int64)
            offsets = (prefix[:, None] + k[None, :]).reshape(-1)
            limits = (np.asarray(lengths)[:, None]
                      - k[None, :]).reshape(-1)
            B = chans.shape[0]
            headers, nibbles, f1, f2 = unit_encoder(
                chans, np.broadcast_to(offsets, (B, len(offsets))),
                np.broadcast_to(limits, (B, len(limits))),
                ops.XA_FILTER_COUNT,
                ops.SHIFT_RANGE_8BPS if bits8 else ops.SHIFT_RANGE_4BPS,
                prev1=prev1, prev2=prev2, device=device)
            self.final_state = (f1, f2)

        with spans.span("xa.assemble"):
            # Arrange into block-unit encode order (adpcm.c:202-231): stereo
            # interleaves L/R per unit pair, mono is sequential.
            headers = headers.reshape(B, S, 18, upb_pc)
            nibbles = nibbles.reshape(B, S, 18, upb_pc, 28)
            if stereo:
                # (S, 18, upb, 2)
                h = np.stack([headers[0], headers[1]], axis=-1)
                n = np.stack([nibbles[0], nibbles[1]], axis=-2)
                h = h.reshape(S, 18, self.upb_total)
                n = n.reshape(S, 18, self.upb_total, 28)
            else:
                h, n = headers[0], nibbles[0]

            self.payloads = np.stack([
                host.xa_assemble(h[s], n[s], self.upb_total, bits8)
                for s in range(S)])

    def write_sector(self, buffer, index, lba, eof):
        """Fill the persistent sector buffer with audio sector ``index``.

        Touches exactly the bytes psx_audio_xa_encode touches; computes the
        EDC before applying the EOF flag (bug-compatible ordering).
        """
        args = self.args
        is_cd = xa_sector_size(args) == 2352
        if is_cd:
            host.sector_init(buffer, lba, host.SECTOR_MODE2_FORM2)
            sub = 16
        else:
            sub = 0
        buffer[sub + 0] = args.audio_xa_file
        buffer[sub + 1] = args.audio_xa_channel & 0x1F
        buffer[sub + 2] = SUBMODE_AUDIO_RT_FORM2
        # coding |= onto the existing byte (adpcm.c:277-288); the persistent
        # buffer makes this idempotent, as in the reference.
        buffer[sub + 3] |= xa_coding_byte(args)
        buffer[sub + 4:sub + 8] = buffer[sub:sub + 4]
        data_off = sub + 8
        buffer[data_off:data_off + 2304] = self.payloads[index]
        if is_cd:
            host.calc_checksums(buffer[:2352], host.SECTOR_MODE2_FORM2)
        else:
            e = host.edc(buffer[0:0x91C].tobytes())
            buffer[0x91C:0x920] = np.frombuffer(
                int(e).to_bytes(4, "little"), np.uint8)
        if eof:
            buffer[sub + 2] |= SUBMODE_EOF
            buffer[sub + 6] |= SUBMODE_EOF


# Audio sectors per device call in the chunked feed. The .str muxer keeps
# the small chunk (its A/V look-ahead stays short); standalone audio
# encodes use the large one (~2 MB of PCM per call).
AUDIO_CHUNK_SECTORS = 64
AUDIO_CHUNK_SECTORS_SOLO = 1024


class AudioSectorFeed:
    """Chunked XA audio-sector encoder: chunk_sectors sectors per device
    call with exact ADPCM state threading across chunks (the reference's
    persistent psx_audio_encoder_state_t), pulling PCM incrementally from
    a take_audio source. ``unit_encoder`` takes the place of
    ``streams.encode_unit_streams`` (the batch runner's injection point)."""

    def __init__(self, args, source, audio_lengths, device,
                 chunk_sectors=None, unit_encoder=None):
        self.args = args
        self.source = source
        self.lengths = audio_lengths
        self.device = device
        self.chunk = chunk_sectors or AUDIO_CHUNK_SECTORS
        self.unit_encoder = unit_encoder
        ch = args.audio_channels
        self.ch = ch
        self.prev1 = np.zeros(ch, np.int32)
        self.prev2 = np.zeros(ch, np.int32)
        self.next_idx = 0
        self.cache = {}

    def sector(self, idx):
        """-> (XaAudioSectors, local index) owning sector ``idx``."""
        while idx >= self.next_idx:
            hi = min(self.next_idx + self.chunk, len(self.lengths))
            lens = self.lengths[self.next_idx:hi]
            pcm = self.source.take_audio(int(sum(lens)) * self.ch)
            xs = XaAudioSectors(self.args, pcm, lens, self.device,
                                self.prev1, self.prev2,
                                unit_encoder=self.unit_encoder)
            self.prev1, self.prev2 = xs.final_state
            for i in range(len(lens)):
                self.cache[self.next_idx + i] = (xs, i)
            self.next_idx = hi
        return self.cache[idx]

    def evict(self, idx):
        self.cache.pop(idx, None)


def encode_file_xa(args, dec, output, device, unit_encoder=None):
    """filefmt.c:167-210. An injected non-chunked ``unit_encoder`` gets the
    whole file in one call (the batch runner's capture and replay count
    on exactly one unit encode per file); a ``chunked`` one keeps the
    bounded feed, so concurrent jobs' chunks can share device calls.

    Span ``xa.sectors`` around the sector loop: its self time is the
    per-sector host work (subheaders, EDC, writes), less the chunks it
    pulls (their ``xa.encode`` and ``xa.assemble``)."""
    from ..io import ingest

    ch = args.audio_channels
    sps = xa_samples_per_sector(args)
    sector_size = xa_sector_size(args)

    source = ingest.source_for(dec)
    lengths, eois = [], []
    while dec.ensure_av_data(sps * ch, 0):
        ln = min(dec.audio_sample_count // ch, sps)
        lengths.append(ln)
        eois.append(dec.end_of_input)
        dec.retire_av_data(ln * ch, 0)

    chunk = len(lengths) if streams.whole_file(unit_encoder) \
        else AUDIO_CHUNK_SECTORS_SOLO
    feed = AudioSectorFeed(args, source, lengths, device, chunk_sectors=chunk,
                           unit_encoder=unit_encoder)
    buffer = np.zeros(2352, dtype=np.uint8)
    progress = Progress(args)
    with spans.span("xa.sectors"):
        for s in range(len(lengths)):
            xs, i = feed.sector(s)
            xs.write_sector(buffer, i, s, eois[s])
            feed.evict(s)
            output.write(buffer[:sector_size].tobytes())
            # The reference prints the pre-increment loop counter
            # (filefmt.c:177,199-208).
            progress.print_xa(s, sps, args.audio_frequency)
    if hasattr(dec, "close"):
        dec.close()
