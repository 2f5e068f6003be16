""".str muxers: the str/strcd A/V sector interleave and strv's
2048-byte video-only sectors, with STR chunk headers and the reference's
rational frame pacing.

Counterpart of ``psxavenc_tpu/containers/strf.py`` (encode_file_str,
filefmt.c:391-520; encode_file_strspu, filefmt.c:522-631; and
encode_sector_str, mdec.c:757-836). A dry run of the muxing loop derives
the sector schedule, the audio sector lengths and the frame budgets from
the A/V totals alone; the writer then walks the schedule, with frames
encoded in look-ahead device batches and audio sectors in chunked device
calls (ADPCM state threads across chunks), both evicted once written.
The sector buffer is never cleared between sectors, as in the reference,
so bytes a sector does not write keep the previous sector's values.
"""

import math
import sys

import numpy as np

from .. import cli_args as ca
from ..io.ingest import source_for
from ..models.bs_video import BsFrameEncoder
from ..native import host
from ..utils import spans
from ..utils.progress import Progress
from . import xa as xamod

STR_MAGIC = 0x0160

# Frames per look-ahead device batch (the encoder's largest bucket).
VIDEO_BATCH_FRAMES = 128


def _video_banner(args, interleave, vspb, frame_size):
    if not (args.flags & ca.FLAG_QUIET):
        if interleave > 1:
            print(f"Interleave: {interleave - vspb}/{interleave} audio, "
                  f"{vspb}/{interleave} video", file=sys.stderr)
        print(f"Frame size: {frame_size:.2f} sectors", file=sys.stderr)


def _schedule(args, dec, asps, interleave, vspb0, base_overflow,
              overflow_den, frames_needed):
    """Dry run of the muxing loop (filefmt.c:450-516 + mdec.c:768-780):
    the sector descriptors, audio sector lengths and frame budgets."""
    ch = args.audio_channels
    avail_a = dec.audio_sample_count
    avail_v = dec.video_frame_count
    eoi = False
    vspb = vspb0
    overflow_num = 0
    frame_max = 0
    offset = 0
    frame_count = 0

    sectors = []
    audio_lengths = []
    frame_budgets = []

    sc = 0
    while (not eoi) or offset < frame_max:
        na = asps * ch
        if not eoi:
            if (na and avail_a <= na) or \
                    (frames_needed and avail_v <= frames_needed):
                eoi = True
        if asps == 0:
            is_video = True
        elif args.flags & ca.FLAG_STR_TRAILING_AUDIO:
            is_video = (sc % interleave) < vspb
        else:
            is_video = (sc % interleave) > 0
        if is_video:
            frames_used = 0
            while offset >= frame_max:
                frame_count += 1
                overflow_num += base_overflow
                frame_max = overflow_num // overflow_den * 2016
                overflow_num %= overflow_den
                offset = 0
                frame_budgets.append(frame_max)
                frames_used += 1
            if frames_used > avail_v:
                raise RuntimeError("video underrun: encoder needs a frame "
                                   "the input no longer provides")
            sectors.append({"video": True, "frame": frame_count,
                            "chunk_index": offset // 2016,
                            "chunk_count": frame_max // 2016,
                            "offset": offset, "eoi": eoi, "lba": sc})
            offset += 2016
            avail_v -= frames_used
        else:
            ln = min(avail_a // ch, asps)
            if ln == 0:
                vspb += 1
            else:
                audio_lengths.append(ln)
            sectors.append({"video": False, "length": ln,
                            "audio_index": len(audio_lengths) - 1,
                            "eoi": eoi, "lba": sc})
            avail_a -= ln * ch
        sc += 1
    return sectors, audio_lengths, frame_budgets


class _PrecomputedFrameFeed:
    """Frame feed over results another component already encoded (the
    batch runner groups many files' frames into shared device calls and
    hands each muxer its slice)."""

    def __init__(self, results):
        self.results = results
        self.scale_prefix = [0]
        for _, info in results:
            self.scale_prefix.append(self.scale_prefix[-1]
                                     + info["quant_scale"])

    def frame(self, f):
        return self.results[f - 1]

    def evict_below(self, f):
        pass  # the batch runner owns the results

    def quant_scale_sum(self, frames_started):
        return self.scale_prefix[frames_started]


class _FrameFeed:
    """Look-ahead batched frame encoder: encodes VIDEO_BATCH_FRAMES
    budgeted frames per device call and evicts written frames. Source
    frame k-1 feeds encoded frame k, clamping at EOF (the reference's
    window keeps returning the final frame, decoding.c:524-531)."""

    def __init__(self, enc, source, frame_budgets, total_src_frames):
        self.enc = enc
        self.source = source
        self.budgets = frame_budgets
        self.total_src = total_src_frames
        self.pulled = 0
        self.pending = []       # pulled source frames not yet consumed
        self.last_src = None
        self.next_frame = 1     # next 1-based frame number to encode
        self.inflight = None    # (ids, handle)
        self.cache = {}
        self.scale_prefix = [0]  # prefix sums of per-frame quant scales

    def _launch_next(self):
        if self.next_frame > len(self.budgets):
            return None
        hi = min(self.next_frame + VIDEO_BATCH_FRAMES - 1,
                 len(self.budgets))
        ids = range(self.next_frame, hi + 1)
        need = min(hi, self.total_src) - self.pulled
        if need > 0:
            self.pending.extend(self.source.take_frames(need))
            self.pulled += need
        sources = []
        for k in ids:
            if k <= self.total_src:
                self.last_src = self.pending.pop(0)
            sources.append(self.last_src)
        handle = self.enc.encode_frames_async(
            sources, [self.budgets[k - 1] for k in ids])
        self.next_frame = hi + 1
        return ids, handle

    def frame(self, f):
        while f not in self.cache:
            if self.inflight is None:
                self.inflight = self._launch_next()
            ids, handle = self.inflight
            self.inflight = self._launch_next()
            for k, r in zip(ids, self.enc.fetch(handle)):
                self.cache[k] = r
                self.scale_prefix.append(self.scale_prefix[-1]
                                         + r[1]["quant_scale"])
        return self.cache[f]

    def evict_below(self, f):
        for k in list(self.cache):
            if k < f:
                del self.cache[k]

    def quant_scale_sum(self, frames_started):
        """Running sum over the first ``frames_started`` frames (what
        filefmt.c:507-515 prints as quant_scale_sum / frame_index)."""
        return self.scale_prefix[frames_started]


def _write_video_sector(args, buffer, desc, fb, info, enc):
    """init_sector_buffer_video (filefmt.c:73-91) + encode_sector_str
    header/payload placement (mdec.c:782-835)."""
    fmt = args.format
    if fmt == ca.FORMAT_STRCD:
        host.sector_init(buffer, desc["lba"], host.SECTOR_MODE2_FORM1)
        sub = 16
        payload = 0x18
    elif fmt == ca.FORMAT_STR:
        sub = 0
        payload = 0x008
    else:  # strv: no subheader, payload at 0
        sub = None
        payload = 0x000
    if sub is not None:
        buffer[sub + 0] = args.audio_xa_file
        buffer[sub + 1] = args.audio_xa_channel & 0x1F
        buffer[sub + 2] = 0x48  # DATA | RT
        buffer[sub + 3] = 0
        buffer[sub + 4:sub + 8] = buffer[sub:sub + 4]

    header = np.zeros(32, dtype=np.uint8)
    header[0x00] = STR_MAGIC & 0xFF
    header[0x01] = STR_MAGIC >> 8
    header[0x02] = args.str_video_id & 0xFF
    header[0x03] = (args.str_video_id >> 8) & 0xFF
    header[0x04] = desc["chunk_index"] & 0xFF
    header[0x05] = (desc["chunk_index"] >> 8) & 0xFF
    header[0x06] = desc["chunk_count"] & 0xFF
    header[0x07] = (desc["chunk_count"] >> 8) & 0xFF
    fi = desc["frame"]
    header[0x08:0x0C] = np.frombuffer(
        (fi & 0xFFFFFFFF).to_bytes(4, "little"), np.uint8)
    header[0x0C:0x10] = np.frombuffer(
        (info["bytes_used"] & 0xFFFFFFFF).to_bytes(4, "little"), np.uint8)
    header[0x10] = enc.width & 0xFF
    header[0x11] = (enc.width >> 8) & 0xFF
    header[0x12] = enc.height & 0xFF
    header[0x13] = (enc.height >> 8) & 0xFF
    header[0x14:0x1C] = fb[:8]

    buffer[payload:payload + 32] = header
    buffer[payload + 32:payload + 32 + 2016] = \
        fb[desc["offset"]:desc["offset"] + 2016]

    if fmt in (ca.FORMAT_STR, ca.FORMAT_STRCD):
        # The reference always computes Form1 checksums here, even for the
        # 2336-byte layout where the buffer is not framed as a full
        # sector (filefmt.c:474).
        host.calc_checksums(buffer[:2352], host.SECTOR_MODE2_FORM1)


def _mux(args, dec, output, sectors, audio_lengths, frame_budgets,
         sector_size, buffer_size, device, frame_results=None):
    """Incremental schedule writer shared by str/strcd and strv; with
    ``frame_results`` (the batch runner's), the frames are not encoded
    here. ``device``: one device or a sequence; the frames split over
    all of them, the audio runs on the first."""
    enc = BsFrameEncoder(args.video_codec, dec.video_width,
                         dec.video_height, device)
    source = source_for(dec)
    if frame_results is not None:
        frames = _PrecomputedFrameFeed(frame_results)
    else:
        frames = _FrameFeed(enc, source, frame_budgets,
                            dec.video_frame_count)
    audio = xamod.AudioSectorFeed(args, source, audio_lengths, enc.device)
    buffer = np.zeros(buffer_size, dtype=np.uint8)
    progress = Progress(args)
    frame_count = 0
    # One span over the loop: its self time is the per-sector host work;
    # the frame batches and audio chunks it pulls open their own.
    with spans.span("str.sectors"):
        for desc in sectors:
            if desc["video"]:
                frame_count = desc["frame"]
                fb, info = frames.frame(frame_count)
                _write_video_sector(args, buffer, desc, fb, info, enc)
                if desc["chunk_index"] == desc["chunk_count"] - 1:
                    frames.evict_below(frame_count + 1)
            elif desc["length"] > 0:
                xs, i = audio.sector(desc["audio_index"])
                xs.write_sector(buffer, i, desc["lba"], desc["eoi"])
                audio.evict(desc["audio_index"])
            # length == 0: the reference writes the untouched buffer
            # (filefmt.c:482-494 with an empty encode), i.e. previous bytes.
            output.write(buffer[:sector_size].tobytes())
            progress.print_str(frame_count, desc["lba"],
                               frames.quant_scale_sum(frame_count),
                               args.str_fps_num, args.str_fps_den)
    if hasattr(dec, "close"):
        dec.close()


def str_schedule(args, dec, quiet=False):
    """Full str/strcd schedule from the A/V totals (the banner prints
    unless ``quiet``)."""
    if dec.has_audio:
        interleave = xamod.xa_sector_interleave(args) * args.str_cd_speed
        asps = xamod.xa_samples_per_sector(args)
        vspb = interleave - 1
    else:
        interleave = 1
        asps = 0
        vspb = 1

    base_overflow = (75 * args.str_cd_speed) * vspb * args.str_fps_den
    overflow_den = interleave * args.str_fps_num
    frame_size = base_overflow / overflow_den
    if not quiet:
        _video_banner(args, interleave, vspb, frame_size)
    frames_needed = max(2, math.ceil(vspb / frame_size))
    with spans.span("str.schedule"):
        return _schedule(args, dec, asps, interleave, vspb, base_overflow,
                         overflow_den, frames_needed)


def strspu_schedule(args, dec, quiet=False):
    """strv schedule (video-only pacing, filefmt.c:522-631)."""
    interleave, asps, vspb = 1, 0, 1
    base_overflow = (75 * args.str_cd_speed) * vspb * args.str_fps_den
    overflow_den = interleave * args.str_fps_num
    frame_size = base_overflow / overflow_den
    if not quiet:
        _video_banner(args, interleave, vspb, frame_size)
    frames_needed = max(2, math.ceil(vspb / frame_size))
    with spans.span("str.schedule"):
        return _schedule(args, dec, asps, interleave, vspb, base_overflow,
                         overflow_den, frames_needed)


def encode_file_str(args, dec, output, device, frame_results=None):
    """str/strcd (filefmt.c:391-520)."""
    sector_size = xamod.xa_sector_size(args)
    sectors, audio_lengths, frame_budgets = str_schedule(args, dec)
    _mux(args, dec, output, sectors, audio_lengths, frame_budgets,
         sector_size, 2352, device, frame_results)


def encode_file_strspu(args, dec, output, device, frame_results=None):
    """strv: 2048-byte sectors, video only (filefmt.c:522-631; the
    reference's audio branch is unimplemented)."""
    if dec.has_audio:
        raise NotImplementedError(
            "strspu audio is unimplemented in the reference "
            "(filefmt.c:528)")
    sectors, _, frame_budgets = strspu_schedule(args, dec)
    _mux(args, dec, output, sectors, [], frame_budgets, 2048, 2048, device,
         frame_results)
