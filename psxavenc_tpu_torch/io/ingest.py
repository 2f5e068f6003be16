"""Media ingest: decoding front end feeding the device encoders.

Replaces the reference's FFmpeg-based streaming decoder
(psxavenc/decoding.c). Rather than a sliding window fed packet-by-packet,
the full input is decoded up front into host tensors (audio: interleaved s16;
video: NV21 frames on the target CFR grid) and a small state machine
reproduces the observable ``ensure_av_data``/``retire_av_data`` semantics —
including the "wait for more than strictly needed" quirk (decoding.c:514-520)
that controls exactly when ``end_of_input`` flips, which is visible in output
bytes (EOF sector flags, SPU loop flags).

Supported inputs without FFmpeg: WAV (PCM/float, smpl loop chunks), AVI with
raw I420/NV12/NV21 video, raw PCM/YUV via explicit format hints. If an
``ffmpeg`` binary is on PATH it is used as a fallback demuxer/decoder for
everything else.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np

from ..utils import spans
from . import wav as wavmod

DECODER_USE_AUDIO = 1 << 0
DECODER_USE_VIDEO = 1 << 1
DECODER_AUDIO_REQUIRED = 1 << 2
DECODER_VIDEO_REQUIRED = 1 << 3

AV_TIME_BASE = 1000000  # libavutil microsecond time base


class OpenError(Exception):
    """Input rejected; the detail message has already been printed to
    stderr (the reference prints inside open_av_data, decoding.c:168-200,
    and main adds the generic line, main.c:66-68)."""


class Decoder:
    """Pre-decoded A/V buffers with reference-compatible windowing."""

    def __init__(self):
        self.audio = np.zeros(0, dtype=np.int16)  # interleaved
        self.video = np.zeros((0, 0), dtype=np.uint8)  # (T, frame_bytes)
        self.audio_pos = 0
        self.video_pos = 0
        self.end_of_input = False
        self.video_width = 0
        self.video_height = 0
        self.video_fps_num = 0
        self.video_fps_den = 0
        self.channels = 1
        self.sample_rate = 0
        self.loop_point_ms = -1  # milliseconds, -1 if none (smpl chunk)
        self.loop_meta_ms = None     # "loop_start" metadata tag
        self.loop_chapter_ms = None  # first chapter start
        self.n_chapters = 0
        self.has_audio = False
        self.has_video = False

    # -- reference ensure/retire semantics ---------------------------------
    @property
    def audio_sample_count(self):
        return len(self.audio) - self.audio_pos

    @property
    def video_frame_count(self):
        return len(self.video) - self.video_pos

    def audio_window(self):
        return self.audio[self.audio_pos:]

    def video_window(self):
        return self.video[self.video_pos:]

    def ensure_av_data(self, needed_audio, needed_video):
        # decoding.c:510-534: polling stops when counts *exceed* the need;
        # hitting EOF first flips end_of_input. With the whole file decoded,
        # EOF is observed exactly when the remaining buffer can no longer
        # exceed the need.
        a, v = self.audio_sample_count, self.video_frame_count
        if not self.end_of_input:
            if (needed_audio and a <= needed_audio) or \
               (needed_video and v <= needed_video):
                self.end_of_input = True
        return (bool(a) or not needed_audio) and \
               (bool(v) or not needed_video)

    def retire_av_data(self, audio_samples, video_frames):
        assert audio_samples <= self.audio_sample_count
        assert video_frames <= self.video_frame_count
        self.audio_pos += audio_samples
        self.video_pos += video_frames

    def reset(self):
        """Rewind the ensure/retire window (the batch runner's plan pass
        consumes it, then the mux pass replays it)."""
        self.audio_pos = 0
        self.video_pos = 0
        self.end_of_input = False

    def drain_audio_blocks(self, block_samples):
        """Closed form of the per-block ensure/retire drain (the whole
        file is already decoded, so the window walk is arithmetic):
        equivalent to repeating ``ensure_av_data(block, 0)`` /
        ``retire_av_data(min(count, block), 0)`` until ensure fails.
        Returns (lengths, end_of_input flags) per block and leaves the
        window state exactly as the loop would (all audio retired,
        end_of_input set). The flag flips when the remaining count
        first fails to EXCEED the need (decoding.c:510-534), i.e. on
        the block with <= block_samples remaining."""
        a0 = self.audio_sample_count
        was_eoi = self.end_of_input
        if a0 <= 0:
            if block_samples > 0:
                self.end_of_input = True
            return (np.zeros(0, np.int64), np.zeros(0, bool))
        nb = -(-a0 // block_samples)
        lens = np.full(nb, block_samples, np.int64)
        lens[-1] = a0 - (nb - 1) * block_samples
        remaining_before = a0 - block_samples * np.arange(nb,
                                                          dtype=np.int64)
        eois = was_eoi | (remaining_before <= block_samples)
        self.audio_pos += a0
        self.end_of_input = True
        return lens, eois


class StreamingDecoder:
    """O(1)-memory ingest for long video encodes (str/strcd/strv/sbs).

    Mirrors the reference's sliding-window decoder (decoding.c:510-559
    never holds more than ~1 sector of audio + ``frames_needed`` frames)
    where the default tier decodes everything up front. Two passes over
    the input through the native extension:

    1. a count-only decode (identical loop, stores nothing) giving the
       exact post-resample/retime totals the muxers schedule from;
    2. a packet-at-a-time streaming decode consumed incrementally via
       :meth:`take_audio` / :meth:`take_frames` while sectors are written.

    The second pass runs quiet (validation messages printed once by the
    first). Only the video muxers consume this; the audio formats keep
    the whole-file tier (their inputs are small).
    """

    def __init__(self, args, flags, path):
        from ..native import ingest_ext

        self._kwargs = dict(
            flags=flags, audio_frequency=args.audio_frequency,
            audio_channels=args.audio_channels,
            video_width=args.video_width, video_height=args.video_height,
            ignore_aspect=self._ignore_aspect(args),
            fps_num=args.str_fps_num, fps_den=args.str_fps_den,
            quiet=_quiet(args), swr_options=args.swresample_options,
            sws_options=args.swscale_options)
        self._path = path
        try:
            r = ingest_ext.ingest(path, count_only=True, **self._kwargs)
        except OSError:
            raise OpenError()
        self._audio_total = r["audio_count"]
        self._video_total = r["video_frame_count"]
        self.video_width = r["video_width"]
        self.video_height = r["video_height"]
        self.has_audio = r["has_audio"]
        self.has_video = r["has_video"]
        self.video_fps_num = args.str_fps_num
        self.video_fps_den = args.str_fps_den
        self.channels = args.audio_channels
        self.sample_rate = args.audio_frequency
        self.loop_point_ms = -1
        self.loop_meta_ms = r["loop_meta_ms"]
        self.n_chapters = r["n_chapters"]
        self.loop_chapter_ms = r["chapter0_ms"] if r["n_chapters"] else None
        if r["is_wav"] and r["has_audio"]:
            try:
                w = wavmod.read_wav(path)
                if w.loop_start_offset >= 0:
                    pts = w.loop_start_offset / w.sample_rate
                    self.loop_point_ms = int(round(pts * 1000.0))
            except Exception:  # noqa: BLE001 — smpl probe only
                pass
        self._stream = None
        self.end_of_input = False
        self._virt_audio_pos = 0
        self._virt_video_pos = 0
        # instrumentation: high-water marks (bounded-memory assertions)
        self.peak_buffered_frames = 0
        self.peak_buffered_audio = 0

    @staticmethod
    def _ignore_aspect(args):
        from ..cli_args import FLAG_BS_IGNORE_ASPECT

        return bool(args.flags & FLAG_BS_IGNORE_ASPECT)

    # The muxers schedule from totals (the whole-file Decoder's counts are
    # also totals at schedule time — nothing has been retired yet); the
    # audio containers' windowing loops additionally drive the virtual
    # ensure/retire below (counts only, no data — the same observable
    # decoding.c:510-559 semantics as the whole-file Decoder) and then
    # pull samples in chunks via take_audio.
    @property
    def audio_sample_count(self):
        return self._audio_total - self._virt_audio_pos

    @property
    def video_frame_count(self):
        return self._video_total - self._virt_video_pos

    def ensure_av_data(self, needed_audio, needed_video):
        a = self.audio_sample_count
        v = self.video_frame_count
        if not self.end_of_input:
            if (needed_audio and a <= needed_audio) or \
               (needed_video and v <= needed_video):
                self.end_of_input = True
        return (bool(a) or not needed_audio) and \
               (bool(v) or not needed_video)

    def retire_av_data(self, audio_samples, video_frames):
        assert audio_samples <= self.audio_sample_count
        assert video_frames <= self.video_frame_count
        self._virt_audio_pos += audio_samples
        self._virt_video_pos += video_frames

    def reset(self):
        self._virt_audio_pos = 0
        self._virt_video_pos = 0
        self.end_of_input = False

    def _ensure_stream(self):
        if self._stream is None:
            from ..native import ingest_ext

            kw = dict(self._kwargs)
            kw["quiet"] = True  # messages already printed by pass 1
            self._stream = ingest_ext.IngestStream(self._path, **kw)
        return self._stream

    def _note_peaks(self):
        a, v = self._stream.buffered()
        self.peak_buffered_audio = max(self.peak_buffered_audio, a)
        self.peak_buffered_frames = max(self.peak_buffered_frames, v)

    def take_audio(self, n_values):
        """Exactly ``n_values`` interleaved s16 samples (zero-padded past
        EOF; the schedules never over-request)."""
        st = self._ensure_stream()
        st.fill(min_audio_values=n_values)
        self._note_peaks()
        got = st.take_audio(n_values)
        if len(got) < n_values:
            got = np.concatenate(
                [got, np.zeros(n_values - len(got), np.int16)])
        return got

    def take_frames(self, k):
        """Exactly ``k`` decoded NV21 frames as (k, frame_bytes) uint8."""
        st = self._ensure_stream()
        st.fill(min_video_frames=k)
        self._note_peaks()
        out = st.take_video(k)
        assert len(out) == k, "schedule over-requested source frames"
        return out

    def close(self):
        if self._stream is not None:
            self._stream.close()
            self._stream = None


class WholeFileSource:
    """Adapts a fully-decoded Decoder to the incremental take_audio /
    take_frames source API the chunked muxers consume (StreamingDecoder
    implements the same interface over the native packet stream)."""

    def __init__(self, dec):
        self._audio = dec.audio_window() if dec.has_audio \
            else np.zeros(0, np.int16)
        self._frames = dec.video_window() if dec.has_video \
            else np.zeros((0, 0), np.uint8)
        self._apos = 0
        self._fpos = 0

    def take_audio(self, n_values):
        out = self._audio[self._apos:self._apos + n_values]
        self._apos += n_values
        if len(out) < n_values:  # zero-pad past EOF, like the stream
            out = np.concatenate(
                [out, np.zeros(n_values - len(out), np.int16)])
        return out

    def take_frames(self, k):
        out = self._frames[self._fpos:self._fpos + k]
        self._fpos += k
        assert len(out) == k
        return out


def source_for(dec):
    """The incremental data source for a decoder (itself if streaming)."""
    return dec if hasattr(dec, "take_frames") else WholeFileSource(dec)


def drain_audio_blocks(dec, block_samples):
    """Per-block windowing drain shared by the SPU muxer: (lengths,
    end_of_input) arrays for fixed-size audio pulls. Whole-file decoders
    answer in closed form (Decoder.drain_audio_blocks); streaming tiers
    run the real ensure/retire loop (each ensure may decode more
    input)."""
    fast = getattr(dec, "drain_audio_blocks", None)
    if fast is not None:
        return fast(block_samples)
    lens, eois = [], []
    while dec.ensure_av_data(block_samples, 0):
        ln = min(dec.audio_sample_count, block_samples)
        lens.append(ln)
        eois.append(dec.end_of_input)
        dec.retire_av_data(ln, 0)
    return (np.asarray(lens, np.int64), np.asarray(eois, bool))


def _q15_mix(samples, matrix):
    """swresample's s16 rematrix: Q15 integer coefficients with
    round-half-up accumulation (out = (sum(in*q15) + 16384) >> 15).
    Integer matrices are used as-is (exact probed coefficients); float
    matrices are rounded to Q15."""
    m = np.asarray(matrix)
    if m.dtype.kind == "f":
        q15 = np.round(m * 32768.0).astype(np.int64)
    else:
        q15 = m.astype(np.int64)
    acc = samples.astype(np.int64) @ q15.T
    out = (acc + (1 << 14)) >> 15
    return np.clip(out, -32768, 32767).astype(np.int16)


# FFmpeg default channel layouts by count (what a plain WAV without an
# explicit channel mask is assigned).
_DEFAULT_LAYOUTS = {
    1: ["FC"],
    2: ["FL", "FR"],
    3: ["FL", "FR", "LFE"],
    4: ["FL", "FR", "FC", "BC"],
    5: ["FL", "FR", "FC", "BL", "BR"],
    6: ["FL", "FR", "FC", "LFE", "BL", "BR"],
    7: ["FL", "FR", "FC", "LFE", "BC", "SL", "SR"],
    8: ["FL", "FR", "FC", "LFE", "BL", "BR", "SL", "SR"],
}

_SQRT1_2 = 2.0 ** -0.5


def _swr_matrix(src_names, target_channels):
    """swresample's default mixing matrix to mono/stereo, including the
    renormalization by the largest per-output coefficient sum when it
    exceeds 1.0 (verified bit-exactly against swr via the golden tests)."""
    clev = slev = _SQRT1_2
    rows = 2 if target_channels == 2 else 1
    m = np.zeros((rows, len(src_names)))
    for c, name in enumerate(src_names):
        if target_channels == 2:
            coef = {"FL": (1, 0), "FR": (0, 1), "FC": (clev, clev),
                    "BL": (slev, 0), "BR": (0, slev),
                    "SL": (slev, 0), "SR": (0, slev),
                    "BC": (slev * _SQRT1_2, slev * _SQRT1_2),
                    "LFE": (0, 0)}[name]
            m[0, c], m[1, c] = coef
        else:
            m[0, c] = {"FL": _SQRT1_2, "FR": _SQRT1_2, "FC": 1.0,
                       "BL": slev * _SQRT1_2, "BR": slev * _SQRT1_2,
                       "SL": slev * _SQRT1_2, "SR": slev * _SQRT1_2,
                       "BC": slev * _SQRT1_2, "LFE": 0.0}[name]
    maxsum = np.abs(m).sum(axis=1).max()
    if maxsum > 1.0:
        m /= maxsum
    return m


def _remix_channels(samples, target_channels):
    """swresample-compatible channel remix (decoding.c:216-247).

    Bit-exact for passthrough and for default-layout sources mixed down/up
    to mono or stereo (the configurations the reference CLI can request):
    the Q15 matrices are probed from the real library and shipped next to
    the tap banks (swr_exact.mix_matrix), because swr's float pipeline
    lands +-1 Q15 step off a double-precision recomputation on some
    layouts. >2-channel targets with mismatched sources are best-effort
    (the reference leaves their order unspecified, decoding.c:226).
    """
    src = samples.shape[1]
    if src == target_channels:
        return samples
    if target_channels in (1, 2):
        from . import swr_exact

        m = swr_exact.mix_matrix(src, target_channels)
        if m is None and _DEFAULT_LAYOUTS.get(src) is not None:
            m = _swr_matrix(_DEFAULT_LAYOUTS[src], target_channels)
        if m is not None:
            return _q15_mix(samples, m)
    out = np.zeros((samples.shape[0], target_channels), dtype=np.int16)
    out[:, :min(src, target_channels)] = samples[:, :min(src,
                                                         target_channels)]
    return out


def _remix_resample(samples, src_rate, target_channels, dst_rate):
    """Remix + resample in libswresample's order.

    swr applies the rematrix and the resampler in a data-dependent order:
    resample FIRST when downmixing (in_ch > out_ch, every rate pair) or
    when upmixing with out_ch*in_rate < in_ch*out_rate; rematrix first
    otherwise. The order is observable in output bytes (both stages round
    to int16), verified against libswresample over a 46-configuration
    grid (tools/extract_swr_banks.py probes; tests/test_golden_fallback).
    """
    src_ch = samples.shape[1]
    resample_first = (src_ch > target_channels or
                      target_channels * src_rate < src_ch * dst_rate)
    if resample_first:
        return _remix_channels(_resample(samples, src_rate, dst_rate),
                               target_channels)
    return _resample(_remix_channels(samples, target_channels),
                     src_rate, dst_rate)


def _resample(samples, src_rate, dst_rate):
    """Rate conversion for the ffmpeg-free fallback tier.

    Bit-exact passthrough when rates match. For the common PSX ratios
    the shipped swresample tap banks (io/swr_exact.py, extracted from
    the real library) replay swr_convert EXACTLY; every other rational
    ratio synthesizes a bank with the reverse-engineered filter
    generator (io/swr_gen.py) — byte-identical to libswresample in its
    exact-rational regime except for taps that land within a float ulp
    of a rounding boundary (PARITY.md; worst case +-1 LSB on isolated
    outputs)."""
    if src_rate == dst_rate:
        return samples
    from . import swr_exact

    exact = swr_exact.resample(samples, src_rate, dst_rate)
    if exact is not None:
        return exact
    from . import swr_gen

    bank = swr_gen.generate_bank(src_rate, dst_rate)
    return swr_exact.apply_bank(np.asarray(samples, np.int64), *bank)


def _ffprobe(path):
    """libavformat-equivalent stream/metadata probe via the ffprobe CLI."""
    exe = shutil.which("ffprobe")
    if exe is None:
        return None
    r = subprocess.run(
        [exe, "-v", "error", "-show_streams", "-show_format",
         "-show_chapters", "-of", "json", path], capture_output=True)
    if r.returncode != 0:
        return None
    try:
        return json.loads(r.stdout)
    except json.JSONDecodeError:
        return None


def _probe_streams(probe, kind):
    return [s for s in probe.get("streams", [])
            if s.get("codec_type") == kind]


def _validate_probe_streams(probe, flags):
    """Single-track validation with the reference's exact messages
    (decoding.c:168-200)."""
    if flags & DECODER_USE_AUDIO:
        n = len(_probe_streams(probe, "audio"))
        if n > 1:
            print("Input file must have a single audio track",
                  file=sys.stderr)
            raise OpenError()
        if (flags & DECODER_AUDIO_REQUIRED) and n == 0:
            print("Input file has no audio data", file=sys.stderr)
            raise OpenError()
    if flags & DECODER_USE_VIDEO:
        n = len(_probe_streams(probe, "video"))
        if n > 1:
            print("Input file must have a single video track",
                  file=sys.stderr)
            raise OpenError()
        if (flags & DECODER_VIDEO_REQUIRED) and n == 0:
            print("Input file has no video data", file=sys.stderr)
            raise OpenError()


def _strtoll(text):
    """C strtoll(text, NULL, 10): leading whitespace + sign + digits,
    stopping at the first non-digit; 0 when nothing parses."""
    m = re.match(r"\s*([+-]?\d+)", text)
    return int(m.group(1)) if m else 0


def _probe_loop_tags(dec, probe):
    """loop_start metadata tag + first-chapter loop candidates
    (decoding.c:344-365)."""
    if probe is None:
        return
    tags = probe.get("format", {}).get("tags", {}) or {}
    for key, value in tags.items():
        if key.lower() == "loop_start":
            # AV_TIME_BASE (microsecond) units, C strtoll semantics:
            # parse the leading integer, 0 if none. C integer division
            # truncates toward zero (decoding.c:347), unlike Python //.
            us = _strtoll(str(value)) * 1000
            q = abs(us) // AV_TIME_BASE
            dec.loop_meta_ms = -q if us < 0 else q
            break
    chapters = probe.get("chapters", []) or []
    dec.n_chapters = len(chapters)
    if chapters:
        ch = chapters[0]
        num, den = 1, 1
        tb = ch.get("time_base", "1/1")
        if "/" in tb:
            num, den = (int(x) for x in tb.split("/", 1))
        pts = float(ch.get("start", 0)) * num / den
        dec.loop_chapter_ms = int(round(pts * 1000.0))


def _swr_filter(args):
    """aresample filter spec matching the reference's swr instance:
    default options, output rate/layout, plus the raw -R option string
    applied verbatim (decoding.c:237-255 + av_opt_set_from_string)."""
    ch = args.audio_channels
    spec = f"aresample=osr={args.audio_frequency}"
    if ch == 1:
        spec += ":ocl=mono"
    elif ch == 2:
        spec += ":ocl=stereo"
    else:
        spec += f":och={ch}"  # unspecified order (decoding.c:226)
    if args.swresample_options:
        spec += ":" + args.swresample_options.replace(",", ":")
    return spec


def _ffmpeg_audio(args, path):
    """Decode + swresample via the ffmpeg CLI — the same libswresample
    pipeline the reference drives in-process (decoding.c:205-255,
    370-406)."""
    exe = shutil.which("ffmpeg")
    if exe is None:
        return None
    r = subprocess.run(
        [exe, "-v", "error", "-i", path, "-map", "0:a:0",
         "-af", _swr_filter(args), "-f", "s16le", "-"],
        capture_output=True)
    if r.returncode != 0:
        if args.swresample_options:
            sys.stderr.write(r.stderr.decode(errors="replace"))
            raise OpenError()
        return None
    x = np.frombuffer(r.stdout, dtype="<i2")
    ch = args.audio_channels
    return x[: len(x) // ch * ch].reshape(-1, ch)


def _ffmpeg_frame_ptss(path):
    """Per-frame presentation timestamps of the first video stream, in
    seconds (what decoding.c:429 computes from frame->pts)."""
    exe = shutil.which("ffprobe")
    if exe is None:
        return None
    r = subprocess.run(
        [exe, "-v", "error", "-select_streams", "v:0", "-show_entries",
         "frame=pts_time,best_effort_timestamp_time", "-of", "json", path],
        capture_output=True)
    if r.returncode != 0:
        return None
    try:
        frames = json.loads(r.stdout).get("frames", [])
    except json.JSONDecodeError:
        return None
    out = []
    for i, fr in enumerate(frames):
        v = fr.get("pts_time")
        if v in (None, "N/A"):
            v = fr.get("best_effort_timestamp_time")
        if v in (None, "N/A"):
            v = out[-1] if out else 0.0
        out.append(float(v))
    return out


def _ffmpeg_video(args, path, src_w, src_h):
    """Decode + swscale via the ffmpeg CLI with the reference's scaler
    setup — BICUBIC, forced ITU-601 full-range output
    (decoding.c:287-311) — at the aspect-adjusted size, followed by the
    reference's CFR drop/duplicate retiming (decoding.c:408-478).

    Returns (frames list, dst_w, dst_h) or None.
    """
    exe = shutil.which("ffmpeg")
    if exe is None:
        return None
    dst_w, dst_h = adjust_video_size(args, src_w, src_h)
    vf = (f"scale=w={dst_w}:h={dst_h}:flags=bicubic"
          f":in_color_matrix=auto:out_color_matrix=bt601:out_range=pc")
    if args.swscale_options:
        vf += ":" + args.swscale_options.replace(",", ":")
    r = subprocess.run(
        [exe, "-v", "error", "-i", path, "-map", "0:v:0",
         "-vsync", "passthrough", "-vf", vf, "-f", "rawvideo",
         "-pix_fmt", "nv21", "-"],
        capture_output=True)
    if r.returncode != 0:
        if args.swscale_options:
            sys.stderr.write(r.stderr.decode(errors="replace"))
            raise OpenError()
        return None
    fsz = dst_w * dst_h * 3 // 2
    n = len(r.stdout) // fsz
    raw = np.frombuffer(r.stdout[:n * fsz], dtype=np.uint8).reshape(n, fsz)
    ptss = _ffmpeg_frame_ptss(path)
    if ptss is None or len(ptss) < n:
        ptss = (ptss or []) + [
            i * args.str_fps_den / args.str_fps_num
            for i in range(len(ptss or []), n)]
    frames = _cfr_retime(list(raw), ptss[:n], args.str_fps_num,
                         args.str_fps_den)
    return frames, dst_w, dst_h


def _cfr_retime(frames, ptss, fps_num, fps_den):
    """Constant-frame-rate conversion: drop late frames, duplicate across
    gaps (decoding.c:408-478)."""
    out = []
    step = fps_den / fps_num
    next_pts = 0.0
    for frame, pts in zip(frames, ptss):
        if out and pts < next_pts:
            continue
        if not out:
            next_pts = pts
        else:
            next_pts += step
        dupes = max(0, math.ceil((pts - next_pts) / step))
        for _ in range(dupes):
            out.append(out[-1])
            next_pts += step
        out.append(frame)
    return out


def _scale_frame_nv21(y, cb, cr, src_w, src_h, dst_w, dst_h):
    """Planar YUV420 -> NV21 at dst size. Pass-through (bit-exact with
    swscale) when sizes match; bicubic resample otherwise (approximate)."""
    if (src_w, src_h) == (dst_w, dst_h):
        yp = y
        cbp, crp = cb, cr
    else:
        yp = _bicubic(y.reshape(src_h, src_w), dst_w, dst_h)
        cbp = _bicubic(cb.reshape(src_h // 2, src_w // 2), dst_w // 2,
                       dst_h // 2)
        crp = _bicubic(cr.reshape(src_h // 2, src_w // 2), dst_w // 2,
                       dst_h // 2)
    c = np.empty(dst_w * dst_h // 2, dtype=np.uint8)
    c[0::2] = crp.reshape(-1)  # NV21: Cr first (decoding.c:293, mdec.c:627)
    c[1::2] = cbp.reshape(-1)
    return np.concatenate([yp.reshape(-1), c])


def _bicubic(img, dst_w, dst_h):
    """Catmull-Rom-ish bicubic resize, uint8 in/out."""
    src_h, src_w = img.shape

    def axis_resize(a, dst, axis):
        src = a.shape[axis]
        if src == dst:
            return a
        scale = src / dst
        x = (np.arange(dst) + 0.5) * scale - 0.5
        x0 = np.floor(x).astype(int)
        t = x - x0
        idx = np.stack([np.clip(x0 + k, 0, src - 1) for k in (-1, 0, 1, 2)])
        w = np.stack([_cub(t + 1), _cub(t), _cub(1 - t), _cub(2 - t)])
        taken = np.take(a, idx, axis=axis)  # (4, ..., dst, ...)
        wshape = [1] * taken.ndim
        wshape[0] = 4
        wshape[axis + 1] = dst
        return (taken * w.reshape(wshape)).sum(axis=0)

    out = axis_resize(img.astype(np.float64), dst_h, 0)
    out = axis_resize(out, dst_w, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _cub(x, a=-0.5):
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0))


def adjust_video_size(args, src_w, src_h):
    """Aspect-preserving shrink of the requested size (decoding.c:275-285)."""
    from ..cli_args import FLAG_BS_IGNORE_ASPECT

    dst_w, dst_h = args.video_width, args.video_height
    if not (args.flags & FLAG_BS_IGNORE_ASPECT):
        src_ratio = src_w / src_h
        dst_ratio = dst_w / dst_h
        if src_ratio < dst_ratio:
            dst_w = (int(round(dst_h * src_ratio)) + 15) & ~15
        else:
            dst_h = (int(round(dst_w / src_ratio)) + 15) & ~15
    return dst_w, dst_h


def _quiet(args):
    from ..cli_args import FLAG_QUIET

    return bool(args.flags & FLAG_QUIET)


def _warn_channels(args, src_channels):
    # decoding.c:229-233
    if args.audio_channels > src_channels and not _quiet(args):
        print(f"Warning: input file has less than "
              f"{args.audio_channels} channels", file=sys.stderr)


def _warn_resolution(args, src_w, src_h):
    # decoding.c:270-274 (compares the pre-aspect-adjust request).
    if (args.video_width > src_w or args.video_height > src_h) \
            and not _quiet(args):
        print(f"Warning: input file has resolution lower than "
              f"{args.video_width}x{args.video_height}", file=sys.stderr)


def _open_native_ingest(args, flags, path):
    """Ingest through the native FFmpeg extension (the same libav*/swr/sws
    stack the reference links): exact stream validation, resampling,
    rescaling, colorspace, -R/-S option handling and CFR retiming.
    Returns None when the extension is unavailable."""
    from ..cli_args import FLAG_BS_IGNORE_ASPECT
    from ..native import ingest_ext

    if ingest_ext.load() is None:
        return None
    try:
        r = ingest_ext.ingest(
            path, flags=flags, audio_frequency=args.audio_frequency,
            audio_channels=args.audio_channels,
            video_width=args.video_width, video_height=args.video_height,
            ignore_aspect=args.flags & FLAG_BS_IGNORE_ASPECT,
            fps_num=args.str_fps_num, fps_den=args.str_fps_den,
            quiet=_quiet(args), swr_options=args.swresample_options,
            sws_options=args.swscale_options)
    except OSError:
        # Detail (if any) already printed by the extension, exactly like
        # the reference's open_av_data; main adds the generic line.
        raise OpenError()
    dec = Decoder()
    dec.video_fps_num = args.str_fps_num
    dec.video_fps_den = args.str_fps_den
    dec.channels = args.audio_channels
    dec.sample_rate = args.audio_frequency
    dec.audio = r["audio"]
    dec.video = r["video"]
    dec.video_width = r["video_width"]
    dec.video_height = r["video_height"]
    dec.has_audio = r["has_audio"]
    dec.has_video = r["has_video"]
    dec.loop_meta_ms = r["loop_meta_ms"]
    dec.n_chapters = r["n_chapters"]
    dec.loop_chapter_ms = r["chapter0_ms"] if r["n_chapters"] else None
    if r["is_wav"] and r["has_audio"]:
        # WAV smpl loop chunk, highest priority (decoding.c:330-341).
        try:
            w = wavmod.read_wav(path)
            if w.loop_start_offset >= 0:
                pts = w.loop_start_offset / w.sample_rate
                dec.loop_point_ms = int(round(pts * 1000.0))
        except Exception:  # noqa: BLE001 — smpl probe only
            pass
    return dec


# Above this estimated decoded size, "auto" switches to streaming ingest.
_STREAM_AUTO_BYTES = 512 << 20


def _streaming_wanted(args, flags, path):
    """Decide the ingest tier: bounded-memory streaming (StreamingDecoder)
    vs whole-file. PSXAVENC_STREAMING=1 forces it, =0 disables it; the
    default ("auto") streams when the container duration estimates the
    decoded A/V above ~512 MB (the whole-file tier would hold all of it
    in RAM; the reference never holds more than a sliding window,
    decoding.c:510-559). All container formats support it (strspu's
    audio rejection happens downstream either way)."""
    from .. import cli_args as ca
    from ..native import ingest_ext

    if getattr(args, "format", None) in (None, ca.FORMAT_INVALID):
        return False
    mode = os.environ.get("PSXAVENC_STREAMING", "auto").lower()
    if mode in ("0", "off", "no"):
        return False
    if ingest_ext.load() is None:
        return False
    if mode in ("1", "on", "yes", "force"):
        return True
    # auto: size estimate from the container duration (no decode).
    p = ingest_ext.probe(
        path, flags=flags, audio_frequency=args.audio_frequency,
        audio_channels=args.audio_channels, video_width=args.video_width,
        video_height=args.video_height,
        ignore_aspect=False, fps_num=args.str_fps_num,
        fps_den=args.str_fps_den, quiet=True,
        swr_options=args.swresample_options,
        sws_options=args.swscale_options)
    if p is None or p["duration_us"] < 0:
        return False
    secs = p["duration_us"] / 1e6
    est = 0.0
    if p["has_video"]:
        est += secs * (args.str_fps_num / args.str_fps_den) * \
            (p["video_width"] * p["video_height"] * 3 // 2)
    if p["has_audio"]:
        est += secs * args.audio_frequency * args.audio_channels * 2
    return est > _STREAM_AUTO_BYTES


def open_av_data(args, flags):
    """Build a fully-decoded Decoder for the input file (decoding.c:131).

    Preferred path: the native FFmpeg ingest extension — the reference's
    own L0 stack, bit-exact by construction. Fallbacks (no ffmpeg dev
    libraries): pure-Python WAV/AVI readers, then the ffmpeg CLI. Raw
    escape-hatch extensions (.pcm/.s16/.nv21/.yuv) always bypass
    libavformat. Spans: ``ingest.open`` around it all; inside it, where
    Python does the steps, ``ingest.demux`` (the AVI or WAV reader),
    ``ingest.nv21`` (I420 to NV21, scaling and the frame-rate grid) and
    ``ingest.stack`` (the frames into one array).
    """
    with spans.span("ingest.open"):
        return _open_av_data(args, flags)


def _open_av_data(args, flags):
    dec = Decoder()
    dec.video_fps_num = args.str_fps_num
    dec.video_fps_den = args.str_fps_den
    dec.channels = args.audio_channels
    dec.sample_rate = args.audio_frequency

    path = args.input_file
    ext = os.path.splitext(path)[1].lower()
    raw_hint = ext in (".pcm", ".s16", ".nv21", ".yuv")

    if not raw_hint:
        if _streaming_wanted(args, flags, path):
            return StreamingDecoder(args, flags, path)
        native = _open_native_ingest(args, flags, path)
        if native is not None:
            return native

    avi = None
    if ext == ".avi":
        from . import avi as avimod

        with spans.span("ingest.demux"):
            avi = avimod.read_avi(path)

    # The -R/-S option strings are applied verbatim to the real
    # libswresample/libswscale (decoding.c:250-252,312-314), so any input
    # carrying them routes through the ffmpeg CLI.
    force_ffmpeg_audio = bool(args.swresample_options) and not raw_hint
    force_ffmpeg_video = bool(args.swscale_options) and not raw_hint
    probe = None

    def get_probe():
        nonlocal probe
        if probe is None:
            probe = _ffprobe(path)
            if probe is not None:
                _validate_probe_streams(probe, flags)
                _probe_loop_tags(dec, probe)
        return probe

    if flags & DECODER_USE_AUDIO:
        audio = None
        if ext in (".pcm", ".s16"):
            # Headerless s16le PCM at the target rate/channels (an
            # ffmpeg-free escape hatch; interpretation follows the
            # requested -f/-c).
            raw = np.fromfile(path, dtype="<i2")
            ch = args.audio_channels
            audio = raw[: len(raw) // ch * ch].reshape(-1, ch)
        elif ext == ".wav" and not force_ffmpeg_audio:
            with spans.span("ingest.demux"):
                w = wavmod.read_wav(path)
            _warn_channels(args, w.samples.shape[1])
            audio = _remix_resample(w.samples, w.sample_rate,
                                    args.audio_channels,
                                    args.audio_frequency)
            if w.loop_start_offset >= 0:
                # decoding.c:334-336: ms from the *source* sample rate.
                pts = w.loop_start_offset / w.sample_rate
                dec.loop_point_ms = int(round(pts * 1000.0))
            else:
                get_probe()  # loop_start tag fallback, when available
        elif avi is not None and avi.audio is not None \
                and not force_ffmpeg_audio:
            _warn_channels(args, avi.audio.shape[1])
            audio = _remix_resample(avi.audio, avi.audio_rate,
                                    args.audio_channels,
                                    args.audio_frequency)
        else:
            if ext == ".wav" and force_ffmpeg_audio:
                # -R reroutes decoding through the ffmpeg CLI, but the
                # smpl loop chunk must still be honored — the reference
                # parses it regardless of -R (decoding.c:331-342).
                try:
                    w = wavmod.read_wav(path)
                    if w.loop_start_offset >= 0:
                        pts = w.loop_start_offset / w.sample_rate
                        dec.loop_point_ms = int(round(pts * 1000.0))
                except Exception:  # noqa: BLE001 — smpl probe only
                    pass
            p = get_probe()
            if p is None and force_ffmpeg_audio:
                print("-R options require the ffmpeg/ffprobe binaries "
                      "(not found on PATH)", file=sys.stderr)
                raise OpenError()
            if p is not None:
                astreams = _probe_streams(p, "audio")
                if astreams:
                    _warn_channels(
                        args, int(astreams[0].get("channels", 0)))
                    audio = _ffmpeg_audio(args, path)
        if audio is not None:
            # has_audio keys off stream presence, like the reference
            # (decoding.c / main: audio_stream != NULL), even when zero
            # samples decode.
            dec.audio = np.ascontiguousarray(audio).reshape(-1)
            dec.has_audio = True
        elif flags & DECODER_AUDIO_REQUIRED:
            print("Input file has no audio data", file=sys.stderr)
            raise OpenError()

    if flags & DECODER_USE_VIDEO:
        frames = None
        if ext in (".nv21", ".yuv"):
            # Headerless NV21 frames at the requested -s geometry and -r
            # rate (.yuv is treated as I420 and repacked).
            dec.video_width = args.video_width
            dec.video_height = args.video_height
            w, h = dec.video_width, dec.video_height
            fsz = w * h * 3 // 2
            raw = np.fromfile(path, dtype=np.uint8)
            nfr = len(raw) // fsz
            raw = raw[: nfr * fsz].reshape(nfr, fsz)
            if ext == ".yuv":
                frames = []
                for fr in raw:
                    y = fr[: w * h]
                    cb = fr[w * h: w * h + w * h // 4]
                    cr = fr[w * h + w * h // 4:]
                    frames.append(_scale_frame_nv21(y, cb, cr, w, h, w, h))
            else:
                frames = list(raw)
        elif avi is not None and avi.frames and not force_ffmpeg_video:
            v = avi
            _warn_resolution(args, v.width, v.height)
            dst_w, dst_h = adjust_video_size(args, v.width, v.height)
            dec.video_width, dec.video_height = dst_w, dst_h
            with spans.span("ingest.nv21"):
                raw = [_scale_frame_nv21(y, cb, cr, v.width, v.height,
                                         dst_w, dst_h)
                       for (y, cb, cr) in v.frames]
                ptss = [i * v.fps_den / v.fps_num for i in range(len(raw))]
                frames = _cfr_retime(raw, ptss, args.str_fps_num,
                                     args.str_fps_den)
        else:
            p = get_probe()
            if p is None and force_ffmpeg_video:
                print("-S options require the ffmpeg/ffprobe binaries "
                      "(not found on PATH)", file=sys.stderr)
                raise OpenError()
            if p is not None:
                vstreams = _probe_streams(p, "video")
                if vstreams:
                    src_w = int(vstreams[0].get("width", 0))
                    src_h = int(vstreams[0].get("height", 0))
                    _warn_resolution(args, src_w, src_h)
                    res = _ffmpeg_video(args, path, src_w, src_h)
                    if res is not None:
                        frames, dec.video_width, dec.video_height = res
        if frames:
            with spans.span("ingest.stack"):
                dec.video = np.stack(frames)
            dec.has_video = True
        elif frames is not None:
            # Stream present but zero frames decoded: the reference's
            # open_av_data succeeds (has_video keys off stream presence)
            # and the muxer simply encodes no frames, like the native
            # ingest tier.
            fsz = dec.video_width * dec.video_height * 3 // 2
            dec.video = np.zeros((0, fsz), np.uint8)
            dec.has_video = True
        elif flags & DECODER_VIDEO_REQUIRED:
            print("Input file has no video data", file=sys.stderr)
            raise OpenError()

    return dec


def get_av_loop_point(dec, args):
    """Loop point in ms with the reference's priority and stderr messages
    (decoding.c:328-368): WAV smpl chunk -> "loop_start" metadata tag ->
    first chapter. Returns -1 when absent."""
    quiet = _quiet(args)
    if dec.has_audio and dec.loop_point_ms >= 0:
        if not quiet:
            print(f"Detected loop point (from smpl data): "
                  f"{dec.loop_point_ms} ms", file=sys.stderr)
        return dec.loop_point_ms
    if dec.loop_meta_ms is not None:
        if not quiet:
            print(f"Detected loop point (from metadata): "
                  f"{dec.loop_meta_ms} ms", file=sys.stderr)
        return dec.loop_meta_ms
    if dec.n_chapters > 0:
        if dec.n_chapters > 1 and not quiet:
            print(f"Warning: input file has {dec.n_chapters} chapters, "
                  f"using first one as loop point", file=sys.stderr)
        if not quiet:
            print(f"Detected loop point (from first chapter): "
                  f"{dec.loop_chapter_ms} ms", file=sys.stderr)
        return dec.loop_chapter_ms
    return -1
