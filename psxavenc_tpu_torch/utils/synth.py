"""Deterministic synthetic media generators (tests + benchmarks)."""

import pathlib
import struct

import numpy as np


def write_wav(path, samples, sample_rate, channels=1, loop_start=None,
              loop_end=None):
    """Write a PCM s16le WAV; optionally with a smpl forward-loop chunk."""
    samples = np.asarray(samples, dtype="<i2")
    if channels > 1:
        assert samples.ndim == 2 and samples.shape[1] == channels
    data = samples.tobytes()
    chunks = b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, sample_rate,
        sample_rate * 2 * channels, 2 * channels, 16)
    if loop_start is not None:
        smpl = struct.pack("<9I", 0, 0, 1000000000 // sample_rate, 60, 0, 0,
                           0, 1, 0)
        smpl += struct.pack("<6I", 0, 0, loop_start,
                            loop_end if loop_end is not None else loop_start,
                            0, 0)
        chunks += b"smpl" + struct.pack("<I", len(smpl)) + smpl
    chunks += b"data" + struct.pack("<I", len(data)) + data
    riff = b"WAVE" + chunks
    blob = b"RIFF" + struct.pack("<I", len(riff)) + riff
    pathlib.Path(path).write_bytes(blob)
    return path


def write_avi_sized(path, width, height, frames, fps_num, fps_den=1,
                    audio=None, audio_rate=44100):
    """Write an AVI with raw I420 video and optional PCM s16 audio.

    ``frames``: list of (y, cb, cr) uint8 1-D planes for width x height.
    ``audio``: (n, ch) int16 or None.
    """
    def chunk(tag, payload):
        pad = b"\x00" if len(payload) & 1 else b""
        return tag + struct.pack("<I", len(payload)) + payload + pad

    def lst(four, payload):
        return chunk(b"LIST", four + payload)

    n = len(frames)
    frame_bytes = width * height * 3 // 2
    us_per_frame = int(round(1_000_000 * fps_den / fps_num))
    nstreams = 1 + (1 if audio is not None else 0)

    avih = struct.pack("<14I", us_per_frame, frame_bytes * fps_num, 0,
                       0x10, n, 0, nstreams, frame_bytes, width, height,
                       0, 0, 0, 0)
    strh_v = (b"vids" + b"I420" + struct.pack("<IHHIIIIIIIi4H", 0, 0, 0, 0,
                                              fps_den, fps_num, 0, n, 0,
                                              0xFFFFFFFF, 0, 0, 0, width,
                                              height))
    strf_v = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 12, b"I420",
                         frame_bytes, 0, 0, 0, 0)
    hdrl = avih and (chunk(b"avih", avih)
                     + lst(b"strl", chunk(b"strh", strh_v)
                           + chunk(b"strf", strf_v)))
    if audio is not None:
        ch = audio.shape[1]
        block = 2 * ch
        strh_a = (b"auds" + b"\x00\x00\x00\x00"
                  + struct.pack("<IHHIIIIIIIi4H", 0, 0, 0, 0, 1, audio_rate,
                                0, len(audio), 0, 0xFFFFFFFF, block, 0, 0,
                                0, 0))
        strf_a = struct.pack("<HHIIHH", 1, ch, audio_rate,
                             audio_rate * block, block, 16)
        hdrl += lst(b"strl", chunk(b"strh", strh_a) + chunk(b"strf", strf_a))

    movi = b""
    index = []
    offset = 4  # relative to start of 'movi' fourcc
    # Interleave: one video frame then its slice of audio.
    audio_pos = 0
    spf = None
    if audio is not None:
        spf = (len(audio) + n - 1) // n
    for i, (y, cb, cr) in enumerate(frames):
        payload = np.concatenate([y, cb, cr]).astype(np.uint8).tobytes()
        c = chunk(b"00db", payload)
        index.append((b"00db", 0x10, offset, len(payload)))
        movi += c
        offset += len(c)
        if audio is not None and audio_pos < len(audio):
            seg = audio[audio_pos:audio_pos + spf]
            audio_pos += len(seg)
            payload = np.ascontiguousarray(seg, dtype="<i2").tobytes()
            c = chunk(b"01wb", payload)
            index.append((b"01wb", 0x10, offset, len(payload)))
            movi += c
            offset += len(c)

    idx1 = b"".join(tag + struct.pack("<III", flags, off, ln)
                    for tag, flags, off, ln in index)
    riff = (b"AVI " + lst(b"hdrl", hdrl) + lst(b"movi", movi)
            + chunk(b"idx1", idx1))
    blob = b"RIFF" + struct.pack("<I", len(riff)) + riff
    pathlib.Path(path).write_bytes(blob)
    return path


def rand_frames(width, height, n, seed=0, motion=True):
    """Deterministic synthetic I420 frames: smooth gradients + moving
    blocks + noise — enough detail to exercise the quant-scale search."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    frames = []
    base = (rng.random((height, width)) * 60).astype(np.float64)
    for t in range(n):
        ph = t * 0.7 if motion else 0.0
        y = (128 + 80 * np.sin(xx * 0.05 + ph) * np.cos(yy * 0.08)
             + base * np.sin(t * 0.3 + 1))
        bx = (17 * t) % max(1, width - 32)
        by = (11 * t) % max(1, height - 32)
        y[by:by + 32, bx:bx + 32] = 230
        y = np.clip(y + rng.standard_normal((height, width)) * 6, 0,
                    255).astype(np.uint8)
        cb = np.clip(128 + 50 * np.sin(xx[::2, ::2] * 0.03 + t * 0.2), 0,
                     255).astype(np.uint8)
        cr = np.clip(128 + 50 * np.cos(yy[::2, ::2] * 0.04 - t * 0.1), 0,
                     255).astype(np.uint8)
        frames.append((y.reshape(-1), cb.reshape(-1), cr.reshape(-1)))
    return frames


def rand_pcm(n, channels=1, seed=0, scale=22000):
    """Deterministic band-limited-ish random PCM exercising the encoder."""
    rng = np.random.default_rng(seed)
    shape = (n, channels) if channels > 1 else (n,)
    x = rng.standard_normal(shape)
    # Cumulative sum gives a low-frequency component, plus white noise and
    # occasional full-scale spikes to exercise shift/filter edges.
    y = np.cumsum(x, axis=0)
    y = y / (np.abs(y).max() + 1e-9)
    z = 0.7 * y + 0.25 * rng.standard_normal(shape) * 0.3
    spikes = rng.random(shape) < 0.001
    z = np.where(spikes, rng.choice([-1.0, 1.0], shape), z)
    return np.clip(z * scale, -32768, 32767).astype(np.int16)


def tone(n, channels=1, freq=440.0, sample_rate=37800, amplitude=30000):
    """(n, channels) int16 sine at ``freq``, channel c a radian later in
    phase than channel c - 1: a loud steady tone, on which ADPCM encodes
    started from different states can stay apart for good."""
    t = np.arange(n)[:, None] / sample_rate
    phase = np.arange(channels)[None, :]
    return np.round(amplitude * np.sin(2 * np.pi * freq * t + phase)) \
        .astype(np.int16)
