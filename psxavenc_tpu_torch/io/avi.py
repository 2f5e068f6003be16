"""Minimal AVI demuxer for raw I420 video (+ optional PCM s16 audio).

This is the FFmpeg-free ingest path for video: uncompressed I420 in AVI is
demuxed to planar YUV (bit-exact with what the reference's
libavformat+rawvideo stack produces for the same file), letting golden
tests and simple workflows run without an ffmpeg binary.
"""

import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class AviData:
    width: int = 0
    height: int = 0
    fps_num: int = 0
    fps_den: int = 1
    frames: list = field(default_factory=list)  # [(y, cb, cr) uint8 arrays]
    audio_rate: int = 0
    audio_channels: int = 0
    audio: np.ndarray = None  # (n, ch) int16 or None

    @property
    def fps(self):
        return self.fps_num / self.fps_den

    @property
    def fps_den_num(self):
        return self.fps_den, self.fps_num


def _chunks(buf, pos, end):
    while pos + 8 <= end:
        ctype = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        yield ctype, pos + 8, size
        pos += 8 + size + (size & 1)


def read_avi(path):
    buf = open(path, "rb").read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError("not an AVI file")

    out = AviData()
    stream_types = []  # fcc per stream index
    audio_blobs = []
    video_blobs = []

    def walk(pos, end):
        nonlocal out
        cur_stream = [-1]
        for ctype, dpos, size in _chunks(buf, pos, end):
            body = buf[dpos:dpos + size]
            if ctype == b"LIST":
                walk(dpos + 4, dpos + size)
            elif ctype == b"strh":
                fcc = body[:4]
                stream_types.append(fcc)
                scale, rate = struct.unpack_from("<II", body, 20)
                if fcc == b"vids":
                    out.fps_num, out.fps_den = rate, scale
            elif ctype == b"strf":
                fcc = stream_types[-1] if stream_types else b""
                if fcc == b"vids":
                    (_, w, h) = struct.unpack_from("<Iii", body, 0)
                    out.width, out.height = w, abs(h)
                elif fcc == b"auds":
                    (_, ch, rate) = struct.unpack_from("<HHI", body, 0)
                    out.audio_channels, out.audio_rate = ch, rate
            elif len(ctype) == 4 and ctype[2:4] in (b"db", b"dc"):
                video_blobs.append(body)
            elif len(ctype) == 4 and ctype[2:4] == b"wb":
                audio_blobs.append(body)

    walk(12, len(buf))

    w, h = out.width, out.height
    for blob in video_blobs:
        need = w * h * 3 // 2
        if len(blob) < need:
            continue
        arr = np.frombuffer(blob[:need], dtype=np.uint8)
        y = arr[: w * h]
        cb = arr[w * h: w * h + w * h // 4]
        cr = arr[w * h + w * h // 4:]
        out.frames.append((y, cb, cr))
    if audio_blobs:
        pcm = np.frombuffer(b"".join(audio_blobs), dtype="<i2")
        ch = max(1, out.audio_channels)
        pcm = pcm[: (len(pcm) // ch) * ch]
        out.audio = pcm.reshape(-1, ch)
    return out
