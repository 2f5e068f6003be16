"""RIFF/WAVE reader with smpl loop-point parsing.

Produces interleaved s16 PCM like the reference's FFmpeg front end
(psxavenc/decoding.c:216-247). For s16 inputs the samples pass through
bit-exact; other sample formats are converted with round-to-nearest (the
reference's swresample does the same for the formats we accept).

Loop points follow psxavenc/decoding.c:52-111: the first loop of the first
``smpl`` chunk, forward type assumed, start offset in samples.
"""

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavData:
    sample_rate: int
    channels: int
    samples: np.ndarray  # (n, channels) int16, interleaved order preserved
    loop_start_offset: int  # sample offset, -1 if none


def _convert_to_s16(raw, fmt, bits, channels):
    if fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2")
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.int32) - 128) \
                << 8
            x = x.astype(np.int16)
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3).astype(np.uint32)
            v = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)).astype(np.int32)
            v = (v << 8) >> 16  # sign-extend 24-bit then take the top 16
            x = v.astype(np.int16)
        elif bits == 32:
            x = (np.frombuffer(raw, dtype="<i4") >> 16).astype(np.int16)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif fmt == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        f = np.frombuffer(raw, dtype=dt)
        x = np.clip(np.rint(f * 32768.0), -32768, 32767).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV format tag: {fmt}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels)


def read_wav(path):
    data = open(path, "rb").read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt_tag = bits = channels = rate = None
    pcm = None
    loop_start = -1
    pos = 12
    while pos + 8 <= len(data):
        ctype = data[pos:pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8:pos + 8 + csize]
        if ctype == b"fmt ":
            fmt_tag, channels, rate = struct.unpack_from("<HHI", body, 0)
            (bits,) = struct.unpack_from("<H", body, 14)
            if fmt_tag == 0xFFFE and csize >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (fmt_tag,) = struct.unpack_from("<H", body, 24)
        elif ctype == b"data":
            pcm = body
        elif ctype == b"smpl" and csize >= 4 * 9:
            # decoding.c:69-107: first loop of the chunk, if any.
            (loop_count,) = struct.unpack_from("<I", body, 28)
            if loop_count > 0 and csize >= 4 * 9 + 4 * 6:
                (loop_start,) = struct.unpack_from("<i", body, 36 + 8)
        # No word-alignment padding: the reference's smpl scanner skips
        # exactly chunk_size bytes (decoding.c:69-75).
        pos += 8 + csize

    if fmt_tag is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    samples = _convert_to_s16(pcm, fmt_tag, bits, channels)
    return WavData(rate, channels, samples, loop_start)
