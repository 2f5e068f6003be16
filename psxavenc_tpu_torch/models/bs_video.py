"""BS video frame encoder model: device pipeline + host assembly.

Counterpart of ``psxavenc_tpu/models/bs_video.py``: frames go to the
device in chunk-sized batches (8, 32 or 128 frames, padded with the last
frame), ``api.bs_encode_frames_packed`` encodes them, and the host adds
the 8-byte frame headers. The device is explicit; on the CPU the kernels
run their plain versions.
"""

import numpy as np
import torch

from .. import api
from ..ops import bs as bs_ops


def _stack_frames(frames, pad_to):
    """(list of per-frame byte rows) -> (pad_to, frame_bytes) uint8.

    Zero-copy when the frames are exactly consecutive rows of one
    C-contiguous 2-D array (the whole-file ingest layout): the batch is a
    strided view of that array. Any padding, reordering or mixed sources
    stack a copy."""
    n = len(frames)
    f0 = frames[0]
    if (pad_to == n and isinstance(f0, np.ndarray) and f0.ndim == 1
            and f0.nbytes > 0 and f0.flags["C_CONTIGUOUS"]):
        # Every row must live in the same backing allocation at exactly
        # addr0 + j*fsz for the strided view to be in-bounds memory.
        ub = f0.base if f0.base is not None else f0
        addr0 = f0.__array_interface__["data"][0]
        fsz = f0.nbytes
        ok = True
        for j, f in enumerate(frames):
            if (not isinstance(f, np.ndarray) or f.ndim != 1
                    or f.nbytes != fsz or f.dtype != f0.dtype
                    or not f.flags["C_CONTIGUOUS"]
                    or (f.base if f.base is not None else f) is not ub
                    or f.__array_interface__["data"][0]
                    != addr0 + j * fsz):
                ok = False
                break
        if ok:
            return np.lib.stride_tricks.as_strided(
                f0, shape=(n, f0.shape[0]),
                strides=(fsz, f0.itemsize), writeable=False)
    rows = [np.asarray(f) for f in frames]
    rows += [rows[-1]] * (pad_to - n)
    return np.stack(rows)


def _bucket(n):
    """Frames per device batch: 128 for long inputs, 32 or 8 for short."""
    return 128 if n >= 96 else (32 if n >= 32 else BsFrameEncoder.CHUNK)


class BsFrameEncoder:
    """Stateful frame encoder (quant-scale sum) matching mdec_encoder_t's
    observable behavior, with chunk-batched device work on ``device``."""

    CHUNK = 8  # smallest device batch

    def __init__(self, codec, width, height, device):
        assert width % 16 == 0 and height % 16 == 0
        self.codec = codec  # bs_ops.BS_V2 / BS_V3 / BS_V3DC
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.quant_scale_sum = 0
        self._staging = None  # pinned host buffer for uploads to a card

    def _upload(self, fr):
        """(B, F) uint8 host frames -> a device tensor."""
        if self.device.type != "cuda":
            return torch.tensor(np.asarray(fr), device=self.device)
        if self._staging is None or self._staging.shape != fr.shape:
            self._staging = torch.empty(fr.shape, dtype=torch.uint8,
                                        pin_memory=True)
        # The previous batch's copy out of the staging buffer finished
        # when its results were read back.
        self._staging.numpy()[...] = fr
        return self._staging.to(self.device, non_blocking=True)

    def _encode_batch(self, frames_nv21, sizes, pad_to, cap_words):
        """One device call -> dict of host numpy arrays."""
        fr = _stack_frames(list(frames_nv21), pad_to)
        budgets = np.array(list(sizes) + [sizes[-1]] * (pad_to - len(sizes)),
                           np.int32)
        out = api.bs_encode_frames_packed(
            self._upload(fr), torch.from_numpy(budgets).to(self.device),
            codec=self.codec, width=self.width, height=self.height,
            capacity_words=cap_words)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        host["words"] = host["words"].view(np.uint16)
        return host

    def encode_frames(self, frames_nv21, frame_max_sizes):
        """Encode N frames with per-frame budgets -> list of (buffer, info),
        one device call per chunk."""
        n = len(frames_nv21)
        if n == 0:
            return []
        # One capacity for the whole call.
        cap_words = max(1, (int(max(frame_max_sizes)) - 8 + 1) // 2)
        gran = _bucket(n)
        results = []
        for base in range(0, n, gran):
            ids = range(base, min(base + gran, n))
            sizes = [frame_max_sizes[i] for i in ids]
            out = self._encode_batch([frames_nv21[i] for i in ids], sizes,
                                     gran, cap_words)
            results += self._collect(out, sizes)
        return results

    def encode_frames_async(self, frames_nv21, frame_max_sizes):
        """Encode one batch now; returns a ready handle for :meth:`fetch`
        (the muxers' frame feeds call the pair one batch ahead)."""
        sizes = list(frame_max_sizes)
        n = len(sizes)
        gran = 128 if n >= 96 else (32 if n > self.CHUNK else self.CHUNK)
        cap_words = max(1, (int(max(sizes)) - 8 + 1) // 2)
        return self._encode_batch(frames_nv21, sizes, gran, cap_words), sizes

    def fetch(self, handle):
        """Materialize an encoded batch -> list of (buffer, info)."""
        out, sizes = handle
        return self._collect(out, sizes)

    def _collect(self, out, sizes):
        return [self._assemble(int(out["scale"][j]), out["words"][j],
                               int(out["total_bits"][j]),
                               int(out["nz_count"][j]), int(sizes[j]))
                for j in range(len(sizes))]

    def _assemble(self, scale, words, total_bits, nz, frame_max_size):
        if scale >= 64:
            raise RuntimeError(
                "frame does not fit budget even at quant scale 63 "
                "(the reference asserts here too, mdec.c:723)")
        buffer = np.zeros(frame_max_size, dtype=np.uint8)
        payload = words.astype("<u2").tobytes()
        buffer[8:] = np.frombuffer(payload[:frame_max_size - 8], np.uint8)
        # total_bits already includes the 10-bit end-of-frame code.
        bytes_used = 8 + 2 * ((total_bits + 15) >> 4)
        assert bytes_used <= frame_max_size
        bytes_used = (bytes_used + 0x3) & ~0x3

        nb = (self.width // 16) * (self.height // 16) * 6
        hwords = nz + 2 * nb + 2
        hwords = (hwords + 0x3F) & ~0x3F
        blocks_used = (hwords + 1) >> 1

        # 8-byte BS frame header (mdec.c:725-755).
        buffer[0] = blocks_used & 0xFF
        buffer[1] = (blocks_used >> 8) & 0xFF
        buffer[2] = 0x00
        buffer[3] = 0x38
        buffer[4] = scale & 0xFF
        buffer[5] = (scale >> 8) & 0xFF
        buffer[6] = 0x02 if self.codec == bs_ops.BS_V2 else 0x03
        buffer[7] = 0x00

        self.quant_scale_sum += scale
        return buffer, {
            "quant_scale": scale,
            "bytes_used": bytes_used,
            "blocks_used": blocks_used,
        }
