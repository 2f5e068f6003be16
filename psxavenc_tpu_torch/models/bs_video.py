"""BS video frame encoder model: device pipeline + host assembly.

Counterpart of ``psxavenc_tpu/models/bs_video.py``: frames go to the
device in chunk-sized batches (8, 32 or 128 frames, padded with the last
frame), ``api.bs_encode_frames_owned`` encodes them (the default step
of ``api.bs_encode_frames_packed``, handed the uploaded frames, which it
frees after the NV21 kernel; split over the devices by
``parallel.mesh.packed_video_step`` when the encoder has more than one),
and the host adds the 8-byte frame headers. The device is explicit; on
the CPU the kernels run their plain versions.

Batches are pipelined one deep with a CUDA stream and events, where the
JAX encoder uses an uploader thread: ``encode_frames`` stacks batch k+1's
frames into a pinned staging buffer and enqueues its upload, its step and
the read-back of its results into pinned host tensors (``non_blocking``)
on the encoder's own stream, and only then waits for batch k's read-back
and assembles its frames, so the card works on batch k+1 while the host
builds batch k's headers. ``encode_frames_async`` enqueues a batch and
returns without waiting for the card; ``fetch`` is the one place that
waits, on an event recorded after the read-back. Two staging buffers are
used in turn, and one is refilled only after the event recorded after
the last upload from it has completed. The host work of a batch (the
staging copy, some 40 launches, the headers) is mostly Python, which a
second thread would run under the same interpreter lock: on the H100's
host an uploader thread was no faster end to end
(``tools/torch_pipeline_bench.py``, PERF.md), so none is started. On the
CPU a batch is encoded when it is enqueued.

Spans (``utils/spans.py``, on only under a profiler): ``bs.open`` (the
constructor) and, once a batch keyed by its sequence number, ``bs.stack``
(the frames and budgets stacked), ``bs.stage`` (the pinned staging copy
and its wait on the last upload), ``bs.launch`` (what follows, in three
children: ``bs.upload``, the uploads and their event; ``bs.step``, the
step's launches; ``bs.read_back``, the pinned buffers, the copies into
them and the event after them; on the CPU and the native tier
``bs.step`` alone), ``bs.wait`` (``fetch``'s wait on the event) and
``bs.collect`` (the headers and buffers). While a profile runs on a card,
four timing events on the encoder's stream (before the upload; after it,
the staging buffer's ``uploaded`` event; after the step's last launch;
after the read-back, the batch's ``done`` event) give the batch's device
time of each stage, read at ``fetch`` once the batch is done and added to
the counters ``bs_upload_device_ns``, ``bs_step_device_ns`` and
``bs_read_back_device_ns``. While a profile runs, the device tier's step
also returns K1's statistics rows and each frame's DC bits, which come
back with the batch's read-back and are added to the counters
``k1_frames``, ``k1_global_frames``, ``k1_evaluations``, ``dc_bits`` and
``frame_bits`` at ``fetch`` (over several devices too); with no profile
running the step makes no statistics tensor, reads back no DC bits and
records no timing event.

The compute tier is read from PSXAVENC_VIDEO_TIER at construction
(``video_tier``): ``device`` runs that step on the encoder's devices
(the kernels on the card, their plain versions on the CPU); ``native``
runs the native C++ frame encoder (``native/tiers.py``, bit-exact with
both) on the host's cores, one call for all the frames of a call, with
per-worker search seeds carried across calls; ``auto`` (the default) is
``native`` when every device of the encoder is the CPU and ``device``
otherwise. ``native`` on an encoder with a CUDA device raises
ValueError: an encoder on the card never reaches the native library.
"""

import os

import numpy as np
import torch

from .. import api
from ..native import tiers
from ..ops import bs as bs_ops
from ..ops import bs_cuda
from ..parallel import mesh
from ..utils import spans

TIERS = ("auto", "device", "native")
_GLOBAL = bs_cuda.STAT_NAMES.index("global_reader")
_EVALS = [bs_cuda.STAT_NAMES.index(k) for k in ("ladder", "fused", "exact")]


def video_tier(devices):
    """PSXAVENC_VIDEO_TIER (``auto``, ``device`` or ``native``) resolved
    for an encoder on ``devices`` -> ``"device"`` or ``"native"``;
    ``native`` is refused unless every device is the CPU."""
    tier = os.environ.get("PSXAVENC_VIDEO_TIER", "auto")
    if tier not in TIERS:
        raise ValueError(f"PSXAVENC_VIDEO_TIER={tier!r}: one of {TIERS}")
    cpu = all(torch.device(d).type == "cpu" for d in devices)
    if tier == "native" and not cpu:
        raise ValueError("PSXAVENC_VIDEO_TIER=native runs on the host: "
                         "give the encoder the CPU, not "
                         f"{', '.join(str(d) for d in devices)}")
    if tier == "auto":
        tier = "native" if cpu else "device"
    return tier


def _stack_frames(frames, pad_to):
    """(list of per-frame byte rows) -> (pad_to, frame_bytes) uint8.

    Zero-copy when the frames are exactly consecutive rows of one
    C-contiguous 2-D array (the whole-file ingest layout): the batch is a
    strided view of that array, writeable when that array is (so that
    torch can read it without a copy; the encoder only reads it). Any
    padding, reordering or mixed sources stack a copy."""
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
                strides=(fsz, f0.itemsize))
    rows = [np.asarray(f) for f in frames]
    rows += [rows[-1]] * (pad_to - n)
    return np.stack(rows)


def _count_stats(out, n):
    """A batch's statistics, read back, into the counters: K1's rows (B,
    8) (padded frames included), and the DC bits and total bits of its
    ``n`` frames."""
    stats = out.pop("k1_stats")
    spans.count("k1_frames", len(stats))
    spans.count("k1_global_frames", int(stats[:, _GLOBAL].sum()))
    spans.count("k1_evaluations", int(stats[:, _EVALS].sum()))
    spans.count("dc_bits", int(out.pop("dc_total")[:n].sum()))
    spans.count("frame_bits", int(out["total_bits"][:n].sum()))


def _recorded(stream, timing):
    """An event recorded on ``stream`` now; a timing event if ``timing``."""
    event = torch.cuda.Event(enable_timing=timing)
    event.record(stream)
    return event


def _count_clocks(clocks):
    """A done batch's four timing events into the device-time counters."""
    up, step, back = (a.elapsed_time(b) for a, b in zip(clocks, clocks[1:]))
    spans.count("bs_upload_device_ns", round(up * 1e6))
    spans.count("bs_step_device_ns", round(step * 1e6))
    spans.count("bs_read_back_device_ns", round(back * 1e6))


def _bucket(n):
    """Frames per device batch: 128 for long inputs, 32 or 8 for short."""
    return 128 if n >= 96 else (32 if n >= 32 else BsFrameEncoder.CHUNK)


class _Staging:
    """A pinned host buffer for uploads, and the event recorded after the
    last copy out of it."""

    def __init__(self):
        self.frames = None
        self.budgets = None
        self.uploaded = None

    def fill(self, fr, budgets):
        if self.uploaded is not None:
            self.uploaded.synchronize()     # the last upload from it is done
        if self.frames is None or self.frames.shape != fr.shape:
            self.frames = torch.empty(fr.shape, dtype=torch.uint8,
                                      pin_memory=True)
            self.budgets = torch.empty(budgets.shape, dtype=torch.int32,
                                       pin_memory=True)
        if fr.flags.writeable:
            # torch copies on its intra-op threads: several times numpy's
            # one-thread rate from frames the cache does not hold.
            self.frames.copy_(torch.from_numpy(fr))
        else:
            self.frames.numpy()[...] = fr
        self.budgets.numpy()[...] = budgets
        return self.frames, self.budgets


class BsFrameEncoder:
    """Stateful frame encoder (quant-scale sum) matching mdec_encoder_t's
    observable behavior, with chunk-batched device work on ``device``: one
    device, or a sequence of devices that each batch splits over (it may
    name one device more than once)."""

    CHUNK = 8  # smallest device batch

    def __init__(self, codec, width, height, device):
        with spans.span("bs.open"):
            assert width % 16 == 0 and height % 16 == 0
            self._closed = False
            self.codec = codec  # bs_ops.BS_V2 / BS_V3 / BS_V3DC
            self.width = width
            self.height = height
            self.devices = mesh.device_list(device)
            self.device = self.devices[0]
            self.tier = video_tier(self.devices)
            if self.tier == "native":
                tiers.lib()         # a failed build raises here
            self.quant_scale_sum = 0
            # The step per (capacity, K1 statistics or not), the staging
            # buffers and the stream of the uploads, steps and read-backs;
            # the next batch's sequence number (its spans' key).
            self._steps = {}
            self._staging = [_Staging(), _Staging()]
            self._turn = 0
            self._stream = None
            self._seq = 0
            # The native tier's search seeds, one (workers, 2) array per
            # worker count, carried across calls; they steer the order of
            # the search only, never a byte.
            self._native_seeds = {}

    def close(self):
        """Wait for the batches enqueued on the encoder's stream, then
        drop its staging buffers, steps and stream (idempotent; also run
        by ``__del__``). A handle enqueued before ``close`` can still be
        fetched; enqueueing on a closed encoder raises RuntimeError."""
        if self._closed:
            return
        self._closed = True
        if self._stream is not None:
            self._stream.synchronize()
        self._stream = None
        self._staging = None
        self._steps = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _native_encode(self, fr, budgets, cap_words):
        """One native-tier call for all of ``fr``, with the seeds of its
        worker count."""
        nt = max(1, min(len(fr), os.cpu_count() or 1))
        seeds = self._native_seeds.setdefault(nt, np.zeros((nt, 2),
                                                           np.int32))
        return tiers.bs_encode_frames(
            fr, budgets, codec=self.codec, width=self.width,
            height=self.height, capacity_words=cap_words, n_threads=nt,
            seeds=seeds)

    def _gran(self, frames):
        """A batch size of at least ``frames`` that divides over the
        devices."""
        n_dev = len(self.devices)
        return -(-frames // n_dev) * n_dev

    def _step(self, cap_words, k1_stats):
        """step(batch) on a dict of the batch's ``frames`` and ``budgets``
        on the devices, which it empties: on one device
        ``api.bs_encode_frames_owned``, which frees the frames after the
        NV21 kernel; on several the split, which holds them to its end."""
        step = self._steps.get((cap_words, k1_stats))
        if step is None:
            kw = dict(codec=self.codec, width=self.width, height=self.height,
                      capacity_words=cap_words, k1_stats=k1_stats)
            if len(self.devices) > 1:
                split = mesh.packed_video_step(self.devices, **kw)

                def step(batch):
                    return split(batch.pop("frames"), batch.pop("budgets"))
            else:
                def step(batch):
                    return api.bs_encode_frames_owned(batch, **kw)
            self._steps[cap_words, k1_stats] = step
        return step

    def _launch(self, frames_nv21, sizes, pad_to, cap_words):
        """Enqueue one batch: its host prep, upload, step and read-back ->
        a handle for :meth:`fetch`: (budgets, dict of host arrays, the
        event after the read-back, or None on the CPU and the native
        tier, the batch's sequence number, its four timing events while a
        profile runs on a card, else None)."""
        if self._closed:
            raise RuntimeError("BsFrameEncoder is closed")
        seq = self._seq
        self._seq += 1
        sizes = list(sizes)
        with spans.span("bs.stack", seq):
            fr = _stack_frames(list(frames_nv21), pad_to)
            budgets = np.array(sizes + [sizes[-1]] * (pad_to - len(sizes)),
                               np.int32)
        if self.tier == "native":
            with spans.span("bs.launch", seq), spans.span("bs.step", seq):
                out = self._native_encode(fr, budgets, cap_words)
            return sizes, out, None, seq, None
        traced = spans.enabled()
        step = self._step(cap_words, traced)
        if self.device.type != "cuda":
            with spans.span("bs.launch", seq):
                batch = {"frames": torch.tensor(np.asarray(fr),
                                                device=self.device),
                         "budgets": torch.from_numpy(budgets).to(
                             self.device)}
                with spans.span("bs.step", seq):
                    out = step(batch)
            return sizes, out, None, seq, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        staging = self._staging[self._turn]
        self._turn ^= 1
        with spans.span("bs.stage", seq):
            frames_h, budgets_h = staging.fill(fr, budgets)
        with spans.span("bs.launch", seq), torch.cuda.stream(self._stream):
            with spans.span("bs.upload", seq):
                if traced:
                    start = _recorded(self._stream, True)
                # The step holds the only reference to the uploaded
                # frames, so their block goes back to the allocator, on
                # this stream, once the NV21 kernel is enqueued.
                batch = {"frames": frames_h.to(self.device,
                                               non_blocking=True),
                         "budgets": budgets_h.to(self.device,
                                                 non_blocking=True)}
                staging.uploaded = _recorded(self._stream, traced)
            with spans.span("bs.step", seq):
                out = step(batch)
                if traced:
                    stepped = _recorded(self._stream, True)
            with spans.span("bs.read_back", seq):
                host = {}
                for k, v in out.items():
                    host[k] = torch.empty(v.shape, dtype=v.dtype,
                                          pin_memory=True)
                    host[k].copy_(v, non_blocking=True)
                done = _recorded(self._stream, traced)
        clocks = (start, staging.uploaded, stepped, done) if traced else None
        return sizes, host, done, seq, clocks

    def encode_frames(self, frames_nv21, frame_max_sizes):
        """Encode N frames with per-frame budgets -> list of (buffer, info),
        one device call per chunk, the next chunk enqueued before this
        one's results are assembled."""
        n = len(frames_nv21)
        if n == 0:
            return []
        # One capacity for the whole call; the native tier takes all the
        # frames in one call (no compiled shapes, no padding).
        cap_words = max(1, (int(max(frame_max_sizes)) - 8 + 1) // 2)
        gran = n if self.tier == "native" else self._gran(_bucket(n))

        def launch(base):
            ids = range(base, min(base + gran, n))
            return self._launch([frames_nv21[i] for i in ids],
                                [frame_max_sizes[i] for i in ids], gran,
                                cap_words)

        results = []
        pending = launch(0)
        for base in range(0, n, gran):
            current = pending
            pending = launch(base + gran) if base + gran < n else None
            results += self.fetch(current)
        return results

    def encode_frames_async(self, frames_nv21, frame_max_sizes):
        """Enqueue one batch and return a handle for :meth:`fetch` without
        waiting for the card (the muxers' frame feeds enqueue the next
        batch before they fetch this one)."""
        sizes = list(frame_max_sizes)
        n = len(sizes)
        gran = 128 if n >= 96 else (32 if n > self.CHUNK else self.CHUNK)
        cap_words = max(1, (int(max(sizes)) - 8 + 1) // 2)
        pad_to = n if self.tier == "native" else self._gran(max(gran, n))
        return self._launch(frames_nv21, sizes, pad_to, cap_words)

    def fetch(self, handle):
        """Wait for an enqueued batch -> list of (buffer, info)."""
        sizes, out, done, seq, clocks = handle
        if done is not None:
            with spans.span("bs.wait", seq):
                done.synchronize()
        with spans.span("bs.collect", seq):
            if clocks is not None:
                _count_clocks(clocks)
            out = {k: np.asarray(v) for k, v in out.items()}
            if "k1_stats" in out:
                _count_stats(out, len(sizes))
            return self._collect(out, sizes)

    def _collect(self, out, sizes):
        """A batch's host results -> list of (buffer, info), the 8-byte BS
        frame headers (mdec.c:725-755) built for the whole batch at once;
        frame j's buffer is a row of one (n, max size) array cut to its
        budget. An unfittable frame raises as the reference does
        (mdec.c:723), after the frames before it were counted."""
        n = len(sizes)
        size = np.asarray(sizes, np.int64)
        scale = out["scale"][:n].astype(np.int64)
        # total_bits already includes the 10-bit end-of-frame code.
        bytes_used = 8 + 2 * ((out["total_bits"][:n].astype(np.int64)
                               + 15) >> 4)
        unfit = np.flatnonzero(scale >= 64)
        over = np.flatnonzero(bytes_used > size)
        first = min([n, *unfit[:1], *over[:1]])
        self.quant_scale_sum += int(scale[:first].sum())
        if first < n:
            if scale[first] >= 64:
                raise RuntimeError(
                    "frame does not fit budget even at quant scale 63 "
                    "(the reference asserts here too, mdec.c:723)")
            raise AssertionError(f"frame {first}: {bytes_used[first]} "
                                 f"bytes used of {size[first]}")
        bytes_used = (bytes_used + 0x3) & ~0x3
        nb = (self.width // 16) * (self.height // 16) * 6
        hwords = out["nz_count"][:n].astype(np.int64) + 2 * nb + 2
        hwords = (hwords + 0x3F) & ~0x3F
        blocks_used = (hwords + 1) >> 1

        width = int(size.max())
        buffers = np.empty((n, width), np.uint8)
        payload = out["words"][:n].astype("<u2", copy=False).view(np.uint8)
        buffers[:, 8:] = payload[:, :width - 8]
        buffers[:, 0] = blocks_used & 0xFF
        buffers[:, 1] = (blocks_used >> 8) & 0xFF
        buffers[:, 2] = 0x00
        buffers[:, 3] = 0x38
        buffers[:, 4] = scale & 0xFF
        buffers[:, 5] = (scale >> 8) & 0xFF
        buffers[:, 6] = 0x02 if self.codec == bs_ops.BS_V2 else 0x03
        buffers[:, 7] = 0x00
        return [(buffers[j, :sizes[j]], {
            "quant_scale": int(scale[j]),
            "bytes_used": int(bytes_used[j]),
            "blocks_used": int(blocks_used[j]),
        }) for j in range(n)]
