"""Driver ``video_feed``: a movie's frames through the program's frame
encoder, ``models.bs_video.BsFrameEncoder``, the way the .str muxer's
look-ahead feed drives it: one encoder per pass over the movie, batches
of ``batch_frames`` frames with their schedule budgets enqueued with
``encode_frames_async`` one batch ahead of ``fetch``.

A unit is one pass. A batch's latency runs from the call that enqueues
it to the return of the ``fetch`` that hands back its frames. The frames
drawn from the seed for the check keep every distinct buffer the window
returned for them; after the window the plain reference encodes those
frames again and each buffer is compared byte for byte."""

import contextlib
import time

import numpy as np
import torch

from benchref import bs as ref_bs

from .. import pacing, roofline, spec, traffic

CODECS = {"v2": 0}
REF_CHUNK = 16


class Driver:
    def __init__(self, cell, seed, device, tmp, spans):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device = device
        self.span = spans
        self.width, self.height = self.cfg["width"], self.cfg["height"]
        self.codec = CODECS[self.cfg["codec"]]
        self.attempted = self.failed = 0
        self.seen = {}
        self.scales = None
        self.encoder = None

    def setup(self):
        self.encoder = spec.program(
            "psxavenc_tpu_torch.models.bs_video").BsFrameEncoder
        n = int(round(self.mix["movie_seconds"] * self.cfg["fps_num"]
                      / self.cfg["fps_den"]))
        self.frames = traffic.movie(self.seed, n, self.width, self.height,
                                    self.device,
                                    scene_frames=self.mix["scene_frames"])
        self.budgets = pacing.frame_budgets(self.cfg, n)
        rng = np.random.default_rng(self.seed % (1 << 63))
        b = self.mix["batch_frames"]
        last = range((n - 1) // b * b, n)       # the padded last batch
        pick = rng.choice(n, self.mix["check_frames"], replace=False)
        self.check_ids = sorted(set(pick.tolist()) | set(last))
        self.seen = {k: {} for k in self.check_ids}
        for _ in range(self.mix["warmup_passes"]):
            self._pass(record=False)

    def _pass(self, record=True):
        n, b = len(self.budgets), self.mix["batch_frames"]
        enc = self.encoder(self.codec, self.width, self.height, self.device)
        starts = list(range(0, n, b))
        rows = self.frames
        span = self.span if record else _no_span

        def launch(lo):
            hi = min(lo + b, n)
            t = _now()
            with span("enqueue"):
                h = enc.encode_frames_async([rows[k] for k in range(lo, hi)],
                                            self.budgets[lo:hi])
            return lo, hi, h, t

        pending = launch(0)
        scales = [0] * n
        for i in range(len(starts)):
            nxt = launch(starts[i + 1]) if i + 1 < len(starts) else None
            lo, hi, h, t = pending
            with span("fetch"):
                out = enc.fetch(h)
            if record:
                self.span.record("batch_wait", _now() - t)
            for k in range(lo, hi):
                scales[k] = out[k - lo][1]["quant_scale"]
                seen = self.seen.get(k)
                if record and seen is not None:
                    key = out[k - lo][0].tobytes()
                    seen[key] = seen.get(key, 0) + 1
            pending = nxt
        with span("close"):
            enc.close()
        self.scales = scales
        return n

    def unit(self):
        self.attempted += self._pass()

    def census(self, ctx):
        """The work of a pass for the kernels' roofline, from the frames
        and the scales the window chose: K1 (FDCT and a scale search
        that needs the totals at the chosen scale and the one below it),
        K3 (emission at the chosen scale), K4 (placement into the budget's
        words) and the tail emission (blocks over 256 bits)."""
        scales = torch.tensor(self.scales, device=self.device)
        nz, n_long, long_nz = [], [], []
        for lo in range(0, len(self.budgets), REF_CHUNK * 4):
            f = torch.from_numpy(self.frames[lo:lo + REF_CHUNK * 4]).to(
                self.device)
            a, b_, c = ref_bs.frame_work(f, self.width, self.height,
                                         scales[lo:lo + len(f)])
            nz.append(a)
            n_long.append(b_)
            long_nz.append(c)
        nz, n_long, long_nz = (int(torch.cat(x).sum()) for x in
                               (nz, n_long, long_nz))
        frames = len(self.budgets)
        nb = (self.width // 16) * (self.height // 16) * 6
        evals = sum(1 if s == 1 else 2 for s in self.scales)
        out_words = sum((bgt - 8 + 3) // 4 for bgt in self.budgets)
        work = {
            "select_pix_kernel": roofline.fdct_select_work(frames, nb, nb,
                                                           evals),
            "emit_prep_kernel": roofline.emit_prep_work(
                frames, nb, frames * 64 * nb * 2, nz),
            "emit_tail_kernel": roofline.tail_work(frames, nb, n_long,
                                                   long_nz),
        }
        byts, ops = roofline.place_work(frames, nb + 1, 0)
        work["place_kernel"] = (byts + out_words * roofline.I32, ops)
        ctx.work = {k: (b * ctx.traced_units, o * ctx.traced_units)
                    for k, (b, o) in work.items()}
        ctx.batches_traced = ctx.traced_units * -(-frames //
                                                  self.mix["batch_frames"])

    def release(self):
        self.encoder = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, ids, dct=ref_bs.fdct_islow):
        """The plain reference's buffers of frames ``ids``."""
        out = {}
        for lo in range(0, len(ids), REF_CHUNK):
            part = ids[lo:lo + REF_CHUNK]
            f = torch.from_numpy(self.frames[part]).to(self.device)
            bud = torch.tensor([self.budgets[k] for k in part],
                               device=self.device)
            bufs, _, _ = ref_bs.encode_frames(f, bud, self.width, self.height,
                                           dct=dct)
            for k, buf in zip(part, bufs):
                out[k] = buf.cpu().numpy().tobytes()
        return out

    def check(self):
        """frames_wrong: checked frames any of whose buffers differs from
        the reference's."""
        ref = self.reference(self.check_ids)
        wrong = sum(1 for k in self.check_ids
                    if not self.seen[k] or any(buf != ref[k]
                                               for buf in self.seen[k]))
        return [("frames_wrong", wrong, 0)]

    def control(self):
        """frames_wrong of the control: the reference with a float32 DCT
        in the program's place."""
        ref = self.reference(self.check_ids)
        ctl = self.reference(self.check_ids, dct=ref_bs.fdct_float)
        return [("frames_wrong", sum(ref[k] != ctl[k]
                                     for k in self.check_ids), 0)]


def _now():
    return time.perf_counter()


def _no_span(name):
    return contextlib.nullcontext()
