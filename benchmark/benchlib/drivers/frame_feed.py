"""Driver ``frame_feed``: ``video_feed``'s closed loop (one
``BsFrameEncoder`` a pass over the movie, batches of ``batch_frames``
frames with their schedule budgets enqueued one ahead of ``fetch``) in the
configuration's codec, BS v2 or v3, on the traffic's ``content``:
``movie`` (``benchlib/traffic.py``'s synthetic movie) or ``noise`` (every
frame uniform random NV21 bytes from the seed).

The check holds the frames drawn from the seed and the padded last batch,
byte for byte, to the codec's plain reference: ``benchref/bs_v3.py`` for
v3, ``benchref/bs.py`` for v2. The control breaks one guarantee: for v3
one DC predictor shared by the three block types, for v2 the float32 DCT.
The census counts the codec's DC bits in each block's length, and K2's
work (``dc_chain_kernel``) where the codec is v3."""

import numpy as np
import torch

from benchref import bs as ref_bs
from benchref import bs_v3 as ref_v3

from .. import pacing, roofline, roofline_dc, spec, traffic
from . import video_feed

CODECS = {"v2": 0, "v3": 1}
NOISE_STREAM = 3
CENSUS_CHUNK = 64


def noise(seed, n_frames, width, height, device):
    """(n_frames, w*h*3/2) uint8 frames of uniform random bytes drawn from
    the seed on ``device``, returned as one host array of consecutive
    rows."""
    g = traffic.generator(seed, device, NOISE_STREAM)
    size = width * height * 3 // 2
    out = np.empty((n_frames, size), np.uint8)
    for lo in range(0, n_frames, traffic.CHUNK):
        k = min(traffic.CHUNK, n_frames - lo)
        out[lo:lo + k] = torch.randint(0, 256, (k, size), generator=g,
                                       device=device,
                                       dtype=torch.uint8).cpu().numpy()
    return out


class Driver(video_feed.Driver):
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
        if self.mix["content"] == "noise":
            self.frames = noise(self.seed, n, self.width, self.height,
                                self.device)
        else:
            self.frames = traffic.movie(
                self.seed, n, self.width, self.height, self.device,
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

    def census(self, ctx):
        """``video_feed``'s census of a pass (K1, K3, K4 and the tail
        emission, from the frames and the scales the window chose), its
        blocks' lengths counted with the codec's DC codes, and for v3 K2
        over the pass's frames (``benchlib/roofline_dc.py``)."""
        frame_work = ref_v3.frame_work if self.codec else ref_bs.frame_work
        scales = torch.tensor(self.scales, device=self.device)
        nz = n_long = long_nz = 0
        for lo in range(0, len(self.budgets), CENSUS_CHUNK):
            f = torch.from_numpy(self.frames[lo:lo + CENSUS_CHUNK]).to(
                self.device)
            a, b_, c = frame_work(f, self.width, self.height,
                                  scales[lo:lo + len(f)])
            nz += int(a.sum())
            n_long += int(b_.sum())
            long_nz += int(c.sum())
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
        if self.codec:
            work["dc_chain_kernel"] = roofline_dc.dc_work(frames, nb)
        ctx.work = {k: (b * ctx.traced_units, o * ctx.traced_units)
                    for k, (b, o) in work.items()}
        ctx.batches_traced = ctx.traced_units * -(-frames //
                                                  self.mix["batch_frames"])

    def reference(self, ids, dct=ref_bs.fdct_islow, shared=False):
        """The codec's plain reference's buffers of frames ``ids``;
        ``shared`` (v3 only) runs its chain on one DC predictor."""
        if not self.codec:
            return super().reference(ids, dct)
        out = {}
        for lo in range(0, len(ids), video_feed.REF_CHUNK):
            part = ids[lo:lo + video_feed.REF_CHUNK]
            f = torch.from_numpy(self.frames[part]).to(self.device)
            bud = torch.tensor([self.budgets[k] for k in part],
                               device=self.device)
            bufs = ref_v3.encode_frames(f, bud, self.width, self.height,
                                        dct=dct, shared=shared)[0]
            for k, buf in zip(part, bufs):
                out[k] = buf.cpu().numpy().tobytes()
        return out

    def control(self):
        """frames_wrong of the control: for v3 the reference with one DC
        predictor for all three block types, for v2 ``video_feed``'s (a
        float32 DCT)."""
        if not self.codec:
            return super().control()
        ref = self.reference(self.check_ids)
        ctl = self.reference(self.check_ids, shared=True)
        return [("frames_wrong", sum(ref[k] != ctl[k]
                                     for k in self.check_ids), 0)]
