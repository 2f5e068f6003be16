"""Driver ``cli_movie``: a whole ``-t str`` encode through the program's
CLI entry, in process, movie after movie, as an FMV user runs it.

Set-up writes the movie once as an AVI under the run's temporary
directory: the traffic's frames as raw I420 at the configuration's frame
rate and a stereo track made from the seed. A unit is one encode of it
into the same .str file, overwriting the last. After the movies drawn
from the seed (and after the last one) the file is read back and its
digest kept; after the window the plain reference writes the .str file
again from the same frames and samples, and every digest is compared."""

import hashlib
import os

import numpy as np
import torch

from benchref import bs as ref_bs
from benchref import strmux

from .. import spec, traffic


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Driver:
    def __init__(self, cell, seed, device, tmp, spans):
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device = device
        self.tmp = tmp
        self.span = spans
        self.attempted = self.failed = 0
        self.movies = 0
        self.digests = []

    def setup(self):
        self.cli = spec.program("psxavenc_tpu_torch.cli")
        cfg = self.cfg
        w, h = cfg["width"], cfg["height"]
        n = int(round(self.mix["movie_seconds"] * cfg["fps_num"]
                      / cfg["fps_den"]))
        self.frames = traffic.movie(self.seed, n, w, h, self.device,
                                    scene_frames=self.mix["scene_frames"])
        rate = cfg["audio_frequency"]
        samples = n * rate * cfg["fps_den"] // cfg["fps_num"]
        tracks, _ = traffic.clips(self.seed, [samples] * 2, rate,
                                  self.device)
        self.pcm = np.stack(tracks, 1)
        self.source = os.path.join(self.tmp, "movie.avi")
        self.output = os.path.join(self.tmp, "movie.str")
        traffic.write_avi(self.source, self.frames, w, h, cfg["fps_num"],
                          self.pcm, rate)
        self.argv = ["-q", "-t", cfg["format"], "-x", str(cfg["cd_speed"]),
                     "-v", cfg["codec"], "-f", str(rate), "-c",
                     str(cfg["audio_channels"]), "-s", f"{w}x{h}",
                     self.source, self.output]
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        for _ in range(self.mix["warmup_movies"]):
            self.cli.main(self.argv)

    def unit(self):
        with self.span("cli"):
            rc = self.cli.main(self.argv)
        self.failed += rc != 0
        self.attempted += 1
        self.movies += 1
        if self.rng.random() < self.mix["check_share"]:
            with self.span("read_back"):
                self.digests.append(_digest(self.output))

    def census(self, ctx):
        """The video batches of the traced movies (128 frames each)."""
        ctx.batches_traced = ctx.traced_units * len(self.frames) / 128

    def release(self):
        self.cli = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dct=ref_bs.fdct_islow, rounds=None):
        return hashlib.sha256(strmux.str_file(
            self.cfg, self.frames, self.pcm, self.device,
            src_fps=(self.cfg["fps_num"], self.cfg["fps_den"]), dct=dct,
            rounds=rounds)).hexdigest()

    def check(self):
        """movies_wrong: movies read back whose bytes differ from the
        reference's, the last one included."""
        ref = self.reference()
        got = self.digests + [_digest(self.output)]
        return [("movies_wrong", sum(d != ref for d in got), 0)]

    def control(self):
        """movies_wrong of the control: the reference with a float32 DCT
        in the program's place."""
        return [("movies_wrong",
                 int(self.reference(dct=ref_bs.fdct_float)
                     != self.reference()), 0)]
