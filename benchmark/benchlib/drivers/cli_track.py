"""Driver ``cli_track``: a whole ``-t xa`` encode of a CD-quality master
through the program's CLI entry, in process, track after track, as a
game's music is made into .xa background tracks.

Set-up writes the master once as a 44,100 Hz stereo s16 WAV under the
run's temporary directory: one tonal channel and one of noise bursts,
made from the seed. A unit is one encode of it with every XA option at
its default, into the same .xa file, overwriting the last. After the
tracks drawn from the seed (and after the last one) the file is read back
and its digest kept; after the window the plain reference writes the .xa
file again from the master, and every digest is compared."""

import hashlib
import os
import struct

import numpy as np
import torch

from benchref import strmux
from benchref import xa as ref_xa

from .. import roofline, spec, traffic

ADPCM_KERNELS = "adpcm_"


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_wav(path, pcm, rate):
    """An (n, channels) PCM s16le WAV."""
    pcm = np.ascontiguousarray(pcm, "<i2")
    ch = pcm.shape[1]
    data = pcm.tobytes()
    fmt = struct.pack("<IHHIIHH", 16, 1, ch, rate, rate * 2 * ch, 2 * ch,
                      16)
    body = b"WAVE" + b"fmt " + fmt + b"data" + struct.pack("<I", len(data)) \
        + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


class Driver:
    def __init__(self, cell, seed, device, tmp, spans):
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device = device
        self.tmp = tmp
        self.span = spans
        self.attempted = self.failed = 0
        self.tracks = 0
        self.digests = []

    def setup(self):
        self.cli = spec.program("psxavenc_tpu_torch.cli")
        cfg = self.cfg
        ref_xa.check_config(cfg)
        rate = cfg["master_frequency"]
        self.frames = int(round(self.mix["track_seconds"] * rate))
        channels, _ = traffic.clips(self.seed, [self.frames] * 2, rate,
                                    self.device)
        self.master = np.stack(channels, 1)
        self.source = os.path.join(self.tmp, "track.wav")
        self.output = os.path.join(self.tmp, "track.xa")
        write_wav(self.source, self.master, rate)
        self.argv = ["-q", "-t", cfg["format"], self.source, self.output]
        self.units = ref_xa.UNITS_A_SECTOR * len(ref_xa.sector_lengths(
            ref_xa.resampled_length(self.frames)))
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        for _ in range(self.mix["warmup_tracks"]):
            self.cli.main(self.argv)

    def unit(self):
        with self.span("cli"):
            rc = self.cli.main(self.argv)
        self.failed += rc != 0
        self.attempted += 1
        self.tracks += 1
        if self.rng.random() < self.mix["check_share"]:
            with self.span("read_back"):
                self.digests.append(_digest(self.output))

    def census(self, ctx):
        """K5's work for a track: every unit of both channels' streams
        through XA's four filters' candidates."""
        byts, ops = roofline.adpcm_work(2, self.units, strmux.XA_FILTERS,
                                        4)
        ctx.work = {ADPCM_KERNELS: (byts * ctx.traced_units,
                                    ops * ctx.traced_units)}

    def release(self):
        self.cli = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rounds=None):
        return hashlib.sha256(ref_xa.xa_file(
            self.cfg, self.master, self.device, rounds=rounds)).hexdigest()

    def check(self):
        """tracks_wrong: tracks read back whose bytes differ from the
        reference's, the last one included."""
        ref = self.reference()
        got = self.digests + [_digest(self.output)]
        return [("tracks_wrong", sum(d != ref for d in got), 0)]

    def control(self):
        """tracks_wrong of the control: the reference's ADPCM segments
        encoded from guessed start states and never repaired."""
        return [("tracks_wrong",
                 int(self.reference(rounds=1) != self.reference()), 0)]
