"""Driver ``cli_tone``: ``cli_track``'s whole ``-t xa`` encodes, track after
track, of another master: a loud steady tone, on which encodes of K5's
segments started from guessed states never meet the serial encode's, so
its serial walk re-encodes nearly every unit, as with sustained pure tones
in game music (chiptune leads, test and calibration tracks).

The master is ``track_seconds`` of 44,100 Hz stereo s16, a sine of
``frequency`` Hz at ``amplitude`` on both channels, each channel's start
phase drawn from the seed (``tone_master``). On such a track the plain
reference's segmented passes settle one segment a pass, far too slowly
for a run, so the check holds the last .xa file to the serial encoder
with ``benchref/xa_serial.py`` (the file's units, each encoded again from
the state the file decodes to before it) and compares every digest with
the file that reference writes. The control is the reference's segments
from guessed states, never repaired (``benchref/xa.py`` with
``rounds=1``), put through the same check."""

import hashlib
import os

import numpy as np

from benchref import xa as ref_xa
from benchref import xa_serial

from .. import spec
from . import cli_track


def tone_master(seed, frames, rate, frequency, amplitude):
    """(frames, 2) int16: a sine of ``frequency`` Hz at ``amplitude`` at
    ``rate`` on two channels, their start phases in [0, 2 pi) drawn from
    ``seed``."""
    rng = np.random.default_rng([seed % (1 << 63), 2])
    phase = rng.uniform(0.0, 2 * np.pi, 2)
    t = np.arange(frames, dtype=np.float64)[:, None] / rate
    x = amplitude * np.sin(2 * np.pi * frequency * t + phase[None, :])
    return np.round(x).astype(np.int16)


class Driver(cli_track.Driver):
    def setup(self):
        self.cli = spec.program("psxavenc_tpu_torch.cli")
        cfg, mix = self.cfg, self.mix
        ref_xa.check_config(cfg)
        rate = cfg["master_frequency"]
        self.frames = int(round(mix["track_seconds"] * rate))
        self.master = tone_master(self.seed, self.frames, rate,
                                  mix["frequency"], mix["amplitude"])
        self.source = os.path.join(self.tmp, "track.wav")
        self.output = os.path.join(self.tmp, "track.xa")
        cli_track.write_wav(self.source, self.master, rate)
        self.argv = ["-q", "-t", cfg["format"], self.source, self.output]
        self.units = ref_xa.UNITS_A_SECTOR * len(ref_xa.sector_lengths(
            ref_xa.resampled_length(self.frames)))
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        for _ in range(mix["warmup_tracks"]):
            self.cli.main(self.argv)

    def reference(self, data):
        """The digest of the reference's file for the program's file
        ``data``, or None where a unit of ``data`` is not the serial
        encoder's (then no file is the reference's)."""
        ref = xa_serial.xa_file_checked(self.cfg, self.master, data,
                                        self.device)
        return None if ref is None else hashlib.sha256(ref).hexdigest()

    def check(self):
        """tracks_wrong: tracks read back whose bytes differ from the
        reference's, the last one included; all of them where the last
        file fails the check."""
        with open(self.output, "rb") as f:
            last = f.read()
        ref = self.reference(last)
        got = self.digests + [hashlib.sha256(last).hexdigest()]
        return [("tracks_wrong", sum(d != ref for d in got), 0)]

    def control(self):
        """tracks_wrong of the control: the reference's ADPCM segments
        encoded from guessed start states and never repaired, checked as
        the program's file is."""
        ctl = ref_xa.xa_file(self.cfg, self.master, self.device, rounds=1)
        return [("tracks_wrong",
                 int(self.reference(ctl) != hashlib.sha256(ctl)
                     .hexdigest()), 0)]
