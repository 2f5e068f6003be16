"""Driver ``job_list``: a list of audio files through the program's batch
runner, ``batch.run_jobs``, list after list, as a sound designer's job
list runs.

Set-up writes the mix's clips as WAV files under the run's temporary
directory; every list encodes all of them into the same output files,
overwriting the last list's. A unit is one list. After each list the
files drawn from the seed for that list are read back and kept; after
the window the plain reference works every file out again from the
clips' samples, and each file read back, and every file of the last
list, is compared byte for byte."""

import os
import struct

import numpy as np
import torch

from benchref import adpcm as ref_adpcm

from .. import roofline, spec, traffic

ADPCM_KERNELS = "adpcm_"


def write_wav(path, pcm, rate):
    """A mono PCM s16le WAV."""
    data = np.asarray(pcm, "<i2").tobytes()
    fmt = struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
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
        self.lists = 0
        self.read_back = []
        self.launches = 0

    def setup(self):
        self.batch = spec.program("psxavenc_tpu_torch.batch")
        self.counts = spec.program(
            "psxavenc_tpu_torch.ops.adpcm_cuda").LAUNCHES
        rate = self.cfg["audio_frequency"]
        lengths = traffic.clip_lengths(self.mix, rate)
        self.clips, _ = traffic.clips(self.seed, lengths, rate, self.device)
        os.makedirs(os.path.join(self.tmp, "in"))
        os.makedirs(os.path.join(self.tmp, "out"))
        self.outputs, self.jobs = [], []
        for k, pcm in enumerate(self.clips):
            src = os.path.join(self.tmp, "in", f"clip{k:03d}.wav")
            dst = os.path.join(self.tmp, "out", f"clip{k:03d}.vag")
            write_wav(src, pcm, rate)
            self.outputs.append(dst)
            self.jobs.append(["-q", "-t", self.cfg["format"], "-f",
                              str(rate), src, dst])
        self.list_samples = sum(len(c) for c in self.clips)
        self.list_units = sum(-(-len(c) // ref_adpcm.UNIT)
                              for c in self.clips)
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        for _ in range(self.mix["warmup_lists"]):
            self._list()

    def _list(self):
        rcs = self.batch.run_jobs(self.jobs, group=self.mix["group"],
                                  quiet=True, device=self.device)
        return sum(1 for rc in rcs if rc != 0)

    def unit(self):
        before = self.counts["adpcm_encode_units"]
        with self.span("run_jobs"):
            failed = self._list()
        self.launches += self.counts["adpcm_encode_units"] - before
        self.failed += failed
        self.attempted += len(self.jobs)
        self.lists += 1
        with self.span("read_back"):
            for k in self.rng.choice(len(self.jobs),
                                     self.mix["read_back_files"],
                                     replace=False):
                with open(self.outputs[k], "rb") as f:
                    self.read_back.append((int(k), f.read()))

    def census(self, ctx):
        """K5's work for a list: every unit of every clip through the
        filters' candidates, one stream a clip."""
        byts, ops = roofline.adpcm_work(1, self.list_units,
                                        ref_adpcm.SPU_FILTERS, 4)
        byts += 2 * roofline.I32 * (len(self.clips) - 1)
        ctx.work = {ADPCM_KERNELS: (byts * ctx.traced_units,
                                    ops * ctx.traced_units)}

    def release(self):
        self.batch = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rounds=None):
        """The plain reference's bytes of every output file."""
        return ref_adpcm.vag_files(
            [torch.from_numpy(c) for c in self.clips], self.outputs,
            self.cfg["audio_frequency"], rounds=rounds, device=self.device)

    def check(self):
        """files_wrong: files of which a read-back, or the last list's
        output, differs from the reference's bytes."""
        ref = self.reference()
        got = list(self.read_back)
        for k, path in enumerate(self.outputs):
            with open(path, "rb") as f:
                got.append((k, f.read()))
        wrong = {k for k, data in got if data != ref[k]}
        return [("files_wrong", len(wrong), 0)]

    def control(self):
        """files_wrong of the control: the reference's segments encoded
        from guessed start states and never repaired."""
        ref, ctl = self.reference(), self.reference(rounds=1)
        return [("files_wrong", sum(a != b for a, b in zip(ref, ctl)), 0)]
