"""The plain references agree with the program's CPU path at tiny sizes:
BS v2 frames through BsFrameEncoder (its native tier and its plain torch
tier), .vag files through the batch runner and .str files through the
CLI."""

import os

import numpy as np
import pytest
import torch

from benchlib import pacing, traffic
from benchlib.drivers.job_list import write_wav
from benchref import adpcm as ref_adpcm
from benchref import bs as ref_bs

W, H = 48, 32


def _frames(seed, n, noise):
    f = traffic.movie(seed, n, W, H, "cpu", scene_frames=3)
    if noise:   # some frames of noise: escapes and blocks over 256 bits
        rng = np.random.default_rng(seed)
        f[::3] = rng.integers(0, 256, f[::3].shape, dtype=np.uint8)
    return f


@pytest.mark.parametrize("tier", ["native", "device"])
@pytest.mark.parametrize("seed,noise", [(3, False), (2**32 + 9, True)])
def test_frames_equal_the_program(monkeypatch, tier, seed, noise):
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    monkeypatch.setenv("PSXAVENC_VIDEO_TIER", tier)
    frames = _frames(seed, 9, noise)
    budgets = [600, 2016, 900, 1500, 4032, 700, 800, 1200, 3000]
    got = BsFrameEncoder(0, W, H, "cpu").encode_frames(list(frames), budgets)
    ref, scales, used = ref_bs.encode_frames(torch.from_numpy(frames),
                                       torch.tensor(budgets), W, H)
    for (buf, info), r, s, u in zip(got, ref, scales, used):
        assert info["quant_scale"] == int(s)
        assert info["bytes_used"] == u
        assert buf.tobytes() == r.numpy().tobytes()


def test_str_budgets_frames_equal_the_program():
    from psxavenc_tpu_torch.models.bs_video import BsFrameEncoder
    cfg = {"audio_frequency": 37800, "audio_channels": 2,
           "audio_bit_depth": 4, "cd_speed": 2, "fps_num": 15,
           "fps_den": 1, "sector_payload_bytes": 2016}
    budgets = [b // 40 for b in pacing.frame_budgets(cfg, 6)]
    frames = _frames(11, 6, False)
    got = BsFrameEncoder(0, W, H, "cpu").encode_frames(list(frames), budgets)
    ref, _, _ = ref_bs.encode_frames(torch.from_numpy(frames),
                                     torch.tensor(budgets), W, H)
    assert [b.tobytes() for b, _ in got] == [r.numpy().tobytes()
                                             for r in ref]


def test_vag_files_equal_the_program(tmp_path):
    from psxavenc_tpu_torch import batch
    lengths = [1, 27, 28, 29, 100, 3000, 9000]
    clips, _ = traffic.clips(17, lengths, 44100, "cpu")
    jobs, outs = [], []
    for k, pcm in enumerate(clips):
        src, dst = tmp_path / f"c{k}.wav", str(tmp_path / f"c{k}.vag")
        write_wav(str(src), pcm, 44100)
        jobs.append(["-q", "-t", "vag", "-f", "44100", str(src), dst])
        outs.append(dst)
    assert batch.run_jobs(jobs, quiet=True, device="cpu") == [0] * len(jobs)
    ref = ref_adpcm.vag_files([torch.from_numpy(c) for c in clips], outs,
                              44100)
    for path, r in zip(outs, ref):
        with open(path, "rb") as f:
            assert f.read() == r, os.path.basename(path)


@pytest.mark.parametrize("n_frames,extra", [(30, 0), (47, 1234),
                                             (61, -5000)])
def test_str_files_equal_the_cli(monkeypatch, tmp_path, n_frames, extra):
    """The whole .str file, the CLI in process on the CPU: retiming,
    schedule, frames, XA sectors, the persistent buffer and the EDC."""
    from psxavenc_tpu_torch import cli

    from benchref import strmux
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    frames = traffic.movie(n_frames, n_frames, W, H, "cpu", scene_frames=7)
    n = n_frames * 37800 // 15 + extra
    tracks, _ = traffic.clips(n_frames, [n, n], 37800, "cpu")
    pcm = np.stack(tracks, 1)
    src, dst = str(tmp_path / "m.avi"), str(tmp_path / "m.str")
    traffic.write_avi(src, frames, W, H, 15, pcm, 37800)
    assert cli.main(["-q", "-t", "str", "-x", "2", "-v", "v2", "-f", "37800",
                     "-c", "2", "-s", f"{W}x{H}", src, dst]) == 0
    cfg = dict(width=W, height=H, fps_num=15, fps_den=1, cd_speed=2,
               audio_frequency=37800, audio_channels=2, audio_bit_depth=4)
    with open(dst, "rb") as f:
        assert f.read() == strmux.str_file(cfg, frames, pcm, "cpu")


@pytest.mark.parametrize("segment", [1, 3, 64])
def test_segments_reach_the_serial_answer(segment):
    """Any segment length gives the same units: the fixed point is the
    serial walk (segment 1 is the serial walk itself, unit by unit)."""
    clips, _ = traffic.clips(5, [900, 1700], 44100, "cpu")
    units, limits, first = [], [], []
    for c in clips:
        n, lim = ref_adpcm.spu_layout(len(c))
        u = torch.zeros(n * 28, dtype=torch.int64)
        u[:len(c)] = torch.from_numpy(c.astype(np.int64))
        units.append(u.reshape(n, 28))
        limits.append(torch.tensor(lim))
        f = torch.zeros(n, dtype=torch.bool)
        f[0] = True
        first.append(f)
    args = (torch.cat(units), torch.cat(limits), torch.cat(first))
    h, nb = ref_adpcm.encode_streams(*args, segment=segment)
    h1, nb1 = ref_adpcm.encode_streams(*args, segment=1)
    assert torch.equal(h, h1) and torch.equal(nb, nb1)
