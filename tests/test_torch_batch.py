"""The port's batch runner (``psxavenc_tpu_torch.batch``) on the CPU: the
grouped run writes the same bytes as the serial run and as psxavenc_tpu's
batch runner, on a fixed mixed job list, on seeded random mixes and in
the streaming tier (whose chunk rounds share device calls); a failing
shared encode fails every job without hanging; a missing input is
reported; ``main`` needs a card unless PSXAVENC_PLATFORM=cpu.

Inputs stay small (the plain ADPCM search costs milliseconds per unit on
the CPU): audio of a few thousand samples, video of 32x32 to 48x48."""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from psxavenc_tpu import batch as jbatch
from psxavenc_tpu.utils.synth import (rand_frames, rand_pcm, write_avi_sized,
                                      write_wav)
from psxavenc_tpu_torch import batch as tbatch

from test_torch_parity import PLAIN_TIERS, plain_tiers

REPO = pathlib.Path(__file__).resolve().parent.parent
DIRS = ("g", "s", "j")   # port grouped, port serial, JAX grouped


def _jobs(tmp_path, specs):
    """specs: (CLI arguments, input path, output basename) -> one job list
    per directory of DIRS, the same basenames in each (.vag headers embed
    them)."""
    out = {}
    for d in DIRS:
        (tmp_path / d).mkdir(exist_ok=True)
        out[d] = [args + [str(src), str(tmp_path / d / name)]
                  for args, src, name in specs]
    return out


def _run_all(jobs):
    with plain_tiers():
        rcs = {"g": tbatch.run_jobs(jobs["g"], group=True, quiet=True,
                                    device="cpu"),
               "s": tbatch.run_jobs(jobs["s"], group=False, quiet=True,
                                    device="cpu")}
    rcs["j"] = jbatch.run_jobs(jobs["j"], group=True, quiet=True)
    return rcs


def _assert_same_bytes(jobs):
    for k in range(len(jobs["g"])):
        data = {d: pathlib.Path(jobs[d][k][-1]).read_bytes() for d in DIRS}
        assert data["g"] == data["s"] == data["j"], jobs["g"][k]
        assert len(data["g"]) > 0


def _mixed_specs(tmp_path):
    a = write_wav(tmp_path / "a.wav", rand_pcm(3100, seed=1), 44100)
    b = write_wav(tmp_path / "b.wav", rand_pcm(2300, seed=2), 44100,
                  loop_start=700)
    st = write_wav(tmp_path / "st.wav", rand_pcm(2600, channels=2, seed=3),
                   37800, channels=2)
    t3 = write_wav(tmp_path / "t3.wav", rand_pcm(2500, channels=3, seed=4),
                   44100, channels=3)
    v = write_avi_sized(tmp_path / "v.avi", 48, 32,
                        rand_frames(48, 32, 6, seed=5), 15)
    w = write_avi_sized(tmp_path / "w.avi", 32, 32,
                        rand_frames(32, 32, 4, seed=6), 15)
    return [
        (["-q", "-t", "vag", "-f", "44100"], a, "a.vag"),
        (["-q", "-t", "spu", "-f", "44100"], b, "b.spu"),
        (["-q", "-t", "vag", "-f", "44100"], b, "b.vag"),
        (["-q", "-t", "xa", "-f", "37800", "-c", "2"], st, "st.xa"),
        (["-q", "-t", "spui", "-f", "44100", "-c", "3"], t3, "t3.spui"),
        (["-q", "-t", "strv", "-s", "48x32"], v, "v.strv"),
        (["-q", "-t", "sbs", "-v", "v3", "-s", "48x32", "-a", "4096"], v,
         "v.sbs"),
        (["-q", "-t", "strv", "-s", "32x32"], w, "w.strv"),
        (["-q", "-t", "sbs", "-v", "v2", "-s", "48x32", "-a", "4096"], v,
         "v2.sbs"),
    ]


def test_batch_matches_serial_and_jax(tmp_path):
    """Grouped == serial == psxavenc_tpu's runner; the grouped run makes
    one K5 call per (filter_count, shift_range) class and one encoder run
    per video class."""
    jobs = _jobs(tmp_path, _mixed_specs(tmp_path))
    rcs = _run_all(jobs)
    assert rcs["g"] == rcs["s"] == rcs["j"] == [0] * len(jobs["g"])
    _assert_same_bytes(jobs)


def test_batch_groups_device_work(tmp_path, capsys):
    """The grouped run's [batch] lines: the SPU files share one audio
    group, XA its own, and the two 48x32 v2 jobs share a video group."""
    jobs = _jobs(tmp_path, _mixed_specs(tmp_path))
    with plain_tiers():
        assert tbatch.run_jobs(jobs["g"], group=True, device="cpu") == \
            [0] * len(jobs["g"])
    err = capsys.readouterr().err
    assert "audio group fc=5 sr=12: 4 jobs, 6 streams" in err, err
    assert "audio group fc=4 sr=12: 1 jobs, 2 streams" in err, err
    assert "video group 48x32 codec=0: 2 jobs" in err, err
    assert "9/9 jobs succeeded" in err, err


def test_batch_requests_hold_int16_samples(tmp_path, monkeypatch):
    """Every request the planning pass captures holds the container's
    samples as (B, N) int16, (B, T) int32 offsets and clipped int32
    limits, and no (B, T, 28) tensor; the group's int16 rows gathered from
    it are the int32 units K5 reads. A sample outside s16 raises."""
    from psxavenc_tpu_torch.ops import adpcm_cuda

    jobs = _jobs(tmp_path, _mixed_specs(tmp_path))
    reqs = []
    real = tbatch._request

    def spy(*a):
        reqs.append(real(*a))
        return reqs[-1]

    monkeypatch.setattr(tbatch, "_request", spy)
    with plain_tiers():
        assert tbatch.run_jobs(jobs["g"], group=True, quiet=True,
                               device="cpu") == [0] * len(jobs["g"])
    assert len(reqs) == 5
    for r in reqs:
        B, T = r["lim"].shape
        assert r["pcm"].dtype == torch.int16 and r["pcm"].shape[0] == B
        assert r["offsets"].dtype == r["lim"].dtype == torch.int32
        assert r["offsets"].shape == (B, T)
        assert int(r["lim"].min()) >= -(1 << 30) and int(r["lim"].max()) <= 28
        assert not [v for v in r.values()
                    if torch.is_tensor(v) and v.ndim == 3]
        rows = torch.zeros((B + 1, T + 2, 28), dtype=torch.int16)
        adpcm_cuda.gather_units_plain(r["pcm"], r["offsets"], T,
                                      out=rows[1:, :T])
        assert torch.equal(rows[1:, :T].to(torch.int32),
                           adpcm_cuda.gather_units_plain(
                               r["pcm"].to(torch.int32), r["offsets"], T))
        assert not rows[0].any() and not rows[:, T:].any()
    with pytest.raises(ValueError, match="s16"):
        real(np.array([[0, 40000]], np.int32), np.array([[0]]),
             np.array([[2]]), 5, 12, None, None)


@pytest.mark.parametrize("seed", range(3))
def test_batch_fuzz_matches_serial_and_jax(tmp_path, seed):
    """Seeded random job mixes (formats x rates x channels x lengths,
    audio and video together), as tests/test_batch_runner.py draws them
    at smaller sizes."""
    rng = np.random.default_rng(7700 + seed)
    specs = []
    for k in range(int(rng.integers(4, 8))):
        kind = str(rng.choice(["vag", "spu", "xa", "spui", "strv"]))
        name = f"j{k}"
        if kind == "strv":
            w, h = 16 * int(rng.integers(2, 4)), 16 * int(rng.integers(2, 4))
            src = write_avi_sized(
                tmp_path / f"{name}.avi", w, h,
                rand_frames(w, h, int(rng.integers(2, 6)),
                            seed=7800 + 10 * seed + k), 15)
            args = ["-q", "-t", "strv", "-s", f"{w}x{h}"]
        else:
            rate = int(rng.choice([18900, 37800])) if kind == "xa" \
                else int(rng.choice([18900, 22050, 37800, 44100]))
            ch = 2 if kind == "xa" else (
                int(rng.integers(1, 4)) if kind == "spui" else 1)
            n = int(rng.integers(500, 3000))
            src = write_wav(tmp_path / f"{name}.wav",
                            rand_pcm(n, channels=ch,
                                     seed=7850 + 10 * seed + k),
                            rate, channels=ch)
            args = ["-q", "-t", kind, "-f", str(rate)]
            if kind in ("xa", "spui"):
                args += ["-c", str(ch)]
        specs.append((args, src, name))
    jobs = _jobs(tmp_path, specs)
    rcs = _run_all(jobs)
    assert rcs["g"] == rcs["s"] == rcs["j"] == [0] * len(specs)
    _assert_same_bytes(jobs)


@pytest.fixture
def streaming(monkeypatch):
    """The streaming ingest tier with small chunks, so each job's chunk
    feed runs several rounds (in both packages)."""
    from psxavenc_tpu.containers import vag as jvag
    from psxavenc_tpu.containers import xa as jxa
    from psxavenc_tpu_torch.containers import vag as tvag
    from psxavenc_tpu_torch.containers import xa as txa

    monkeypatch.setenv("PSXAVENC_STREAMING", "1")
    for mod in (jvag, tvag):
        monkeypatch.setattr(mod, "SPU_CHUNK_BLOCKS", 32)
    for mod in (jxa, txa):
        monkeypatch.setattr(mod, "AUDIO_CHUNK_SECTORS_SOLO", 1)


def test_batch_streaming_tier_shares_rounds(tmp_path, streaming, capsys):
    specs = []
    for k, n in enumerate((3011, 2473, 1890)):
        wav = write_wav(tmp_path / f"a{k}.wav", rand_pcm(n, seed=40 + k),
                        44100)
        specs.append((["-q", "-t", "vag", "-f", "44100"], wav, f"a{k}.vag"))
    st = write_wav(tmp_path / "st.wav", rand_pcm(4100, channels=2, seed=44),
                   37800, channels=2)
    specs.append((["-t", "xa", "-f", "37800", "-c", "2"], st, "o.xa"))
    jobs = _jobs(tmp_path, specs)
    with plain_tiers():
        rcs_g = tbatch.run_jobs(jobs["g"], group=True, device="cpu")
        err = capsys.readouterr().err
        rcs_s = tbatch.run_jobs(jobs["s"], group=False, quiet=True,
                                device="cpu")
    rcs_j = jbatch.run_jobs(jobs["j"], group=True, quiet=True)
    assert rcs_g == rcs_s == rcs_j == [0] * len(specs)
    _assert_same_bytes(jobs)
    assert "streaming tier: 4 jobs" in err, err
    assert "shared a device call" in err, err


def test_batch_streaming_flush_failure_does_not_hang(tmp_path, streaming,
                                                     monkeypatch):
    """A failing shared encode fails every waiting streaming job (rc 1)
    instead of leaving their threads blocked on unfinished slots."""
    def boom(reqs, device, quiet=False):
        raise RuntimeError("device unavailable (simulated)")

    monkeypatch.setattr(tbatch, "_encode_audio_groups", boom)
    jobs = []
    for k in range(3):
        wav = write_wav(tmp_path / f"a{k}.wav", rand_pcm(2011, seed=60 + k),
                        44100)
        jobs.append(["-q", "-t", "vag", "-f", "44100", str(wav),
                     str(tmp_path / f"a{k}.vag")])
    result = {}

    def run():
        result["rcs"] = tbatch.run_jobs(jobs, group=True, quiet=True,
                                        device="cpu")

    with plain_tiers():
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive(), "batch runner hung after a flush failure"
    assert result["rcs"] == [1, 1, 1]


@pytest.mark.parametrize("group", ["1", "0"])
def test_batch_reports_failures(tmp_path, monkeypatch, capsys, group):
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    monkeypatch.setenv("PSXAVENC_BATCH_GROUP", group)
    for k, v in PLAIN_TIERS.items():
        monkeypatch.setenv(k, v)
    wav = write_wav(tmp_path / "a.wav", rand_pcm(600, seed=9), 44100)
    jobs = tmp_path / "jobs.txt"
    jobs.write_text(f"-q -t vag {tmp_path}/missing.wav {tmp_path}/x.vag\n"
                    f"-q -t vag -f 44100 {wav} {tmp_path}/a.vag\n")
    assert tbatch.main([str(jobs)]) == 1
    err = capsys.readouterr().err
    assert "[1/2]" in err and "FAILED (1)" in err, err
    assert "[2/2]" in err and ": ok" in err, err
    assert (tmp_path / "a.vag").stat().st_size > 0


def test_main_needs_a_card_unless_cpu(tmp_path, monkeypatch, capsys):
    """Without PSXAVENC_PLATFORM the device is the card; with none the
    runner exits 1 before any job. ``python -m psxavenc_tpu_torch.batch``
    with PSXAVENC_PLATFORM=cpu runs the jobs without importing JAX."""
    wav = write_wav(tmp_path / "a.wav", rand_pcm(700, seed=8), 44100)
    out = tmp_path / "a.vag"
    jobs = tmp_path / "jobs.txt"
    jobs.write_text(f"-q -t vag -f 44100 {wav} {out}\n")
    monkeypatch.delenv("PSXAVENC_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbatch.main([str(jobs)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()

    runner = ("import sys\n"
              "from psxavenc_tpu_torch import batch\n"
              "rc = batch.main(sys.argv[1:])\n"
              "assert 'jax' not in sys.modules, 'jax was imported'\n"
              "sys.exit(rc)\n")
    env = dict(os.environ, PSXAVENC_PLATFORM="cpu", OMP_NUM_THREADS="1",
               **PLAIN_TIERS)
    proc = subprocess.run([sys.executable, "-c", runner, str(jobs)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = tmp_path / "j" / "a.vag"
    want.parent.mkdir()
    assert jbatch.run_jobs([["-q", "-t", "vag", "-f", "44100", str(wav),
                             str(want)]], quiet=True) == [0]
    assert out.read_bytes() == want.read_bytes()
