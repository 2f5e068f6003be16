"""PSXAVENC_PROFILE in the port's CLI (PSXAVENC_PLATFORM=cpu): the job runs
under torch.profiler and a Chrome trace lands in the named directory,
with "Profile written to DIR" on stderr unless -q; the output bytes are
those of a run without the profiler, and a failing job writes its trace
too."""

import json

import pytest

from psxavenc_tpu.utils.synth import rand_pcm, write_wav
from psxavenc_tpu_torch import cli

from test_torch_parity import PLAIN_TIERS


@pytest.fixture
def wav(tmp_path, monkeypatch):
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    monkeypatch.delenv("PSXAVENC_PROFILE", raising=False)
    for k, v in PLAIN_TIERS.items():
        monkeypatch.setenv(k, v)
    return write_wav(tmp_path / "in.wav", rand_pcm(1500, seed=5), 44100)


def _vag(wav, out, quiet):
    argv = (["-q"] if quiet else []) + ["-t", "vag", "-f", "44100", str(wav),
                                        str(out)]
    return cli.main(argv)


@pytest.mark.parametrize("quiet", [False, True])
def test_profile_writes_a_trace(wav, tmp_path, monkeypatch, capsys, quiet):
    (tmp_path / "plain").mkdir()
    (tmp_path / "prof").mkdir()
    assert _vag(wav, tmp_path / "plain" / "out.vag", quiet) == 0
    capsys.readouterr()
    prof_dir = tmp_path / "profile"
    monkeypatch.setenv("PSXAVENC_PROFILE", str(prof_dir))
    assert _vag(wav, tmp_path / "prof" / "out.vag", quiet) == 0
    err = capsys.readouterr().err
    traces = list(prof_dir.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    line = f"Profile written to {prof_dir}"
    assert (line in err) != quiet
    assert (tmp_path / "prof" / "out.vag").read_bytes() == \
        (tmp_path / "plain" / "out.vag").read_bytes()


def test_a_failing_job_writes_its_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PSXAVENC_PLATFORM", "cpu")
    prof_dir = tmp_path / "profile"
    monkeypatch.setenv("PSXAVENC_PROFILE", str(prof_dir))
    rc = cli.main(["-t", "vag", str(tmp_path / "missing.wav"),
                   str(tmp_path / "out.vag")])
    assert rc == 1
    assert len(list(prof_dir.glob("trace_*.json"))) == 1
    err = capsys.readouterr().err
    assert "Failed to open input file" in err
    assert f"Profile written to {prof_dir}" in err
