"""``python -m psxavenc_tpu_torch.cli`` (PSXAVENC_PLATFORM=cpu) writes the
same -t sbs and -t strv bytes as psxavenc_tpu.cli, without importing
JAX; unported formats and a missing card exit 1."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from psxavenc_tpu import cli as jcli
from psxavenc_tpu.utils.synth import rand_frames, write_avi_sized
from psxavenc_tpu_torch import cli as tcli

REPO = pathlib.Path(__file__).resolve().parent.parent

# Runs the port's CLI and fails if anything imported JAX.
_RUNNER = ("import sys\n"
           "from psxavenc_tpu_torch import cli\n"
           "rc = cli.main(sys.argv[1:])\n"
           "assert 'jax' not in sys.modules, 'jax was imported'\n"
           "sys.exit(rc)\n")


@pytest.fixture(scope="module")
def avi(tmp_path_factory):
    path = tmp_path_factory.mktemp("avi") / "in.avi"
    write_avi_sized(path, 48, 32, rand_frames(48, 32, 12, seed=6), 15)
    return path


@pytest.mark.parametrize("argv", [["-t", "sbs", "-v", "v3dc"],
                                  ["-t", "strv", "-v", "v2"]])
def test_cli_matches_jax_cli(avi, tmp_path, argv):
    want = tmp_path / "jax.out"
    got = tmp_path / "torch.out"
    assert jcli.main(["-q", *argv, str(avi), str(want)]) == 0
    env = dict(os.environ, PSXAVENC_PLATFORM="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, "-q", *argv, str(avi), str(got)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert got.read_bytes() == want.read_bytes()
    assert len(want.read_bytes()) > 0


def test_unported_format_exits_1(avi, tmp_path, capsys):
    out = tmp_path / "x.xa"
    assert tcli.main(["-t", "xa", str(avi), str(out)]) == 1
    assert "not yet ported to the torch backend" in capsys.readouterr().err
    assert not out.exists()


def test_no_card_exits_1(avi, tmp_path, monkeypatch, capsys):
    """The default device is the card; without one the CLI stops."""
    monkeypatch.delenv("PSXAVENC_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.sbs"
    assert tcli.main(["-t", "sbs", str(avi), str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
