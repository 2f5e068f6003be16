"""The port's CLI writes psxavenc_tpu's bytes for every audio format and
for the str/strcd A/V interleave, on the CPU.

All port runs go through one subprocess (PSXAVENC_PLATFORM=cpu) that
fails if ``jax`` or ``psxavenc_tpu`` was imported; each format is then
compared byte for byte, with no mask, with ``psxavenc_tpu.cli.main`` on
the same input and the same output file name (.vag headers embed it).
Inputs are seeded and short (under a second of audio each).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from psxavenc_tpu import cli as jcli
from psxavenc_tpu.utils.synth import (rand_frames, rand_pcm,
                                      write_avi_sized, write_wav)

from test_torch_parity import PLAIN_TIERS

REPO = pathlib.Path(__file__).resolve().parent.parent

# (case, CLI arguments, input file)
CASES = [
    ("xa_37800_stereo_4bit", ["-t", "xa", "-f", "37800", "-c", "2",
                              "-b", "4"], "s37800.wav"),
    ("xa_18900_mono_4bit", ["-t", "xa", "-f", "18900", "-c", "1",
                            "-b", "4"], "m18900.wav"),
    ("xa_37800_mono_8bit", ["-t", "xa", "-f", "37800", "-c", "1",
                            "-b", "8"], "m37800.wav"),
    ("xa_18900_stereo_8bit", ["-t", "xa", "-f", "18900", "-c", "2",
                              "-b", "8", "-F", "3", "-C", "5"],
     "s18900.wav"),
    ("xacd_37800_stereo_4bit", ["-t", "xacd", "-f", "37800", "-c", "2",
                                "-b", "4"], "s37800.wav"),
    ("xacd_18900_mono_8bit", ["-t", "xacd", "-f", "18900", "-c", "1",
                              "-b", "8"], "m18900.wav"),
    ("spu", ["-t", "spu", "-f", "44100"], "m44100.wav"),
    ("vag_loop", ["-t", "vag", "-f", "44100"], "loop44100.wav"),
    ("spui", ["-t", "spui", "-f", "44100", "-c", "2", "-i", "1024"],
     "s44100.wav"),
    ("vagi", ["-t", "vagi", "-f", "44100", "-c", "2"], "s44100.wav"),
    ("str", ["-t", "str", "-s", "48x32", "-f", "37800", "-c", "2"],
     "av.avi"),
    ("strcd", ["-t", "strcd", "-s", "48x32", "-x", "2", "-f", "37800",
               "-c", "2"], "av.avi"),
]

# Runs every case with the port's CLI; exits 3 if JAX or the JAX package
# was imported.
_RUNNER = """
import json, sys
from psxavenc_tpu_torch import cli
from psxavenc_tpu_torch.native import tiers
failed = [c for c in json.loads(sys.argv[1]) if cli.main(c) != 0]
leaked = sorted(m for m in sys.modules if m == "jax"
                or m.startswith("jax.") or m == "psxavenc_tpu"
                or m.startswith("psxavenc_tpu."))
print(json.dumps({"failed": failed, "leaked": leaked,
                  "native_calls": sum(tiers.COUNTERS.values())}))
sys.exit(3 if leaked else (1 if failed else 0))
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio_in")
    write_wav(d / "s37800.wav", rand_pcm(11000, channels=2, seed=51),
              37800, channels=2)
    write_wav(d / "m37800.wav", rand_pcm(9000, seed=52), 37800)
    write_wav(d / "m18900.wav", rand_pcm(9500, seed=53), 18900)
    write_wav(d / "s18900.wav", rand_pcm(6000, channels=2, seed=54), 18900,
              channels=2)
    write_wav(d / "m44100.wav", rand_pcm(12000, seed=55), 44100)
    write_wav(d / "loop44100.wav", rand_pcm(12000, seed=56), 44100,
              loop_start=4100)
    write_wav(d / "s44100.wav", rand_pcm(14000, channels=2, seed=57),
              44100, channels=2)
    write_avi_sized(d / "av.avi", 48, 32, rand_frames(48, 32, 8, seed=58),
                    15, audio=rand_pcm(22680, channels=2, seed=59),
                    audio_rate=37800)
    return d


@pytest.fixture(scope="module")
def port_run(inputs, tmp_path_factory):
    """Every case through the port's CLI in one subprocess."""
    out = tmp_path_factory.mktemp("audio_port")
    argvs = [["-q", *argv, str(inputs / src), str(out / f"{case}.out")]
             for case, argv, src in CASES]
    env = dict(os.environ, PSXAVENC_PLATFORM="cpu", OMP_NUM_THREADS="1",
               **PLAIN_TIERS)
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, json.dumps(argvs)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    return out, proc.returncode, report, proc.stderr


def test_port_cli_imports_no_jax(port_run):
    _, rc, report, stderr = port_run
    assert report["leaked"] == [], report
    assert report["failed"] == [], stderr
    assert rc == 0
    assert report["native_calls"] == 0      # the plain versions ran


def test_host_sector_code_matches_jax_native():
    """The port's host sector library (native/host.py) against
    psxavenc_tpu.native on seeded sectors."""
    from psxavenc_tpu import native as jnative
    from psxavenc_tpu_torch.native import host

    rng = np.random.default_rng(61)
    data = rng.integers(0, 256, 2352, dtype=np.uint8)
    assert host.edc(data.tobytes()) == jnative.edc(data.tobytes())
    for stype in (host.SECTOR_MODE1, host.SECTOR_MODE2_FORM1,
                  host.SECTOR_MODE2_FORM2):
        for lba in (0, 4499, 123456):
            want, got = data.copy(), data.copy()
            jnative.sector_init(want, lba, stype)
            host.sector_init(got, lba, stype)
            jnative.calc_checksums(want, stype)
            host.calc_checksums(got, stype)
            assert np.array_equal(want, got), (stype, lba)
    want = rng.integers(0, 256, (5, 2336), dtype=np.uint8)
    got = want.copy()
    jnative.edc_batch(want, 0, 0x91C, 0x91C)
    host.edc_batch(got, 0, 0x91C, 0x91C)
    assert np.array_equal(want, got)
    for upb, bits8 in ((8, False), (4, True), (4, False), (2, True)):
        hdr = rng.integers(0, 256, (18, upb), dtype=np.uint8)
        vals = rng.integers(0, 16 if not bits8 else 256, (18, upb, 28),
                            dtype=np.uint8)
        assert np.array_equal(jnative.xa_assemble(hdr, vals, upb, bits8),
                              host.xa_assemble(hdr, vals, upb, bits8))


@pytest.mark.parametrize("case,argv,src", CASES,
                         ids=[c[0] for c in CASES])
def test_cli_matches_jax_cli(case, argv, src, inputs, port_run, tmp_path):
    out, _, report, stderr = port_run
    want = tmp_path / f"{case}.out"
    assert jcli.main(["-q", *argv, str(inputs / src), str(want)]) == 0
    got = out / f"{case}.out"
    assert got.exists(), stderr
    assert len(want.read_bytes()) > 0
    assert got.read_bytes() == want.read_bytes()
