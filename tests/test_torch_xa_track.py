"""The port's ``-t xa`` at psxavenc's defaults against the benchmark's plain
reference (``benchmark/benchref/xa.py``, loaded by path), on the CPU.

The CLI runs in one subprocess (PSXAVENC_PLATFORM=cpu, the ingest's
Python readers as on the card's host) on seeded 44,100 Hz stereo masters:
one of 3 s, whose last sector is partial, and one just over 1,024 sectors,
so that two of the muxer's 1,024-sector chunks meet. Each .xa file equals
the reference's byte for byte. The resampler, the bank the reference keeps
and its EDC are held to the port's own; the reference's control (ADPCM
segments never repaired) differs from the program's bytes."""

import importlib
import importlib.util
import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCHREF = REPO / "benchmark" / "benchref"
CFG = json.loads((REPO / "benchmark" / "configs"
                  / "xa-37800-stereo.json").read_text())

# Master frames: 3 s (57 sectors, the last of 487 samples a channel) and
# 2,410,000 (1,025 sectors: the second chunk holds one, of 1,314).
LENGTHS = {"short": 3 * 44100, "two_chunks": 2_410_000}

_RUNNER = """
import json, sys
from psxavenc_tpu_torch import cli
failed = [c for c in json.loads(sys.argv[1]) if cli.main(c) != 0]
print(json.dumps({"failed": failed}))
sys.exit(1 if failed else 0)
"""


def _benchref_xa():
    """benchmark/benchref/xa.py, its package loaded by path."""
    if "benchref" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "benchref", BENCHREF / "__init__.py",
            submodule_search_locations=[str(BENCHREF)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["benchref"] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module("benchref.xa")


def master(n, seed):
    """(n, 2) int16 at 44,100 Hz: a tone of three partials on the left,
    noise over a low tone on the right."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    f0 = rng.uniform(110, 440)
    left = sum(a * np.sin(2 * np.pi * f0 * (k + 1) * t + p) for k, (a, p)
               in enumerate(zip((0.5, 0.25, 0.12), rng.uniform(0, 6, 3))))
    right = 0.3 * rng.standard_normal(n) + 0.2 * np.sin(2 * np.pi * 55 * t)
    x = np.stack([left, right], 1) * 0.8 * 32767
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def write_wav(path, pcm, rate):
    data = np.ascontiguousarray(pcm, "<i2").tobytes()
    ch = pcm.shape[1]
    fmt = struct.pack("<IHHIIHH", 16, 1, ch, rate, rate * 2 * ch, 2 * ch,
                      16)
    body = b"WAVE" + b"fmt " + fmt + b"data" + struct.pack("<I", len(data)) \
        + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Every master through the port's CLI with ``-t xa`` and nothing else,
    in one subprocess."""
    d = tmp_path_factory.mktemp("xa_track")
    masters, argvs = {}, []
    for k, (case, n) in enumerate(LENGTHS.items()):
        masters[case] = master(n, seed=70 + k)
        write_wav(d / f"{case}.wav", masters[case], 44100)
        argvs.append(["-q", "-t", "xa", str(d / f"{case}.wav"),
                      str(d / f"{case}.xa")])
    env = dict(os.environ, PSXAVENC_PLATFORM="cpu",
               PSXAVENC_NO_NATIVE_INGEST="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER, json.dumps(argvs)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return d, masters


@pytest.mark.parametrize("case", list(LENGTHS))
def test_cli_xa_equals_the_reference(port_run, case):
    d, masters = port_run
    ref = _benchref_xa()
    got = (d / f"{case}.xa").read_bytes()
    want = ref.xa_file(CFG, masters[case], "cpu")
    out = ref.resampled_length(LENGTHS[case])
    assert len(want) == ref.SECTOR * -(-out // ref.PER_SECTOR)
    assert out % ref.PER_SECTOR                 # the last sector partial
    assert got == want


@pytest.mark.parametrize("n", [5, 40, 9_000])
def test_resampler_equals_the_reference(n):
    from psxavenc_tpu_torch.io import ingest
    x = master(n, seed=n)
    got = ingest._remix_resample(x, 44100, 2, 37800)
    want = _benchref_xa().resample(x, "cpu").numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_reference_bank_is_the_ports():
    bank = _benchref_xa().load_bank()
    z = np.load(REPO / "psxavenc_tpu_torch" / "data" / "swr_banks.npz")
    assert [bank[k] for k in "WLMD"] == z["44100_37800_meta"].tolist()
    assert bank["starts"] == z["44100_37800_starts"].tolist()
    assert bank["taps"] == z["44100_37800_taps"].tolist()


def test_reference_edc_is_the_ports():
    from psxavenc_tpu_torch.native import host
    rng = np.random.default_rng(73)
    rows = rng.integers(0, 256, (3, 0x91C), dtype=np.uint8)
    got = _benchref_xa().edc(torch.from_numpy(rows)).tolist()
    assert got == [host.edc(r.tobytes()) for r in rows]


def test_control_differs_on_a_tone(port_run):
    """Segments from guessed start states, never repaired: the bytes
    differ from the program's."""
    d, masters = port_run
    ctl = _benchref_xa().xa_file(CFG, masters["short"], "cpu", rounds=1)
    assert len(ctl) == len((d / "short.xa").read_bytes())
    assert ctl != (d / "short.xa").read_bytes()


def test_reference_loads_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, 'benchmark')\n"
            "import benchref.xa\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'psxavenc_tpu',"
            " 'psxavenc_tpu_torch'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
