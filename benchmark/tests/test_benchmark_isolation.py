"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names; the reference loads nothing of the
program under test either. The checks that load run in a fresh
interpreter."""

import os
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT

PRELUDE = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
           "from benchlib import runner\n")


def _run(code, tmp_path):
    env = dict(os.environ, USE_FLAX="0", PSXAVENC_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", PRELUDE + code],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_reference_loads_neither_jax_nor_the_program(tmp_path):
    out = _run("import benchref.bs, benchref.adpcm\n"
               "tops = {m.split('.')[0] for m in sys.modules}\n"
               "print(sorted(tops & {'jax', 'jaxlib', 'flax', "
               "'psxavenc_tpu', 'psxavenc_tpu_torch'}))\n", tmp_path)
    assert out.strip() == "[]"


def test_a_run_of_the_harness_loads_no_jax(tmp_path):
    """A whole CPU run of a tiny cell of each driver, then the runner's
    own look at sys.modules, as run.py makes it before printing."""
    out = _run("sys.path.insert(0, " + repr(os.path.join(BENCH, "tests"))
               + ")\nimport conftest\n"
               f"tree = conftest.make_tiny_tree({str(tmp_path)!r})\n"
               "for name in ('str.tiny', 'vag.tiny', 'movie.tiny'):\n"
               "    assert conftest.run_cell(tree, name)['correct']\n"
               "assert 'psxavenc_tpu_torch' in sys.modules\n"
               "print(runner.forbidden_modules())\n", tmp_path)
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchlib import runner
    for name in ("psxavenc_tpu_torch.probe", "jaxtyping_probe"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"psxavenc_tpu", "jax"} & set(runner.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.probe", sys)
    assert "jax" in runner.forbidden_modules()


def test_run_py_refuses_without_a_card(tmp_path):
    """Without a card run.py exits non-zero and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "str.encoder", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
