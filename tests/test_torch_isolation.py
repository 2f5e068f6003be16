"""The port stands alone: no module of psxavenc_tpu_torch, and neither
chip_smoke.py, bench_torch.py, the port's tools nor the card tests' input
helpers, imports JAX or the JAX package (psxavenc_tpu). Each file is
parsed with ``ast``, so imports inside functions count too."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(REPO).as_posix() for p in [
    *(REPO / "psxavenc_tpu_torch").rglob("*.py"),
    *(REPO / "tools").glob("torch_*.py")]) + \
    ["chip_smoke.py", "examples/torch_batch_api.py",
     "tests/torch_emit_cases.py", "tests/torch_dc_pack_cases.py",
     "bench_torch.py"]
FORBIDDEN = ("psxavenc_tpu", "jax")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_the_port_has_files():
    assert "psxavenc_tpu_torch/cli.py" in FILES
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES)
def test_no_jax_package_import(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = sorted({m for m in _imported_modules(tree) if _forbidden(m)})
    assert bad == [], f"{path} imports {bad}"


def test_the_check_sees_a_forbidden_import():
    tree = ast.parse("def f():\n    from psxavenc_tpu.io import ingest\n"
                     "import jax.numpy as jnp\nfrom . import psxavenc_tpu\n")
    assert sorted(m for m in _imported_modules(tree) if _forbidden(m)) == [
        "jax.numpy", "psxavenc_tpu.io"]
