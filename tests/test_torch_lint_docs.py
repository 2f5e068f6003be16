"""tools/torch_lint_docs.py: it passes on the tree, and on a copy of the
files it reads it fails on each kind of drift: a README port figure 30%
away from a written BENCH_TORCH_DETAILS.json, a figure beside another
card, an altered bound of PERF.md section 6's kernel table or what bounds
it, a bank count that no longer matches."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
LINT = "tools/torch_lint_docs.py"
READS = [LINT, "README.md", "COVERAGE.md", "PARITY.md", "PERF.md",
         "psxavenc_tpu_torch/data/swr_banks.npz",
         "psxavenc_tpu_torch/utils/roofline.py"]
K1_BOUND = re.compile(r"^(\| K1 \|.*\| )(\d+)\.(\d+) \((operations|bytes)\)",
                      re.M)


def _lint(root):
    proc = subprocess.run([sys.executable, str(root / LINT)],
                          capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout


def test_the_lint_passes_on_the_tree():
    rc, out = _lint(REPO)
    assert rc == 0, out
    assert "doc lint OK" in out


def _claims(readme):
    port = readme[readme.index("## PyTorch/CUDA port"):]
    out = {}
    for unit in ("frames/s", "Msamples/s"):
        m = re.search(rf"~([\d,]+)\s+{re.escape(unit)}\s+device-side\s+"
                      r"\(([^),]*)", port)
        out[unit] = (float(m.group(1).replace(",", "")),
                     " ".join(m.group(2).split()))
    return out


def _alter_k1(text, fn):
    m = K1_BOUND.search(text)
    assert m, "PERF.md section 6 has no K1 bound"
    return text[:m.start()] + fn(m) + text[m.end():]


DRIFTS = {
    "none": None,
    "video figure 30% off": ("details", "frames/s"),
    "audio figure 30% off": ("details", "Msamples/s"),
    "another card": ("details", "card"),
    "bound altered": ("PERF.md", lambda m: (
        f"{m.group(1)}{m.group(2)}.{int(m.group(3)) + 10:0{len(m.group(3))}d}"
        f" ({m.group(4)})")),
    "bound by altered": ("PERF.md", lambda m: (
        f"{m.group(1)}{m.group(2)}.{m.group(3)} "
        f"({'bytes' if m.group(4) == 'operations' else 'operations'})")),
    "bank count": ("COVERAGE.md", None),
}


@pytest.mark.parametrize("drift", DRIFTS)
def test_the_lint_on_a_copy(tmp_path, drift):
    for rel in READS:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, tmp_path / rel)
    claims = _claims((REPO / "README.md").read_text())
    card = claims["frames/s"][1]
    details = {"device": card,
               "video_fps_device_graph": {"median": claims["frames/s"][0]},
               "audio_msps_device": {"median": claims["Msamples/s"][0]}}
    where, how = DRIFTS[drift] or (None, None)
    if where == "details":
        if how == "card":
            details["device"] = "NVIDIA A100-SXM4-80GB"
        else:
            key = "video_fps_device_graph" if how == "frames/s" \
                else "audio_msps_device"
            details[key]["median"] /= 1.3
    elif where == "PERF.md":
        path = tmp_path / "PERF.md"
        path.write_text(_alter_k1(path.read_text(), how))
    elif where == "COVERAGE.md":
        path = tmp_path / "COVERAGE.md"
        path.write_text(re.sub(r"(\d+) probed ratio banks",
                               lambda m: f"{int(m.group(1)) + 1} probed "
                                         "ratio banks", path.read_text()))
    (tmp_path / "BENCH_TORCH_DETAILS.json").write_text(json.dumps(details))
    rc, out = _lint(tmp_path)
    if drift == "none":
        assert rc == 0, out
    else:
        assert rc == 1 and "DOC LINT FAIL" in out, out
