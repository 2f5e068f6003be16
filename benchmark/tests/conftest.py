"""Shared helpers of the benchmark's own tests (run on the CPU with
``python -m pytest benchmark/tests``; the tests that need the card are
marked ``requires_cuda`` and skip here).

``tiny_tree`` copies BENCHMARK.json and the benchmark's data files into a
temporary directory and adds tiny cells as new files and entries:
``str.tiny`` (48x32 frames, two seconds of movie), ``movie.tiny`` (the
same through the CLI, with its sound) and ``vag.tiny`` (five clips of
1-50 ms). The harness's code stays the repository's; only the
data it finds by name comes from the copy."""

import json
import os
import shutil
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MOVIE = {"driver": "video_feed", "movie_seconds": 2, "scene_frames": 10,
              "batch_frames": 128, "check_frames": 6, "warmup_passes": 1,
              "trace_seconds": 0.2}
TINY_MOVIE_CLI = {"driver": "cli_movie", "movie_seconds": 2,
                  "scene_frames": 10, "check_share": 0.5,
                  "warmup_movies": 1, "trace_seconds": 0.2}
TINY_BANK = {"driver": "job_list", "clips": 5, "min_seconds": 0.001,
             "max_seconds": 0.05, "spacing": "log", "group": True,
             "read_back_files": 2, "warmup_lists": 1, "trace_seconds": 0.2}


def make_tiny_tree(dst):
    """Copy the data of the benchmark into ``dst`` and add the tiny cells
    there; returns ``dst``."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub),
                        os.path.join(dst, "benchmark", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(BENCH, "configs", "str-v2-320x240.json")) as f:
        cfg = json.load(f)
    cfg.update(name="str-v2-48x32", width=48, height=32)
    _dump(cfg, dst, "benchmark/configs/str-v2-48x32.json")
    _dump(TINY_MOVIE, dst, "benchmark/traffic/tiny_movie.json")
    _dump(TINY_BANK, dst, "benchmark/traffic/tiny_bank.json")
    _dump(TINY_MOVIE_CLI, dst, "benchmark/traffic/tiny_cli.json")
    spec["configs"].append(dict(spec["configs"][0], name="str-v2-48x32",
                                file="benchmark/configs/str-v2-48x32.json",
                                reduced=["width", "height"]))
    spec["workloads"] += [
        dict(name="str.tiny", config="str-v2-48x32", traffic="tiny_movie",
             chips=1, why="a test cell"),
        dict(name="vag.tiny", config="vag-44100-mono", traffic="tiny_bank",
             chips=1, why="a test cell"),
        dict(name="movie.tiny", config="str-v2-48x32", traffic="tiny_cli",
             chips=1, why="a test cell")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        ws = m.get("workloads", [])
        if "str.encoder" in ws:
            ws.append("str.tiny")
        if "vag.bank" in ws:
            ws.append("vag.tiny")
        if "str.movie" in ws:
            ws.append("movie.tiny")
    _dump(spec, dst, "BENCHMARK.json")
    return dst


def _dump(obj, root, rel):
    with open(os.path.join(root, rel), "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture
def tiny_tree(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    return make_tiny_tree(str(tree))


def run_cell(tree, name, seed=5, seconds=0.3, trace=False, tmp=None):
    """One run of a tiny cell on the CPU, without the look for a card ->
    the result dict."""
    import torch

    from benchlib import runner, spec

    cell = spec.Cell(spec.load_spec(tree), name, root=tree,
                     bench_dir=os.path.join(tree, "benchmark"))
    work = tmp or os.path.join(tree, "work")
    os.makedirs(work, exist_ok=True)
    return runner.run(cell, seed, seconds, trace, time.perf_counter(),
                      torch.device("cpu"), work)


@pytest.fixture
def requires_card():
    """Skips a test unless a CUDA card is visible (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
