"""Cells, configurations, traffic mixes and metric readers, found by the
names in ``BENCHMARK.json``:

- a configuration is the file its entry names (``configs/<name>.json``);
- a traffic mix is ``traffic/<traffic>.json``, whose ``driver`` names a
  module of ``benchlib/drivers/``;
- a metric is ``metrics/<name>.py``, a reader with ``read(ctx)`` that
  returns a number, or None where it finds nothing to read.

Adding a cell, a mix or a metric adds files and entries; no file here
changes."""

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of BENCHMARK.json with its files resolved."""

    def __init__(self, spec, name, root=ROOT, bench_dir=BENCH_DIR):
        self.spec = spec
        self.entry = _by_name(spec["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = _by_name(spec["configs"], self.entry["config"],
                             "config")
        with open(os.path.join(root, cfg_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic_name = self.entry["traffic"]
        with open(os.path.join(bench_dir, "traffic",
                               self.traffic_name + ".json")) as f:
            self.traffic = json.load(f)
        self.bench_dir = bench_dir
        self.end_to_end = [m for m in spec["end_to_end"]
                           if _applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def driver(self):
        return importlib.import_module(
            "benchlib.drivers." + self.traffic["driver"])

    def reader(self, metric_name):
        return load_file(os.path.join(self.bench_dir, "metrics",
                                      metric_name + ".py"))


def program(module):
    """Import ``module`` of the program under test from this checkout,
    never from elsewhere on the path."""
    mod = importlib.import_module(module)
    path = os.path.abspath(mod.__file__)
    if not path.startswith(os.path.join(ROOT, "")):
        raise ImportError(f"{module} loads from {path}, outside the "
                          f"checkout {ROOT}")
    return mod


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_file(path):
    """Import a Python file by path (metric names hold dots)."""
    name = "benchmetric_" + os.path.basename(path)[:-3].replace(".", "_")
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod
