"""Finding a cell and everything it names, from BENCHMARK.json alone.

A cell ``<config>.<traffic>`` of ``workloads`` names its configuration
(``configs`` entry, whose ``file`` holds the codec settings) and its
traffic mix (``traffic/<traffic>.json``).  By name, in turn:

  * the configuration's ``program`` is ``programs/<program>.py``, the
    entries that the program's CLI builds for those settings, and its
    ``reference`` is ``reference/<reference>.py``, the plain coder that
    the comparison holds the served streams to;
  * the traffic's ``loop`` is ``loops/<loop>.py``, which drives the entry
    it names over the pages that ``core/pages.py`` makes from the
    traffic's ``pages``;
  * a metric is the reader ``metrics/<metric name>.py``.

A later cell, configuration, traffic mix, loop, program, reference or
metric is found by adding its files and entries, with no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def load_spec(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = REPO) -> Cell:
    """The cell `name` with its configuration, traffic and the metrics it
    reports; KeyError if BENCHMARK.json has no such cell."""
    spec = load_spec(root)
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.join(root, os.path.relpath(BENCH_DIR, REPO))
    with open(os.path.join(bench_dir, "traffic",
                           f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=wl["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder on the
    path: kind is ``loops``, ``programs`` or ``reference``."""
    return importlib.import_module(f"{kind}.{name}")


def load_reader(metric: str, root: str = REPO):
    """The reader module of a metric: ``metrics/<metric>.py``."""
    bench_dir = os.path.join(root, os.path.relpath(BENCH_DIR, REPO))
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
