"""
Finds what a run needs by the names in BENCHMARK.json, so that a later
change adds a configuration, a traffic mix, a cell or a per-layer metric by
adding files and entries only:

  - a cell: an entry of BENCHMARK.json's `workloads`;
  - its configuration: the `file` of the `configs` entry it names;
  - its traffic mix: benchmark/traffic/<traffic>.json;
  - a per-layer metric: benchmark/metrics/<name>.py, a module with
    read(run) -> float or None (None: nothing to read in this run, and the
    metric is left out of the result).
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as f:
        return json.load(f)


def cell_metrics(man: dict, cell: str, key: str) -> List[dict]:
    """The `end_to_end` or `per_layer` entries a cell reports: those that
    list it under `workloads`, or list no cells."""
    return [m for m in man[key]
            if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str, bench_dir: str = BENCH_DIR
                  ) -> Callable[[object], Optional[float]]:
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], run,
                 bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = metric_reader(m["name"], bench_dir)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
