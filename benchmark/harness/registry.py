"""
Finds what a run needs by the names in BENCHMARK.json, so that a later
change adds a configuration, a traffic mix, a cell or a per-layer metric by
adding files and entries only:

  - a cell: an entry of BENCHMARK.json's `workloads`;
  - its configuration: the `file` of the `configs` entry it names;
  - its traffic mix: benchmark/traffic/<traffic>.json;
  - a per-layer metric: benchmark/metrics/<name>.py, a module with
    read(run) -> float or None (None: nothing to read in this run, and the
    metric is left out of the result);
  - an input writer: benchmark/inputs/<name>.py, a module with
    write(cfg, seed, layout, workdir) -> path, writing one more input file
    of the sample, named by a traffic mix's `inputs`; a traffic argument
    "{<name>}" becomes the file's path;
  - a check: benchmark/checks/<name>.py, a module with LIMITS (number name
    -> limit), read(outdir), reference(cfg, seed, layout, paths, base,
    precision) and judge(prog, ref) -> {number name: number}, named by a
    traffic mix's `checks`: more numbers compared beside those of
    harness/judge.py.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType
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


def _module(kind: str, name: str, bench_dir: str) -> ModuleType:
    """benchmark/<kind>/<name>.py as a module."""
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR
                  ) -> Callable[[object], Optional[float]]:
    return _module("metrics", name, bench_dir).read


def read_metrics(entries: List[dict], run,
                 bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = metric_reader(m["name"], bench_dir)(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# a name that maps to a file, and a whole traffic argument naming an input
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
PLACEHOLDER = re.compile(r"^\{(.*)\}$")
CHECK_PARTS = ("LIMITS", "read", "reference", "judge")


@dataclass
class Extensions:
    """A cell's input writers and checks, in order, and the limits of every
    number it compares: the base limits, then each check's."""
    writers: Dict[str, Callable]
    checks: Dict[str, ModuleType]
    limits: Dict[str, float]


def _listed(key: str, traffic: dict) -> List[str]:
    """A traffic mix's `inputs` or `checks`, each name once."""
    names = traffic.get(key, [])
    if not isinstance(names, list):
        raise ValueError(f"{key} is not a list")
    for n in names:
        if not isinstance(n, str) or not NAME.match(n):
            raise ValueError(f"{key}: {n!r} is not a name")
    return list(dict.fromkeys(names))


def extensions(traffic: dict, base_limits: Dict[str, float],
               bench_dir: str = BENCH_DIR) -> Extensions:
    """Finds the input writers and checks that a cell's traffic mix names,
    and fails, before anything runs, on a writer or check that does not
    exist, a check that lacks a part, a number name that repeats one
    already compared, or a traffic argument "{<name>}" whose input the mix
    does not name."""
    def find(kind: str, name: str) -> ModuleType:
        if not os.path.exists(os.path.join(bench_dir, kind, name + ".py")):
            raise KeyError(f"no {kind}/{name}.py in the benchmark")
        return _module(kind, name, bench_dir)

    writers = {n: find("inputs", n).write for n in _listed("inputs", traffic)}
    checks = {n: find("checks", n) for n in _listed("checks", traffic)}
    limits = dict(base_limits)
    for n, m in checks.items():
        lacks = [p for p in CHECK_PARTS if not hasattr(m, p)]
        if lacks:
            raise ValueError(f"check {n!r} lacks {', '.join(lacks)}")
        for k, v in m.LIMITS.items():
            if k in limits:
                raise ValueError(f"check {n!r}: the number {k!r} is "
                                 "already compared")
            limits[k] = v
    for a in traffic.get("args", []):
        m = PLACEHOLDER.match(a)
        if m and m.group(1) not in writers:
            raise KeyError(f"traffic argument {a!r} names no input of the "
                           "cell")
    return Extensions(writers, checks, limits)


def resolve_args(args: List[str], paths: Dict[str, str]) -> List[str]:
    """A traffic's arguments with each whole "{<input>}" replaced by the
    path of the file that input's writer wrote."""
    out = []
    for a in args:
        m = PLACEHOLDER.match(a)
        out.append(paths[m.group(1)] if m else a)
    return out


def check_numbers(check: ModuleType, prog, ref) -> Dict[str, float]:
    """check.judge(prog, ref), which must give each of its LIMITS' numbers
    and no other."""
    got = check.judge(prog, ref)
    if set(got) != set(check.LIMITS):
        raise ValueError(f"{check.__name__} judged {sorted(got)}, not "
                         f"{sorted(check.LIMITS)}")
    out = {}
    for k in check.LIMITS:
        v = got[k]
        # a numpy scalar as a plain number, for the result's JSON
        out[k] = v.item() if hasattr(v, "item") else v
    return out
