"""Helpers of the benchmark's tests: the test-sized configurations in
data/, and the harness driven on the CPU."""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {name: os.path.join(HERE, "data", f"tiny_{name}.json")
        for name in ("metagenome", "isolate")}


def tiny_config(name: str) -> dict:
    with open(TINY[name]) as f:
        return json.load(f)


def load_run_module():
    """benchmark/run.py as a module (it is a script, not in a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(ROOT, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_manifest(name: str) -> dict:
    """BENCHMARK.json with the cell `<name>.profile`'s configuration
    replaced by the test-sized one."""
    from benchmark.harness import registry
    man = registry.manifest()
    for c in man["configs"]:
        if c["name"] == name:
            c["file"] = TINY[name]
    return man
