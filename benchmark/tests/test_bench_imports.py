"""Nothing the benchmark runs loads JAX or the JAX package: no module under
benchmark/ imports them, and a run's process holds none of them after the
window (top-level names compared whole: instrain_tpu_torch is not
instrain_tpu)."""

import ast
import json
import os
import subprocess
import sys

from bench_helpers import ROOT, load_run_module

FORBIDDEN = {"jax", "jaxlib", "flax", "instrain_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax():
    for d, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                bad = {n.split(".")[0] for n in _imports(os.path.join(d, f))
                       } & FORBIDDEN
                assert not bad, (f, bad)


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference, the input writers and the checks (and the toy ones of
    the tests) import neither the port nor the JAX package."""
    bench = os.path.join(ROOT, "benchmark")
    dirs = ("ref", "gen", "inputs", "checks", os.path.join("tests", "data"))
    for sub in dirs:
        for d, _, files in os.walk(os.path.join(bench, sub)):
            for f in files:
                if f.endswith(".py"):
                    bad = {n.split(".")[0] for n in _imports(
                        os.path.join(d, f))} & (FORBIDDEN |
                                                {"instrain_tpu_torch"})
                    assert not bad, (f, bad)


def test_whole_name_check():
    run = load_run_module()
    saved = dict(sys.modules)
    try:
        sys.modules["instrain_tpu_torch_fake"] = sys
        sys.modules["jaxtyping_fake"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & FORBIDDEN)
        sys.modules["instrain_tpu.fake"] = sys
        assert "instrain_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'benchmark', 'tests')!r})\n"
        "from bench_helpers import load_run_module, tiny_manifest\n"
        "run = load_run_module()\n"
        "man = tiny_manifest('isolate')\n"
        "cell = [w for w in man['workloads'] "
        "if w['name'] == 'isolate.profile'][0]\n"
        "res = run.run_cell(man, cell, 3, 0.5, False, device='cpu')\n"
        "print(json.dumps([res['correct'], run.forbidden_modules()]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    correct, bad = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and bad == []
