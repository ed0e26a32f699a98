"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and new entries only: in a scratch copy of
the benchmark, the harness finds them by name and runs the new cell on the
CPU, and no file the benchmark had is changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from bench_helpers import ROOT, TINY


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tmp_path):
    copy = str(tmp_path / "tree")
    os.makedirs(copy)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = _digests(copy)
    bench = os.path.join(copy, "benchmark")
    shutil.copy(TINY["isolate"], os.path.join(bench, "configs", "deep.json"))
    with open(os.path.join(bench, "traffic", "short_loop.json"), "w") as f:
        json.dump({"why": "test", "loop": "closed", "concurrency": 1,
                   "warmup_samples": 0,
                   "args": ["-p", "2", "--skip_plot_generation"]}, f)
    with open(os.path.join(bench, "metrics", "samples_in_window.py"),
              "w") as f:
        f.write("def read(run):\n    return float(len(run.samples))\n")
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "deep", "source": "https://example.org",
                           "file": "benchmark/configs/deep.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "deep.short_loop", "config": "deep",
                             "traffic": "short_loop", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "samples_in_window", "unit": "samples",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "setup_s",
                             "workloads": ["deep.short_loop"]})
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    # the copy's harness first on sys.path, the program after it
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{copy!r}, {ROOT!r}]\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('r', "
        f"{os.path.join(bench, 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "from benchmark.harness import registry\n"
        "assert registry.ROOT == sys.path[0], registry.ROOT\n"
        "man = registry.manifest()\n"
        "cell = registry.workload(man, 'deep.short_loop')\n"
        "res = run.run_cell(man, cell, 77, 0.5, True, device='cpu')\n"
        "print(json.dumps(res))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=copy)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    # the new cell reports the metrics that list it, and only those
    assert set(res["metrics"]) == {"samples_in_window"}
    assert res["metrics"]["samples_in_window"]["value"] >= 1
    after = _digests(copy)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "benchmark/configs/deep.json", "benchmark/traffic/short_loop.json",
        "benchmark/metrics/samples_in_window.py"}
