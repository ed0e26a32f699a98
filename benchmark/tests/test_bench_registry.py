"""A later change adds a configuration, a traffic mix, a cell, a per-layer
metric, an input file and a check as new files and new entries only: in a
scratch copy of the benchmark, the harness finds them by name and runs the
new cell on the CPU, and no file the benchmark had is changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_helpers import HERE, ROOT, TINY
from benchmark.harness import judge


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _scratch_copy(tmp_path):
    """BENCHMARK.json and benchmark/ copied into tmp_path/tree."""
    copy = str(tmp_path / "tree")
    os.makedirs(copy)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return copy


def _add_entries(copy, **entries):
    """Appends entries to BENCHMARK.json's lists, by key."""
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        man = json.load(f)
    for key, items in entries.items():
        man[key].extend(items)
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)


def _run_cell(copy, name, seed):
    """Runs the copy's cell on the CPU in a process of its own; returns its
    result and the traffic arguments make_cfg was handed."""
    run_py = os.path.join(copy, "benchmark", "run.py")
    # the copy's harness first on sys.path, the program after it
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{copy!r}, {ROOT!r}]\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('r', {run_py!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "from benchmark.harness import registry\n"
        "assert registry.ROOT == sys.path[0], registry.ROOT\n"
        "seen, make_cfg = [], run.make_cfg\n"
        "def spy(cli, pipeline, traffic, inputs, out):\n"
        "    seen.append(list(traffic['args']))\n"
        "    return make_cfg(cli, pipeline, traffic, inputs, out)\n"
        "run.make_cfg = spy\n"
        "man = registry.manifest()\n"
        f"cell = registry.workload(man, {name!r})\n"
        f"res = run.run_cell(man, cell, {seed}, 0.5, True, device='cpu')\n"
        "print(json.dumps([res, seen[0]]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=copy)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_new_cell_from_new_files_only(tmp_path):
    copy = _scratch_copy(tmp_path)
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
    _add_entries(
        copy,
        configs=[{"name": "deep", "source": "https://example.org",
                  "file": "benchmark/configs/deep.json", "reduced": [],
                  "why": "test"}],
        workloads=[{"name": "deep.short_loop", "config": "deep",
                    "traffic": "short_loop", "chips": 1, "why": "test"}],
        per_layer=[{"name": "samples_in_window", "unit": "samples",
                    "better": "higher", "source": "host_clock",
                    "layer": "harness", "moves": "setup_s",
                    "workloads": ["deep.short_loop"]}])

    res, _ = _run_cell(copy, "deep.short_loop", 77)
    assert res["correct"], res["compared"]
    # the new cell reports the metrics that list it, and only those
    assert set(res["metrics"]) == {"samples_in_window"}
    assert res["metrics"]["samples_in_window"]["value"] >= 1
    after = _digests(copy)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "benchmark/configs/deep.json", "benchmark/traffic/short_loop.json",
        "benchmark/metrics/samples_in_window.py"}


# the toy check as it is, with one gene left out of its reference, and
# with a read that raises: (what is appended to it, correct, rows read)
VARIANTS = {
    "sound": ("", True, 0),
    "drop_one": ("DROP = 1\n", False, 1),
    "raises": ("def read(outdir):\n    raise OSError(outdir)\n", False,
               1e300),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_new_input_and_check_from_new_files_only(tmp_path, variant):
    """A genes file written in set-up, named by the traffic as "{toy_genes}",
    and a check of gene_info against it; with one gene left out of the
    check's reference, or a check that raises, the run is not correct."""
    tail, expect, rows = VARIANTS[variant]
    copy = _scratch_copy(tmp_path)
    before = _digests(copy)
    bench = os.path.join(copy, "benchmark")
    shutil.copy(TINY["metagenome"],
                os.path.join(bench, "configs", "toy_meta.json"))
    for kind in ("inputs", "checks"):
        os.makedirs(os.path.join(bench, kind), exist_ok=True)
    shutil.copy(os.path.join(HERE, "data", "toy_genes_writer.py"),
                os.path.join(bench, "inputs", "toy_genes.py"))
    with open(os.path.join(HERE, "data", "toy_genes_check.py")) as f:
        check = f.read()
    with open(os.path.join(bench, "checks", "toy_gene_rows.py"), "w") as f:
        f.write(check + tail)
    with open(os.path.join(bench, "traffic", "genes_loop.json"), "w") as f:
        json.dump({"why": "test", "loop": "closed", "concurrency": 1,
                   "warmup_samples": 0, "inputs": ["toy_genes"],
                   "checks": ["toy_gene_rows"],
                   "args": ["-p", "2", "--skip_plot_generation",
                            "-g", "{toy_genes}"]}, f)
    _add_entries(
        copy,
        configs=[{"name": "toy_meta", "source": "https://example.org",
                  "file": "benchmark/configs/toy_meta.json", "reduced": [],
                  "why": "test"}],
        workloads=[{"name": "toy_meta.genes_loop", "config": "toy_meta",
                    "traffic": "genes_loop", "chips": 1, "why": "test"}])

    res, argv = _run_cell(copy, "toy_meta.genes_loop", 91)
    assert res["correct"] is expect, res["compared"]
    cmp = res["compared"]
    assert {k: cmp[k]["limit"] for k in cmp if k.startswith("toy_")} == {
        "toy_gene_rows_mismatched": 0, "toy_gene_lengths_mismatched": 0}
    assert cmp["toy_gene_rows_mismatched"]["value"] == rows
    # every base number still compared, before the check's
    assert list(cmp)[:len(judge.LIMITS)] == list(judge.LIMITS)
    # the placeholder reached the CLI's arguments as the written file
    g = argv[argv.index("-g") + 1]
    assert g.endswith(os.sep + "toy.genes.fna") and "{" not in g
    after = _digests(copy)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "benchmark/configs/toy_meta.json",
        "benchmark/traffic/genes_loop.json",
        "benchmark/inputs/toy_genes.py", "benchmark/checks/toy_gene_rows.py"}
