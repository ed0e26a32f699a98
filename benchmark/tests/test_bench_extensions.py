"""Input writers and checks, found by name (harness/registry.py): a cell
that names what does not exist, or a number that is already compared,
fails before anything runs; the cells that name none compare what they
did, with the CLI arguments of their traffic unchanged; the control
reports a check's numbers beside the base ones."""

import os
import shutil

import pytest

from bench_helpers import HERE, tiny_config
from benchmark.control import control_numbers
from benchmark.harness import judge, registry

TRAFFIC = {"loop": "closed", "concurrency": 1, "args": ["-p", "2"]}


@pytest.fixture
def bench_dir(tmp_path):
    """A benchmark directory holding the toy genes writer and check."""
    d = str(tmp_path)
    for kind in ("inputs", "checks"):
        os.makedirs(os.path.join(d, kind))
    shutil.copy(os.path.join(HERE, "data", "toy_genes_writer.py"),
                os.path.join(d, "inputs", "toy_genes.py"))
    shutil.copy(os.path.join(HERE, "data", "toy_genes_check.py"),
                os.path.join(d, "checks", "toy_gene_rows.py"))
    return d


def _toy():
    return dict(TRAFFIC, inputs=["toy_genes"], checks=["toy_gene_rows"],
                args=["-g", "{toy_genes}"])


def _check_source(limits):
    return (f"LIMITS = {limits!r}\n"
            "def read(outdir):\n    return {}\n"
            "def reference(cfg, seed, layout, paths, base, precision):\n"
            "    return {}\n"
            "def judge(prog, ref):\n"
            f"    return dict.fromkeys({sorted(limits)!r}, 0)\n")


@pytest.mark.parametrize("case,error", [
    ("unknown_placeholder", KeyError),
    ("missing_check", KeyError),
    ("missing_input", KeyError),
    ("repeats_base_number", ValueError),
    ("repeats_other_check", ValueError),
    ("check_lacks_a_part", ValueError),
    ("not_a_name", ValueError),
])
def test_a_bad_cell_fails_before_it_runs(bench_dir, case, error):
    traffic = _toy()
    checks = os.path.join(bench_dir, "checks")
    if case == "unknown_placeholder":
        traffic["args"] = ["-g", "{genes}"]
    elif case == "missing_check":
        traffic["checks"] = ["toy_gene_rows", "gene_types"]
    elif case == "missing_input":
        traffic["inputs"] = ["toy_genes", "proteins"]
    elif case == "repeats_base_number":
        with open(os.path.join(checks, "again.py"), "w") as f:
            f.write(_check_source({"snv_mismatches": 0}))
        traffic["checks"] = ["again"]
    elif case == "repeats_other_check":
        with open(os.path.join(checks, "again.py"), "w") as f:
            f.write(_check_source({"toy_gene_rows_mismatched": 0}))
        traffic["checks"] = ["toy_gene_rows", "again"]
    elif case == "check_lacks_a_part":
        with open(os.path.join(checks, "partial.py"), "w") as f:
            f.write("LIMITS = {'partial_gap': 1e-6}\n")
        traffic["checks"] = ["partial"]
    elif case == "not_a_name":
        traffic["inputs"] = ["../toy_genes"]
    with pytest.raises(error):
        registry.extensions(traffic, judge.LIMITS, bench_dir)


def test_a_mix_names_its_inputs_and_checks(bench_dir):
    ext = registry.extensions(_toy(), judge.LIMITS, bench_dir)
    assert list(ext.writers) == ["toy_genes"]
    assert list(ext.checks) == ["toy_gene_rows"]
    assert list(ext.limits) == list(judge.LIMITS) + [
        "toy_gene_rows_mismatched", "toy_gene_lengths_mismatched"]
    assert registry.resolve_args(["-p", "2", "-g", "{toy_genes}"],
                                 {"toy_genes": "/x/toy.genes.fna"}) == [
        "-p", "2", "-g", "/x/toy.genes.fna"]


def test_cells_that_name_none_are_as_they_were():
    man = registry.manifest()
    for cell in man["workloads"]:
        traffic = registry.traffic(cell["traffic"])
        ext = registry.extensions(traffic, judge.LIMITS)
        assert not ext.writers and not ext.checks
        assert ext.limits == judge.LIMITS
        assert registry.resolve_args(traffic["args"], {}) == traffic["args"]


def test_check_numbers_must_be_its_limits(bench_dir):
    ext = registry.extensions(_toy(), judge.LIMITS, bench_dir)
    check = ext.checks["toy_gene_rows"]
    assert registry.check_numbers(check, {"a": 300}, {"a": 300}) == {
        "toy_gene_rows_mismatched": 0, "toy_gene_lengths_mismatched": 0}
    check.judge = lambda prog, ref: {"toy_gene_rows_mismatched": 0}
    with pytest.raises(ValueError):
        registry.check_numbers(check, {}, {})


def test_control_reports_a_checks_numbers(bench_dir):
    ext = registry.extensions(_toy(), judge.LIMITS, bench_dir)
    nums = control_numbers(tiny_config("metagenome"), 2 ** 31 + 9, ext)
    assert [k for k in nums if k not in judge.LIMITS] == [
        "toy_gene_rows_mismatched", "toy_gene_lengths_mismatched"]
    assert nums["toy_gene_rows_mismatched"] == 0
    # the base numbers still fail the control
    assert not judge.verdict(nums, ext.limits)
