"""The plain reference against `instrain_tpu_torch profile --device cpu`
at a test size: every number of the comparison within its limit, with
linkage rows on both sides; and the reference's SNV-calling thresholds
against the program's tables."""

import os

import numpy as np
import pytest

from bench_helpers import tiny_config
from benchmark.gen import reads
from benchmark.harness import judge, outputs
from benchmark.ref import profile as rp


@pytest.mark.parametrize("name", ["metagenome", "isolate"])
def test_reference_agrees_with_the_program(tmp_path, name):
    from instrain_tpu_torch import cli
    cfg = tiny_config(name)
    seed = 2 ** 31 + 1234
    inp = reads.write_inputs(cfg, seed, str(tmp_path / "in"), threads=2)
    out = str(tmp_path / "profile.IS")
    argv = ["profile", inp["bam"], inp["fasta"], "-o", out, "-p", "2",
            "--skip_plot_generation", "--device", "cpu"]
    if inp["stb"]:
        argv += ["-s", inp["stb"]]
    cli.main(argv)
    prog = outputs.read_profile(out)
    ref = rp.reference(cfg, seed)
    nums = judge.judge(prog, ref)
    assert judge.verdict(nums), nums
    assert len(ref["snvs"]) > 10 and len(ref["linkage"]) > 0
    assert len(prog["linkage"]) == len(ref["linkage"])
    # the relative's pairs are filtered out, every other pair kept
    mp = ref["mapping"]
    assert (mp["filtered_pairs"] < mp["unfiltered_pairs"]).all()


def test_thresholds_match_the_program():
    from instrain_tpu_torch.kernels import nullmodel
    from instrain_tpu_torch.kernels.sitestats import freq_min_count_lut
    ours = rp.null_thresholds(10000, 1e-6, 0.001)
    assert np.array_equal(ours, nullmodel.analytic_null_thresholds(
        10000, 1e-6, 0.001))
    assert np.array_equal(rp.freq_thresholds(10000, 0.05),
                          freq_min_count_lut(0.05, 10000))


def test_reference_imports_nothing_of_the_program():
    import ast
    here = os.path.dirname(os.path.abspath(rp.__file__))
    for d in (here, os.path.dirname(reads.__file__)):
        for f in os.listdir(d):
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names]
                             if isinstance(node, ast.Import) else
                             [node.module or ""] if isinstance(
                                 node, ast.ImportFrom) and node.level == 0
                             else [])
                    for n in names:
                        assert n.split(".")[0] not in (
                            "instrain_tpu_torch", "instrain_tpu", "jax"), f
