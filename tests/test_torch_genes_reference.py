"""
The port's `profile -s <stb> -g <genes.fna> --device cpu` held to the
benchmark's plain reference of the gene tables (benchmark/checks/genes.py,
over benchmark/ref/profile.py), on the benchmark's test-sized metagenome
and its genes file (benchmark/inputs/genes.py, under the gene model of
benchmark/configs/metagenome_genes.json): every compared number
within its limit, and every mutation type present. The same output fails
the comparison against a reference with one gene left out, with one SNV's
mutation type flipped, with one gene's nucl_diversity moved by 3e-5, and
against the reference computed one precision step down (the control).
"""

import json
import os

import pytest

from benchmark.checks import genes as check
from benchmark.gen import reads as gen
from benchmark.inputs import genes as genes_input
from benchmark.ref.profile import reference
from instrain_tpu_torch.cli import main as port_main

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
CFG = os.path.join(BENCH, "tests", "data", "tiny_metagenome.json")
GENE_MODEL = os.path.join(BENCH, "configs", "metagenome_genes.json")
# a seed whose SNVs fall in every class: intergenic, synonymous,
# non-synonymous and in two overlapping genes
SEED = 48


def _correct(numbers):
    assert set(numbers) == set(check.LIMITS)
    return all(numbers[k] <= check.LIMITS[k] for k in check.LIMITS)


@pytest.fixture(scope="module")
def judged(tmp_path_factory):
    """The config, the layout, the genes file, the port's gene tables and
    the reference's."""
    d = str(tmp_path_factory.mktemp("genes_reference"))
    with open(CFG) as f, open(GENE_MODEL) as g:
        cfg = dict(json.load(f), genes=json.load(g)["genes"])
    inputs = gen.write_inputs(cfg, SEED, d, threads=2)
    paths = {"genes": genes_input.write(cfg, SEED, inputs["layout"], d)}
    out = os.path.join(d, "sample.IS")
    assert port_main(["profile", inputs["bam"], inputs["fasta"], "-o", out,
                      "-s", inputs["stb"], "-g", paths["genes"],
                      "--device", "cpu", "--skip_plot_generation"]) == 0
    ref = check.reference(cfg, SEED, inputs["layout"], paths,
                          reference(cfg, SEED, threads=2), "reference")
    return cfg, inputs["layout"], paths, check.read(out), ref


def test_port_within_every_limit(judged):
    _, _, _, prog, ref = judged
    numbers = check.judge(prog, ref)
    assert _correct(numbers), numbers
    assert len(ref["gene_info"]) > 0 and len(ref["snvs"]) > 0


def test_every_mutation_type_occurs(judged):
    _, _, _, prog, ref = judged
    for side in (prog, ref):
        assert {"I", "S", "N", "M"} <= set(side["snvs"]["mutation_type"])


@pytest.mark.parametrize("case", ["gene_dropped", "type_flipped",
                                  "diversity_off", "control"])
def test_altered_reference_fails(judged, case):
    cfg, layout, paths, prog, ref = judged
    if case == "gene_dropped":
        ref = dict(ref, gene_info=ref["gene_info"].iloc[1:])
    elif case == "type_flipped":
        snvs = ref["snvs"].copy()
        k = snvs.index[snvs["mutation_type"] == "N"][0]
        snvs.loc[k, "mutation_type"] = "S"
        ref = dict(ref, snvs=snvs)
    elif case == "diversity_off":
        # a tenth of what a float32 running sum along the scaffold lost
        info = ref["gene_info"].copy()
        k = info["nucl_diversity"].first_valid_index()
        info.loc[k, "nucl_diversity"] += 3e-5
        ref = dict(ref, gene_info=info)
    else:
        prog = check.reference(cfg, SEED, layout, paths,
                               reference(cfg, SEED, precision="control",
                                         threads=2), "control")
    assert not _correct(check.judge(prog, ref))
