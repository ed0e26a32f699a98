"""
parse_annotations of the port against the JAX package: two samples
(synth BAMs of 4 scaffolds of 8 kb at 40x, seeds 3 and 5, with the genes
of synth_genes, seeds 0 and 1), each profiled with -g and genome-wide
aggregation by each package; then each package's parse_annotations over
its own profiles, with an annotation CSV that has a malformed line. Every
CSV it writes, and gene2anno with --store_rawdata, byte for byte.
"""

import json
import os
import shutil

import pandas as pd
import pytest

from instrain_tpu.cli import main as jax_main
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.synth import synth, synth_genes

CLASSES = {"S", "N", "I", "M"}


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """(port profiles, JAX profiles, annotation CSV)."""
    d = tmp_path_factory.mktemp("annotations")
    port, jax, genes = [], [], []
    for k, seed in enumerate((3, 5)):
        sd = d / f"s{k}"
        sd.mkdir()
        fasta, bam, _ = synth(str(sd), S=4, L=8000, COV=40, seed=seed)
        named = str(sd / f"sample_{k}.bam")     # the samples' names
        shutil.move(bam, named)
        fna, _ = synth_genes(fasta, seed=k)
        for main, outs, tag in ((port_main, port, "port"),
                                (jax_main, jax, "jax")):
            out = str(d / f"{tag}_{k}.IS")
            extra = ["--device", "cpu"] if tag == "port" else []
            assert main(["profile", named, fasta, "-o", out, "-g", fna,
                         "--skip_plot_generation"] + extra) == 0
            outs.append(out)
        snv = pd.read_csv(os.path.join(
            port[-1], "output", f"port_{k}.IS_SNVs.tsv"), sep="\t")
        assert set(snv["mutation_type"].dropna()) == CLASSES
        genes += pd.read_csv(os.path.join(
            port[-1], "output", f"port_{k}.IS_gene_info.tsv"),
            sep="\t")["gene"].tolist()
    anno = str(d / "anno.csv")
    with open(anno, "w") as f:
        f.write("gene,anno\n")
        for i, g in enumerate(genes[::2]):
            f.write(f"{g},K{i % 4:05d}\n")
            if i % 3 == 0:
                f.write(f"{g},COG{i % 5}\n")
        f.write("this,line,has,too,many,fields\n")
        f.write("not_a_gene,K00001\n")
    return port, jax, anno


def _outputs(out):
    loc = os.path.join(out, "output")
    files = sorted(os.listdir(loc))
    texts = {}
    for name in files:
        with open(os.path.join(loc, name)) as f:
            texts[name] = f.read()
    return texts


@pytest.mark.parametrize("extra", [[], ["-b", "0"],
                                   ["-g", "0.5", "--store_rawdata"]])
def test_parse_annotations_matches_jax(samples, tmp_path, extra):
    port, jax, anno = samples
    p_out, j_out = str(tmp_path / "port_pa"), str(tmp_path / "jax_pa")
    assert port_main(["parse_annotations", "-i", *port, "-a", anno, "-o",
                      p_out] + extra) == 0
    assert jax_main(["parse_annotations", "-i", *jax, "-a", anno, "-o",
                     j_out] + extra) == 0
    got, want = _outputs(p_out), _outputs(j_out)
    assert got == want
    assert {"SampleAnnotationTotals.csv", "LongFormData.csv",
            "ParsedGeneAnno_genes.csv",
            "ParsedGeneAnno_bases_fraction.csv"} <= set(got)
    totals = pd.read_csv(os.path.join(p_out, "output",
                                      "SampleAnnotationTotals.csv"))
    assert list(totals["sample"]) == ["sample_0.bam", "sample_1.bam"]
    assert (totals["detected_genes_with_anno"] > 0).all()
    if "-b" in extra:
        assert "detected_genomes" not in totals
    else:
        assert (totals["detected_genomes"] == 1).all()
    if "--store_rawdata" in extra:
        def raw(out):
            with open(os.path.join(out, "raw_data", "gene2anno.json")) as f:
                return json.load(f)
        assert raw(p_out) == raw(j_out)
        assert "this" not in raw(p_out)
