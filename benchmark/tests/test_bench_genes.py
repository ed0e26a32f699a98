"""The genes cell, metagenome.genes: its configuration is metagenome's
sample with a gene model; its genes file (inputs/genes.py) is Prodigal's
form over the configuration's scaffolds, drawn from the seed; the harness
finds the cell's writer, check and metrics by name and hands the written
file to `-g`; the genes check holds its own reference to its limits and
fails a gene left out or a mutation type changed."""

import json
import os

import numpy as np
import pytest

from bench_helpers import tiny_config
from benchmark.checks import genes as check
from benchmark.gen import reads as gen
from benchmark.harness import judge, registry
from benchmark.inputs import genes as genes_input

SEED = 2 ** 31 + 11
CONFIGS = os.path.join(registry.BENCH_DIR, "configs")
COMP = bytes.maketrans(b"ACGT", b"TGCA")
NEW_METRICS = {"genes_us_per_pair", "genes_parse_us_per_pair",
               "genes_coverage_us_per_pair", "genes_mutations_us_per_pair",
               "genes_counts_us_per_pair", "store_genes_us_per_pair"}


def _records(path):
    """(header fields, sequence) of each gene of a genes file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                out.append([[p.strip() for p in line[1:].split("#")], ""])
            else:
                out[-1][1] += line
    return out


def _config(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    cfg = dict(tiny_config("metagenome"),
               genes=_config("metagenome_genes")["genes"])
    lay = gen.layout(cfg, SEED)
    d = str(tmp_path_factory.mktemp("genes"))
    path = genes_input.write(cfg, SEED, lay, d)
    refs = {n: gen.scaffold_fragments(cfg, lay, s, SEED)[1]["ref"]
            for s, n in enumerate(lay.names)}
    return cfg, lay, path, refs


def test_genes_are_prodigals_over_the_scaffolds(written):
    _, lay, path, refs = written
    recs = _records(path)
    assert len(recs) > 2 * len(lay.names)
    seen = {}
    for head, seq in recs:
        name, start, end, strand, meta = head
        scaf, k = name.rsplit("_", 1)
        a, b = int(start) - 1, int(end) - 1
        L = len(refs[scaf])
        assert int(k) == seen.get(scaf, 0) + 1
        seen[scaf] = int(k)
        assert meta.startswith(f"ID={lay.names.index(scaf) + 1}_{k};")
        assert strand in ("1", "-1")
        assert 0 <= a <= b <= L - 1 and (b - a + 1) % 3 == 0
        body = refs[scaf][a:b + 1].tobytes()
        if strand == "-1":
            body = body.translate(COMP)[::-1]
        assert seq.encode() == body
        partial = meta.split(";")[1]
        cut = f"{int(a <= 2)}{int(b >= L - 3)}"
        # a gene is flagged partial only where a scaffold end cuts it
        assert partial in ("partial=00", f"partial={cut}")
        assert b - a + 1 >= (60 if partial != "partial=00" else 90)


def test_gene_model(written):
    """Both strands in co-directed runs, some stop/start overlaps, most
    of each scaffold coding, partial genes at scaffold ends."""
    _, lay, path, refs = written
    recs = _records(path)
    strands = [h[3] for h, _ in recs]
    assert {"1", "-1"} <= set(strands)
    turns = sum(a != b for a, b in zip(strands, strands[1:]))
    assert turns < len(strands) / 2
    overlaps = coding = 0
    for s in lay.names:
        genes = [(int(h[1]), int(h[2])) for h, _ in recs
                 if h[0].rsplit("_", 1)[0] == s]
        overlaps += sum(a2 <= b1 for (_, b1), (a2, _) in zip(genes,
                                                             genes[1:]))
        cover = np.zeros(len(refs[s]), dtype=bool)
        for a, b in genes:
            cover[a - 1:b] = True
        coding += cover.sum()
    assert overlaps > 0
    assert 0.8 < coding / sum(len(r) for r in refs.values()) < 0.95
    assert any("partial=00" not in h[4] for h, _ in recs)


def test_same_seed_same_file(written, tmp_path):
    cfg, lay, path, _ = written
    again = genes_input.write(cfg, SEED, lay, str(tmp_path))
    with open(path, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()
    (tmp_path / "other").mkdir()
    other = genes_input.write(cfg, SEED + 1, gen.layout(cfg, SEED + 1),
                              str(tmp_path / "other"))
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() != g.read()


def test_the_cell_is_found_by_name():
    man = registry.manifest()
    cell = registry.workload(man, "metagenome.genes")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "metagenome_genes", "genes", 1)
    assert registry.config(man, cell["config"])["genes"]
    traffic = registry.traffic(cell["traffic"])
    ext = registry.extensions(traffic, judge.LIMITS)
    assert list(ext.writers) == ["genes"] and list(ext.checks) == ["genes"]
    assert ext.limits == dict(judge.LIMITS, **check.LIMITS)
    args = registry.resolve_args(traffic["args"], {"genes": "/x/genes.fna"})
    assert args[-2:] == ["-g", "/x/genes.fna"]
    assert args[:-2] == registry.traffic("profile")["args"]


def test_the_configuration_is_the_metagenome_sample_with_genes():
    """Every key of the metagenome configuration but its source and its
    assumed figures is the same, so the genes cell profiles
    metagenome.profile's sample; the gene model is the one key added."""
    meta, genes = _config("metagenome"), _config("metagenome_genes")
    for k in set(meta) - {"source", "assumed"}:
        assert genes[k] == meta[k], k
    assert set(genes) - set(meta) == {"gene_model_source", "genes"}
    assert set(meta["assumed"]) <= set(genes["assumed"])
    man = registry.manifest()
    entry = {c["name"]: c for c in man["configs"]}
    assert entry["metagenome_genes"]["reduced"] == ["genomes"]
    assert (entry["metagenome_genes"]["source"]
            != entry["metagenome"]["source"])


def test_the_gene_metrics_are_the_cells_alone():
    man = registry.manifest()
    names = {m["name"] for m in registry.cell_metrics(man, "metagenome.genes",
                                                      "per_layer")}
    assert names == NEW_METRICS
    for cell in ("metagenome.profile", "isolate.profile"):
        assert not NEW_METRICS & {m["name"] for m in registry.cell_metrics(
            man, cell, "per_layer")}
    for name in NEW_METRICS:
        assert os.path.exists(os.path.join(registry.BENCH_DIR, "metrics",
                                           name + ".py"))


def test_the_check_fails_a_changed_reference(written):
    """Its own reference passes; a gene left out of it, a mutation type
    changed in it, or its control does not."""
    from benchmark.ref.profile import reference
    cfg, lay, path, _ = written
    paths = {"genes": path}
    ref = check.reference(cfg, SEED, lay, paths, reference(cfg, SEED),
                          "reference")
    assert len(ref["gene_info"]) and len(ref["snvs"])

    def correct(prog, r):
        nums = registry.check_numbers(check, prog, r)
        return judge.verdict(nums, check.LIMITS)

    assert correct(ref, ref)
    assert not correct(ref, dict(ref, gene_info=ref["gene_info"].iloc[1:]))
    snvs = ref["snvs"].copy()
    typed = snvs.index[snvs["mutation_type"].isin(["N", "S"])][0]
    snvs.loc[typed, "mutation_type"] = (
        "S" if snvs.loc[typed, "mutation_type"] == "N" else "N")
    assert not correct(ref, dict(ref, snvs=snvs))
    low = check.reference(cfg, SEED, lay, paths,
                          reference(cfg, SEED, precision="control"),
                          "control")
    assert not correct(low, ref)
