"""
Gene profiling of the port against the JAX package on the same inputs:
the codon machinery, both gene-file parsers, SNV classification and gene
SNV counts, `profile -g` for each engine, and `profile_genes` over a
stored profile.

The input is one synth BAM (4 scaffolds of 8 kb at 40x, seed 3) with the
gene files of synth_genes (seed 0), sized so that its SNVs fall in every
class: S and N in one gene, I in none, M in more than one. Tables and
TSVs must be byte-identical; count_sites within 1e-12. The port sums a
gene's nucleotide diversity in f64 in both paths, as the JAX package's
stored-profile path (calc_gene_clonality_series) does, where the JAX
package's inline path sums in f32: so profile -g's gene_info and
genes_clonality are held to the JAX package's profile_genes over its own
profile, and every other table to its profile -g.
"""

import gzip
import os
import re
import shutil

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.cli import main as jax_main
from instrain_tpu.profile import genes as JG
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.profile import genes as PG
from instrain_tpu_torch.store import profile_dir as PD
from instrain_tpu_torch.synth import synth, synth_genes

FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]
TSVS = ["SNVs", "gene_info", "scaffold_info", "linkage"]
GENE_ATTRS = ["genes_table", "genes_coverage", "genes_clonality",
              "genes_SNP_count", "SNP_mutation_types"]
CLASSES = {"S", "N", "I", "M"}
F64_DIVERSITY = {"gene_info", "genes_clonality"}


@pytest.fixture(scope="module")
def gene_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("genes")
    fasta, bam, _ = synth(str(d), S=4, L=8000, COV=40, seed=3)
    fna, gb = synth_genes(fasta, seed=0)
    return str(d), fasta, bam, fna, gb


def _profile_pair(d, fasta, bam, engine, genes, name="", stored_genes=None):
    """The port's profile on the CPU and the JAX package's, both with the
    same engine and gene file, and the JAX package's profile_genes with
    that file (or `stored_genes`) over a copy of its profile."""
    tag = f"{name}{engine}_{os.path.splitext(genes)[1][1:]}"
    port, jax = os.path.join(d, f"port_{tag}.IS"), os.path.join(
        d, f"jax_{tag}.IS")
    assert port_main(["profile", bam, fasta, "-o", port, "--device", "cpu",
                      "--engine", engine, "-g", genes] + FLAGS) == 0
    assert jax_main(["profile", bam, fasta, "-o", jax, "--engine", engine,
                     "-g", genes] + FLAGS) == 0
    jax_genes = shutil.copytree(jax, os.path.join(d, f"jaxgenes_{tag}.IS"))
    assert jax_main(["profile_genes", "-i", jax_genes,
                     "-g", stored_genes or genes]) == 0
    return port, jax, jax_genes


@pytest.fixture(scope="module")
def profiled(gene_input):
    """engine -> (port dir, JAX dir), prodigal genes."""
    d, fasta, bam, fna, _ = gene_input
    return {e: _profile_pair(d, fasta, bam, e, fna)
            for e in ("dense", "hybrid", "batch")}


def _tsv(out, table):
    path = os.path.join(out, "output", f"{os.path.basename(out)}_{table}.tsv")
    with open(path) as f:
        return f.read()


def _raw(out, attr):
    """An attribute's stored text (a pandas table's CSV, decompressed)."""
    value = pd.read_csv(os.path.join(out, "raw_data", "attributes.tsv"),
                        sep="\t", index_col="name").loc[attr, "value"]
    path = os.path.join(out, "raw_data", os.path.basename(value))
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def _assert_same_profiles(port, jax, jax_genes=None):
    """Byte for byte: the gene diversity tables against `jax_genes` (the
    JAX package's f64 diversity, see above), the rest against `jax`."""
    jax_genes = jax_genes or jax
    for t in TSVS:
        want = jax_genes if t in F64_DIVERSITY else jax
        assert _tsv(port, t) == _tsv(want, t), t
    for attr in GENE_ATTRS:
        want = jax_genes if attr in F64_DIVERSITY else jax
        assert _raw(port, attr) == _raw(want, attr), attr


def _classes(out):
    snv = pd.read_csv(os.path.join(
        out, "output", f"{os.path.basename(out)}_SNVs.tsv"), sep="\t")
    return set(snv["mutation_type"].dropna())


def _failures(out):
    with open(os.path.join(out, "log", "log.log")) as f:
        return [l.split("FAILURE", 1)[1].strip() for l in f
                if "FAILURE" in l]


# ---------------------------------------------------------------- codons

def test_codon_functions_match_jax():
    """count_sites within 1e-12, translate and revcomp equal, on random
    sequences with N, '---', stops, lowercase and U, some not a whole
    number of codons."""
    rng = np.random.default_rng(0)
    alphabet = list("ACGTACGTACGTNacgtU-")
    stops = ["TAA", "TAG", "TGA"]
    for i in range(200):
        n = int(rng.integers(0, 80))
        codons = ["".join(rng.choice(alphabet, 3)) for _ in range(n)]
        for j in rng.integers(0, max(n, 1), 3) if n else []:
            codons[j] = rng.choice(stops + ["---", "NNN", "ANG"])
        seq = "".join(codons) + "ACGT"[:i % 3]
        js, jn = JG.count_sites(seq)
        ps, pn = PG.count_sites(seq)
        assert abs(js - ps) <= 1e-12 and abs(jn - pn) <= 1e-12, seq
        assert PG.translate(seq) == JG.translate(seq)
        assert PG.revcomp(seq) == JG.revcomp(seq)
    assert PG.count_sites("") == JG.count_sites("") == (0.0, 0.0)
    assert PG.translate("ATGGCT") == "MA"
    assert PG.translate("TAATAGTGA") == "***"
    assert PG.CODON_TABLE == JG.CODON_TABLE
    assert PG.STOP_CODONS == JG.STOP_CODONS


# ---------------------------------------------------------------- parsers

@pytest.mark.parametrize("kind", ["fna", "gb"])
def test_parse_genes_matches_jax(gene_input, kind):
    path = gene_input[3 if kind == "fna" else 4]
    want, got = JG.parse_genes(path), PG.parse_genes(path)
    pd.testing.assert_frame_equal(got.gene_table, want.gene_table)
    assert list(got.scaff2genes) == list(want.scaff2genes)
    for s, df in want.scaff2genes.items():
        pd.testing.assert_frame_equal(got.scaff2genes[s], df)
    assert got.gene2sequence == want.gene2sequence
    table = got.gene_table
    # the layout's cases: both strands, a partial gene, one past its
    # scaffold's end, a scaffold absent from the FASTA, one without genes
    assert set(table["direction"].astype(str)) == {"1", "-1"}
    assert "scaf_absent" in got.scaff2genes
    assert "scaf_3" not in got.scaff2genes
    past = table[table["end"] >= 8000]
    assert len(past) == 1 and past["scaffold"].iloc[0] == "scaf_0"
    if kind == "fna":
        assert past["partial"].iloc[0] == True  # noqa: E712
    else:
        assert (table["partial"] == "compound").sum() == 1
    starts = table.sort_values(["scaffold", "start"])
    overlap = (starts.groupby("scaffold")["end"].shift() >=
               starts["start"])
    assert overlap.any()


# ---------------------------------------------------------------- SNV types

def test_characterize_snps_synthetic():
    """A known synonymous and non-synonymous mutation classify right, in
    both packages (tests/test_genes.py's case)."""
    gdb = pd.DataFrame([{"gene": "g1", "scaffold": "s", "direction": "1",
                         "partial": False, "start": 10, "end": 21}])
    g2s = {"g1": "ATGGCTGCTTAA"}  # M A A *
    sdb = pd.DataFrame([
        {"position": 15, "con_base": "C", "var_base": "C",
         "ref_base": "T"},
        {"position": 14, "con_base": "T", "var_base": "T",
         "ref_base": "C"},
    ])
    out = PG.characterize_snps(gdb, sdb, g2s)
    assert list(out["mutation_type"]) == ["S", "N"]
    assert out["mutation"].iloc[1].startswith("N:A")
    pd.testing.assert_frame_equal(out, JG.characterize_snps(gdb, sdb, g2s))


def _random_genes(rng, n_genes, L, genbank):
    rows, g2s = [], {}
    for k in range(n_genes):
        a = int(rng.integers(0, L - 30))
        b = min(a + 3 * int(rng.integers(5, 60)) - 1, L + 20)
        strand = int(rng.choice([1, -1]))
        gene = f"s_{k}"
        rows.append(dict(gene=gene, scaffold="s",
                         direction=strand if genbank else str(strand),
                         partial=bool(rng.random() < 0.2), start=a, end=b))
        seq = "".join(rng.choice(list("ACGTACGTACGTNacgt"), b - a + 1))
        if rng.random() < 0.1:           # a compound gene's short sequence
            seq = seq[:len(seq) // 2]
        g2s[gene] = seq
    return pd.DataFrame(rows), g2s


def _random_snvs(rng, L, n, n_mm):
    """A cumulative SNV table: positions seen at one or more mm levels,
    allele counts 1-4 (1 and 2 are classified), random bases."""
    pos = np.sort(rng.choice(L, n, replace=False))
    rows = []
    for p in pos:
        for mm in sorted(rng.choice(n_mm, int(rng.integers(1, n_mm + 1)),
                                    replace=False)):
            con, var = rng.choice(list("ACGT"), 2)
            rows.append(dict(scaffold="s", position=int(p),
                             position_coverage=int(rng.integers(5, 60)),
                             allele_count=int(rng.choice([1, 2, 2, 3, 4])),
                             ref_base=str(rng.choice(list("ACGTN"))),
                             con_base=str(con), var_base=str(var),
                             mm=int(mm)))
    return pd.DataFrame(rows)


@pytest.mark.parametrize("genbank", [False, True])
def test_snv_classes_and_counts_random(genbank):
    """characterize_snps, its wrapper and calc_gene_snp_counts on random
    genes (both strands, prodigal string or GenBank integer strands,
    genes past the scaffold's end, sequences shorter than their span,
    N and lowercase bases) and a random cumulative SNV table over four mm
    levels: equal to the JAX package's."""
    rng = np.random.default_rng(5 + genbank)
    L = 3000
    gdb, g2s = _random_genes(rng, 40, L, genbank)
    ldb = _random_snvs(rng, L, 300, 4)
    sdb_in = ldb.drop_duplicates("position", keep="last").drop(
        columns=["mm"])
    got = PG.characterize_snps(gdb, sdb_in, g2s)
    pd.testing.assert_frame_equal(got, JG.characterize_snps(gdb, sdb_in, g2s))
    assert set(got["mutation_type"]) == CLASSES
    want_w = JG.characterize_snps_wrapper(ldb, gdb, g2s)
    got_w = PG.characterize_snps_wrapper(ldb, gdb, g2s)
    pd.testing.assert_frame_equal(got_w, want_w)
    pd.testing.assert_frame_equal(
        PG.calc_gene_snp_counts(gdb, ldb, got_w, g2s),
        JG.calc_gene_snp_counts(gdb, ldb, want_w, g2s))
    # no classified SNV, and a gene whose sequence is missing
    one = ldb[ldb["allele_count"] > 2]
    g2s_missing = {k: v for k, v in g2s.items() if k != "s_0"}
    pd.testing.assert_frame_equal(
        PG.calc_gene_snp_counts(gdb, one, pd.DataFrame(), g2s_missing),
        JG.calc_gene_snp_counts(gdb, one, pd.DataFrame(), g2s_missing))


# ---------------------------------------------------------------- profile -g

@pytest.mark.parametrize("engine", ["dense", "hybrid", "batch"])
def test_profile_genes_match_jax(profiled, engine):
    """profile -g --device cpu against instrain_tpu profile -g with the
    same engine: gene_info, SNVs (with mutation_type, mutation, gene),
    the other TSVs and the stored gene tables, byte for byte."""
    port, jax, jax_genes = profiled[engine]
    _assert_same_profiles(port, jax, jax_genes)
    assert _classes(port) == CLASSES
    assert _failures(port) == _failures(jax) == []
    info = pd.read_csv(os.path.join(
        port, "output", f"{os.path.basename(port)}_gene_info.tsv"),
        sep="\t")
    assert len(info) > 0 and (info["coverage"] > 0).all()
    assert "scaf_3" not in set(info["scaffold"])
    assert info["pNpS_variants"].notna().any()


def test_profile_genes_engines_agree(profiled):
    """The three engines give the same gene tables: nucl_diversity within
    the cross-engine tolerance of tests/test_torch_batch.py (1e-6; the
    engines' f32 clonality may differ in its last bit at a site), every
    other column byte for byte."""
    def read(out):
        info = pd.read_csv(os.path.join(
            out, "output", f"{os.path.basename(out)}_gene_info.tsv"),
            sep="\t")
        return info.pop("nucl_diversity").values, info.to_csv()

    div, rest = read(profiled["dense"][0])
    for engine in ("hybrid", "batch"):
        d, r = read(profiled[engine][0])
        assert r == rest, engine
        assert np.array_equal(np.isnan(d), np.isnan(div)), engine
        m = ~np.isnan(div)
        assert np.allclose(d[m], div[m], rtol=1e-6, atol=1e-6), engine


def test_profile_genbank_matches_jax(gene_input):
    """A GenBank gene file (integer strands, a join(...) CDS, partial
    spans) through profile -g, against the JAX package."""
    d, fasta, bam, _, gb = gene_input
    port, jax, jax_genes = _profile_pair(d, fasta, bam, "dense", gb)
    _assert_same_profiles(port, jax, jax_genes)
    assert _classes(port) == CLASSES


def test_gene_exception_is_logged_like_jax(gene_input):
    """A gene starting past its scaffold's end fails that scaffold's gene
    profiling: logged as a GeneException, as the JAX package logs it,
    while the scaffold's other tables stay. The gene diversity tables
    equal the JAX package's profile_genes with scaf_1's genes left out."""
    d, fasta, bam, fna, _ = gene_input
    bad = os.path.join(d, "bad.genes.fna")
    with open(fna) as f, open(bad, "w") as out:
        out.write(f.read())
        out.write(">scaf_1_99 # 8100 # 8400 # 1 # ID=9_9;partial=00\n" +
                  "A" * 301 + "\n")
    others = os.path.join(d, "others.genes.fna")
    with open(fna) as f, open(others, "w") as out:
        out.write("".join(">" + r for r in f.read().split(">")[1:]
                          if not r.startswith("scaf_1_")))
    port, jax, jax_genes = _profile_pair(d, fasta, bam, "hybrid", bad,
                                         name="bad_", stored_genes=others)
    assert _failures(port) == _failures(jax)
    assert len(_failures(port)) == 1
    assert re.match(r"GeneException scaf_1 ", _failures(port)[0])
    assert "scaf_1" in PD.ProfileDir(port).get("scaffold_list")
    _assert_same_profiles(port, jax, jax_genes)


# ---------------------------------------------------------------- profile_genes

def test_profile_genes_command_matches_jax(gene_input, profiled, tmp_path,
                                           monkeypatch):
    """profile_genes with the GenBank file over a copy of each package's
    dense profile equals the JAX package's; over a copy whose covT and
    clonT are pickles (where h5py is missing) it gives the same bytes."""
    gb = gene_input[4]
    port, jax = (shutil.copytree(p, str(tmp_path / os.path.basename(p)))
                 for p in profiled["dense"][:2])
    assert port_main(["profile_genes", "-i", port, "-g", gb]) == 0
    assert jax_main(["profile_genes", "-i", jax, "-g", gb]) == 0
    _assert_same_profiles(port, jax)
    assert _classes(port) == CLASSES

    # the same profile stored without h5py, then profile_genes on it
    d, fasta, bam, _, _ = gene_input
    monkeypatch.setattr(PD, "_h5py", lambda: None)
    pick = str(tmp_path / "pickled.IS")
    assert port_main(["profile", bam, fasta, "-o", pick, "--device", "cpu",
                      "--engine", "dense"] + FLAGS) == 0
    attrs = pd.read_csv(os.path.join(pick, "raw_data", "attributes.tsv"),
                        sep="\t", index_col="name")
    assert attrs.loc["covT", "value"].endswith(".pickle")
    assert port_main(["profile_genes", "-i", pick, "-g", gb]) == 0
    for t in ("SNVs", "gene_info"):
        assert _tsv(pick, t) == _tsv(port, t), t
