"""
Options of `profile` and `compare` held against the JAX package, one case
per option set.

  - `instrain_tpu_torch profile --device cpu` against `instrain_tpu
    profile --engine dense` on one synth input (4 scaffolds of 5 kb at
    40x): the four TSVs byte for byte under each option set, and the same
    error where an option leaves no pairs.
  - `instrain_tpu_torch compare --device cpu` against `instrain_tpu
    compare` on the JAX package's profiles of a 3-sample synth_samples
    input (4 scaffolds of 5 kb): every comparison TSV byte for byte under
    --group_length small enough to make four groups and two (the overlap
    kernel's plain version runs once per group), and under -ani / -cov.
    Both run in this process, so Python's set order, which compare's row
    order follows, is the same for both.
"""

import os

import numpy as np
import pytest

from instrain_tpu.cli import main as jax_main
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.store.profile_dir import ProfileDir
from instrain_tpu_torch.synth import synth, synth_samples

TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]

# "{d}" is the test's directory, where it writes the files an option reads
PROFILE_OPTIONS = {
    "defaults": [],
    "pairing_all_reads": ["--pairing_filter", "all_reads"],
    "pairing_non_discordant": ["--pairing_filter", "non_discordant"],
    "min_read_ani": ["--min_read_ani", "0.9"],
    "min_mapq": ["--min_mapq", "10"],
    "min_cov": ["-c", "10"],
    "maximum_reads": ["--maximum_reads", "3000"],
    "min_snp": ["--min_snp", "3"],
    "min_freq": ["-f", "0.1"],
    "fdr": ["-fdr", "1e-3"],
    "rarefied_coverage": ["--rarefied_coverage", "20"],
    "window_length": ["--window_length", "1000"],
    "min_scaffold_reads": ["--min_scaffold_reads", "2000"],
    "max_insert_relative": ["--max_insert_relative", "1.5"],
    "skip_mm_profiling": ["--skip_mm_profiling"],
    "database_mode": ["--database_mode"],
    "use_full_fasta_header": ["--use_full_fasta_header"],
    "store_everything": ["--store_everything"],
    "detailed_mapping_info": ["--detailed_mapping_info"],
    "min_genome_coverage": ["--min_genome_coverage", "30"],
    "scaffolds_to_profile": ["--scaffolds_to_profile", "{d}/scaffolds.txt"],
    "priority_reads": ["--priority_reads", "{d}/priority.txt"],
    "priority_reads_maximum": ["--priority_reads", "{d}/priority.fastq",
                               "--maximum_reads", "3000"],
    "null_model_file": ["--null_model", "{d}/NullModel.txt"],
}


def write_null_model(path, error_rate=0.005, max_coverage=3000):
    """An inStrain-format NullModel.txt from the analytic model at
    error_rate (5x the default's): row N holds 3 * P(Binom(N, rate / 3)
    >= e) for e = 1..18, up to max_coverage (deeper positions take the
    file's largest threshold)."""
    from scipy.stats import binom
    covs = np.arange(1, max_coverage + 1)
    e = np.arange(1, 19)
    prob = 3 * binom.sf(e[None, :] - 1, covs[:, None], error_rate / 3)
    with open(path, "w") as f:
        f.write("coverage\t" + "\t".join(map(str, e)) + "\n")
        for n, row in zip(covs, prob):
            f.write(f"{n}\t" + "\t".join(repr(float(x)) for x in row) +
                    "\n")


@pytest.fixture(scope="module")
def synth_input(tmp_path_factory):
    """The synth input, and the files the options read: two of its four
    scaffolds, and every 5th read pair's name (as a list and as FASTQ)."""
    d = tmp_path_factory.mktemp("options")
    fasta, bam, _ = synth(str(d), S=4, L=5000, COV=40, seed=3)
    with open(d / "scaffolds.txt", "w") as f:
        f.write("scaf_1\nscaf_3\n")
    names = [f"r{q}" for q in range(0, 2600, 5)]
    with open(d / "priority.txt", "w") as f:
        f.write("\n".join(names) + "\n")
    with open(d / "priority.fastq", "w") as f:
        f.write("".join(f"@{n}\nACGT\n+\nIIII\n" for n in names[::2]))
    write_null_model(str(d / "NullModel.txt"))
    return str(d), fasta, bam


def _tsv(out, table):
    path = os.path.join(out, "output", f"{os.path.basename(out)}_{table}.tsv")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(PROFILE_OPTIONS))
def test_profile_option_matches_jax(synth_input, case):
    d, fasta, bam = synth_input
    extra = [x.format(d=d) for x in PROFILE_OPTIONS[case]]
    port, jax = (os.path.join(d, f"{tag}_{case}.IS") for tag in ("port",
                                                                 "jax"))
    assert port_main(["profile", bam, fasta, "-o", port, "--device", "cpu"]
                     + FLAGS + extra) == 0
    assert jax_main(["profile", bam, fasta, "-o", jax, "--engine", "dense"]
                    + FLAGS + extra) == 0
    for table in TABLES:
        assert _tsv(port, table) == _tsv(jax, table), table
    # (SNVs may be empty: --min_scaffold_reads 2000 keeps no scaffold)
    assert len(_tsv(jax, "mapping_info").splitlines()) > 2


def test_null_model_file_is_read(synth_input):
    """The file written from the analytic model at error rate 0.005 gives
    that model's thresholds up to its last coverage, and they differ from
    the default model's."""
    from instrain_tpu_torch.kernels.nullmodel import (
        analytic_null_thresholds, null_thresholds)
    d, _, _ = synth_input
    got = null_thresholds(os.path.join(d, "NullModel.txt"))
    want = analytic_null_thresholds(error_rate=0.005)
    np.testing.assert_array_equal(got[:3001], want[:3001])
    assert (got[3001:] == want[:3001].max()).all()
    assert (got[1:3001] > analytic_null_thresholds()[1:3001]).any()


def _gz_texts(out, plain_ok=False):
    """{table: decompressed bytes} of a run's .tsv.gz outputs; plain_ok
    takes a file that is not gzipped as it is (the JAX package writes
    mapping_info as plain text under its .tsv.gz name)."""
    import gzip
    od = os.path.join(out, "output")
    got = {}
    for f in sorted(os.listdir(od)):
        assert f.endswith(".tsv.gz"), f
        table = f[len(os.path.basename(out)) + 1:-len(".tsv.gz")]
        with open(os.path.join(od, f), "rb") as fh:
            raw = fh.read()
        if raw[:2] == b"\x1f\x8b" or not plain_ok:
            raw = gzip.decompress(raw)
        got[table] = raw
    return got


def test_profile_debug_and_force_compress_match_jax(synth_input):
    """-d writes runtime_summary.txt in both packages, with the same
    section headers; --force_compress gzips every table, and each .gz
    decompresses to the JAX package's bytes (mapping_info too, which the
    JAX package leaves as plain text under its .gz name)."""
    d, fasta, bam = synth_input
    outs = {}
    for tag, runner, extra in ((("port", port_main, ["--device", "cpu"]),
                                ("jax", jax_main, ["--engine", "dense"]))):
        outs[tag] = os.path.join(d, f"{tag}_debug_gz.IS")
        assert runner(["profile", bam, fasta, "-o", outs[tag], "-d",
                       "--force_compress"] + FLAGS + extra) == 0
    got = _gz_texts(outs["port"])
    assert sorted(got) == sorted(TABLES)
    assert got == _gz_texts(outs["jax"], plain_ok=True)
    # the port's mapping_info reads back through its .gz name
    mi = ProfileDir(outs["port"]).load_output("mapping_info")
    assert mi["scaffold"].iloc[0] == "all_scaffolds"
    headers = {}
    for tag, out in outs.items():
        with open(os.path.join(out, "log", "runtime_summary.txt")) as f:
            headers[tag] = [l for l in f.read().splitlines()
                            if l.startswith(".:: ")]
    assert headers["port"] == headers["jax"]
    assert ".:: Failures ::." in headers["port"]
    assert ".:: Checkpoints: main_profile ::." in headers["port"]


def test_min_insert_leaving_no_pairs_fails_alike(synth_input):
    """--min_insert above every insert leaves no pairs: both packages stop
    with the same error."""
    d, fasta, bam = synth_input
    errors = []
    for runner, tag, engine in ((port_main, "port", ["--device", "cpu"]),
                                (jax_main, "jax", ["--engine", "dense"])):
        with pytest.raises(Exception) as e:
            runner(["profile", bam, fasta, "-o", os.path.join(
                d, f"{tag}_min_insert.IS"), "--min_insert", "400"] + FLAGS +
                engine)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]
    assert "No paired reads remain" in errors[0][1]


# ---------------------------------------------------------------- compare

COMPARE_TABLES = ["comparisonsTable", "genomeWide_compare", "strain_clusters",
                  "pairwise_SNP_locations"]
COMPARE_OPTIONS = {
    "group_length_5000": ["--group_length", "5000"],        # 4 groups
    "group_length_10000": ["--group_length", "10000"],      # 2 groups
    "ani_cov": ["-ani", "0.999", "-cov", "0.5"],
    "cluster_single": ["--clusterAlg", "single", "-ani", "0.999"],
    "cluster_complete": ["--clusterAlg", "complete", "-ani", "0.999"],
}


@pytest.fixture(scope="module")
def jax_sample_profiles(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("samples"))
    fasta, bams, stb = synth_samples(d, 3, 4, 5000, [12, 25, 40], seed=5)
    outs = []
    for i, bam in enumerate(bams):
        out = os.path.join(d, f"jax{i}.IS")
        assert jax_main(["profile", bam, fasta, "-o", out, "-s", stb,
                         "--skip_plot_generation", "--engine", "dense"]) == 0
        outs.append(out)
    return d, outs, stb


@pytest.mark.parametrize("case", sorted(COMPARE_OPTIONS))
@pytest.mark.parametrize("engine", ["host", "device"])
def test_compare_option_matches_jax(jax_sample_profiles, case, engine):
    d, profiles, stb = jax_sample_profiles
    flags = ["-s", stb, "--skip_plot_generation",
             "--store_mismatch_locations"] + COMPARE_OPTIONS[case]
    port = os.path.join(d, f"port_{case}_{engine}.RC")
    jax = os.path.join(d, f"jax_{case}_{engine}.RC")
    assert port_main(["compare", "-i"] + profiles + ["-o", port, "--device",
                      "cpu", "--engine", engine] + flags) == 0
    assert jax_main(["compare", "-i"] + profiles + ["-o", jax, "--engine",
                     "host"] + flags) == 0
    for table in COMPARE_TABLES:
        want = _tsv(jax, table)
        assert _tsv(port, table) == want, table
        assert len(want.splitlines()) > 1, table


def test_compare_force_compress_matches_jax(jax_sample_profiles):
    """compare --force_compress gzips comparisonsTable; it decompresses to
    the JAX package's bytes."""
    import gzip
    d, profiles, stb = jax_sample_profiles
    texts = {}
    for tag, runner, extra in (("port", port_main, ["--device", "cpu"]),
                               ("jax", jax_main, [])):
        out = os.path.join(d, f"{tag}_gz.RC")
        assert runner(["compare", "-i"] + profiles + ["-o", out, "-s", stb,
                       "--skip_plot_generation", "--force_compress"] +
                      extra) == 0
        with gzip.open(os.path.join(out, "output", f"{tag}_gz.RC_"
                                    f"comparisonsTable.tsv.gz")) as f:
            texts[tag] = f.read()
    assert texts["port"] == texts["jax"]
    assert len(texts["jax"].splitlines()) > 1
