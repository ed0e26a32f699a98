"""
The port's figures (plotting/) against the JAX package's.

  - The figure data: load_windowed_metrics, _ld_window_means,
    _symmetric_matrix, mm_for_ani and _allowed_scaffolds give the JAX
    functions' values on the same stored profile, exactly (host numpy on
    the same tables).
  - The figures: under SOURCE_DATE_EPOCH=0 (matplotlib then writes a
    fixed creation date), the port's make_plots over `instrain_tpu_torch
    profile -g --device cpu` and the JAX package's over `instrain_tpu
    profile -g` (its gene tables made again by its `profile_genes`, as
    tests/test_torch_genes.py holds them), of one synth input (4
    scaffolds of 8 kb at 60x, the genes of synth_genes), write the same
    nine PDFs byte for byte; plot 10 the
    same over both packages' `compare -s` of three synth_samples
    profiles. Profile and compare without --skip_plot_generation draw
    them; without matplotlib they log the failure, exit 0 and write the
    same TSVs, and `plot` raises ImportError, as the JAX package's does.
  - The `plot` subcommand with -pl, -g and -mb writes the JAX package's
    file set.
"""

import logging
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.cli import main as jax_main
from instrain_tpu.plotting import plots as JP
from instrain_tpu.plotting import windowed as JW
from instrain_tpu.plotting.controller import make_plots as jax_make_plots
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.plotting import plots as PP
from instrain_tpu_torch.plotting import windowed as PW
from instrain_tpu_torch.plotting.controller import make_plots
from instrain_tpu_torch.store.profile_dir import ProfileDir
from instrain_tpu_torch.synth import synth, synth_genes, synth_samples

PROFILE_FIGURES = [
    "CoverageAndBreadth_vs_readMismatch.pdf",
    "genomeWide_microdiveristy_metrics.pdf", "readANI_distribution.pdf",
    "MajorAllele_frequency_plot.pdf", "LinkageDecay_plot.pdf",
    "ReadFiltering_plot.pdf", "ScaffoldInspection_plot.pdf",
    "LinkageDecay_types_plot.pdf", "GeneHistogram_plot.pdf"]
DENDROGRAMS = "inStrainCompare_dendrograms.pdf"


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    """One synth input with genes and a two-genome .stb, profiled by each
    package into p.IS under a directory of its own (the figures' file
    names carry the basename), with --skip_plot_generation; the JAX
    package's gene tables then made again by its profile_genes."""
    d = tmp_path_factory.mktemp("plots")
    fasta, bam, _ = synth(str(d), S=4, L=8000, COV=60, seed=3)
    genes, _ = synth_genes(fasta, seed=0)
    stb = str(d / "g.stb")
    with open(stb, "w") as f:
        f.write("".join(f"scaf_{s}\tgenome_{s // 2}\n" for s in range(4)))
    flags = ["-g", genes, "-s", stb, "--skip_plot_generation"]
    out = {}
    for tag, runner, extra in (("jax", jax_main, []),
                               ("port", port_main, ["--device", "cpu"])):
        os.makedirs(d / tag)
        out[tag] = str(d / tag / "p.IS")
        assert runner(["profile", bam, fasta, "-o", out[tag]] + flags +
                      extra) == 0
    # the JAX package's gene tables from its stored-profile path, whose
    # f64 diversity sum the port's profile -g shares (test_torch_genes.py)
    assert jax_main(["profile_genes", "-i", out["jax"], "-g", genes]) == 0
    return str(d), fasta, bam, genes, stb, out


def _figures(out):
    fd = os.path.join(out, "figures")
    base = os.path.basename(out)
    got = {}
    for f in sorted(os.listdir(fd)):
        assert f.startswith(base + "_"), f
        with open(os.path.join(fd, f), "rb") as fh:
            got[f[len(base) + 1:]] = fh.read()
    return got


def _tsvs(out):
    od = os.path.join(out, "output")
    got = {}
    for f in sorted(os.listdir(od)):
        with open(os.path.join(od, f), "rb") as fh:
            got[f] = fh.read()
    return got


def _rerun_dir(out, dest):
    """A copy of a profile directory, its figures removed."""
    shutil.copytree(out, dest)
    shutil.rmtree(os.path.join(dest, "figures"))
    return dest


# ---------------------------------------------------------------- data


def test_figure_data_matches_jax(profiles):
    *_, out = profiles
    j, p = JaxProfileDir(out["jax"]), ProfileDir(out["port"])
    rl = p.get_read_length()
    assert rl == j.get_read_length() and rl > 200
    for ani in (0, 95, 99.5, 100, 0.98):
        assert PW.mm_for_ani(rl, ani) == JW.mm_for_ani(rl, ani)
    s2l = p.get("scaffold2length")
    args = dict(covTs=p.get("covT"), clonTs=p.get("clonT"),
                raw_linkage_table=p.get("raw_linkage_table"),
                cumulative_snv_table=p.get("cumulative_snv_table"))
    jargs = dict(covTs=j.get("covT"), clonTs=j.get("clonT"),
                 raw_linkage_table=j.get("raw_linkage_table"),
                 cumulative_snv_table=j.get("cumulative_snv_table"))
    for scaffolds, window in ((["scaf_0", "scaf_1"], None),
                              (list(s2l), 1000), (["scaf_3"], 777)):
        got = PW.load_windowed_metrics(scaffolds, s2l, rl,
                                       window_len=window, **args)
        want = JW.load_windowed_metrics(scaffolds, s2l, rl,
                                        window_len=window, **jargs)
        pd.testing.assert_frame_equal(got[0], want[0])
        assert got[1:] == want[1:]
        assert set(got[0]["metric"]) == {"coverage", "nucl_diversity",
                                         "linkage", "snp_density"}
    ldb = p.get("raw_linkage_table")
    assert len(ldb) > 5
    for kw in ({}, {"chunk_size": 7, "min_vals": None},
               {"min_vals": 2, "max_d": 400}):
        pd.testing.assert_frame_equal(PP._ld_window_means(ldb, **kw),
                                      JP._ld_window_means(ldb, **kw))
    rng = np.random.default_rng(0)
    names = ["a", "b", "c", "d"]
    rows = [(a, b, v) for a in names for b in names
            if a != b for v in [rng.random()] if rng.random() < 0.7]
    gdb = pd.DataFrame(rows, columns=["name1", "name2", "popANI"])
    pd.testing.assert_frame_equal(PP._symmetric_matrix(gdb, "popANI"),
                                  JP._symmetric_matrix(gdb, "popANI"))
    for kw in ({}, {"minimum_breadth": 0.99}, {"minimum_breadth": 1.01},
               {"genomes": ["genome_1"]}, {"genomes": []}):
        got = PP._allowed_scaffolds(p, **kw)
        assert got == JP._allowed_scaffolds(j, **kw), kw
    assert PP._allowed_scaffolds(p, minimum_breadth=0.99) == set(s2l)


# ---------------------------------------------------------------- figures


def test_figures_match_jax_byte_for_byte(profiles, tmp_path, monkeypatch):
    """make_plots over each package's profile: the nine figures, each PDF
    byte-identical, over 1,000 bytes."""
    *_, out = profiles
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    dirs = {t: _rerun_dir(out[t], str(tmp_path / t / "p.IS"))
            for t in out}
    assert jax_make_plots(JaxProfileDir(dirs["jax"])) == \
        [str(i) for i in range(1, 10)]
    assert make_plots(ProfileDir(dirs["port"])) == \
        [str(i) for i in range(1, 10)]
    want, got = _figures(dirs["jax"]), _figures(dirs["port"])
    assert sorted(got) == sorted(PROFILE_FIGURES)
    for name in PROFILE_FIGURES:
        assert got[name] == want[name], name
        assert len(got[name]) > 1000, name


def test_profile_draws_the_figures(profiles, tmp_path, monkeypatch):
    """profile without --skip_plot_generation draws the nine figures (the
    bytes of make_plots over the stored profile), and its TSVs equal the
    run with the flag; a `plots` phase is timed."""
    from instrain_tpu_torch.profile import pipeline
    d, fasta, bam, genes, stb, out = profiles
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setattr(pipeline, "PHASES", {})
    run = str(tmp_path / "port" / "p.IS")
    assert port_main(["profile", bam, fasta, "-o", run, "-g", genes, "-s",
                      stb, "--device", "cpu"]) == 0
    assert pipeline.PHASES["plots"] > 0
    assert _tsvs(run) == _tsvs(out["port"])
    got = _figures(run)
    assert sorted(got) == sorted(PROFILE_FIGURES)
    again = _rerun_dir(run, str(tmp_path / "again" / "p.IS"))
    make_plots(again)
    assert _figures(again) == got


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Three synth_samples profiles (2 genomes x 2 scaffolds of 5 kb) of
    the JAX package, for compare -s."""
    d = tmp_path_factory.mktemp("plot_samples")
    fasta, bams, stb = synth_samples(str(d), 3, 4, 5000, [12, 25, 40],
                                     seed=5)
    profs = []
    for i, bam in enumerate(bams):
        profs.append(str(d / f"s{i}.IS"))
        assert jax_main(["profile", bam, fasta, "-o", profs[-1], "-s", stb,
                         "--skip_plot_generation", "--engine",
                         "dense"]) == 0
    return str(d), profs, stb


@pytest.fixture(scope="module")
def flagged_compare(samples):
    """The port's compare -s of the samples with --skip_plot_generation."""
    d, profs, stb = samples
    out = os.path.join(d, "flag", "c.RC")
    assert port_main(["compare", "-i"] + profs + ["-o", out, "-s", stb,
                      "--device", "cpu", "--skip_plot_generation"]) == 0
    return out


def test_compare_dendrograms_match_jax(samples, flagged_compare,
                                       monkeypatch):
    """compare -s without --skip_plot_generation draws plot 10 in both
    packages: the same bytes; its TSVs equal a run with the flag."""
    d, profs, stb = samples
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    figs = {}
    for tag, runner, extra in (("jax", jax_main, []),
                               ("port", port_main, ["--device", "cpu"])):
        out = os.path.join(d, tag, "c.RC")
        assert runner(["compare", "-i"] + profs + ["-o", out, "-s", stb] +
                      extra) == 0
        figs[tag] = _figures(out)
    assert list(figs["port"]) == [DENDROGRAMS]
    assert figs["port"] == figs["jax"]
    assert len(figs["port"][DENDROGRAMS]) > 1000
    assert _tsvs(flagged_compare) == _tsvs(os.path.join(d, "port", "c.RC"))
    assert not os.listdir(os.path.join(flagged_compare, "figures"))


# ---------------------------------------------------------------- no mpl


def _hide_matplotlib(monkeypatch):
    for mod in ("instrain_tpu_torch.plotting.plots",
                "instrain_tpu.plotting.plots"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_without_matplotlib(profiles, samples, flagged_compare, tmp_path,
                            monkeypatch, caplog):
    """Without matplotlib, profile and compare log the plot failure, exit
    0 and write the TSVs of a run with --skip_plot_generation; `plot`
    raises ImportError in both packages."""
    d, fasta, bam, genes, stb, out = profiles
    _hide_matplotlib(monkeypatch)
    run = str(tmp_path / "port" / "p.IS")
    assert port_main(["profile", bam, fasta, "-o", run, "-g", genes, "-s",
                      stb, "--device", "cpu"]) == 0
    with open(os.path.join(run, "log", "log.log")) as f:
        assert "Plotting failed" in f.read()
    assert _tsvs(run) == _tsvs(out["port"])
    assert not os.listdir(os.path.join(run, "figures"))

    sd, profs, sstb = samples
    caplog.set_level(logging.ERROR)
    rc_out = str(tmp_path / "c.RC")
    assert port_main(["compare", "-i"] + profs + ["-o", rc_out, "-s", sstb,
                      "--device", "cpu"]) == 0
    assert "compare plotting failed" in caplog.text
    assert _tsvs(rc_out) == _tsvs(flagged_compare)

    for runner, prof in ((port_main, out["port"]), (jax_main, out["jax"])):
        with pytest.raises(ImportError):
            runner(["plot", "-i", prof, "-pl", "1"])


# ---------------------------------------------------------------- plot


@pytest.mark.parametrize("extra", [
    ["-pl", "1", "3"], ["-g", "genome_1"], ["-mb", "0.99"],
    ["-pl", "2", "7", "-g", "genome_0", "-mb", "0.99"]],
    ids=["pl", "genome", "mb", "all_three"])
def test_plot_command_matches_jax(profiles, tmp_path, monkeypatch, extra):
    *_, out = profiles
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    figs = {}
    for tag, runner in (("jax", jax_main), ("port", port_main)):
        run = _rerun_dir(out[tag], str(tmp_path / tag / "p.IS"))
        assert runner(["plot", "-i", run] + extra) == 0
        figs[tag] = _figures(run)
    assert figs["port"] == figs["jax"]
    assert figs["port"]
    if extra[:3] == ["-pl", "1", "3"]:
        assert sorted(figs["port"]) == [
            "CoverageAndBreadth_vs_readMismatch.pdf",
            "readANI_distribution.pdf"]
