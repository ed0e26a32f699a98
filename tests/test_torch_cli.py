"""
The port's CLI against the JAX package's: the same subcommands, options
and defaults (plus --device), and the host-only subcommands and auxiliary
scripts giving the same files, byte for byte, on a synth_samples input
(3 samples, 2 genomes x 2 scaffolds of 5 kb):

  - quick_profile (with and without -s, --stringent_breadth_cutoff), and
    its coverage against a naive per-record accumulation on a BAM with a
    supplementary record between primaries;
  - filter_reads (defaults; -l 0.98 --pairing_filter all_reads);
  - other --run_statistics (the printed report) and other --old_IS (a
    legacy pickle of an unimportable class: the same attributes and
    stored tables);
  - check_deps in a fresh interpreter, which imports no jax;
  - auxiliary_scripts: recluster_compare over one compare, and
    rarefaction_curve --device cpu at fractions 0.5 and 1.0 (the JAX
    package's scripts run by path, as tests/test_aux_scripts.py runs
    them).
"""

import argparse
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest

from instrain_tpu import cli as jax_cli
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch import cli as port_cli
from instrain_tpu_torch.store.profile_dir import ProfileDir
from instrain_tpu_torch.synth import synth_samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------- surface


def _surface(parser):
    """subcommand -> option strings (or <pos>dest) -> (dest, default,
    nargs, action, choices, type)."""
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in subs.choices.items():
        out[name] = {
            (tuple(a.option_strings) or ("<pos>" + a.dest,)):
            (a.dest, a.default, a.nargs, type(a).__name__, a.choices, a.type)
            for a in sp._actions if a.dest != "help"}
    return out


def test_cli_surface_matches_jax():
    """Every subcommand and option of instrain_tpu's parser exists in the
    port's with the same default, nargs, action, choices and type. The
    port's only extra is --device, on the subcommands that run kernels;
    there is no other difference."""
    want = _surface(jax_cli.build_parser())
    got = _surface(port_cli.build_parser())
    assert sorted(got) == sorted(want)
    assert len(want) == 10
    for name in want:
        extra = set(got[name]) - set(want[name])
        assert extra == ({("--device",)} if name in ("profile", "compare")
                         else set()), (name, extra)
        for opt, spec in want[name].items():
            assert got[name].get(opt) == spec, (name, opt)


# ---------------------------------------------------------------- inputs


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    fasta, bams, stb = synth_samples(str(d), 3, 4, 5000, [12, 25, 40],
                                     seed=5)
    return str(d), fasta, bams, stb


@pytest.mark.parametrize("extra", [
    [], ["-s", None], ["-s", None, "--stringent_breadth_cutoff", "0.5",
                       "--breadth_cutoff", "0.9"]],
    ids=["defaults", "stb", "stringent"])
def test_quick_profile_matches_jax(samples, extra):
    d, fasta, bams, stb = samples
    extra = [stb if x is None else x for x in extra]
    tag = "_".join(x for x in extra if x.startswith("--")) or "plain"
    outs = {}
    for pkg, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        outs[pkg] = os.path.join(d, f"qp_{pkg}_{tag}{len(extra)}")
        assert main(["quick_profile", bams[1], fasta, "-o", outs[pkg]] +
                    extra) == 0
    for f in ("coverm_raw.tsv", "genomeCoverage.csv", "scaffolds.txt"):
        want = _read(os.path.join(outs["jax"], f))
        assert _read(os.path.join(outs["port"], f)) == want, f
    cdb = pd.read_csv(os.path.join(outs["port"], "coverm_raw.tsv"),
                      sep="\t")
    assert len(cdb) == 4 and (cdb["Read Count"] > 0).all()


def test_quick_profile_coverage_matches_naive(tmp_path):
    """The vectorised event gather (the contiguous slice and the ragged
    ranges branches) equals a naive per-record accumulation; the ragged
    branch runs where a non-primary record sits between primaries
    (tests/test_cli.py:196-241 on the port's bgzf writer)."""
    from instrain_tpu_torch.io.bgzf import (bam_header, bam_record, nm_tag,
                                            write_bgzf)
    from instrain_tpu_torch.profile.quick_profile import quick_profile

    L = 300
    seq = "ACGT" * 15  # 60 bp
    qual = bytes([40]) * 60
    cigar = [(60, "M")]
    parts = [bam_header([("s0", L), ("s1", L)])]
    # s0: primaries around a supplementary record (flag 0x800)
    for name, flag, pos in (("a", 0, 0), ("b", 0x800, 50), ("c", 0, 100)):
        parts.append(bam_record(name, flag, 0, pos, 42, cigar, -1, -1, 0,
                                seq, qual, nm_tag(0)))
    # s1: contiguous primaries only
    for name, pos in (("d", 10), ("e", 40)):
        parts.append(bam_record(name, 0, 1, pos, 42, cigar, -1, -1, 0, seq,
                                qual, nm_tag(0)))
    bam_path = str(tmp_path / "qp.bam")
    write_bgzf(bam_path, b"".join(parts))
    fasta = str(tmp_path / "qp.fa")
    with open(fasta, "w") as f:
        f.write(">s0\n" + "A" * L + "\n>s1\n" + "A" * L + "\n")

    out = str(tmp_path / "qpo")
    quick_profile(bam_path, fasta, output=out)
    cdb = pd.read_csv(os.path.join(out, "coverm_raw.tsv"), sep="\t")
    row0 = cdb[cdb["Contig"] == "s0"].iloc[0]
    row1 = cdb[cdb["Contig"] == "s1"].iloc[0]
    # s0: two 60 bp primaries (the supplementary left out): 120 covered
    assert row0["Read Count"] == 2
    assert row0["Covered Bases"] == 120
    assert abs(row0["Mean"] - 120 / L) < 1e-12
    # s1: 40..69 covered twice: 90 covered bases, mean 120 / L
    assert row1["Read Count"] == 2
    assert row1["Covered Bases"] == 90
    assert abs(row1["Mean"] - 120 / L) < 1e-12


@pytest.mark.parametrize("extra", [
    [], ["-l", "0.98", "--pairing_filter", "all_reads"]],
    ids=["defaults", "ani_all_reads"])
def test_filter_reads_matches_jax(samples, extra):
    d, fasta, bams, _ = samples
    outs = {}
    for pkg, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        outs[pkg] = os.path.join(d, f"fr_{pkg}_{len(extra)}")
        assert main(["filter_reads", bams[2], fasta, "-o", outs[pkg]] +
                    extra) == 0
    want = _read(os.path.join(outs["jax"], "mapping_info.csv"))
    assert _read(os.path.join(outs["port"], "mapping_info.csv")) == want
    # all_scaffolds and the four scaffolds, under the two header lines
    assert len(want.splitlines()) == 7


# ---------------------------------------------------------------- other


@pytest.fixture(scope="module")
def profiled(samples):
    """The samples profiled by the JAX package (genome-wide on)."""
    d, fasta, bams, stb = samples
    outs = []
    for i, bam in enumerate(bams):
        outs.append(os.path.join(d, f"s{i}.IS"))
        assert jax_cli.main(["profile", bam, fasta, "-o", outs[-1], "-s",
                             stb, "--skip_plot_generation", "--engine",
                             "dense"]) == 0
    return outs


def test_run_statistics_matches_jax(profiled, capsys):
    capsys.readouterr()
    texts = []
    for main, arg in ((jax_cli.main, profiled[0]),
                      (port_cli.main, profiled[0]),
                      (port_cli.main, os.path.join(profiled[0], "log",
                                                   "log.log"))):
        assert main(["other", "--run_statistics", arg]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[1] == texts[0] and texts[2] == texts[0]
    assert "Run report" in texts[0] and "main_profile" in texts[0]


def _legacy_pickle(path, monkeypatch):
    """A pre-directory profile: a pickled inStrain.SNVprofile.SNVprofile,
    a class that cannot be imported where it is read."""
    cls = type("SNVprofile", (), {})
    cls.__module__ = "inStrain.SNVprofile"
    obj = cls()
    rng = np.random.default_rng(3)
    pos = np.sort(rng.choice(5000, 40, replace=False))
    obj.snp_table = pd.DataFrame({
        "scaffold": ["scaf_0"] * 20 + ["scaf_1"] * 20, "position": pos,
        "mm": rng.integers(0, 3, 40), "var_freq": rng.random(40),
        "con_base": rng.choice(list("ACGT"), 40)})
    obj.cumulative_scaffold_table = pd.DataFrame({
        "scaffold": ["scaf_0", "scaf_1"], "length": [5000, 5000],
        "coverage": [12.5, 30.25], "mm": [0, 1]})
    obj.scaffold2length = {"scaf_0": 5000, "scaf_1": 5000}
    obj.covT = {s: {mm: pd.Series(rng.integers(1, 50, 30),
                                  index=np.sort(rng.choice(5000, 30, False)))
                    for mm in (0, 2)} for s in ("scaf_0", "scaf_1")}
    obj.notes = "an attribute the converter does not know"
    pkg, mod = types.ModuleType("inStrain"), types.ModuleType(
        "inStrain.SNVprofile")
    mod.SNVprofile = cls
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "inStrain", pkg)
        m.setitem(sys.modules, "inStrain.SNVprofile", mod)
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def test_old_is_matches_jax(tmp_path, monkeypatch):
    for pkg in ("jax", "port"):
        os.makedirs(tmp_path / pkg)
        _legacy_pickle(str(tmp_path / pkg / "old.pickle"), monkeypatch)
    assert "inStrain" not in sys.modules
    assert jax_cli.main(["other", "--old_IS",
                         str(tmp_path / "jax" / "old.pickle")]) == 0
    assert port_cli.main(["other", "--old_IS",
                          str(tmp_path / "port" / "old.pickle")]) == 0
    j = JaxProfileDir(str(tmp_path / "jax" / "old.pickle.IS"))
    p = ProfileDir(str(tmp_path / "port" / "old.pickle.IS"))
    keys = p.keys()
    assert keys == j.keys()
    assert {"cumulative_snv_table", "cumulative_scaffold_table",
            "scaffold2length", "covT"} <= set(keys)
    assert "notes" not in keys
    for k in ("cumulative_snv_table", "cumulative_scaffold_table"):
        pd.testing.assert_frame_equal(p.get(k), j.get(k))
    assert p.get("scaffold2length") == j.get("scaffold2length")
    got, want = p.get("covT"), j.get("covT")
    assert sorted(got) == sorted(want) == ["scaf_0", "scaf_1"]
    for s in want:
        assert sorted(got[s]) == sorted(want[s]) == [0, 2]
        for mm in want[s]:
            pd.testing.assert_series_equal(got[s][mm], want[s][mm])


def test_check_deps_imports_no_jax():
    code = ("import sys\n"
            "from instrain_tpu_torch.cli import main\n"
            "assert main(['check_deps']) == 0\n"
            "print('JAX LOADED', 'jax' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "instrain_tpu_torch version" in out
    assert "\ntorch        OK (version" in out and "CUDA build" in out
    assert "CUDA available:" in out and "\nnvcc: " in out
    assert "native decoder (instrain_io): " in out
    assert "CUDA kernels (instrain_kernels): " in out
    assert "JAX LOADED False" in out


# ---------------------------------------------------------------- scripts


def _jax_script(script, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "auxiliary_scripts", script)] +
        args, capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res


def test_recluster_compare_matches_jax(samples, profiled, capsys):
    from instrain_tpu_torch.auxiliary_scripts import recluster_compare
    d, _, _, stb = samples
    rc = os.path.join(d, "c.RC")
    assert jax_cli.main(["compare", "-i"] + profiled + ["-o", rc, "-s", stb,
                         "--skip_plot_generation"]) == 0
    outs = {k: os.path.join(d, f"recluster_{k}.tsv") for k in ("jax",
                                                               "port")}
    args = ["-i", rc, "-a", "0.999", "-cov", "0.5", "--clusterAlg",
            "single"]
    _jax_script("recluster_compare.py", args + ["-o", outs["jax"]])
    assert recluster_compare.main(args + ["-o", outs["port"]]) == 0
    want = _read(outs["jax"])
    assert _read(outs["port"]) == want
    assert len(want.splitlines()) == 7    # header, 3 samples x 2 genomes
    assert "cluster assignments" in capsys.readouterr().out


def test_rarefaction_curve_matches_jax(samples, tmp_path):
    from instrain_tpu_torch.auxiliary_scripts import rarefaction_curve
    _, fasta, bams, _ = samples
    outs = {k: str(tmp_path / k) for k in ("jax", "port")}
    _jax_script("rarefaction_curve.py", [bams[0], fasta, "-o", outs["jax"],
                                         "-s", "0.5", "1.0"])
    assert rarefaction_curve.main([bams[0], fasta, "-o", outs["port"],
                                   "--device", "cpu", "-s", "0.5",
                                   "1.0"]) == 0
    want = _read(os.path.join(outs["jax"], "rarefaction_curve.tsv"))
    assert _read(os.path.join(outs["port"],
                              "rarefaction_curve.tsv")) == want
    rows = pd.read_csv(os.path.join(outs["port"], "rarefaction_curve.tsv"),
                       sep="\t")
    assert list(rows["fraction"]) == [0.5, 1.0]
    assert rows["mean_coverage"].iloc[0] < rows["mean_coverage"].iloc[1]
