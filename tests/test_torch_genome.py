"""
Genome-wide aggregation of the port (profile/genome.py) against the JAX
package's, on synth(S=4, L=5000): `instrain_tpu_torch profile --device
cpu` without --skip_genome_wide against `instrain_tpu profile --engine
dense`, with and without -s, and the `genome_wide` subcommand rerun on
each profile (with --mm_level and --skip_mm_profiling too).

Table tolerances (tests/test_compact.py:736-776): integers and strings
exact, nucl_diversity* 1e-6 relative, every other float 1e-9. Both
packages run the same numpy and scipy, so the files are also expected
byte for byte, and are checked so.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.cli import main as jax_main
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.store import profile_dir as PD
from instrain_tpu_torch.synth import synth


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome")
    fasta, bam, _ = synth(str(d), S=4, L=5000, COV=40, seed=3)
    stb = str(d / "synth.stb")
    with open(stb, "w") as f:
        for s in range(4):
            f.write(f"scaf_{s}\tgenome_{s // 2}\n")
    return str(d), fasta, bam, stb


_PROFILES = {}


def _profile_pair(data, with_stb):
    """A port (--device cpu) and a JAX (--engine dense) profile, genome-wide
    aggregation on, made once per stb choice."""
    if with_stb not in _PROFILES:
        d, fasta, bam, stb = data
        extra = ["-s", stb] if with_stb else []
        tag = "stb" if with_stb else "all"
        port, jax = os.path.join(d, f"port_{tag}.IS"), \
            os.path.join(d, f"jax_{tag}.IS")
        assert port_main(["profile", bam, fasta, "-o", port, "--device",
                          "cpu", "--skip_plot_generation"] + extra) == 0
        assert jax_main(["profile", bam, fasta, "-o", jax, "--engine",
                         "dense", "--skip_plot_generation"] + extra) == 0
        _PROFILES[with_stb] = port, jax
    return _PROFILES[with_stb]


def _path(out, table):
    return os.path.join(out, "output", f"{os.path.basename(out)}_{table}.tsv")


def assert_tables_match(a_path, b_path):
    with open(a_path) as f:
        a_text = f.read()
    with open(b_path) as f:
        b_text = f.read()
    a, b = pd.read_csv(a_path, sep="\t"), pd.read_csv(b_path, sep="\t")
    assert len(a) > 0 and list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for col in a.columns:
        va, vb = a[col].values, b[col].values
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            va, vb = va.astype(float), vb.astype(float)
            assert np.array_equal(np.isnan(va), np.isnan(vb)), col
            m = ~np.isnan(va)
            tol = 1e-6 if col.startswith("nucl_diversity") else 1e-9
            assert np.allclose(va[m], vb[m], rtol=tol, atol=0), col
        else:
            assert np.array_equal(va, vb), col
    assert a_text == b_text


@pytest.mark.parametrize("table", ["genome_info", "SNVs"])
@pytest.mark.parametrize("with_stb", [False, True], ids=["all", "stb"])
def test_profile_genome_tables_match_jax(data, with_stb, table):
    port, jax = _profile_pair(data, with_stb)
    assert_tables_match(_path(port, table), _path(jax, table))
    genomes = pd.read_csv(_path(port, "genome_info"), sep="\t")["genome"]
    assert list(genomes) == (["genome_0", "genome_1"] if with_stb
                             else ["all_scaffolds"])


@pytest.mark.parametrize("opts", [[], ["--mm_level"],
                                  ["--skip_mm_profiling"]],
                         ids=["default", "mm_level", "skip_mm"])
@pytest.mark.parametrize("with_stb", [False, True], ids=["all", "stb"])
def test_genome_wide_rerun_matches_jax(data, tmp_path, with_stb, opts):
    """The genome_wide subcommand on each package's own profile (a copy),
    with the stb the other way round from the profile run."""
    port, jax = _profile_pair(data, with_stb)
    extra = [] if with_stb else ["-s", data[3]]
    outs = []
    for runner, src in ((port_main, port), (jax_main, jax)):
        dst = str(tmp_path / os.path.basename(src))
        shutil.copytree(src, dst)
        assert runner(["genome_wide", "-i", dst] + extra + opts) == 0
        outs.append(dst)
    for table in ("genome_info", "SNVs"):
        assert_tables_match(_path(outs[0], table), _path(outs[1], table))
    info = pd.read_csv(_path(outs[0], "genome_info"), sep="\t")
    assert ("mm" in info.columns) == (opts == ["--mm_level"])


def test_genome_level_info_read_by_jax(data):
    port, jax = _profile_pair(data, True)
    got = JaxProfileDir(port).get("genome_level_info")
    pd.testing.assert_frame_equal(got,
                                  PD.ProfileDir(port).get("genome_level_info"))
    pd.testing.assert_frame_equal(got,
                                  JaxProfileDir(jax).get("genome_level_info"))
    for name in ("scaffold2bin", "bin2length"):
        assert PD.ProfileDir(port).get(name) == JaxProfileDir(jax).get(name)


def test_genome_wide_on_pickled_covt(data, tmp_path, monkeypatch):
    """Where h5py is missing (covT pickled), genome_wide writes the same
    genome_info."""
    port, _ = _profile_pair(data, True)
    monkeypatch.setattr(PD, "_h5py", lambda: None)
    dst = str(tmp_path / "pickled.IS")
    shutil.copytree(port, dst)
    prof = PD.ProfileDir(dst)
    prof.store("covT", JaxProfileDir(port).get("covT"), "special", "covT")
    assert prof.get("covT", scaffolds=["scaf_0"]).keys() == {"scaf_0"}
    assert port_main(["genome_wide", "-i", dst, "-s", data[3]]) == 0
    assert_tables_match(_path(dst, "genome_info"),
                        _path(port, "genome_info"))
