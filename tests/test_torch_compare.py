"""
The port's `compare` against the JAX package's.

  - The overlap counts (K7): the port's host popcount and the plain
    version of the overlap_counts kernel against the JAX package's host
    path and its device function (jit on the CPU), exact in int64.
  - `instrain_tpu_torch compare --device cpu` (engines host and device)
    against `instrain_tpu compare` on the same JAX-made profiles of a
    synth_samples input (3 samples, 2 genomes x 2 scaffolds x 5 kb), with
    -s, --bams, --store_mismatch_locations, --store_coverage_overlap and
    --include_self_comparisons: every TSV byte for byte, and the
    coverage-overlap special. Then port profiles + port compare against
    JAX profiles + JAX compare, and the scaffold-selection options.
  - The rest: pickled covT (no h5py), the JAX ProfileDir reading the
    port's comparisonsTable, the auto engine rule, a kernel fault failing
    the run, --device cuda without a GPU, unported plots, and the ranged
    BAM decode.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from instrain_tpu.cli import main as jax_main
from instrain_tpu.io.bai import make_bai
from instrain_tpu.io.bam import decode_bam as jax_decode
from instrain_tpu.kernels import compare as JK
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.compare import pipeline as CP
from instrain_tpu_torch.io.bam import decode_bam as port_decode
from instrain_tpu_torch.kernels import compare as K
from instrain_tpu_torch.kernels import cuda_compare as CC
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.store import profile_dir as PD
from instrain_tpu_torch.synth import synth_samples

TABLES = ["comparisonsTable", "genomeWide_compare", "strain_clusters",
          "pairwise_SNP_locations", "pooled_SNV_info", "pooled_SNV_data",
          "pooled_SNV_data_keys"]


# ---------------------------------------------------------------- K7

@pytest.mark.parametrize("L", [1, 7, 64, 1000, 4099])
@pytest.mark.parametrize("mg", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_overlap_counts_match_jax(n, mg, L):
    rng = np.random.default_rng(n * 1000 + mg * 100 + L)
    masks = [rng.random((mg, L)) < rng.random() for _ in range(n)]
    jb, js = JK.pairwise_overlap_counts_host(masks)
    db, ds = JK.pairwise_overlap_counts_device(masks)
    np.testing.assert_array_equal(jb, db)
    np.testing.assert_array_equal(js, ds)
    words = np.stack([K.pack_mask(m) for m in masks])
    assert words.dtype == np.uint64 and words.shape == (n, mg, -(-L // 64))
    hb, hs = K.pairwise_overlap_counts_host(words)
    pb, ps = K.overlap_counts_plain(torch.from_numpy(words.view(np.int64)))
    for b, s in ((hb, hs), (pb.numpy(), ps.numpy())):
        assert b.dtype == s.dtype == np.int64
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("L", [1, 7, 9, 33, 63, 64, 65, 130])
def test_packing_zero_past_L(L):
    """The bits past L are zero, and the packed bits read back as the
    mask, by position and in full."""
    rng = np.random.default_rng(L)
    mask = np.ones((2, L), bool)
    mask[1] = rng.random(L) < 0.5
    words = K.pack_mask(mask)
    assert np.bitwise_count(words).sum(axis=1).tolist() == \
        mask.sum(axis=1).tolist()
    np.testing.assert_array_equal(K.unpack_words(words, L), mask)
    pos = rng.integers(0, L, 20)
    np.testing.assert_array_equal(K.mask_bits(words, pos), mask[:, pos])


def test_threshold_words_match_jax_masks():
    from instrain_tpu.compare.pipeline import _threshold_masks
    rng = np.random.default_rng(3)
    L = 1000
    covT = {mm: pd.Series(rng.integers(1, 6, 700),
                          index=np.sort(rng.choice(L, 700, replace=False)))
            for mm in (0, 2, 5)}
    grid = [0, 1, 2, 5]
    want = _threshold_masks(covT, grid, L, 5)
    got = CP.threshold_words(covT, grid, L, 5)
    np.testing.assert_array_equal(K.unpack_words(got, L), want)


# ---------------------------------------------------------------- compare

FLAGS = ["-s", None, "--store_mismatch_locations",
         "--store_coverage_overlap", "--include_self_comparisons",
         "--skip_plot_generation"]


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    d = tmp_path_factory.mktemp("samples")
    fasta, bams, stb = synth_samples(str(d), 3, 4, 5000, [12, 25, 40],
                                     seed=5)
    return str(d), fasta, bams, stb


def _profiles(samples, runner, tag, extra):
    d, fasta, bams, stb = samples
    outs = []
    for i, bam in enumerate(bams):
        out = os.path.join(d, f"{tag}{i}.IS")
        assert runner(["profile", bam, fasta, "-o", out, "-s", stb,
                       "--skip_plot_generation"] + extra) == 0
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def jax_profiles(samples):
    return _profiles(samples, jax_main, "jax", ["--engine", "dense"])


@pytest.fixture(scope="module")
def port_profiles(samples):
    return _profiles(samples, port_main, "port", ["--device", "cpu"])


def _flags(samples, bams=True):
    d, fasta, bam_list, stb = samples
    f = [stb if x is None else x for x in FLAGS]
    return f + (["--bams"] + bam_list if bams else [])


def _run(runner, inputs, out, flags):
    assert runner(["compare", "-i"] + inputs + ["-o", out] + flags) == 0
    return out


@pytest.fixture(scope="module")
def jax_rc(samples, jax_profiles):
    return _run(jax_main, jax_profiles, os.path.join(samples[0], "jax.RC"),
                _flags(samples) + ["--engine", "host"])


@pytest.fixture(scope="module")
def port_rcs(samples, jax_profiles):
    return {eng: _run(port_main, jax_profiles,
                      os.path.join(samples[0], f"port_{eng}.RC"),
                      _flags(samples) + ["--engine", eng, "--device", "cpu"])
            for eng in ("host", "device")}


def _tsv(rc, table):
    path = os.path.join(rc, "output",
                        f"{os.path.basename(rc)}_{table}.tsv")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("table", TABLES)
def test_compare_tsvs_match_jax(jax_rc, port_rcs, table, engine):
    got, want = _tsv(port_rcs[engine], table), _tsv(jax_rc, table)
    assert got == want
    assert len(want.splitlines()) > 1


def test_compare_inputs_are_not_trivial(jax_rc):
    """Some pairs below 1 in conANI, popANI and coverage overlap; two
    strain clusters in every genome."""
    out = JaxProfileDir(jax_rc).get_output_base()
    g = pd.read_csv(out + "genomeWide_compare.tsv", sep="\t")
    other = g[g["name1"] != g["name2"]]
    for col in ("conANI", "popANI", "coverage_overlap"):
        assert (other[col] < 1).any(), col
    clusters = pd.read_csv(out + "strain_clusters.tsv", sep="\t")
    assert (clusters.groupby("genome")["cluster"].nunique() == 2).all()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_coverage_overlap_special_matches_jax(jax_rc, port_rcs, engine):
    want = JaxProfileDir(jax_rc).get("scaff2pair2mm2cov")
    got = PD.ProfileDir(port_rcs[engine]).get("scaff2pair2mm2cov")
    assert got == want and len(want) == 4


def test_port_profiles_and_compare_match_jax(samples, port_profiles,
                                             jax_rc):
    """Port profiles through the port's compare against JAX profiles
    through the JAX package's: the same bytes."""
    rc = _run(port_main, port_profiles,
              os.path.join(samples[0], "port_all.RC"),
              _flags(samples) + ["--device", "cpu"])
    for table in TABLES:
        assert _tsv(rc, table) == _tsv(jax_rc, table), table


@pytest.mark.parametrize("extra", [
    ["--database_mode", "--breadth", "0.95"],
    ["--genome", "genome_1"],
    ["--scaffolds", None],
    ["--skip_popANI"]], ids=["database_mode", "genome", "scaffolds",
                             "skip_popANI"])
def test_scaffold_selection_matches_jax(samples, jax_profiles, extra):
    d = samples[0]
    if None in extra:
        lst = os.path.join(d, "scaffolds.txt")
        with open(lst, "w") as f:
            f.write("scaf_0\nscaf_3\n")
        extra = [lst if x is None else x for x in extra]
    tag = extra[0].strip("-")
    flags = _flags(samples, bams=False) + extra
    if tag == "scaffolds":
        # with -s, the stb's scaffolds join the list (the JAX package's
        # union, compare/pipeline.py:70-77)
        flags = flags[2:]
    j = _run(jax_main, jax_profiles, os.path.join(d, f"jsel_{tag}.RC"),
             flags)
    p = _run(port_main, jax_profiles, os.path.join(d, f"psel_{tag}.RC"),
             flags + ["--device", "cpu"])
    outs = sorted(os.listdir(os.path.join(j, "output")))
    assert [o.replace("jsel", "psel") for o in outs] == \
        sorted(os.listdir(os.path.join(p, "output")))
    for o in outs:
        table = o.split(".RC_")[1][:-4]
        assert _tsv(p, table) == _tsv(j, table), table
    got = PD.ProfileDir(p).get("scaffold2length")
    assert got == JaxProfileDir(j).get("scaffold2length")
    if tag == "skip_popANI":
        assert not outs
    else:
        scaffs = set(pd.read_csv(os.path.join(p, "output", outs[0].replace(
            "jsel", "psel")), sep="\t")["scaffold"])
        want = {"database_mode": {"scaf_0", "scaf_1", "scaf_2", "scaf_3"},
                "genome": {"scaf_2", "scaf_3"},
                "scaffolds": {"scaf_0", "scaf_3"}}[tag]
        assert scaffs <= want and scaffs


def test_pickled_covt_goes_through_compare(samples, port_profiles,
                                           port_rcs, tmp_path, monkeypatch):
    """Where h5py is missing, the port's profiles hold covT as a pickle;
    compare reads it (covt_scaffolds and the bulk group load) and gives
    the same rows."""
    monkeypatch.setattr(PD, "_h5py", lambda: None)
    copies = []
    for i, src in enumerate(port_profiles):
        dst = str(tmp_path / f"pickled{i}.IS")
        shutil.copytree(src, dst)
        prof = PD.ProfileDir(dst)
        covT = JaxProfileDir(dst).get("covT")
        prof.store("covT", covT, "special", "coverage")
        assert prof.get("covT", scaffolds=["scaf_1"]).keys() == {"scaf_1"}
        assert prof.covt_scaffolds() == set(covT)
        copies.append(dst)
    flags = _flags(samples, bams=False) + ["--device", "cpu"]
    rc = _run(port_main, copies, str(tmp_path / "p.RC"), flags)
    key = ["scaffold", "name1", "name2"]
    got = pd.read_csv(os.path.join(rc, "output", "p.RC_comparisonsTable.tsv"),
                      sep="\t").sort_values(key).reset_index(drop=True)
    want = pd.read_csv(os.path.join(
        port_rcs["host"], "output", "port_host.RC_comparisonsTable.tsv"),
        sep="\t").sort_values(key).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want)
    assert PD.ProfileDir(rc).get("scaff2pair2mm2cov") == JaxProfileDir(
        port_rcs["host"]).get("scaff2pair2mm2cov")


def test_jax_profiledir_reads_port_comparisons(port_rcs):
    for rc in port_rcs.values():
        got = JaxProfileDir(rc).get("comparisonsTable")
        pd.testing.assert_frame_equal(got,
                                      PD.ProfileDir(rc).get("comparisonsTable"))
        assert len(got) > 0


def test_auto_engine_rule():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    bound = CP.DEVICE_MIN_WORK
    assert CP.DEVICE_MIN_WORK == 1 << 33
    # n^2 * Mg * L at the bound: 16 samples, 4 levels, 2^23 positions
    assert 16 * 16 * 4 * (1 << 23) == bound
    assert CP.use_device_overlap("auto", gpu, 16, 4, 1 << 23)
    assert not CP.use_device_overlap("auto", gpu, 16, 4, (1 << 23) - 1)
    assert not CP.use_device_overlap("auto", cpu, 16, 4, 1 << 30)
    assert not CP.use_device_overlap("auto", gpu, 65, 4, 1 << 30)
    assert CP.use_device_overlap("device", cpu, 2, 1, 10)
    assert not CP.use_device_overlap("host", gpu, 64, 9, 1 << 30)


def test_device_engine_runs_the_wrapper(samples, jax_profiles, tmp_path,
                                        monkeypatch):
    """--engine device runs the kernel's wrapper once per scaffold (its
    plain version on the CPU, so no launch), auto on the CPU never."""
    flags = _flags(samples, bams=False) + ["--device", "cpu"]
    calls = []
    real = CC.overlap_counts
    monkeypatch.setattr(CP.cuda_compare, "overlap_counts",
                        lambda words: calls.append(words.shape) or
                        real(words))
    for eng, want in (("device", 4), ("auto", 0), ("host", 0)):
        calls.clear()
        CC.reset_launch_counts()
        _run(port_main, jax_profiles, str(tmp_path / f"{eng}.RC"),
             flags + ["--engine", eng])
        assert len(calls) == want, eng
        assert CC.launch_counts() == {"overlap_counts": 0}


def test_kernel_fault_fails_compare(samples, jax_profiles, tmp_path,
                                    monkeypatch):
    """A host failure in one scaffold is logged as a CompareException and
    the run goes on; a KernelError in the overlap call fails the run."""
    real = CP._compare_pair

    def host_fault(sc, *a, **k):
        if sc.scaffold == "scaf_1":
            raise ValueError("host failure")
        return real(sc, *a, **k)

    monkeypatch.setattr(CP, "_compare_pair", host_fault)
    flags = _flags(samples, bams=False) + ["--device", "cpu"]
    rc = _run(port_main, jax_profiles, str(tmp_path / "host.RC"), flags)
    db = PD.ProfileDir(rc).get("comparisonsTable")
    assert "scaf_1" not in set(db["scaffold"]) and len(db) > 0

    def kernel_fault(words):
        raise KernelError("overlap_counts: launch failed")

    monkeypatch.setattr(CP.cuda_compare, "overlap_counts", kernel_fault)
    with pytest.raises(KernelError):
        _run(port_main, jax_profiles, str(tmp_path / "k.RC"),
             flags + ["--engine", "device"])


def test_cuda_without_gpu_and_unported_plots_raise(jax_profiles, samples,
                                                   tmp_path, monkeypatch):
    stb = samples[3]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_main(["compare", "-i"] + jax_profiles +
                  ["-o", str(tmp_path / "plot.RC"), "-s", stb,
                   "--device", "cpu"])
    assert not os.path.exists(str(tmp_path / "plot.RC"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["compare", "-i"] + jax_profiles +
                  ["-o", str(tmp_path / "gpu.RC"), "--device", "cuda"])


def test_ranged_decode_matches_jax(samples, tmp_path):
    """decode_bam(scaffolds=) decodes the named scaffolds' ranges through
    a .bai, as the JAX package does, and the whole BAM without one."""
    bam = str(tmp_path / "s.bam")
    shutil.copy(samples[2][1], bam)
    plain = port_decode(bam, scaffolds=["scaf_2"])
    assert not plain.ranged and len(set(plain.ref_id.tolist())) == 4
    make_bai(bam)
    got = port_decode(bam, scaffolds=["scaf_2"])
    want = jax_decode(bam, scaffolds=["scaf_2"])
    assert got.ranged and want.ranged
    assert set(got.ref_id.tolist()) == {2}
    for f in ("ref_id", "pos", "qname_id", "nm", "ev_pos", "ev_base"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.qnames == want.qnames
