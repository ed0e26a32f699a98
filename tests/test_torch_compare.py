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
    the run, --device cuda without a GPU, the dendrograms drawn without
    --skip_plot_generation, and the ranged BAM decode: pooling through
    the samples' .bai and through a full decode gives the same tables.
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


def _random_masks(rng, n, mg, L):
    return [rng.random((mg, L)) < rng.random() for _ in range(n)]


GROUPS = [
    [(1, 1, 1), (2, 3, 7), (17, 5, 4099), (5, 1, 64)],
    [(8, 5, 4000)] * 3,
    [(64, 2, 130), (2, 1, 63), (17, 4, 1000), (1, 2, 65)],
    [(3, 1, 1)],
    [(2, 5, 20000), (8, 2, 1), (16, 4, 4099)],
    # past 64 samples: two and three tiles of 64 among small scaffolds
    [(65, 2, 4099), (1, 1, 1), (100, 1, 63), (17, 3, 63)],
    [(130, 2, 1), (17, 1, 4099), (65, 1, 63)],
    [(130, 1, 4099), (100, 2, 1), (1, 2, 63)],
]


@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_overlap_counts_group_match_jax(gi):
    """The plain group version over a group of mixed N, Mg and L (its
    words in one buffer after the group table) equals the JAX package's
    host and device functions scaffold by scaffold, exact in int64."""
    rng = np.random.default_rng(gi)
    masks = [_random_masks(rng, *d) for d in GROUPS[gi]]
    words = [np.stack([K.pack_mask(m) for m in ms]) for ms in masks]
    plan = K.group_plan([w.shape for w in words])
    assert plan.n_words == sum(w.size for w in words)
    buf = torch.from_numpy(K.group_buffer(words, plan))
    out = CC.overlap_counts_group(buf, plan)
    assert out.dtype == torch.int64 and out.shape == (plan.n_out,)
    got = K.split_counts(out.numpy(), plan)
    assert len(got) == len(masks)
    for ms, (b, s) in zip(masks, got):
        jb, js = JK.pairwise_overlap_counts_host(ms)
        db, ds = JK.pairwise_overlap_counts_device(ms)
        for want_b, want_s in ((jb, js), (db, ds)):
            np.testing.assert_array_equal(b, want_b)
            np.testing.assert_array_equal(s, want_s)


def _block_rows(plan):
    """(scaffold, mm level, first word, end word, tile pair) of each block
    of the group launch, as csrc/compare.cu:block_row finds them."""
    t = plan.table
    S = len(plan.shapes)
    rows = []
    for b in range(plan.n_blocks):
        s = max(k for k in range(S) if t[6, k] <= b)
        W, chunk, P = int(t[2, s]), int(t[3, s]), int(t[7, s])
        nb = -(-W // chunk)
        rc, p = divmod(b - int(t[6, s]), P)
        m, c = divmod(rc, nb)
        rows.append((s, m, c * chunk, min(c * chunk + chunk, W),
                     K.tile_pair(int(t[0, s]), p)))
    return rows


@pytest.mark.parametrize("sms", [1, 2, 132])
@pytest.mark.parametrize("shapes", [
    [(8, 5, 625)] * 128, [(16, 4, 1 << 17)], [(64, 3, 1563)],
    [(1, 1, 1), (2, 5, 1), (17, 3, 70000), (64, 1, 63)],
    [(2, 1, 1 << 17)] + [(8, 2, 625)] * 7,
    [(65, 2, 4099), (130, 3, 1563), (1, 1, 1)], [(128, 3, 1563)],
    [(100, 1, 63), (8, 5, 625), (193, 2, 70000)]])
def test_group_plan_covers_every_row(shapes, sms):
    """The group launch's blocks cover every (scaffold, mm level) row's
    words once for each of its scaffold's tile pairs (bi <= bj over tiles
    of 64 samples: one up to 64 samples, three up to 128, six up to 192),
    in chunks within the kernel's bounds, and the offsets lay the words
    and counts end to end. Up to 64 samples the plan is the one-tile
    plan: a tile pair's block reads about the bytes of a block of it."""
    plan = K.group_plan(shapes, sms)
    t = plan.table
    seen = {}
    for s, m, w0, w1, pair in _block_rows(plan):
        assert 0 <= w0 < w1 <= shapes[s][2]
        seen.setdefault((s, m, pair), []).append((w0, w1))
    for s, (n, mg, W) in enumerate(shapes):
        chunk = int(t[3, s])
        assert chunk == W or (chunk % K.GROUP_MIN_CHUNK == 0 and
                              K.GROUP_MIN_CHUNK <= chunk <=
                              K.GROUP_MAX_CHUNK)
        T = -(-n // K.GROUP_TILE)
        assert t[7, s] == K.tile_pairs(n) == T * (T + 1) // 2
        pairs = [(bi, bj) for bi in range(T) for bj in range(bi, T)]
        assert [K.tile_pair(n, p) for p in range(len(pairs))] == pairs
        for m in range(mg):
            for pair in pairs:
                spans = sorted(seen.pop((s, m, pair)))
                assert spans[0][0] == 0 and spans[-1][1] == W
                assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert t[4, s + 1] - t[4, s] == n * mg * W
        assert t[5, s + 1] - t[5, s] == mg * n * (n + 1)
    assert not seen
    assert plan.n_out == int(t[5, -1]) and plan.n_blocks == int(t[6, -1])
    if sms == 132 and shapes == [(8, 5, 625)] * 128:
        # the study's rows are one block each
        assert plan.n_blocks == 128 * 5
    if all(n <= K.GROUP_TILE for n, _, _ in shapes):
        # the one-tile plan: a block reads about total / (4 sms) words
        total = sum(n * mg * w for n, mg, w in shapes)
        per = -(-total // (sms * K.GROUP_BLOCKS_PER_SM))
        for s, (n, _, w) in enumerate(shapes):
            want = -(-per // n // K.GROUP_MIN_CHUNK) * K.GROUP_MIN_CHUNK
            assert t[3, s] == min(max(want, K.GROUP_MIN_CHUNK),
                                  K.GROUP_MAX_CHUNK, w)


def test_group_plan_tile_bytes():
    """A block reads about the same bytes at 128 samples as at 8: the
    words of the samples of its tile pair over its chunk."""
    def mean_block_words(shapes):
        plan = K.group_plan(shapes)
        t = plan.table
        words = []
        for s, m, w0, w1, (bi, bj) in _block_rows(plan):
            n = int(t[0, s])
            ni = min(64, n - 64 * bi)
            nj = 0 if bi == bj else min(64, n - 64 * bj)
            words.append((ni + nj) * (w1 - w0))
        return np.mean(words), plan.n_blocks

    # the same words read in all: 8 * 2^20 = 128 * 2^15 * 2 (two tiles,
    # each read by two tile pairs)
    small, nb_small = mean_block_words([(8, 3, 1 << 20)])
    big, nb_big = mean_block_words([(128, 3, 1 << 15)])
    assert 0.8 < big / small < 1.25, (small, big)
    assert 0.8 < nb_big / nb_small < 1.25, (nb_small, nb_big)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [
    [(2, 1, 1), (3, 2, 4099), (8, 5, 40_000)],
    [(16, 4, 1 << 23)], [(64, 3, 100_000)],
    [(1, 1, 63), (2, 5, 64), (8, 3, 4099), (17, 2, 40_000), (64, 4, 1)],
    [(8, 5, 40_000)] * 128,
    [(2, 1, 63), (16, 4, 1 << 23), (8, 5, 40_000), (17, 1, 1)],
    [(65, 4, 40_000)], [(128, 3, 100_000)],
    [(8, 5, 4099), (65, 2, 63), (130, 3, 40_000), (1, 1, 1)]])
def test_overlap_group_kernel_matches_plain_on_gpu(shapes, cuda_device):
    rng = np.random.default_rng(len(shapes))
    words = []
    for n, mg, L in shapes:
        W = -(-L // 64)
        w = rng.integers(0, 2 ** 64, (n, mg, W), dtype=np.uint64)
        if L % 64:
            w[:, :, -1] &= np.uint64((1 << (L % 64)) - 1)
        words.append(w)
    plan = K.group_plan([w.shape for w in words],
                        torch.cuda.get_device_properties(
                            cuda_device).multi_processor_count)
    buf = torch.from_numpy(K.group_buffer(words, plan))
    CC.reset_launch_counts()
    got = CC.overlap_counts_group(buf.to(cuda_device), plan).cpu()
    assert CC.launch_counts() == {"overlap_counts": 1}
    want = K.overlap_counts_group_plain(buf, plan)
    assert torch.equal(got, want)
    for w, (b, s) in zip(words, K.split_counts(got.numpy(), plan)):
        hb, hs = K.pairwise_overlap_counts_host(w)
        np.testing.assert_array_equal(b, hb)
        np.testing.assert_array_equal(s, hs)


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
    """The auto rule decides per comparison group, from the summed
    n^2 * Mg * L of its scaffolds, whatever their sample counts."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    bound = CP.DEVICE_MIN_WORK
    use = CP.use_device_overlap
    # one scaffold at the bound and one position under it
    n, mg = 8, 5
    L = -(-bound // (n * n * mg))
    assert use("auto", gpu, [(n, mg, L)]) == [True]
    assert use("auto", gpu, [(n, mg, L - 1)]) == [False]
    # the group's work sums: halves of the bound reach it together
    half = (n, mg, -(-L // 2))
    assert use("auto", gpu, [half]) == [False]
    assert use("auto", gpu, [half, half]) == [True, True]
    assert use("auto", gpu, [half, (n, mg, 1)]) == [False, False]
    # scaffolds of more than 64 samples count towards the bound like any
    # other: one of 65 samples at the bound and one position under it
    n65 = -(-bound // (65 * 65))
    assert use("auto", gpu, [(65, 1, n65)]) == [True]
    assert use("auto", gpu, [(65, 1, n65 - 1)]) == [False]
    big = (65, 9, 1 << 30)
    assert use("auto", gpu, [big]) == [True]
    assert use("auto", gpu, [big, half]) == [True, True]
    assert use("auto", gpu, [(65, 1, 1), half]) == [False, False]
    assert use("auto", gpu, [(64, 9, 1 << 30)]) == [True]
    # never on the CPU; host and device as asked
    assert use("auto", cpu, [(16, 4, 1 << 30)] * 3) == [False] * 3
    assert use("device", cpu, [(2, 1, 10), (70, 1, 10)]) == [True, True]
    assert use("host", gpu, [(64, 9, 1 << 30)] * 2) == [False, False]
    assert use("auto", gpu, []) == []


def test_device_engine_runs_the_wrapper(samples, jax_profiles, tmp_path,
                                        monkeypatch):
    """--engine device runs the group kernel's wrapper once per comparison
    group (its plain version on the CPU, so no launch), auto on the CPU
    never; the TSVs do not change with the groups."""
    flags = _flags(samples, bams=False) + ["--device", "cpu"]
    calls = []
    real = CC.overlap_counts_group
    monkeypatch.setattr(CP.cuda_compare, "overlap_counts_group",
                        lambda buf, plan: calls.append(plan.shapes) or
                        real(buf, plan))
    # 4 scaffolds of 5 kb: one group by default, 4 at 5,000 bp, 2 at
    # 10,000
    texts = {}
    for eng, extra, want in (("device", [], 1), ("auto", [], 0),
                             ("host", [], 0),
                             ("device", ["--group_length", "5000"], 4),
                             ("device", ["--group_length", "10000"], 2)):
        calls.clear()
        CC.reset_launch_counts()
        tag = f"{eng}{''.join(extra[1:])}"
        rc = _run(port_main, jax_profiles, str(tmp_path / f"{tag}.RC"),
                  flags + ["--engine", eng] + extra)
        assert len(calls) == want, (eng, extra)
        assert sum(len(c) for c in calls) == (4 if want else 0)
        assert CC.launch_counts() == {"overlap_counts": 0}
        texts[tag] = PD.ProfileDir(rc).get("comparisonsTable")
    for tag, db in texts.items():
        pd.testing.assert_frame_equal(
            db.sort_values(["scaffold", "name1", "name2", "mm"]).reset_index(
                drop=True),
            texts["device"].sort_values(
                ["scaffold", "name1", "name2", "mm"]).reset_index(drop=True))


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

    def kernel_fault(buf, plan):
        raise KernelError("overlap_counts: launch failed")

    monkeypatch.setattr(CP.cuda_compare, "overlap_counts_group",
                        kernel_fault)
    with pytest.raises(KernelError):
        _run(port_main, jax_profiles, str(tmp_path / "k.RC"),
             flags + ["--engine", "device"])


def test_plots_drawn_and_cuda_without_gpu_raises(jax_profiles, samples,
                                                 tmp_path, monkeypatch):
    """compare -s without --skip_plot_generation draws the dendrograms;
    --device cuda without a GPU raises."""
    stb = samples[3]
    out = str(tmp_path / "plot.RC")
    assert port_main(["compare", "-i"] + jax_profiles +
                     ["-o", out, "-s", stb, "--device", "cpu"]) == 0
    fig = os.path.join(out, "figures", "plot.RC_inStrainCompare_"
                                       "dendrograms.pdf")
    assert os.path.getsize(fig) > 1000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["compare", "-i"] + jax_profiles +
                  ["-o", str(tmp_path / "gpu.RC"), "--device", "cuda"])


def test_pooling_ranged_equals_full_decode(samples, jax_profiles,
                                           port_rcs, tmp_path, monkeypatch):
    """synth_samples writes a .bai beside each BAM, so pooling decodes
    only the compared scaffolds' ranges; BAMs without an index are decoded
    whole. Both give the same pooled tables."""
    from instrain_tpu_torch.compare import pooling
    d, _, bams, _ = samples
    ranged = []
    decode = pooling.decode_bam

    def spy(*a, **k):
        bam = decode(*a, **k)
        ranged.append(bam.ranged)
        return bam

    monkeypatch.setattr(pooling, "decode_bam", spy)
    copies = []
    for bam in bams:
        copies.append(str(tmp_path / os.path.basename(bam)))
        shutil.copy(bam, copies[-1])
    flags = _flags(samples, bams=False) + ["--engine", "host", "--device",
                                           "cpu"]
    full = _run(port_main, jax_profiles, str(tmp_path / "full.RC"),
                flags + ["--bams"] + copies)
    assert ranged == [False] * 3
    again = _run(port_main, jax_profiles, str(tmp_path / "ranged.RC"),
                 flags + ["--bams"] + bams)
    assert ranged[3:] == [True] * 3
    for table in TABLES:
        assert _tsv(full, table) == _tsv(port_rcs["host"], table), table
        assert _tsv(again, table) == _tsv(full, table), table


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


# ------------------------------------------------- more than 64 samples

@pytest.fixture(scope="module")
def study66(tmp_path_factory):
    """66 tiny samples (2 scaffolds of 2 kb, 5-15x), each profiled by the
    port on the CPU, compared by the port on its overlap kernel's plain
    version (--engine device, one group) and on the host popcount."""
    d = tmp_path_factory.mktemp("study66")
    n = 66
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # many small ops: threads only contend
    try:
        fasta, bams, _ = synth_samples(str(d), n, 2, 2000,
                                       [5 + i % 11 for i in range(n)],
                                       seed=11)
        profiles = []
        for i, bam in enumerate(bams):
            profiles.append(str(d / f"p{i}.IS"))
            assert port_main(["profile", bam, fasta, "-o", profiles[-1],
                              "--device", "cpu", "--skip_genome_wide",
                              "--skip_plot_generation"]) == 0
        flags = ["--skip_plot_generation", "--device", "cpu"]
        shapes = []
        real = CC.overlap_counts_group
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(CP.cuda_compare, "overlap_counts_group",
                       lambda buf, plan: shapes.append(plan.shapes) or
                       real(buf, plan))
            rcs = {eng: _run(port_main, profiles, str(d / f"{eng}.RC"),
                             flags + ["--engine", eng])
                   for eng in ("device", "host")}
    finally:
        torch.set_num_threads(threads)
    return profiles, rcs, shapes


def test_compare_past_64_samples(study66):
    """compare --engine device over 66 samples (the group's scaffolds one
    tile pair past 64 samples each) equals --engine host and the JAX
    package's compare, byte for byte: a row per (scaffold, pair, mm
    level), in one process (row order follows the hash seed)."""
    profiles, rcs, shapes = study66
    # the device run's one group call, its two scaffolds of 66 samples
    assert [[n for n, _, _ in g] for g in shapes] == [[66, 66]]
    want = _tsv(rcs["host"], "comparisonsTable")
    assert _tsv(rcs["device"], "comparisonsTable") == want
    table = pd.read_csv(os.path.join(
        rcs["device"], "output", "device.RC_comparisonsTable.tsv"), sep="\t")
    assert len(table) >= 2 * 66 * 65 // 2
    assert set(table["scaffold"]) == {"scaf_0", "scaf_1"}
    jax_out = os.path.join(os.path.dirname(rcs["host"]), "jax.RC")
    assert jax_main(["compare", "-i"] + profiles +
                    ["-o", jax_out, "--engine", "host",
                     "--skip_plot_generation"]) == 0
    assert _tsv(jax_out, "comparisonsTable") == want
