"""
The port's device compaction (K4) and hybrid engine against the JAX
package: the plain PyTorch K4 (and the kernel wrappers, which take it for
CPU tensors) against instrain_tpu.kernels.sitestats.site_stats_compact
bit for bit; the compact SNP and coverage tables against
instrain_tpu.profile.compact's; `instrain_tpu_torch profile --engine
hybrid --device cpu` against `instrain_tpu profile --engine hybrid`
byte for byte; the engine choice and the hybrid engine's one key per
scaffold; the committed golden file against a fresh JAX run; and — on a
machine with an NVIDIA GPU — each K4 kernel against its plain version.

Tolerances: none within an engine. Every K4 output is bit-identical
(integers by construction, the medians are exact order statistics, and
the f64 clonality sums are exact in any order). Across engines (port
hybrid against port dense) the reference's own cross-engine tolerances
hold: strings and integers exact, nucl_diversity* within 1e-6 and other
floats within 1e-9, relative and absolute (tests/test_compact.py:45-49),
because the dense engine's means are f32 numpy means.
"""

import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

from instrain_tpu.cli import main as jax_main
from instrain_tpu.kernels import sitestats as JS
from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu.profile import compact as JC
from instrain_tpu.profile.pileup import ScaffoldPileup as JaxPileup
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.kernels import cuda_compact as CC
from instrain_tpu_torch.kernels import cuda_sitestats as C
from instrain_tpu_torch.kernels import sitestats as S
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import pipeline as PP
from instrain_tpu_torch.profile.pileup import ScaffoldPileup, run_site_stats
from instrain_tpu_torch.store.profile_dir import ProfileDir
from instrain_tpu_torch.synth import synth

import make_torch_compact_golden as G

NULL_LUT = analytic_null_thresholds(max_coverage=10000)
FREQ_LUT = JS.freq_min_count_lut(0.05, max_coverage=10000)
TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]


def make_case(kind, M=0, L=0, seed=0):
    """(counts int32 [M, 4, L], ref codes u8 [L]) for one test case:
      synth      synth.site_stats_inputs (ref code 4, coverage above the
                 LUT cap, a zero-count level, uncovered positions);
      fuzz       the random sparse pileups of tests/test_compact.py's
                 dense-vs-compact sweep (M, L and depth from the seed);
      no_rows    every base agrees with an ACTG reference: no SNP row, no
                 SNV position;
      uncounted  no position reaches min_cov: NaN medians."""
    if kind == "synth":
        return G.make_inputs(M, L, seed)
    rng = np.random.default_rng(seed)
    if kind == "fuzz":
        M = int(rng.integers(1, 6))
        L = int(rng.integers(500, 6000))
        depth = int(rng.integers(3, 60))
        counts = rng.integers(0, depth, (M, 4, L)).astype(np.int32)
        counts[rng.random((M, 4, L)) < float(rng.uniform(0.4, 0.9))] = 0
        return counts, rng.integers(0, 5, L).astype(np.uint8)
    ref = rng.integers(0, 4, L).astype(np.uint8)
    counts = np.zeros((M, 4, L), np.int32)
    depth = rng.integers(20, 80, (M, L)) if kind == "no_rows" else \
        rng.integers(0, 2, (M, L))
    for m in range(M):
        counts[m, ref, np.arange(L)] = depth[m]
    if kind == "uncounted":
        counts[:, (ref + 1) % 4, np.arange(L)] = rng.integers(0, 2, (M, L))
    return counts, ref


CASES = ([("synth", M, L, M * 7 + L % 11) for M in (1, 5, 9, 33)
          for L in (1237, 4096, 5000)] +
         [("fuzz", 0, 0, s) for s in (11, 29, 47)] +
         [("no_rows", 4, 3000, 1), ("uncounted", 2, 2000, 2)])


def _ids(case):
    kind, M, L, seed = case
    return f"{kind}-M{M}-L{L}-s{seed}"


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_bits_equal(a, b, what):
    a, b = np.asarray(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        u = f"u{a.itemsize}"
        assert np.array_equal(a.view(u), b.view(u)), what
    else:
        assert np.array_equal(a, b), what


def assert_compact_equal(want, got, what=""):
    """Every field of the JAX package's cut compact outputs, bit for bit."""
    for group in ("rows", "agg", "linkage", "masks"):
        assert set(want[group]) == set(got[group]), \
            (what, group, set(want[group]) ^ set(got[group]))
        for k, a in want[group].items():
            b = got[group][k]
            if k in ("n_rows", "n_pos"):
                assert int(a) == int(b), (what, k)
            else:
                _assert_bits_equal(a, b, (what, group, k))


def one_scaffold(out):
    """The K4 outputs of a chunk of one segment in the one-scaffold form
    of the JAX package: the aggregates without their segment axis, rows
    and linkage without seg_start (checked: [0, n_rows] and [0, n_pos])."""
    rows = dict(out["rows"])
    link = dict(out["linkage"])
    assert rows.pop("seg_start").tolist() == [0, rows["n_rows"]]
    assert link.pop("seg_start").tolist() == [0, link["n_pos"]]
    agg = {k: v[0] for k, v in out["agg"].items()}
    return dict(rows=rows, agg=agg, linkage=link, masks=out["masks"])


def _port_full(counts, ref, key, Mp):
    return S.site_stats(*[torch.from_numpy(np.ascontiguousarray(x))
                          for x in (counts, ref, NULL_LUT, FREQ_LUT)],
                        key, m_stride=Mp)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_k4_plain_matches_jax(case):
    counts, ref = make_case(*case)
    M, _, L = counts.shape
    key = PC._fold_keys(100 + case[3], [case[3]])[0]
    want, Mp = G.jax_compact(counts, ref, key, NULL_LUT, FREQ_LUT)
    full = _port_full(counts, ref, key, Mp)
    assert_compact_equal(want, S.compact_from_full(full, M, L), "plain")
    # the kernel wrappers take the plain versions for CPU tensors
    CC.reset_launch_counts()
    seg = C.single_segment(L, key, "cpu")
    assert_compact_equal(want, one_scaffold(CC.compact_from_full(full, seg)),
                         "wrapper")
    assert CC.launch_counts() == {"select_rows": 0, "mm_aggregates": 0,
                                  "masked_median": 0}
    kind = case[0]
    assert (want["rows"]["n_rows"] == 0) == (kind in ("no_rows",
                                                      "uncounted"))
    assert np.isnan(want["agg"]["clon_median"]).all() == (
        kind == "uncounted")


def test_k4_helpers_match_jax():
    """first_set_indices, ffill_expand and median_select against their JAX
    counterparts on the same inputs."""
    rng = np.random.default_rng(3)
    mask = rng.random(3000) < 0.1
    want = np.asarray(JS._first_set_indices(mask, 3000))
    got = S.first_set_indices(torch.from_numpy(mask)).numpy()
    assert np.array_equal(want[want >= 0], got)
    vals = rng.random((13, 700)).astype(np.float32)
    sm = rng.random((13, 700)) < 0.3
    (jf,), jh = JS._ffill_expand([vals], sm, [np.nan])
    (tf,), th = S.ffill_expand([torch.from_numpy(vals)], torch.from_numpy(sm),
                               [float("nan")])
    assert np.array_equal(np.asarray(jh), th.numpy())
    _assert_bits_equal(np.asarray(jf), tf, "ffill")
    v = np.where(rng.random((9, 501)) < 0.7,
                 rng.integers(0, 40, (9, 501)).astype(np.float32), np.inf)
    v[3] = np.inf                                 # an empty row: NaN
    cnt = np.isfinite(v).sum(axis=1)
    _assert_bits_equal(np.asarray(JS._median_select(v, cnt)),
                       S.median_select(torch.from_numpy(v.astype(np.float32)),
                                       torch.from_numpy(cnt)), "median")


def _pileups(kind, M, L, seed):
    counts, ref = make_case(kind, M, L, seed)
    M, _, L = counts.shape
    mm = np.arange(M, dtype=np.int64) * 2 + 1
    name = f"{kind}_{seed}"
    return (JaxPileup(name=name, rid=seed, length=L, mm_values=mm,
                      counts=counts),
            ScaffoldPileup(name=name, rid=seed, length=L, mm_values=mm,
                           counts=counts), ref)


@pytest.mark.parametrize("case", [("synth", 5, 4096, 3),
                                  ("synth", 33, 1237, 4), ("fuzz", 0, 0, 29),
                                  ("no_rows", 2, 1500, 5)], ids=_ids)
def test_compact_tables_match_jax(case):
    """run_site_stats_compact / _hybrid and the compact tables of both
    packages, exact."""
    jpu, ppu, ref = _pileups(*case)
    js = JC.run_site_stats_hybrid(jpu, ref, NULL_LUT, FREQ_LUT, seed=5)
    ps = PC.run_site_stats_hybrid(ppu, ref, NULL_LUT, FREQ_LUT, seed=5)
    pc = PC.run_site_stats_compact(ppu, ref, NULL_LUT, FREQ_LUT, seed=5)
    for a, b in zip(JC.snp_tables_compact(js, ref),
                    PC.snp_tables_compact(ps, ref)):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    pd.testing.assert_frame_equal(JC.snp_table_compact(js, ref),
                                  PC.snp_table_compact(pc, ref),
                                  check_exact=True)
    for stats in (ps, pc):
        pd.testing.assert_frame_equal(JC.coverage_table_compact(js),
                                      PC.coverage_table_compact(stats),
                                      check_exact=True)
    _assert_bits_equal(js.clon, ps.clon, "clon")
    _assert_bits_equal(js.clonR, ps.clonR, "clonR")
    assert np.array_equal(js.total, ps.total)


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return synth(str(d), S=4, L=5000, COV=40, seed=3)


@pytest.fixture(scope="module")
def profiles(synth_data, tmp_path_factory):
    """The port's hybrid and dense runs (--device cpu) and the JAX
    package's hybrid run, on one synthetic BAM."""
    fasta, bam, _ = synth_data
    d = tmp_path_factory.mktemp("profiles")
    out = {k: str(d / f"{k}.IS") for k in ("hybrid", "dense", "jax")}
    for engine in ("hybrid", "dense"):
        assert port_main(["profile", bam, fasta, "-o", out[engine],
                          "--device", "cpu", "--engine", engine] +
                         FLAGS) == 0
    assert jax_main(["profile", bam, fasta, "-o", out["jax"], "--engine",
                     "hybrid"] + FLAGS) == 0
    return out


def _tsv(d, table):
    return os.path.join(d, "output", f"{os.path.basename(d)}_{table}.tsv")


@pytest.mark.parametrize("table", TABLES)
def test_hybrid_tsvs_match_jax_hybrid(profiles, table):
    with open(_tsv(profiles["hybrid"], table)) as f:
        got = f.read()
    with open(_tsv(profiles["jax"], table)) as f:
        want = f.read()
    assert got.count("\n") > 1 and got == want


def _read(path, table):
    return pd.read_csv(path, sep="\t", header=1 if table == "mapping_info"
                       else 0)


@pytest.mark.parametrize("table", TABLES)
def test_hybrid_matches_port_dense(profiles, table):
    a = _read(_tsv(profiles["hybrid"], table), table)
    b = _read(_tsv(profiles["dense"], table), table)
    assert len(a) > 0 and list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for col in a.columns:
        va, vb = a[col].values, b[col].values
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            va, vb = va.astype(float), vb.astype(float)
            assert np.array_equal(np.isnan(va), np.isnan(vb)), col
            m = ~np.isnan(va)
            tol = 1e-6 if col.startswith("nucl_diversity") else 1e-9
            assert np.allclose(va[m], vb[m], rtol=tol, atol=tol), col
        else:
            assert np.array_equal(va, vb), col


def test_hybrid_special_views_match_dense(profiles):
    """covT / clonT / clonTR of the hybrid run equal the dense run's: the
    scaffolds are under 1 Mb, so both engines draw under one key."""
    h, d = ProfileDir(profiles["hybrid"]), ProfileDir(profiles["dense"])
    for special in ("covT", "clonT", "clonTR"):
        got, want = h.get(special), d.get(special)
        assert sorted(got) == sorted(want)
        for scaff in want:
            assert sorted(got[scaff]) == sorted(want[scaff])
            for mm, s in want[scaff].items():
                pd.testing.assert_series_equal(got[scaff][mm], s)


def test_resolve_engine():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert PP.resolve_engine("auto", cuda, 8, 40000) == "hybrid"
    assert PP.resolve_engine("auto", cpu, 8, 40000) == "dense"
    assert PP.resolve_engine("hybrid", cpu, 8, 40000) == "hybrid"
    assert PP.resolve_engine("dense", cuda, 8, 40000) == "dense"
    # the oversize rule on padded extents: 8 * 2^24 = 2^27 is the bound
    assert PP.resolve_engine("auto", cuda, 8, 1 << 24) == "hybrid"
    assert PP.resolve_engine("auto", cuda, 8, (1 << 24) + 1) == "dense"
    assert PP.resolve_engine("auto", cuda, 3, 1 << 24) == "hybrid"
    assert PP.resolve_engine("hybrid", cpu, 9, 1 << 23) == "hybrid"
    assert PP.resolve_engine("hybrid", cpu, 9, (1 << 23) + 1) == "dense"
    assert PP.resolve_engine("auto", cuda, 1, 2_500_000) == "hybrid"
    # the extent of the pileup the JAX package builds
    # (instrain_tpu/profile/pipeline.py:458-481): unpadded M * L under
    # --skip_mm_profiling (M = 1) ...
    L = (1 << 24) + 4096
    assert PP.resolve_engine("hybrid", cuda, 1, L) == "dense"
    assert PP.resolve_engine("hybrid", cuda, 1, L, skip_mm=True) == "hybrid"
    assert PP.resolve_engine("auto", cuda, 1, 1 << 27,
                             skip_mm=True) == "hybrid"
    assert PP.resolve_engine("auto", cuda, 1, (1 << 27) + 1,
                             skip_mm=True) == "dense"
    assert PP.resolve_engine("auto", cpu, 1, L, skip_mm=True) == "dense"

    # ... and when an exact-mm count overflows int16, so that the padded
    # int16 builder falls back (instrain_tpu/profile/pileup.py:121-126);
    # the rule reads only the counts' max()
    class Peak:
        def __init__(self, v):
            self.v = v

        def max(self):
            return self.v

    over, under = Peak(PP.INT16_MAX + 1), Peak(PP.INT16_MAX)
    for M in range(1, 9):
        for L in ((1 << 24) + 1, (1 << 27) // M):
            if not (1 << 24) < L <= (1 << 27) // M:
                continue
            assert PP.resolve_engine("hybrid", cuda, M, L,
                                     counts=over) == "hybrid", (M, L)
            assert PP.resolve_engine("hybrid", cuda, M, L,
                                     counts=under) == "dense", (M, L)
            assert PP.resolve_engine("hybrid", cuda, M, L) == "dense"
        assert PP.resolve_engine("hybrid", cuda, M, (1 << 27) // M + 1,
                                 counts=over) == "dense", M
    # the padded cases stand under a small peak or none
    for peak in (None, under):
        assert PP.resolve_engine("auto", cuda, 8, 1 << 24,
                                 counts=peak) == "hybrid"
        assert PP.resolve_engine("auto", cuda, 8, (1 << 24) + 1,
                                 counts=peak) == "dense"
        assert PP.resolve_engine("hybrid", cpu, 9, (1 << 23) + 1,
                                 counts=peak) == "dense"
    # the run-level rule (instrain_tpu/profile/pipeline.py:239-246, :255):
    # auto is batch on a GPU from 16 kept scaffolds on, hybrid below and
    # dense on the CPU; batch with one scaffold runs hybrid
    n = PP.BATCH_MIN_SCAFFOLDS
    assert n == 16
    assert PP.resolve_run_engine("auto", cuda, n) == "batch"
    assert PP.resolve_run_engine("auto", cuda, n - 1) == "hybrid"
    assert PP.resolve_run_engine("auto", cpu, 1000) == "dense"
    assert PP.resolve_run_engine("batch", cpu, 2) == "batch"
    assert PP.resolve_run_engine("batch", cuda, 1) == "hybrid"
    assert PP.resolve_run_engine("dense", cuda, 1000) == "dense"
    assert PP.resolve_run_engine("hybrid", cuda, 1000) == "hybrid"


def test_batch_engine_runs(tmp_path, synth_data, profiles):
    """--engine batch runs the batch engine (four scaffolds in fewer
    chunks, one per mm extent): its TSVs equal the hybrid engine's, byte
    for byte."""
    fasta, bam, _ = synth_data
    out = str(tmp_path / "b.IS")
    dispatched = []
    dispatch = PC._dispatch_chunk

    def spy(items, *a, **k):
        dispatched.append(len(items))
        return dispatch(items, *a, **k)

    PC._dispatch_chunk = spy
    try:
        assert port_main(["profile", bam, fasta, "-o", out, "--device",
                          "cpu", "--engine", "batch"] + FLAGS) == 0
    finally:
        PC._dispatch_chunk = dispatch
    assert sum(dispatched) == 4 and len(dispatched) < 4
    for table in TABLES:
        with open(_tsv(out, table)) as f, \
                open(_tsv(profiles["hybrid"], table)) as g:
            assert f.read() == g.read(), table


def test_hybrid_draws_one_key_per_scaffold():
    """Hybrid draws clonR under fold_in(seed, rid) over the whole
    scaffold, as the JAX hybrid engine does; the dense engine draws each
    position chunk under its own key, so past the first chunk the two
    differ."""
    rng = np.random.default_rng(8)
    M, L, chunk = 3, 5000, 2048
    counts = rng.integers(15, 40, (M, 4, L)).astype(np.int32)   # >= 60x
    ref = rng.integers(0, 4, L).astype(np.uint8)
    mm = np.arange(M, dtype=np.int64)
    jpu = JaxPileup(name="s", rid=3, length=L, mm_values=mm, counts=counts)
    ppu = ScaffoldPileup(name="s", rid=3, length=L, mm_values=mm,
                         counts=counts)
    want = JC.run_site_stats_hybrid(jpu, ref, NULL_LUT, FREQ_LUT, seed=9)
    got = PC.run_site_stats_hybrid(ppu, ref, NULL_LUT, FREQ_LUT, seed=9)
    _assert_bits_equal(want.clonR, got.clonR, "clonR")
    assert np.isfinite(got.clonR).all()
    dense = run_site_stats(ppu, ref, NULL_LUT, FREQ_LUT, seed=9,
                           max_chunk=chunk).clonR
    _assert_bits_equal(got.clonR[:, :chunk], dense[:, :chunk], "chunk 0")
    assert (got.clonR[:, chunk:] != dense[:, chunk:]).mean() > 0.5


def test_hybrid_engine_runs_one_scaffold_per_chunk(tmp_path, synth_data,
                                                   profiles):
    """--engine hybrid goes through the batch engine's streaming loop with
    every scaffold a chunk of its own, and gives the same bytes as the
    run of the `profiles` fixture."""
    fasta, bam, _ = synth_data
    out = str(tmp_path / "h.IS")
    dispatched = []
    dispatch = PC._dispatch_chunk

    def spy(items, *a, **k):
        dispatched.append(len(items))
        return dispatch(items, *a, **k)

    PC._dispatch_chunk = spy
    try:
        assert port_main(["profile", bam, fasta, "-o", out, "--device",
                          "cpu", "--engine", "hybrid"] + FLAGS) == 0
    finally:
        PC._dispatch_chunk = dispatch
    assert dispatched == [1, 1, 1, 1]
    for table in TABLES:
        with open(_tsv(out, table)) as f, \
                open(_tsv(profiles["hybrid"], table)) as g:
            assert f.read() == g.read(), table


def test_compact_kernel_fault_is_not_contained(tmp_path, synth_data,
                                               monkeypatch):
    fasta, bam, _ = synth_data

    def kernel_fault(*a, **k):
        raise KernelError("select_rows: launch failed")

    monkeypatch.setattr(PC, "_dispatch_chunk", kernel_fault)
    with pytest.raises(KernelError):
        port_main(["profile", bam, fasta, "-o", str(tmp_path / "k.IS"),
                   "--device", "cpu", "--engine", "hybrid"] + FLAGS)


def _golden():
    with np.load(G.PATH) as z:
        return {k: z[k] for k in z.files}


def _golden_case(g, tag):
    want = {grp: {} for grp in ("rows", "agg", "linkage", "masks")}
    for k, v in g.items():
        parts = k.split("/")
        if parts[0] == tag and parts[1] in want:
            want[parts[1]][parts[2]] = v
    return want


def test_compact_golden_is_current():
    """The committed golden file equals a fresh JAX run of its recipe."""
    fresh = G.golden_arrays()
    g = _golden()
    assert sorted(g) == sorted(fresh)
    for k in fresh:
        _assert_bits_equal(fresh[k], g[k], k)


@pytest.mark.parametrize("M,L,seed", G.CASES)
def test_plain_matches_compact_golden(M, L, seed):
    """What chip_smoke.py checks with the kernels, with the plain path."""
    g = _golden()
    tag = f"M{M}_L{L}"
    seg = C.single_segment(L, g[f"{tag}/key"], "cpu")
    full = C.site_stats(*[torch.from_numpy(g[k]) for k in (
        f"{tag}/counts", f"{tag}/ref", "null_lut", "freq_lut")],
        seg, min_cov=G.MIN_COV, min_covR=G.RAREFIED,
        rarefied_draws=G.RAREFIED, m_stride=int(g[f"{tag}/m_stride"]))
    assert_compact_equal(_golden_case(g, tag),
                         one_scaffold(CC.compact_from_full(full, seg)), tag)


# masked_median's plan (cuda_compact.median_plan) and its select, here in
# PyTorch: the CUDA kernel runs only on the card, so its plan and its
# arithmetic are held to the plain version on the CPU.

SMEM_PER_BLOCK = 232448      # bytes a block may take on an H100 (227 KB)
SHORT_STATIC_SMEM = 9216     # the short kernel's static shared arrays, at most
PLAN_CASES = [([40000] * 52, 8), ([1 << 20], 8), ([2_500_000], 5),
              ([250_000], 5), ([1, CC.MEDIAN_SHORT_KEYS,
                                CC.MEDIAN_SHORT_KEYS + 1, 7], 3),
              ([CC.MEDIAN_SHORT_KEYS + 1] * 3, 33), ([1], 1),
              ([16384, 5_000_000, 70_000, 2], 2), ([3] * 40, 80)]


@pytest.mark.parametrize("lengths,M", PLAN_CASES,
                         ids=[f"S{len(c[0])}-M{c[1]}" for c in PLAN_CASES])
def test_median_plan_covers_every_row(lengths, M):
    """Every (segment, mm level, value set) row is one short block's or
    split into disjoint chunk ranges that cover it; short rows fit in
    shared memory; long rows fill the card."""
    plan = CC.median_plan(lengths, M, sms=132)
    lengths = np.asarray(lengths)
    assert plan == CC.median_plan(lengths.tolist(), M)
    short, long_ = list(plan.short_segments), list(plan.long_segments)
    assert sorted(short + long_) == list(range(len(lengths)))
    assert (lengths[short] <= CC.MEDIAN_SHORT_KEYS).all()
    assert (lengths[long_] > CC.MEDIAN_SHORT_KEYS).all()
    assert plan.short_keys == (-(-lengths[short].max() // 4) * 4
                               if short else 0)
    assert plan.short_keys <= CC.MEDIAN_SHORT_KEYS
    # the short kernel's dynamic shared memory: 4 bytes a key
    assert plan.short_keys * 4 + SHORT_STATIC_SMEM <= SMEM_PER_BLOCK
    assert len(plan.first_block) == len(long_) + 1
    assert plan.first_block[0] == 0
    blocks = 0
    for i, s in enumerate(long_):
        n = int(lengths[s])
        nb = int(plan.first_block[i + 1] - plan.first_block[i])
        ranges = [(k * plan.chunk, min(n, (k + 1) * plan.chunk))
                  for k in range(nb)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a < b for a, b in ranges)
        assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
        blocks += nb
    # one block per short row; every long row's chunks: each row once
    rows = [(s, m, w) for s in short for m in range(M) for w in range(3)]
    rows += [(s, m, w) for s in long_ for m in range(M) for w in range(3)]
    assert len(set(rows)) == len(lengths) * M * 3
    if long_:
        assert plan.chunk >= CC.MEDIAN_MIN_CHUNK and plan.chunk % 4096 == 0
        keys = int(lengths[long_].sum()) * 3 * M
        if keys >= 132 * CC.MEDIAN_BLOCKS_PER_SM * CC.MEDIAN_MIN_CHUNK:
            assert blocks * 3 * M >= 132 * CC.MEDIAN_BLOCKS_PER_SM


def test_median_short_limit_matches_kernel():
    """The wrapper's short-row limit is the one compact.cu raises the
    short kernel's dynamic shared memory to, once per device, and that
    limit fits a block beside the kernel's static arrays."""
    path = os.path.join(os.path.dirname(CC.__file__), os.pardir, "csrc",
                        "compact.cu")
    with open(path) as f:
        m = re.search(r"constexpr int kShortKeysMax = (\d+);", f.read())
    assert m and int(m.group(1)) == CC.MEDIAN_SHORT_KEYS
    assert CC.MEDIAN_SHORT_KEYS * 4 + SHORT_STATIC_SMEM <= SMEM_PER_BLOCK


def radix_median(vals, count):
    """The masked_median kernels' select, row by row in PyTorch: digits of
    11, 11 and 10 bits from the top of the f32 keys, each pass a histogram
    of the group's digit; the ranks k1 and k2 narrow together, and once
    their bins differ, k1 is the largest key of its bin's group and k2 the
    smallest of its own (a min/max pass); NaN where count is 0."""
    keys = vals.contiguous().view(torch.int32).to(torch.int64)
    out = []
    for key, c in zip(keys, count.tolist()):
        if c <= 0:
            out.append(float("nan"))
            continue
        k1, k2 = (c - 1) // 2 + 1, c // 2 + 1
        prefix = mask = 0
        shift = 32
        for i, w in enumerate((11, 11, 10)):
            shift -= w
            digit = (1 << w) - 1
            group = key[(key & mask) == prefix]
            hist = torch.bincount((group >> shift) & digit, minlength=1 << w)
            cum = hist.cumsum(0)
            d1 = int(torch.searchsorted(cum, k1))
            d2 = int(torch.searchsorted(cum, k2))
            b1 = int(cum[d1] - hist[d1])
            p = prefix
            prefix, prefix2 = p | (d1 << shift), p | (d2 << shift)
            mask |= digit << shift
            if i == 2:
                v1, v2 = prefix, prefix2
                break
            if d1 != d2:
                v1 = int(key[(key & mask) == prefix].max())
                v2 = int(key[(key & mask) == prefix2].min())
                break
            k1, k2 = k1 - b1, k2 - b1
        v = torch.tensor([v1, v2], dtype=torch.int32).view(torch.float32)
        out.append(float((v[0] + v[1]) / 2))
    return torch.tensor(out, dtype=torch.float32)


def adversarial_rows(n, seed):
    """[R, n] f32 rows, members >= 0 and +inf past them, with their
    counts: all values equal; 1 or 2 members among +inf; clustered
    coverages; f32 patterns on the digits' boundaries; counts 0, 1, 2,
    n - 1, n and at random."""
    rng = np.random.default_rng(seed)
    bits = np.array([0, 0x3E000000, 0x3EFFFFFF, 0x3F000000, 0x3F000001,
                     0x3F7FFBFF, 0x3F7FFC00, 0x3F7FFFFF, 0x3F800000,
                     0x3F800001, 0x3F800400, 0x3F801000, 0x45000000,
                     0x4B800000, 0x4B800001], np.uint32)
    rows, counts = [], []

    def add(v, c):
        c = int(min(c, n))
        v = np.sort(v.astype(np.float32))
        v[c:] = np.inf
        rows.append(rng.permutation(v))
        counts.append(c)

    for c in (0, 1, 2, max(n - 1, 0), n):
        add(np.full(n, 30.0), c)
        add(rng.choice(bits, n).view(np.float32), c)
    for c in (1, 2):
        add(rng.random(n), c)
    add(rng.choice([29.0, 30.0, 31.0], n), n)
    add(rng.integers(0, 2 ** 25, n).astype(np.float32), n)
    add(rng.choice(bits[:4], n).view(np.float32), int(rng.integers(0, n + 1)))
    return (torch.from_numpy(np.stack(rows)),
            torch.tensor(counts, dtype=torch.int64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 64, 1000])
def test_radix_select_matches_median_select(n, seed):
    vals, count = adversarial_rows(n, n + seed)
    _assert_bits_equal(S.median_select(vals, count).numpy(),
                       radix_median(vals, count), (n, seed))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,seed", [(1, 1237, 0), (8, 4096, 1),
                                      (33, 5000, 2), (8, 300_001, 3),
                                      (1, 1, 4), (3, 49152, 5),
                                      (3, 49153, 6), (33, 40000, 7),
                                      (80, 700, 8), (8, 1 << 20, 9),
                                      (5, 250_000, 10)])
def test_k4_kernels_match_plain_on_gpu(M, L, seed, cuda_device):
    counts, ref = G.make_inputs(M, L, seed)
    seg = C.single_segment(L, PC._fold_keys(seed, [seed])[0], cuda_device)
    full = C.site_stats(*[torch.from_numpy(x).to(cuda_device) for x in (
        counts, ref, NULL_LUT, FREQ_LUT)], seg, m_stride=max(
            -(-M // 8) * 8, 8))
    CC.reset_launch_counts()
    rows, link = CC.select_rows(full, seg)
    agg, clon_f, clonR_f = CC.mm_aggregates(full, seg)
    med = CC.masked_median(full["total"], clon_f, clonR_f, agg["counted"],
                           agg["rarefied"], seg)
    torch.cuda.synchronize()
    assert CC.launch_counts() == {"select_rows": 1, "mm_aggregates": 1,
                                  "masked_median": 1}
    prows, plink = S.select_rows_seg(full, seg)
    pagg, pclon_f, pclonR_f = S.mm_aggregates_seg(full, seg)
    pmed = S.masked_medians_seg(full["total"], pclon_f, pclonR_f,
                                pagg["counted"], pagg["rarefied"], seg)
    for want, got in ((prows, rows), (plink, link), (pagg, agg),
                      (pmed, med), ({"f": pclon_f, "r": pclonR_f},
                                    {"f": clon_f, "r": clonR_f})):
        assert set(want) == set(got)
        for k in want:
            a, b = want[k], got[k]
            if isinstance(a, int):
                assert a == b, k
            else:
                _assert_bits_equal(a.cpu().numpy(), b.cpu(), k)
