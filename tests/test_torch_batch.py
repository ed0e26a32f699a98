"""
The port's batch engine (K5) against the JAX package: the chunked
site stats and compaction (the plain versions, which the kernel wrappers
take for CPU tensors) against instrain_tpu's site_stats_compact_batch
through the committed golden file, against the JAX package's
run_site_stats_compact_batch and against the port's own per-scaffold
hybrid engine, bit for bit; `instrain_tpu_torch profile --engine batch
--device cpu` against `instrain_tpu profile --engine batch` byte for
byte, with and without --skip_mm_profiling; the chunk planner; the
oversize diversion to the dense engine; that a kernel fault in the batch
loop fails the run; and — on a machine with an NVIDIA GPU — the
segmented kernels against their plain versions.

These cover the intent of the JAX package's
test_batch_engine_matches_dense, test_batch_engine_skip_mm_matches_dense
and test_batch_mixed_dtype_bucket_separation (tests/test_compact.py:111,
:779, :688): the port buckets chunks by mm extent, not by wire dtype.

Tolerances: none within the batch and hybrid engines (integers by
construction, exact order statistics, f64 sums exact in any order).
Against the dense engine, the reference's cross-engine tolerances
(tests/test_compact.py:45-49): nucl_diversity* within 1e-6, other floats
within 1e-9.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

from instrain_tpu.cli import main as jax_main
from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu.kernels.sitestats import freq_min_count_lut
from instrain_tpu.profile import compact as JC
from instrain_tpu.profile.pileup import ScaffoldPileup as JaxPileup
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.kernels import cuda_compact as CC
from instrain_tpu_torch.kernels import cuda_sitestats as C
from instrain_tpu_torch.kernels import sitestats as S
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import pipeline as PP
from instrain_tpu_torch.profile.pileup import ScaffoldPileup
from instrain_tpu_torch.synth import synth

import make_torch_batch_golden as G

NULL_LUT = analytic_null_thresholds(max_coverage=10000)
FREQ_LUT = freq_min_count_lut(0.05, max_coverage=10000)
TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]


def _bits_equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    assert np.array_equal(a, b), what


def assert_stats_equal(want, got, what, M=None):
    """rows / agg / linkage / masks of two compact stats (or dicts) bit for
    bit; with M, the aggregates and linkage profiles of `got` cut to its
    first M levels."""
    def groups(st):
        return st if isinstance(st, dict) else dict(
            rows=st.rows, agg=st.agg, linkage=st.linkage, masks=st.masks)
    w, g = groups(want), groups(got)
    for grp in ("rows", "agg", "linkage", "masks"):
        assert set(w[grp]) == set(g[grp]), (what, grp)
        for k, a in w[grp].items():
            b = g[grp][k]
            if k in ("n_rows", "n_pos"):
                assert int(a) == int(b), (what, k)
                continue
            if M is not None and (grp == "agg" or k in ("cum", "present")):
                b = np.asarray(b)[:M]
            _bits_equal(a, b, (what, grp, k))


def _golden():
    with np.load(G.PATH) as z:
        return {k: z[k] for k in z.files}


def test_batch_golden_is_current():
    """The committed golden file equals a fresh JAX run of its recipe."""
    fresh = G.golden_arrays()
    g = _golden()
    assert sorted(g) == sorted(fresh)
    for k in fresh:
        _bits_equal(fresh[k], g[k], k)


def golden_chunk(g, name, device="cpu"):
    """The golden chunk `name` through the batch engine's chunk path
    (profile/compact.py) on `device`: its scaffolds padded with empty mm
    levels to the chunk's counter stride, under the golden keys. Returns
    [(true M, stats)] in order."""
    Mp = int(g[f"{name}/m_stride"])
    n = len(G.CHUNKS[name])
    items, Ms = [], []
    for s in range(n):
        counts = g[f"{name}/{s}/counts"]
        M, _, L = counts.shape
        cp = np.zeros((Mp, 4, L), np.int32)
        cp[:M] = counts
        items.append((s, ScaffoldPileup(name=f"s{s}", rid=s, length=L,
                                        mm_values=np.arange(Mp), counts=cp),
                      g[f"{name}/{s}/ref"]))
        Ms.append(M)
    keys = np.stack([g[f"{name}/{s}/key"] for s in range(n)])
    dev = torch.device(device)
    fold = PC._fold_keys
    PC._fold_keys = lambda seed, rids: keys
    try:
        chunk = PC._dispatch_chunk(
            items, torch.as_tensor(g["null_lut"], device=dev),
            torch.as_tensor(g["freq_lut"], device=dev), G.MIN_COV,
            G.RAREFIED, 0, False, dev)
    finally:
        PC._fold_keys = fold
    return [(Ms[s], st) for s, st in PC._finish_chunk(chunk)]


@pytest.mark.parametrize("name", sorted(G.CHUNKS))
def test_plain_batch_matches_golden(name):
    g = _golden()
    C.reset_launch_counts()
    CC.reset_launch_counts()
    got = golden_chunk(g, name)
    assert {**C.launch_counts(), **CC.launch_counts()} == dict.fromkeys(
        ("site_stats", "clonR", "select_rows", "mm_aggregates",
         "masked_median"), 0)
    assert len(got) == len(G.CHUNKS[name])
    for s, (M, st) in enumerate(got):
        want = {grp: {} for grp in ("rows", "agg", "linkage", "masks")}
        for k, v in g.items():
            parts = k.split("/")
            if parts[:2] == [name, str(s)] and parts[2] in want:
                want[parts[2]][parts[3]] = v
        assert_stats_equal(want, st, (name, s), M=M)


def _scaffolds(spec, seed):
    """Port and JAX pileups of scaffolds of the given (M, L, rid), with
    their ref codes."""
    out = []
    for M, L, rid in spec:
        counts, ref = G.make_inputs(M, L, seed + rid)
        mm = np.arange(M, dtype=np.int64) * 3
        kw = dict(name=f"s{rid}", rid=rid, length=L, mm_values=mm,
                  counts=counts)
        out.append((ScaffoldPileup(**kw), JaxPileup(**kw), ref))
    return out


# unequal M and L, some sharing M (one chunk) and one too large to share
SPEC = [(4, 3000, 1), (2, 1, 2), (4, 1237, 3), (9, 800, 4), (4, 40, 5),
        (1, 2500, 6), (9, 4000, 7)]


def test_batch_matches_jax_batch_and_port_hybrid():
    sc = _scaffolds(SPEC, 40)
    pus, jpus, refs = zip(*sc)
    # a small chunk bound: the M = 4 and M = 9 buckets split into chunks
    got = PC.run_site_stats_compact_batch(
        list(pus), list(refs), NULL_LUT, FREQ_LUT, seed=8, with_dense=True,
        max_chunk_cells=3 * 4 * 1300)
    want = JC.run_site_stats_compact_batch(
        list(jpus), list(refs), NULL_LUT, FREQ_LUT, seed=8, with_dense=True)
    for pu, ref, js, ps in zip(pus, refs, want, got):
        assert isinstance(ps, PC.HybridStats) and ps.pileup is pu
        hy = PC.run_site_stats_hybrid(pu, ref, NULL_LUT, FREQ_LUT, seed=8)
        assert_stats_equal(hy, ps, pu.name)
        for k in ("clon", "clonR"):
            _bits_equal(getattr(hy, k), getattr(ps, k), (pu.name, k))
            _bits_equal(np.asarray(getattr(js, k))[:ps.M, :ps.L],
                        getattr(ps, k), (pu.name, "jax", k))
        for a, b in zip(JC.snp_tables_compact(js, ref),
                        PC.snp_tables_compact(ps, ref)):
            pd.testing.assert_frame_equal(a, b, check_exact=True)
        pd.testing.assert_frame_equal(JC.coverage_table_compact(js),
                                      PC.coverage_table_compact(ps),
                                      check_exact=True)


@pytest.mark.parametrize("lengths", [[1], [2048], [2049, 1, 4095, 2048],
                                     [40000] * 52, [1 << 20, 3, 300_001]])
def test_aggregate_tiles_cover_every_position(lengths):
    """mm_aggregates' blocks (csrc/compact.cu C2) at both of its widths:
    with PER positions a thread, block b takes the segment whose first
    tile (big tile for PER = 8) is the last <= b, and within it positions
    (b - first) * 256 PER + thread + 256 v, v < PER: every position of
    every segment once, no block over two segments."""
    from instrain_tpu_torch.kernels.sitestats import (BIG_TILE, TILE,
                                                      Segments)
    seg = Segments(lengths, np.zeros((len(lengths), 2), np.uint32))
    for per, first, n_blocks in ((CC.AGG_PER, seg.btile0, seg.n_btiles),
                                 (1, seg.tile0, seg.n_tiles)):
        assert TILE * per == (BIG_TILE if per > 1 else TILE)
        seen = [np.zeros(n, np.int64) for n in lengths]
        for b in range(n_blocks):
            s = int(np.searchsorted(first, b, side="right")) - 1
            p = (b - first[s]) * TILE * per + np.arange(TILE)[:, None] + \
                TILE * np.arange(per)[None, :]
            p = p[p < lengths[s]]
            assert len(p), (b, s)
            seen[s][p] += 1
        assert all((x == 1).all() for x in seen)
        assert n_blocks == sum(-(-n // (TILE * per)) for n in lengths)
    # big tiles while they give every SM two blocks
    sms = 132
    assert CC.aggregates_per_thread(2 * sms, sms) == CC.AGG_PER
    assert CC.aggregates_per_thread(2 * sms - 1, sms) == 1
    deep = Segments([250_000], np.zeros((1, 2), np.uint32))
    assert CC.aggregates_per_thread(deep.n_btiles, sms) == 1
    chunk = Segments([40000] * 52, np.zeros((52, 2), np.uint32))
    assert CC.aggregates_per_thread(chunk.n_btiles, sms) == CC.AGG_PER


def test_chunk_planner():
    """Chunks hold one mm extent each (int16 and int32 wires never shared
    a chunk in the JAX package; here scaffolds of different M never do),
    keep the arrival order within a chunk, stay within the cell bound
    unless a scaffold alone exceeds it, and cover every scaffold once."""
    rng = np.random.default_rng(1)
    shapes = [(int(m), int(l)) for m, l in zip(rng.choice([1, 4, 9], 60),
                                               rng.integers(1, 5000, 60))]
    shapes[7] = (4, 100_000)                        # alone over the bound
    bound = 4 * 20_000
    chunks = PC.plan_chunks(shapes, bound)
    assert sorted(i for c in chunks for i in c) == list(range(60))
    for c in chunks:
        assert len({shapes[i][0] for i in c}) == 1
        assert c == sorted(c)
        cells = sum(shapes[i][0] * shapes[i][1] for i in c)
        assert cells <= bound or len(c) == 1
    assert [7] in chunks
    # streaming: a chunk is handed out when the next scaffold of its
    # bucket would not fit, or as soon as it is full
    planner = PC.ChunkPlanner(10)
    assert planner.add("a", 2, 3) == []
    assert planner.add("b", 1, 9) == []
    assert planner.add("c", 2, 1) == []
    assert planner.add("d", 2, 2) == [["a", "c"]]
    assert planner.add("e", 1, 1) == [["b", "e"]]
    assert planner.add("f", 4, 3) == [["f"]]         # alone over the bound
    assert planner.rest() == [["d"]]
    # a bound of 0 cells: every scaffold is a chunk of its own (hybrid)
    assert PC.plan_chunks([(2, 5), (1, 1), (2, 5)], 0) == [[0], [1], [2]]


@pytest.fixture(scope="module")
def meta_data(tmp_path_factory):
    """17 scaffolds: --engine auto would pick batch on a GPU."""
    d = tmp_path_factory.mktemp("meta")
    return synth(str(d), S=17, L=3000, COV=30, seed=5)


def _tsv(d, table):
    return os.path.join(d, "output", f"{os.path.basename(d)}_{table}.tsv")


@pytest.fixture(scope="module")
def batch_profiles(meta_data, tmp_path_factory):
    """The port's batch run (--device cpu) and the JAX package's, each
    with and without --skip_mm_profiling."""
    fasta, bam, _ = meta_data
    d = tmp_path_factory.mktemp("batch")
    out = {}
    for tag, extra in (("mm", []), ("skip_mm", ["--skip_mm_profiling"])):
        out[tag] = (str(d / f"port_{tag}.IS"), str(d / f"jax_{tag}.IS"))
        assert port_main(["profile", bam, fasta, "-o", out[tag][0],
                          "--device", "cpu", "--engine", "batch"] +
                         FLAGS + extra) == 0
        assert jax_main(["profile", bam, fasta, "-o", out[tag][1],
                         "--engine", "batch"] + FLAGS + extra) == 0
    return out


@pytest.mark.parametrize("tag", ["mm", "skip_mm"])
@pytest.mark.parametrize("table", TABLES)
def test_batch_tsvs_match_jax_batch(batch_profiles, tag, table):
    port, jx = batch_profiles[tag]
    with open(_tsv(port, table)) as f:
        got = f.read()
    with open(_tsv(jx, table)) as f:
        want = f.read()
    assert got.count("\n") > 1 and got == want


def _read(path, table):
    return pd.read_csv(path, sep="\t", header=1 if table == "mapping_info"
                       else 0)


def test_oversize_scaffold_runs_dense(meta_data, batch_profiles, tmp_path,
                                      monkeypatch):
    """A scaffold over the one-launch bound is diverted to the
    position-chunked dense engine after the chunks, and its tables take
    their place in scaffold order."""
    fasta, bam, _ = meta_data
    monkeypatch.setattr(PP, "HYBRID_MAX_CELLS", 8 * 4096 - 1)
    ran = []
    dense = PP.run_site_stats

    def spy(pu, *a, **k):
        ran.append(pu.name)
        return dense(pu, *a, **k)

    monkeypatch.setattr(PP, "run_site_stats", spy)
    out = str(tmp_path / "o.IS")
    assert port_main(["profile", bam, fasta, "-o", out, "--device", "cpu",
                      "--engine", "batch"] + FLAGS) == 0
    assert len(ran) == 17                  # every scaffold is oversize now
    monkeypatch.setattr(PP, "HYBRID_MAX_CELLS", 1 << 27)
    ran.clear()
    out2 = str(tmp_path / "o2.IS")
    assert port_main(["profile", bam, fasta, "-o", out2, "--device", "cpu",
                      "--engine", "batch"] + FLAGS) == 0
    assert ran == []
    for table in TABLES:
        a = _read(_tsv(out, table), table)
        b = _read(_tsv(batch_profiles["mm"][0], table), table)
        assert list(a.columns) == list(b.columns) and len(a) == len(b)
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


def test_batch_kernel_fault_fails_the_run(meta_data, tmp_path, monkeypatch):
    """A kernel fault in the batch loop fails the run: no scaffold is
    retried on another engine and nothing is contained."""
    fasta, bam, _ = meta_data
    calls = []

    def kernel_fault(*a, **k):
        calls.append(1)
        raise KernelError("select_rows: launch failed")

    monkeypatch.setattr(PC, "_dispatch_chunk", kernel_fault)
    with pytest.raises(KernelError):
        port_main(["profile", bam, fasta, "-o", str(tmp_path / "k.IS"),
                   "--device", "cpu", "--engine", "batch"] + FLAGS)
    assert len(calls) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,lengths", [(8, [1, 1237, 40000, 300, 4096]),
                                       (33, [160, 1, 5000]),
                                       (1, [7, 3000, 1_100_000]),
                                       (3, [1, 49152, 49153, 2]),
                                       (33, [40000] * 3),
                                       (80, [300, 1, 2000]),
                                       (8, [40000] * 52),
                                       (5, [2047, 2048, 2049, 1, 4095])])
def test_segmented_kernels_match_plain_on_gpu(M, lengths, cuda_device):
    parts = [G.make_inputs(M, L, 3 + i) for i, L in enumerate(lengths)]
    counts = torch.from_numpy(np.concatenate([c for c, _ in parts], axis=2))
    ref = torch.from_numpy(np.concatenate([r for _, r in parts]))
    seg = S.Segments(lengths, PC._fold_keys(4, range(len(lengths))),
                     cuda_device)
    Mp = max(-(-M // 8) * 8, 8)
    full = C.site_stats(*[t.to(cuda_device) for t in (
        counts, ref, torch.from_numpy(NULL_LUT), torch.from_numpy(
            FREQ_LUT))], seg, m_stride=Mp)
    C.reset_launch_counts()
    CC.reset_launch_counts()
    clonR = C.clonR(full["cum"], full["total"], full["clonR_set"], seg, 50,
                    Mp)
    rows, link = CC.select_rows(full, seg)
    agg, clon_f, clonR_f = CC.mm_aggregates(full, seg)
    med = CC.masked_median(full["total"], clon_f, clonR_f, agg["counted"],
                           agg["rarefied"], seg)
    torch.cuda.synchronize()
    assert {**C.launch_counts(), **CC.launch_counts()} == {
        "site_stats": 0, "clonR": 1, "select_rows": 1, "mm_aggregates": 1,
        "masked_median": 1}
    pclonR = S.clonR_values_seg(full["cum"], full["total"],
                                full["clonR_set"], seg, 50, Mp)
    prows, plink = S.select_rows_seg(full, seg)
    pagg, pclon_f, pclonR_f = S.mm_aggregates_seg(full, seg)
    pmed = S.masked_medians_seg(full["total"], pclon_f, pclonR_f,
                                pagg["counted"], pagg["rarefied"], seg)
    for want, got in ((dict(c=pclonR), dict(c=clonR)), (prows, rows),
                      (plink, link), (pagg, agg), (pmed, med),
                      (dict(f=pclon_f, r=pclonR_f),
                       dict(f=clon_f, r=clonR_f))):
        assert set(want) == set(got)
        for k in want:
            if isinstance(want[k], int):
                assert want[k] == got[k], k
            else:
                _bits_equal(want[k].cpu().numpy(), got[k].cpu(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(G.CHUNKS))
def test_batch_kernels_match_golden_on_gpu(name, cuda_device):
    g = _golden()
    for s, (M, st) in enumerate(golden_chunk(g, name, cuda_device)):
        want = {grp: {} for grp in ("rows", "agg", "linkage", "masks")}
        for k, v in g.items():
            parts = k.split("/")
            if parts[:2] == [name, str(s)] and parts[2] in want:
                want[parts[2]][parts[3]] = v
        assert_stats_equal(want, st, (name, s), M=M)
