"""
The genes' per-range sums (profile/genes.py:gene_range_sums, one native
pass per scaffold, csrc/host/gene_ranges.cc) on random stats: coverage and
breadth byte for byte against the JAX package's calc_gene_coverage;
nucl_diversity and breadth_minCov byte for byte against float64 prefix
sums over the whole [M, L] scaffold (prefix_clonality below; the JAX
package's in-profile clonality sums in float32, so it cannot be the
oracle). Also the library's build: the pass lives in the decoder's
library, built with g++, and its hashed name follows the new source.
"""

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.profile import genes as JG
from instrain_tpu_torch import build
from instrain_tpu_torch.profile import genes as PG
from instrain_tpu_torch.profile.tables import _ffill_along_mm


def prefix_clonality(gdb, stats):
    """The float64 prefix arithmetic the pass replaced: forward-filled
    clonality over [M, L], its cumsum along positions from the scaffold's
    start, differenced at gene ends."""
    L = stats.pileup.length
    starts = gdb["start"].values.astype(int)
    ends = np.minimum(gdb["end"].values.astype(int), L - 1)
    lens = np.abs(gdb["end"].values - gdb["start"].values) + 1
    clon_f, clon_has, _ = _ffill_along_mm(stats.clon, ~np.isnan(stats.clon))
    vals = np.where(clon_has, clon_f, 0.0).astype(np.float64)
    vsum = np.concatenate([np.zeros((vals.shape[0], 1)),
                           np.cumsum(vals, axis=1)], axis=1)
    hsum = np.concatenate([np.zeros((vals.shape[0], 1)),
                           np.cumsum(clon_has, axis=1)], axis=1)
    table = {"gene": [], "nucl_diversity": [], "breadth_minCov": [],
             "mm": []}
    for mi, mm in enumerate(stats.mm_values):
        if not clon_has[mi].any():
            continue
        v = vsum[mi, ends + 1] - vsum[mi, starts]
        h = hsum[mi, ends + 1] - hsum[mi, starts]
        micro = np.full(len(h), np.nan)
        micro[h > 0] = 1 - (v[h > 0] / h[h > 0])
        table["gene"].extend(gdb["gene"].tolist())
        table["nucl_diversity"].extend(micro.tolist())
        table["breadth_minCov"].extend((h / lens).tolist())
        table["mm"].extend([int(mm)] * len(h))
    return pd.DataFrame(table) if table["gene"] else pd.DataFrame()


def _stats(M, L, seed, total_kind="int64", empty_levels=0, no_clon_levels=0,
           all_nan=False):
    """Random counts [M, 4, L] with `empty_levels` leading levels that
    count nothing, total their cumulative coverage (int64, or int32 as a
    view of rows of stride Lp > L, as io.bam.clon_cum16 gives it), clon
    float32 with NaN where a level's coverage is low, and no value at
    all in the `no_clon_levels` leading levels (or anywhere)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, size=(M, 4, L)).astype(np.int32)
    counts *= rng.random((M, 1, L)) < 0.6          # uncovered positions
    counts[:empty_levels] = 0
    total = np.cumsum(counts.sum(axis=1, dtype=np.int64), axis=0)
    if total_kind == "int32":
        Lp = L + 37
        buf = np.full((M, Lp), -7, dtype=np.int32)  # junk past L
        buf[:, :L] = total
        total = buf[:, :L]
    clon = rng.uniform(0.25, 1.0, size=(M, L)).astype(np.float32)
    clon[rng.random((M, L)) < 0.7] = np.nan
    clon[:max(no_clon_levels, empty_levels)] = np.nan
    if all_nan:
        clon[:] = np.nan
    pileup = SimpleNamespace(length=L, counts_exact=counts)
    mm = np.sort(rng.choice(np.arange(40), size=M, replace=False))
    return SimpleNamespace(pileup=pileup, total=total, clon=clon,
                           mm_values=mm.astype(np.int64))


def _genes(L, seed):
    """Random genes plus the edge cases: a gene at position 0, one ending
    at L - 1, one running past L, a 1 bp gene and two that overlap."""
    rng = np.random.default_rng(seed + 1)
    starts = list(rng.integers(0, L - 1, size=12))
    ends = [min(s + int(rng.integers(0, 400)), L - 1) for s in starts]
    starts += [0, L - 90, L - 50, 17, 100, 150]
    ends += [60, L - 1, L + 200, 17, 300, 260]
    return pd.DataFrame({"gene": [f"g_{i}" for i in range(len(starts))],
                         "start": starts, "end": ends})


def _assert_bytes_equal(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    for c in got.columns:
        if got[c].dtype == np.float64:
            assert np.array_equal(got[c].to_numpy().view(np.uint64),
                                  want[c].to_numpy().view(np.uint64)), c


CASES = {
    "int64": dict(M=9, L=3000),
    "int32_strided": dict(M=9, L=3000, total_kind="int32"),
    "empty_levels": dict(M=7, L=2500, empty_levels=2),
    "no_clon_levels": dict(M=7, L=2500, total_kind="int32",
                           no_clon_levels=3),
    "all_nan_clon": dict(M=5, L=1200, all_nan=True),
    "one_level": dict(M=1, L=900),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_gene_range_sums_match_oracles(case, seed):
    kw = CASES[case]
    stats = _stats(seed=seed % 1000 + len(case), **kw)
    gdb = _genes(kw["L"], seed % 1000)
    sums = PG.gene_range_sums(gdb, stats)
    _assert_bytes_equal(PG.calc_gene_coverage(sums),
                        JG.calc_gene_coverage(gdb, stats))
    _assert_bytes_equal(PG.calc_gene_clonality(sums),
                        prefix_clonality(gdb, stats))
    if kw.get("all_nan"):
        assert PG.calc_gene_clonality(sums).empty
    skipped = max(kw.get("empty_levels", 0), kw.get("no_clon_levels", 0))
    if skipped:
        got = PG.calc_gene_clonality(sums)
        assert sorted(set(got["mm"])) == list(stats.mm_values[skipped:])


def test_gene_range_sums_reads_total_in_place():
    """An int32 total of row stride Lp is read where it lies: the junk
    past L never enters a sum, and no copy is made (a transposed view,
    column stride != 1, gives the same sums)."""
    stats = _stats(M=4, L=1000, seed=3, total_kind="int32")
    gdb = _genes(1000, 3)
    want = PG.gene_range_sums(gdb, stats)
    t = np.ascontiguousarray(stats.total.T).T       # strides (4, 4 * M)
    c = np.ascontiguousarray(stats.clon.T).T
    got = PG.gene_range_sums(gdb, SimpleNamespace(
        pileup=stats.pileup, total=t, clon=c, mm_values=stats.mm_values))
    for k in ("coverage", "breadth", "clon_n", "clon_sum"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k


def test_gene_range_sums_bounds_as_numpy_reads_them():
    """A start past the scaffold raises numpy's IndexError, as the prefix
    sums' indexing did (the pipeline logs it as a GeneException); a
    dtype the pass does not read raises TypeError."""
    stats = _stats(M=3, L=500, seed=4)
    bad = pd.DataFrame({"gene": ["x", "y"], "start": [10, 600],
                        "end": [20, 700]})
    csum = np.zeros((3, 501))
    with pytest.raises(IndexError) as want:
        csum[0, bad["start"].values]
    with pytest.raises(IndexError) as got:
        PG.gene_range_sums(bad, stats)
    assert str(got.value) == str(want.value)
    stats.clon = stats.clon.astype(np.float64)
    with pytest.raises(TypeError):
        PG.gene_range_sums(_genes(500, 4), stats)


def test_host_source_builds_into_decoder_library(tmp_path):
    """The decoder's library holds the pass, built with g++ on a host
    without a GPU, and its hashed name changes with the new source."""
    name, sources, headers, stages = build._native_io_spec()
    src = [s for s in sources if s.endswith("gene_ranges.cc")]
    assert len(src) == 1 and src[0].startswith(build.CSRC_DIR)
    assert stages("OUT")[0][0][0] == os.environ.get("CXX", "g++")
    path = build.native_io_library()
    assert os.path.exists(path)
    from instrain_tpu_torch.io import bam
    assert bam.load_native(path).gr_range_sums
    edited = tmp_path / "gene_ranges.cc"
    shutil.copy(src[0], edited)
    with open(edited, "a") as f:
        f.write("// edited\n")
    other = [str(edited) if s == src[0] else s for s in sources]
    assert build.library_path(name, other, headers, stages) != \
        build.library_path(name, sources, headers, stages)
