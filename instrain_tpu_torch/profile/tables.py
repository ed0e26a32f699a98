"""
Table builders: dense kernel outputs -> the reference's table schemas
(the counterpart of instrain_tpu/profile/tables.py; host numpy/pandas).

Produces, per scaffold:
  - raw SNP table rows (reference: snv_utilities.generate_snp_table,
    274-290; row order = position-major, mm ascending within position)
  - cumulative SNV table (adds var/con/ref frequencies,
    profile_utilities._parse_Sdb, 598-612)
  - cumulative scaffold table (profile_utilities.make_coverage_table,
    425-506) with per-mm coverage/breadth/diversity/ANI metrics
  - sparse covT/clonT/clonTR views matching the reference's storage model
    (mm -> pandas Series indexed by position)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..kernels.sitestats import CLASS_NAMES
from .pileup import ScaffoldStats

BASES = np.array(list("ACTGN"))


def snp_table(stats: ScaffoldStats, ref_codes: np.ndarray) -> pd.DataFrame:
    """raw_snp_table rows for one scaffold."""
    row = stats.row                       # [M, L]
    if not row.any():
        return pd.DataFrame()
    pos_idx, m_idx = np.nonzero(row.T)    # position-major ordering
    cum = stats.cum                       # [M, 4, L]
    mm_vals = stats.mm_values

    table = {
        "scaffold": stats.pileup.name,
        "position": pos_idx.astype(np.int64),
        "ref_base": BASES[np.minimum(ref_codes[pos_idx], 4)],
        "A": cum[m_idx, 0, pos_idx].astype(np.int64),
        "C": cum[m_idx, 1, pos_idx].astype(np.int64),
        "T": cum[m_idx, 2, pos_idx].astype(np.int64),
        "G": cum[m_idx, 3, pos_idx].astype(np.int64),
        "con_base": BASES[stats.con[m_idx, pos_idx]],
        "var_base": BASES[stats.var[m_idx, pos_idx]],
        "mm": mm_vals[m_idx].astype(np.int64),
        "allele_count": stats.morphia[m_idx, pos_idx].astype(np.int64),
        "class": np.array(CLASS_NAMES)[stats.cls[m_idx, pos_idx]],
        "cryptic": stats.cryptic[pos_idx].astype(bool),
        "position_coverage": stats.total[m_idx, pos_idx].astype(np.int64),
    }
    return pd.DataFrame(table)


def cumulative_snv_table(snp_df: pd.DataFrame) -> pd.DataFrame:
    """Add var_freq/con_freq/ref_freq (reference: _parse_Sdb)."""
    if len(snp_df) == 0:
        return pd.DataFrame()
    db = snp_df.copy()
    counts = db[["A", "C", "T", "G"]].values
    base_idx = {b: i for i, b in enumerate("ACTG")}
    pc = db["position_coverage"].values.astype(np.float64)
    var_i = db["var_base"].map(base_idx).values
    con_i = db["con_base"].map(base_idx).values
    rows = np.arange(len(db))
    db["var_freq"] = counts[rows, var_i] / pc
    db["con_freq"] = counts[rows, con_i] / pc
    ref_i = db["ref_base"].map(base_idx)
    ref_freq = np.full(len(db), np.nan)
    ok = ref_i.notna().values
    ref_freq[ok] = counts[rows[ok], ref_i[ok].astype(int)] / pc[ok]
    db["ref_freq"] = ref_freq
    return db


def _ffill_along_mm(arr: np.ndarray, set_mask: np.ndarray):
    """
    Forward-fill values down the mm axis: out[m, p] = value at the highest
    mm' <= m where set (NaN if none). Returns (filled, has_value).
    """
    M, L = arr.shape
    idx = np.where(set_mask, np.arange(M)[:, None], -1)
    idx = np.maximum.accumulate(idx, axis=0)
    has = idx >= 0
    cols = np.broadcast_to(np.arange(L), (M, L))
    filled = np.where(has, arr[np.maximum(idx, 0), cols], np.nan)
    return filled, has, idx


def _masked_row_mean_median(vals: np.ndarray, has: np.ndarray,
                            n: np.ndarray):
    """Row-wise nanmean/nanmedian of `vals` restricted to `has`, with an
    explicit empty-row guard: rows with n == 0 get NaN WITHOUT np
    emitting `Mean of empty slice` / `All-NaN slice` RuntimeWarnings
    (empty rows feed 0.0 into the reductions instead of all-NaN)."""
    masked = np.where(has, vals, np.nan)
    safe = np.where(n[:, None] > 0, masked, 0.0)
    mean = np.where(n > 0, np.nanmean(safe, axis=1), np.nan)
    med = np.where(n > 0, np.nanmedian(safe, axis=1), np.nan)
    return mean, med


def coverage_table(stats: ScaffoldStats, snp_df: Optional[pd.DataFrame] = None
                   ) -> pd.DataFrame:
    """
    Per-mm scaffold summary (reference: make_coverage_table). The mm column
    holds actual mismatch values; one row per mm level observed on the
    scaffold, metrics cumulative over mm' <= mm.
    """
    s = stats
    L = s.pileup.length
    M = len(s.mm_values)
    name = s.pileup.name

    total = s.total.astype(np.float64)               # [M, L] cumulative cov
    clon_f, clon_has, _ = _ffill_along_mm(s.clon, ~np.isnan(s.clon))
    clonR_f, clonR_has, _ = _ffill_along_mm(s.clonR, ~np.isnan(s.clonR))

    # last emitted SNP row per (mm, position)
    row = s.row
    _, have_row, last_idx = _ffill_along_mm(
        np.zeros_like(row, dtype=np.float64), row)
    cols = np.broadcast_to(np.arange(L), (M, L))
    gather = np.maximum(last_idx, 0)
    mor_at = np.where(have_row, s.morphia[gather, cols], -1)
    cls_at = np.where(have_row, s.cls[gather, cols], -1)

    con_classes = np.isin(cls_at, [0, 2, 3])   # SNS, con_SNV, pop_SNV
    pop_classes = np.isin(cls_at, [0, 3])      # SNS, pop_SNV

    out = {}
    out["scaffold"] = [name] * M
    out["length"] = [L] * M
    nonzeros = (total > 0).sum(axis=1)
    out["breadth"] = nonzeros / L
    out["coverage"] = total.mean(axis=1)
    out["coverage_median"] = np.median(total, axis=1).astype(int)
    out["coverage_std"] = total.std(axis=1)
    with np.errstate(invalid="ignore"):
        out["coverage_SEM"] = total.std(axis=1, ddof=1) / np.sqrt(L)

    counted = clon_has.sum(axis=1)
    mean_c, med_c = _masked_row_mean_median(clon_f, clon_has, counted)
    out["nucl_diversity"] = 1 - mean_c
    out["nucl_diversity_median"] = np.where(counted > 0, 1 - med_c, np.nan)

    rarefied = clonR_has.sum(axis=1)
    mean_r, med_r = _masked_row_mean_median(clonR_f, clonR_has, rarefied)
    out["nucl_diversity_rarefied"] = 1 - mean_r
    out["nucl_diversity_rarefied_median"] = np.where(
        rarefied > 0, 1 - med_r, np.nan)

    out["breadth_minCov"] = counted / L
    out["breadth_rarefied"] = rarefied / L
    out["breadth_expected"] = estimate_breadth(out["coverage"])

    out["divergent_site_count"] = have_row.sum(axis=1)
    out["SNS_count"] = (mor_at == 1).sum(axis=1)
    out["SNV_count"] = (mor_at > 1).sum(axis=1)
    con_snps = con_classes.sum(axis=1)
    pop_snps = pop_classes.sum(axis=1)
    out["consensus_divergent_sites"] = con_snps
    out["population_divergent_sites"] = pop_snps
    with np.errstate(invalid="ignore", divide="ignore"):
        out["conANI_reference"] = np.where(
            counted > 0, (counted - con_snps) / np.maximum(counted, 1), 0)
        out["popANI_reference"] = np.where(
            counted > 0, (counted - pop_snps) / np.maximum(counted, 1), 0)
    out["mm"] = s.mm_values.astype(np.int64)

    return pd.DataFrame(out)


def estimate_breadth(coverage):
    """breadth = 1 - e^(-0.883 * coverage) (profile_utilities.py:548-555)."""
    return (-1) * np.exp(-1 * (0.883 * np.asarray(coverage))) + 1


def covT_view(stats: ScaffoldStats) -> Dict[int, pd.Series]:
    """mm -> Series of exact-mm coverage at present positions (int32)."""
    out = {}
    exact = stats.pileup.counts_exact.sum(axis=1)  # [M, L]
    for i, mm in enumerate(stats.mm_values):
        pos = np.nonzero(exact[i] > 0)[0]
        out[int(mm)] = pd.Series(exact[i, pos].astype("int32"), index=pos)
    return out


def clonT_view(stats: ScaffoldStats, rarefied: bool = False
               ) -> Dict[int, pd.Series]:
    """mm -> Series of clonality at set positions (float32)."""
    arr = stats.clonR if rarefied else stats.clon
    out = {}
    for i, mm in enumerate(stats.mm_values):
        vals = arr[i]
        pos = np.nonzero(~np.isnan(vals))[0]
        out[int(mm)] = pd.Series(vals[pos].astype("float32"), index=pos)
    return out
