"""
Windowed per-genome metrics for plots 2 and 7 — the counterpart of
instrain_tpu/plotting/windowed.py (host numpy and pandas).

Semantics match the reference's loader (positional_plots.py:185-508):
for each genome the scaffolds are concatenated longest-first, split into
~100 windows, and each of four metrics (linkage r2, SNV density,
coverage, nucleotide diversity) is averaged per window at two read-ANI
levels (0% -> all reads, 100% -> mm 0). The reference builds windows by
slicing pandas Series per chunk; here each metric is one numpy bincount
pass over (position, value) arrays.

One reference quirk is preserved on purpose: its chunk slices are
`.loc[start:end]` which is INCLUSIVE of `end`, so a value sitting
exactly on a window boundary is counted in both neighbouring windows
(positional_plots.py:496-508). We replicate that with an extra bincount
of the boundary positions so the curves match point-for-point.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import pandas as pd


def mm_for_ani(read_length: float, ani: float) -> int:
    """ANI level (percent or fraction) -> mismatch level
    (reference: positional_plots.py:287-298 _get_mm)."""
    if ani > 1:
        ani = ani / 100.0
    return int(round(read_length - read_length * ani))


def _window_edges(length: int, window_len: int):
    """Window starts/ends: n = L//w + 1 chunks, the last truncated to the
    scaffold end and dropped when empty (reference
    positional_plots.py:444-473 _gen_windowed_cov)."""
    n = length // window_len + 1
    starts = np.arange(n, dtype=np.int64) * window_len
    ends = np.minimum(starts + window_len, length)
    keep = ends > starts
    return starts[keep], ends[keep]


def _windowed(pos: np.ndarray, val: Optional[np.ndarray], length: int,
              window_len: int, mode: str) -> pd.DataFrame:
    """One metric's windows for one scaffold.

    mode: 'sum_per_len' (coverage: window sum / window length),
    'mean' (mean of present values; NaN when none), or
    'count_per_len' (number of present positions / window length).
    """
    starts, ends = _window_edges(length, window_len)
    n = len(starts)
    if n == 0:
        return pd.DataFrame({"start": [], "end": [], "value": []})
    widx = np.minimum(pos // window_len, n - 1)
    # the reference's inclusive .loc[start:end] slice double-counts exact
    # boundary positions into the preceding window too
    bmask = (pos % window_len == 0) & (pos > 0) & (pos // window_len <= n - 1)
    bidx = pos[bmask] // window_len - 1
    ones = np.ones(len(pos))
    cnt = (np.bincount(widx, minlength=n) +
           np.bincount(bidx, minlength=n))
    if mode == "count_per_len":
        value = cnt / (ends - starts)
    else:
        w = np.asarray(val, dtype=np.float64)
        nanmask = np.isnan(w)
        wz = np.where(nanmask, 0.0, w)
        sums = (np.bincount(widx, weights=wz, minlength=n) +
                np.bincount(bidx, weights=wz[bmask], minlength=n))
        if mode == "sum_per_len":
            value = sums / (ends - starts)
        else:  # mean of non-NaN present values
            good = (~nanmask).astype(np.float64)
            ngood = (np.bincount(widx, weights=good, minlength=n) +
                     np.bincount(bidx, weights=good[bmask], minlength=n))
            with np.errstate(invalid="ignore", divide="ignore"):
                value = np.where(ngood > 0, sums / np.maximum(ngood, 1),
                                 np.nan)
    return pd.DataFrame({"start": starts, "end": ends, "value": value})


def _cov_upto(mm2series: Dict[int, pd.Series], mm: int):
    """Counts summed over all levels <= mm (reference
    profile_utilities.mm_counts_to_counts_shrunk)."""
    pos_parts, val_parts = [], []
    for m in sorted(mm2series):
        if int(m) > int(mm):
            continue
        s = mm2series[m]
        pos_parts.append(s.index.values.astype(np.int64))
        val_parts.append(s.values.astype(np.float64))
    if not pos_parts:
        return None, None
    pos = np.concatenate(pos_parts)
    val = np.concatenate(val_parts)
    order = np.argsort(pos, kind="stable")
    pos, val = pos[order], val[order]
    upos, inv = np.unique(pos, return_inverse=True)
    return upos, np.bincount(inv, weights=val)


def _clon_upto(mm2series: Dict[int, pd.Series], mm: int):
    """Per-position clonality, higher mm levels overriding lower
    (reference: positional_plots.py:475-494 _get_basewise_clons3)."""
    pos_parts, val_parts = [], []
    for m in sorted(mm2series):
        if int(m) > int(mm):
            continue
        s = mm2series[m]
        pos_parts.append(s.index.values.astype(np.int64))
        val_parts.append(s.values.astype(np.float64))
    if not pos_parts:
        return None, None
    pos = np.concatenate(pos_parts)
    val = np.concatenate(val_parts)
    # keep the LAST occurrence per position (highest mm wins)
    upos, last = np.unique(pos[::-1], return_index=True)
    return upos, val[::-1][last]


def load_windowed_metrics(scaffolds: Iterable[str],
                          s2l: Dict[str, int],
                          read_length: float,
                          covTs=None, clonTs=None,
                          raw_linkage_table: Optional[pd.DataFrame] = None,
                          cumulative_snv_table: Optional[pd.DataFrame] = None,
                          ani_levels=(0, 100),
                          window_len: Optional[int] = None,
                          metrics: Optional[List[str]] = None):
    """Windowed metric table for one genome's scaffolds.

    Returns (Wdb, breaks, midpoints): Wdb has columns [scaffold, mm, ANI,
    adjusted_start, adjusted_end, value, metric, midpoint]; breaks are
    cumulative scaffold ends; midpoints maps scaffold -> its center on
    the concatenated axis (reference: positional_plots.py:185-285).
    """
    if metrics is None:
        metrics = ["coverage", "nucl_diversity", "linkage", "snp_density"]
    mms = [mm_for_ani(read_length, a) for a in ani_levels]
    scaffolds = sorted(scaffolds, key=lambda s: s2l[s], reverse=True)
    if window_len is None:
        window_len = int(sum(s2l[s] for s in scaffolds) / 100)
    window_len = max(int(window_len), 1)

    breaks, midpoints = [], {}
    tally = 0
    for s in scaffolds:
        midpoints[s] = tally + int(s2l[s] / 2)
        tally += s2l[s]
        breaks.append(tally)

    ldb_all = sdb_all = None
    if raw_linkage_table is not None and len(raw_linkage_table):
        ldb_all = raw_linkage_table[
            raw_linkage_table["scaffold"].isin(set(scaffolds))
        ].sort_values("mm")
    if cumulative_snv_table is not None and len(cumulative_snv_table):
        sdb_all = cumulative_snv_table[
            cumulative_snv_table["scaffold"].isin(set(scaffolds))
        ].sort_values("mm")

    rows = []

    def emit(db, scaffold, mm, ani, offset, metric):
        if db is None or len(db) == 0:
            return
        db = db.copy()
        db["scaffold"] = scaffold
        db["mm"] = mm
        db["ANI"] = ani
        db["adjusted_start"] = db["start"] + offset
        db["adjusted_end"] = db["end"] + offset
        db["metric"] = metric
        rows.append(db[["scaffold", "mm", "ANI", "adjusted_start",
                        "adjusted_end", "value", "metric"]])

    tally = 0
    for scaffold in scaffolds:
        L = int(s2l[scaffold])
        for mm, ani in zip(mms, ani_levels):
            if "coverage" in metrics and covTs and scaffold in covTs:
                pos, val = _cov_upto(covTs[scaffold], mm)
                if pos is not None:
                    emit(_windowed(pos, val, L, window_len, "sum_per_len"),
                         scaffold, mm, ani, tally, "coverage")
            if ("nucl_diversity" in metrics and clonTs and
                    scaffold in clonTs):
                pos, val = _clon_upto(clonTs[scaffold], mm)
                if pos is not None:
                    db = _windowed(pos, 1.0 - val, L, window_len, "mean")
                    emit(db, scaffold, mm, ani, tally, "nucl_diversity")
            # unlike coverage/clonality, the reference emits linkage and
            # snp_density windows even when the mm-filtered selection is
            # empty (NaN / flat-zero lines at the strict ANI level;
            # positional_plots.py:360-442) — only scaffolds absent from
            # the table entirely are skipped
            if "linkage" in metrics and ldb_all is not None:
                ldb = ldb_all[ldb_all["scaffold"] == scaffold]
                if len(ldb):
                    db = (ldb[ldb["mm"] <= int(mm)]
                          .drop_duplicates(
                              subset=["scaffold", "position_A",
                                      "position_B"], keep="last"))
                    pos = db["position_A"].values.astype(np.int64)
                    order = np.argsort(pos, kind="stable")
                    emit(_windowed(pos[order],
                                   db["r2"].values[order], L,
                                   window_len, "mean"),
                         scaffold, mm, ani, tally, "linkage")
            if "snp_density" in metrics and sdb_all is not None:
                sdb = sdb_all[sdb_all["scaffold"] == scaffold]
                if len(sdb):
                    db = (sdb[sdb["mm"] <= int(mm)]
                          .drop_duplicates(subset=["scaffold", "position"],
                                           keep="last"))
                    pos = np.sort(db["position"].values.astype(np.int64))
                    emit(_windowed(pos, None, L, window_len,
                                   "count_per_len"),
                         scaffold, mm, ani, tally, "snp_density")
        tally += L

    if rows:
        Wdb = pd.concat(rows, ignore_index=True)
    else:
        Wdb = pd.DataFrame(columns=["scaffold", "mm", "ANI",
                                    "adjusted_start", "adjusted_end",
                                    "value", "metric"])
    # NaN rows at every break so lines don't bridge scaffold boundaries
    # (reference: positional_plots.py:264-277)
    brows = []
    for mm, ani in zip(mms, ani_levels):
        for metric in Wdb["metric"].unique():
            for b in breaks:
                brows.append(("break", mm, ani, b, b, np.nan, metric))
    if brows:
        Wdb = pd.concat([Wdb, pd.DataFrame(
            brows, columns=Wdb.columns)], ignore_index=True)
    if len(Wdb):
        Wdb["midpoint"] = (Wdb["adjusted_start"] + Wdb["adjusted_end"]) / 2.0
        Wdb = Wdb.sort_values(["metric", "mm", "midpoint", "scaffold"])
    return Wdb, breaks, midpoints
