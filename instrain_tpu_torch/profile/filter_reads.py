"""
Read-pair filtering: vectorized reimplementation of the reference's
filter_reads module (inStrain/filter_reads.py); the counterpart of
instrain_tpu/profile/filter_reads.py (single-process path).

Pipeline (reference: load_paired_reads, filter_reads.py:157-199):
  1. pair_info_from_records — per-(scaffold, qname) pair info merging
     (get_paired_reads, filter_reads.py:885-955): NM summed, lengths summed,
     mapq max, insert = far-end distance once exactly 2 reads are seen.
  2. pairing filter — paired_only / non_discordant / all_reads
     (paired_read_filter, filter_reads.py:471-532).
  3. evaluate_pair as a vectorized mask over the v2o filter set
     (evaluate_pair, filter_reads.py:387-426): PID > min_read_ani,
     mapq > min_mapq, min_insert < insert < max_insert where
     max_insert = median(pair inserts) * max_insert_relative.
  4. mapping_info report table with the reference's exact column order
     (filter_scaff2pair2info, filter_reads.py:201-300).

The output PairSet holds flat arrays (scaffold id, qname id, mm) — the
native layout consumed by the pileup kernels — plus dict views matching the
reference's Rdic contract.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np
import pandas as pd

from ..config import ReadFilterConfig
from ..io.bam import BamArrays


@dataclass
class PairInfo:
    """Per-(scaffold, qname) merged pair info, flat arrays."""

    ref_id: np.ndarray       # int32 per pair entry
    qname_id: np.ndarray     # int64
    nm: np.ndarray           # int64 summed
    insert: np.ndarray       # int64 (-1 unless exactly 2 reads)
    mapq: np.ndarray         # int64 max
    length: np.ndarray       # int64 summed inferred length
    reads: np.ndarray        # int64 count

    def __len__(self):
        return len(self.qname_id)


def pair_info_from_records(bam: BamArrays) -> PairInfo:
    """
    Merge records into per-(scaffold, qname) pair entries, preserving the
    reference's first-seen/second-seen insert semantics.
    """
    n = bam.n_records
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return PairInfo(z.astype(np.int32), z, z, z, z, z, z)

    # stable sort by (ref, qname); stability keeps file (coordinate) order
    order = np.lexsort((np.arange(n), bam.qname_id, bam.ref_id))
    rid = bam.ref_id[order].astype(np.int64)
    qid = bam.qname_id[order]
    key_change = np.empty(n, dtype=bool)
    key_change[0] = True
    key_change[1:] = (rid[1:] != rid[:-1]) | (qid[1:] != qid[:-1])
    group_start = np.nonzero(key_change)[0]
    group_id = np.cumsum(key_change) - 1
    n_groups = len(group_start)
    counts = np.diff(np.append(group_start, n))

    nm = np.zeros(n_groups, dtype=np.int64)
    np.add.at(nm, group_id, bam.nm[order].astype(np.int64))
    length = np.zeros(n_groups, dtype=np.int64)
    np.add.at(length, group_id, bam.qlen_infer[order].astype(np.int64))
    mapq = np.zeros(n_groups, dtype=np.int64)
    np.maximum.at(mapq, group_id, bam.mapq[order].astype(np.int64))

    # insert: only when exactly 2 records; first = group_start,
    # second = group_start + 1 (coordinate order)
    insert = np.full(n_groups, -1, dtype=np.int64)
    two = counts == 2
    g2 = np.nonzero(two)[0]
    if len(g2):
        first = order[group_start[g2]]
        second = order[group_start[g2] + 1]
        f_start = bam.ref_start[first].astype(np.int64)
        f_stop = bam.ref_end[first].astype(np.int64)
        s_start = bam.ref_start[second].astype(np.int64)
        s_stop = bam.ref_end[second].astype(np.int64)
        # reference: if second.ref_end > first.ref_start:
        #   insert = second.ref_end - first.ref_start
        # else: insert = first.ref_end - second.ref_start
        # (filter_reads.py:940-944)
        insert[g2] = np.where(s_stop > f_start, s_stop - f_start,
                              f_stop - s_start)

    return PairInfo(
        ref_id=rid[group_start].astype(np.int32),
        qname_id=qid[group_start],
        nm=nm, insert=insert, mapq=mapq, length=length,
        reads=counts.astype(np.int64),
    )


@dataclass
class PairSet:
    """Filtered pairs: the framework's Rdic equivalent."""

    info: PairInfo                 # post-pairing-filter entries
    passed: np.ndarray             # bool mask over info entries
    mm: np.ndarray                 # int64 = nm (mismatches) per entry
    mapping_info: pd.DataFrame     # the reference-format report table
    filter_values: Dict[str, object]
    ref_names: List[str]
    qnames: Optional[List[str]] = None

    def scaffold_mask(self, rid: int) -> np.ndarray:
        return (self.info.ref_id == rid) & self.passed

    def _rid_slice(self, rid: int):
        """Entries of scaffold `rid` as a slice (the pair arrays are
        rid-sorted by construction; None when a future path breaks
        that and callers must fall back to masks)."""
        cache = getattr(self, "_rid_sorted", None)
        if cache is None:
            cache = bool(np.all(np.diff(self.info.ref_id) >= 0))
            self._rid_sorted = cache
        if not cache:
            return None
        lo, hi = np.searchsorted(self.info.ref_id, [rid, rid + 1])
        return slice(lo, hi)

    def r2m_for_scaffold(self, rid: int):
        """(qname_id, mm) arrays of passing pairs on scaffold rid.
        Slice-based on the rid-sorted arrays — a full-array boolean
        mask per scaffold cost O(n_scaffolds * n_pairs) at metagenome
        scale."""
        sl = self._rid_slice(rid)
        if sl is None:
            m = self.scaffold_mask(rid)
            return self.info.qname_id[m], self.mm[m]
        p = self.passed[sl]
        return self.info.qname_id[sl][p], self.mm[sl][p]

    def rdic(self, skip_mm: bool = False) -> Dict[str, object]:
        """Dict view: scaffold -> {qname: mm} (or set, reference
        controller.py:274-281 when skip_mm_profiling)."""
        if self.qnames is None:
            raise ValueError("Rdic needs the decoded read names")
        out = {}
        for rid, name in enumerate(self.ref_names):
            qids, mms = self.r2m_for_scaffold(rid)
            if skip_mm:
                out[name] = {self.qnames[q] for q in qids}
            else:
                out[name] = {self.qnames[q]: int(m)
                             for q, m in zip(qids, mms)}
        return out

    @property
    def scaffold2pairs(self) -> Dict[str, int]:
        df = self.mapping_info
        return df.set_index("scaffold")["filtered_pairs"].to_dict()

    @property
    def mean_pair_length(self) -> float:
        return float(self.mapping_info["mean_pair_length"].iloc[0])


def detailed_mapping_info(info: PairInfo, passed: np.ndarray,
                          ref_names: List[str],
                          qnames: List[str]) -> pd.DataFrame:
    """Per-read-pair detail table (reference: make_detailed_mapping_info,
    filter_reads.py:544-570, version=2 layout)."""
    return pd.DataFrame({
        "read_pair": [qnames[q] for q in info.qname_id],
        "scaffold": [ref_names[r] for r in info.ref_id],
        "pass_filters": passed.astype(bool),
        "mm": info.nm,
        "insert_dist": info.insert,
        "mapq": info.mapq,
        "length": info.length,
        "reads": info.reads,
    })


def load_priority_reads(path: Optional[str]) -> Set[str]:
    """reference: filter_reads.py:428-469."""
    if path is None:
        return set()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()
    if lines and lines[0].startswith("@"):
        return {l[1:].strip() for l in lines if l.startswith("@")}
    return {l.strip() for l in lines if l.strip()}


def apply_pairing_filter(info: PairInfo, mode: str,
                         priority_ids: np.ndarray) -> PairInfo:
    """
    reference: paired_read_filter (filter_reads.py:471-532).

    priority_ids: sorted int64 array of qname_ids exempt from pairing.
    """
    is_priority = np.isin(info.qname_id, priority_ids)
    if mode == "paired_only":
        keep = (info.reads == 2) | is_priority
        return _subset(info, keep)
    if mode == "non_discordant":
        # keep entries whose qname maps to a single scaffold (or priority)
        _, first_idx, counts = np.unique(info.qname_id, return_index=True,
                                         return_counts=True)
        multi = np.zeros(len(info), dtype=bool)
        multi_q = np.unique(info.qname_id)[counts > 1]
        multi = np.isin(info.qname_id, multi_q)
        keep = (~multi) | is_priority
        return _subset(info, keep)
    if mode == "all_reads":
        # merge entries of the same qname across scaffolds: nm/len/reads
        # summed, mapq of FIRST entry (reference _merge_info bug:
        # max([i1[2] + i2[2]]) = i1.mapq + i2.mapq ... actually sums),
        # insert = -2 (filter_reads.py:534-542). The merged info is shared
        # by every scaffold entry of that qname.
        uq, inv, counts = np.unique(info.qname_id, return_inverse=True,
                                    return_counts=True)
        nm = np.zeros(len(uq), dtype=np.int64)
        np.add.at(nm, inv, info.nm)
        length = np.zeros(len(uq), dtype=np.int64)
        np.add.at(length, inv, info.length)
        reads = np.zeros(len(uq), dtype=np.int64)
        np.add.at(reads, inv, info.reads)
        mapq = np.zeros(len(uq), dtype=np.int64)
        np.add.at(mapq, inv, info.mapq)  # reference sums via its max() bug
        merged = counts > 1
        out = PairInfo(info.ref_id.copy(), info.qname_id.copy(),
                       info.nm.copy(), info.insert.copy(), info.mapq.copy(),
                       info.length.copy(), info.reads.copy())
        m = merged[inv]
        out.nm[m] = nm[inv][m]
        out.length[m] = length[inv][m]
        out.reads[m] = reads[inv][m]
        out.mapq[m] = mapq[inv][m]
        out.insert[m] = -2
        return out
    raise ValueError(f"unknown pairing_filter {mode}")


def _subset(info: PairInfo, mask: np.ndarray) -> PairInfo:
    return PairInfo(*[getattr(info, f)[mask] for f in
                      ("ref_id", "qname_id", "nm", "insert", "mapq",
                       "length", "reads")])


def evaluate_pairs(info: PairInfo, cfg: ReadFilterConfig,
                   max_insert: float) -> np.ndarray:
    """
    Vectorized evaluate_pair (reference: filter_reads.py:387-426).
    Returns bool [n_pairs, 4] in v2o order
    (min_read_ani, max_insert, min_insert, min_mapq).
    """
    n = len(info)
    res = np.zeros((n, 4), dtype=bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        pid = 1.0 - info.nm / info.length
    res[:, 0] = pid > cfg.min_read_ani
    res[:, 3] = info.mapq > cfg.min_mapq
    is_pair = (info.reads == 2) & (info.insert != -1)
    res[:, 2] = np.where(is_pair, info.insert > cfg.min_insert, True)
    res[:, 1] = np.where(is_pair, info.insert < max_insert, True)
    return res


def filter_reads(bam: BamArrays, cfg: ReadFilterConfig,
                 scaffolds: Optional[List[str]] = None) -> PairSet:
    """
    Full read filtering pipeline; returns the PairSet with the
    mapping_info report (reference column order).
    """
    all_info = pair_info_from_records(bam)

    if scaffolds is not None:
        keep_rids = np.array(
            [bam.name_to_ref_id[s] for s in scaffolds
             if s in bam.name_to_ref_id], dtype=np.int64)
        all_info = _subset(all_info, np.isin(all_info.ref_id, keep_rids))
        scaffold_order = [s for s in scaffolds if s in bam.name_to_ref_id]
    else:
        scaffold_order = list(bam.ref_names)

    priority = load_priority_reads(cfg.priority_reads)
    if priority and bam.qnames is not None:
        name_to_qid = {n: i for i, n in enumerate(bam.qnames)}
        priority_ids = np.array(sorted(name_to_qid[p] for p in priority
                                       if p in name_to_qid), dtype=np.int64)
    else:
        priority_ids = np.zeros(0, dtype=np.int64)

    # pre-pairing tallys (reference: paired_read_filter tallys,
    # filter_reads.py:485-500)
    info = apply_pairing_filter(all_info, cfg.pairing_filter, priority_ids)

    # max_insert from the POST-pairing-filter median of true pairs
    # (reference: filter_scaff2pair2info, filter_reads.py:213-218)
    pair_inserts = info.insert[info.reads == 2]
    median_insert = np.median(pair_inserts) if len(pair_inserts) else np.nan
    max_insert = median_insert * cfg.max_insert_relative

    results = evaluate_pairs(info, cfg, max_insert)
    passed = results.all(axis=1)
    is_priority = np.isin(info.qname_id, priority_ids)

    table = _mapping_info_table(all_info, info, results, passed, is_priority,
                                priority_ids, scaffold_order, bam)

    values = {
        "min_read_ani": cfg.min_read_ani,
        "max_insert": max_insert,
        "min_insert": cfg.min_insert,
        "min_mapq": cfg.min_mapq,
        "pairing_filter": cfg.pairing_filter,
        "max_insert_relative": cfg.max_insert_relative,
    }

    return PairSet(info=info, passed=passed, mm=info.nm.copy(),
                   mapping_info=table, filter_values=values,
                   ref_names=list(bam.ref_names), qnames=bam.qnames)


_TALLY_COLS = [
    "unfiltered_reads", "unfiltered_pairs", "unfiltered_singletons",
    "unfiltered_priority_reads",
    "pass_pairing_filter", "pass_min_read_ani", "pass_max_insert",
    "pass_min_insert", "pass_min_mapq", "filtered_pairs",
    "filtered_singletons", "filtered_priority_reads",
]
_MEAN_COLS = ["mean_mistmaches", "mean_insert_distance", "mean_mapq_score",
              "mean_pair_length", "mean_PID", "median_insert"]


def _all_scaffolds_row(sdb: pd.DataFrame) -> dict:
    """The weighted aggregate row over the complete per-scaffold table
    (reference: filter_reads.py:277-298)."""
    arow = {"scaffold": "all_scaffolds"}
    cdb = sdb[sdb["pass_pairing_filter"] > 0]
    total = cdb["pass_pairing_filter"].sum()
    for c in _TALLY_COLS:
        arow[c] = int(cdb[c].sum()) if len(cdb) else 0
    for c in _MEAN_COLS:
        arow[c] = (float((cdb[c] * cdb["pass_pairing_filter"]).sum() /
                         total) if total > 0 else np.nan)
    return arow


def _mapping_info_table(all_info: PairInfo, info: PairInfo,
                        results: np.ndarray, passed: np.ndarray,
                        is_priority: np.ndarray, priority_ids: np.ndarray,
                        scaffold_order: List[str],
                        bam: BamArrays) -> pd.DataFrame:
    """Build the per-scaffold + all_scaffolds report, reference order.

    pair_info_from_records emits entries sorted by (ref, qname) and
    every filter preserves order, so per-scaffold selection is a
    searchsorted SLICE — the former boolean mask per scaffold scanned
    the full pair arrays O(n_scaffolds) times (~1 s of the metagenome
    filter stage on this host). Slices hold the same elements in the
    same order as the masks, so every statistic (incl. np.mean's
    pairwise summation) is bit-identical; a non-sorted input (never
    produced today) falls back to masks."""
    rows = []
    rid_of = bam.name_to_ref_id
    all_priority = np.isin(all_info.qname_id, priority_ids)
    sorted_rids = (np.all(np.diff(all_info.ref_id) >= 0) and
                   np.all(np.diff(info.ref_id) >= 0))

    def pre_of(rid):
        if sorted_rids:
            lo, hi = np.searchsorted(all_info.ref_id, [rid, rid + 1])
            return slice(lo, hi), hi - lo
        m = all_info.ref_id == rid
        return m, int(m.sum())

    def post_of(rid):
        if sorted_rids:
            lo, hi = np.searchsorted(info.ref_id, [rid, rid + 1])
            return slice(lo, hi), hi - lo
        m = info.ref_id == rid
        return m, int(m.sum())

    for scaff in scaffold_order:
        rid = rid_of[scaff]
        pre, n_pre = pre_of(rid)
        post, n_post = post_of(rid)
        row = {"scaffold": scaff}
        row["unfiltered_reads"] = int(all_info.reads[pre].sum())
        row["unfiltered_pairs"] = int((all_info.reads[pre] == 2).sum())
        row["unfiltered_singletons"] = int((all_info.reads[pre] == 1).sum())
        row["unfiltered_priority_reads"] = int(all_priority[pre].sum())
        row["pass_pairing_filter"] = int(n_post)
        row["pass_min_read_ani"] = int(results[post, 0].sum())
        row["pass_max_insert"] = int(results[post, 1].sum())
        row["pass_min_insert"] = int(results[post, 2].sum())
        row["pass_min_mapq"] = int(results[post, 3].sum())
        row["filtered_pairs"] = int(passed[post].sum())
        row["filtered_singletons"] = int((passed[post] &
                                          (info.reads[post] == 1)).sum())
        row["filtered_priority_reads"] = int((passed[post] &
                                              is_priority[post]).sum())
        if n_post > 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                pid = 1.0 - info.nm[post] / info.length[post]
            row["mean_mistmaches"] = float(info.nm[post].mean())
            row["mean_insert_distance"] = float(info.insert[post].mean())
            row["mean_mapq_score"] = float(info.mapq[post].mean())
            row["mean_pair_length"] = float(info.length[post].mean())
            row["mean_PID"] = float(pid.mean())
            row["median_insert"] = float(np.median(info.insert[post]))
        else:
            for c in _MEAN_COLS:
                row[c] = np.nan
        rows.append(row)

    sdb = pd.DataFrame(rows)
    adb = pd.DataFrame([_all_scaffolds_row(sdb)])
    out = pd.concat([adb, sdb]).reset_index(drop=True)
    return out[["scaffold"] + _TALLY_COLS + _MEAN_COLS]


def write_mapping_info(df: pd.DataFrame, location: Optional[str],
                       values: Dict[str, object]):
    """reference: filter_reads.py:699-720 (header comment + TSV); gzipped
    where location ends in .gz (--force_compress), where the JAX package
    writes plain text under that name."""
    header_vals = {k: values[k] for k in
                   ["min_read_ani", "max_insert_relative", "min_insert",
                    "min_mapq", "pairing_filter"] if k in values}
    if location is None:
        return header_vals
    opener = gzip.open if location.endswith(".gz") else open
    with opener(location, "wt") as f:
        f.write("# {0}\n".format(" ".join(
            f"{k}:{v}" for k, v in header_vals.items())))
        df.to_csv(f, index=False, sep="\t")
