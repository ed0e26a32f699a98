"""
The comparison that decides `correct`: one profile's tables (read by
outputs.read_profile) against the plain reference's (ref/profile.py), one
number per layer and kind, each held to a limit of its own.

Counts of mismatched cells are exact and have the limit 0: a row or a
position that one side has and the other lacks counts as mismatched, and
so does every cell of an integer or base column that differs. Float
columns are held by their widest gap, |a - b| / max(|b|, 1) (absolute for
shares and diversities, relative for coverages), or for the clonality of
each site, which is stored in float32 and lies in [0.25, 1], by its
widest relative gap. NaN on both sides agrees; NaN on one side, or a
table one side lacks, reads ONE_SIDED. How each limit was set, and from which readings, is in
PERF.md ("How `correct` is decided").
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

# the gap of a value or table that only one side has (a finite number, so
# that the result stays plain JSON)
ONE_SIDED = 1e300

# name -> limit; a number passes when it is <= its limit
LIMITS = {
    "mapping_mismatches": 0,
    "covT_mismatches": 0,
    "clonT_sites_mismatched": 0,
    "clonT_rel_gap": 1e-5,
    "scaffold_info_mismatches": 0,
    "scaffold_info_gap": 1e-6,
    "snv_mismatches": 0,
    "snv_freq_gap": 1e-12,
    "linkage_mismatches": 0,
    "linkage_gap": 1e-12,
    "genome_info_mismatches": 0,
    "genome_info_gap": 1e-6,
    "genome_coverage_gap": 1e-11,
    "samples_differing": 0,
}

MAPPING_INT = ["unfiltered_pairs", "pass_min_read_ani", "pass_max_insert",
               "pass_min_insert", "filtered_pairs"]
SCAF_INT = ["length", "coverage_median", "SNS_count", "SNV_count",
            "divergent_site_count"]
SCAF_FLOAT = ["coverage", "breadth", "nucl_diversity", "coverage_std",
              "breadth_minCov", "conANI_reference", "popANI_reference"]
SNV_EXACT = ["position_coverage", "allele_count", "ref_base", "con_base",
             "var_base", "A", "C", "T", "G"]
SNV_FLOAT = ["ref_freq", "con_freq", "var_freq"]
LINK_EXACT = ["distance", "allele_A", "allele_a", "allele_B", "allele_b",
              "countAB", "countAb", "countaB", "countab", "total"]
LINK_FLOAT = ["r2", "d_prime"]
GENOME_INT = ["length", "true_scaffolds", "detected_scaffolds", "SNS_count",
              "SNV_count", "filtered_read_pair_count", "coverage_median",
              "iRep_GC_corrected"]
GENOME_FLOAT = ["coverage", "breadth", "nucl_diversity", "breadth_minCov"]
# the genome's coverage distribution and replication rate
GENOME_COVERAGE = ["coverage_std", "coverage_SEM", "iRep"]


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not len(a):
        return 0.0
    both = np.isnan(a) & np.isnan(b)
    one = np.isnan(a) ^ np.isnan(b)
    with np.errstate(invalid="ignore"):
        g = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    g = np.where(both, 0.0, np.where(one, ONE_SIDED, g))
    return float(g.max())


def _tables(a: pd.DataFrame, b: pd.DataFrame, exact: List[str],
            floats: List[str]) -> Tuple[int, float]:
    """(mismatched rows and cells, widest float gap) of two tables indexed
    alike."""
    if not len(a) and not len(b):
        return 0, 0.0
    if not len(a) or not len(b):
        return max(len(a), len(b)), ONE_SIDED
    ia, ib = a.index, b.index
    common = ia.intersection(ib)
    bad = len(ia.difference(ib)) + len(ib.difference(ia))
    a, b = a.loc[common], b.loc[common]
    for c in exact:
        x, y = a[c].values, b[c].values
        bad += int(((x != y) & ~(pd.isna(x) & pd.isna(y))).sum())
    gap = max((_gap(a[c].values, b[c].values) for c in floats), default=0.0)
    return bad, gap


def _views(a: Dict, b: Dict, values: str) -> Tuple[int, float]:
    """(mismatched sites, widest relative gap) of two scaffold -> mm ->
    (positions, values) views; values "exact" counts differing values as
    mismatched, "relative" measures them."""
    bad, gap = 0, 0.0
    for s in set(a) | set(b):
        va, vb = a.get(s, {}), b.get(s, {})
        for m in set(va) | set(vb):
            pa, xa = va.get(m, (np.zeros(0, np.int64), np.zeros(0)))
            pb, xb = vb.get(m, (np.zeros(0, np.int64), np.zeros(0)))
            common, ka, kb = np.intersect1d(pa, pb, assume_unique=True,
                                            return_indices=True)
            bad += len(pa) + len(pb) - 2 * len(common)
            if values == "exact":
                bad += int((xa[ka] != xb[kb]).sum())
            elif len(common):
                r = xb[kb].astype(np.float64)
                gap = max(gap, float(np.max(np.abs(
                    xa[ka].astype(np.float64) - r) / r)))
    return bad, gap


def _settle_d_prime(link: pd.DataFrame) -> pd.DataFrame:
    """D' where D is exactly 0 (AB * ab == Ab * aB in the counts, which
    are compared exactly) reads 0. inStrain's D' takes one branch for a
    negative D, another for a positive one, and is NaN at 0, so at an
    exact 0 the last bit of D's float64 rounding decides between NaN and
    a signed zero: a fused multiply-add (the device engine) and two
    roundings (numpy) decide it differently."""
    if not len(link):
        return link
    zero = (link["countAB"] * link["countab"] ==
            link["countAb"] * link["countaB"])
    link = link.copy()
    link.loc[zero, "d_prime"] = link.loc[zero, "d_prime"].fillna(0.0)
    return link


def judge(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number compared, by name (see LIMITS)."""
    out: Dict[str, float] = {}
    out["mapping_mismatches"], _ = _tables(prog["mapping"], ref["mapping"],
                                           MAPPING_INT, [])
    out["covT_mismatches"], _ = _views(prog["covT"], ref["covT"], "exact")
    out["clonT_sites_mismatched"], out["clonT_rel_gap"] = _views(
        prog["clonT"], ref["clonT"], "relative")
    out["scaffold_info_mismatches"], out["scaffold_info_gap"] = _tables(
        prog["scaffold_info"], ref["scaffold_info"], SCAF_INT, SCAF_FLOAT)
    out["snv_mismatches"], out["snv_freq_gap"] = _tables(
        prog["snvs"], ref["snvs"], SNV_EXACT, SNV_FLOAT)
    out["linkage_mismatches"], out["linkage_gap"] = _tables(
        _settle_d_prime(prog["linkage"]), _settle_d_prime(ref["linkage"]),
        LINK_EXACT, LINK_FLOAT)
    out["genome_info_mismatches"], out["genome_info_gap"] = _tables(
        prog["genome_info"], ref["genome_info"], GENOME_INT, GENOME_FLOAT)
    _, out["genome_coverage_gap"] = _tables(
        prog["genome_info"], ref["genome_info"], [], GENOME_COVERAGE)
    return out


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float] = LIMITS) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)
