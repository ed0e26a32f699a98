"""
Genome-level aggregation and iRep replication-rate estimation
(reference: inStrain/genomeUtilities.py + inStrain/irep_utilities.py) —
the counterpart of instrain_tpu/profile/genome.py, host numpy, pandas and
scipy as there, so that genome_info and genomeWide_compare equal the JAX
package's.
"""

from __future__ import annotations

import bisect
import logging
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import scipy.signal

from ..io.stb import load_scaff2bin
from ..obs.logging import log_failure
from ..obs import spans
from ..store import generate as gen
from ..store.profile_dir import ProfileDir


# breadth model shared with the scaffold-level tables (identical
# float-op order; a drifted copy would desynchronize scaffold_info from
# genome_info)
from .tables import estimate_breadth  # noqa: E402


def genome_wide(isdir: ProfileDir, stb: Optional[List[str]] = None,
                mm_level: bool = False, skip_mm_profiling: bool = False,
                fasta_loc: Optional[str] = None):
    """The genome_wide operation (reference: genomeUtilities.Controller).
    Its spans (obs/spans.py) time a profile run's steps: genome.load (the
    stored tables, covT, the .stb and the FASTA read back),
    genome.coverage (the per-genome coverage arrays and their median, SEM
    and std per mm level), genome.irep (the GC windows and the iRep fits)
    and genome.write (the stores and genome_info and SNVs)."""
    with spans.span("genome.load"):
        s2l = isdir.get("scaffold2length")
        s2b = load_scaff2bin(stb, s2l)
    b2l: Dict[str, int] = {}
    for scaffold, b in s2b.items():
        b2l.setdefault(b, 0)
        if scaffold in s2l:
            b2l[b] += s2l[scaffold]
        else:
            log_failure("StbError", scaffold,
                        f"{b} no_length will not be considered")
    with spans.span("genome.write"):
        isdir.store("scaffold2bin", s2b, "dictionary",
                    "Dictionary of scaffold 2 bin")
        isdir.store("bin2length", b2l, "dictionary",
                    "Dictionary of bin 2 total length")

    with spans.span("genome.load"):
        object_type = isdir.get("object_type")
        if object_type is None:
            object_type = ("compare" if isdir.get("comparisonsTable")
                           is not None else "profile")

    if object_type == "profile":
        gidb = genome_level_info(isdir, s2b, b2l,
                                 skip_mm_profiling=skip_mm_profiling,
                                 fasta_loc=fasta_loc)
        with spans.span("genome.write"):
            isdir.store("genome_level_info", gidb, "pandas",
                        "Table of genome-level information")
            gen.generate(isdir, "genome_info", mm_level=mm_level)
            gen.generate(isdir, "SNVs", mm_level=mm_level)
    else:
        gdb = _add_stb(isdir.get("comparisonsTable"), s2b)
        out = genome_wide_readcomparer(gdb, s2b, b2l, mm_level=mm_level)
        out.to_csv(isdir.get_output_base() + "genomeWide_compare.tsv",
                   index=False, sep="\t")


def _add_stb(db: pd.DataFrame, stb: Dict[str, str]):
    gdb = db.copy()
    gdb["genome"] = gdb["scaffold"].map(stb)
    return gdb


def genome_level_info(isdir: ProfileDir, s2b, b2l,
                      skip_mm_profiling: bool = False,
                      fasta_loc: Optional[str] = None) -> pd.DataFrame:
    """reference: genomeLevel_from_IS (genomeUtilities.py:145-269); spans
    as genome_wide's."""
    with spans.span("genome.load"):
        s2l = isdir.get("scaffold2length")
        db = isdir.get("cumulative_scaffold_table")
        scaff2sequence = _load_scaff2sequence(isdir, fasta_loc)
        covT = isdir.get("covT")
        rdb = isdir.get("mapping_info")
        ldb = isdir.get("raw_linkage_table")
    db["scaffold"] = db["scaffold"].astype(str)
    gdb = _add_stb(db, s2b)

    if skip_mm_profiling:
        gdb = (gdb.sort_values("mm")
                  .drop_duplicates(subset=["scaffold"], keep="last")
                  .sort_values("scaffold"))
        gdb["mm"] = 1000

    gsi = _genome_scaffold_info(gdb, s2b, b2l)

    # coverage-distribution metrics + iRep
    bin2scaffolds: Dict[str, set] = defaultdict(set)
    for s, b in s2b.items():
        bin2scaffolds[b].add(s)
    mms = ([1000] if skip_mm_profiling else
           sorted({mm for ct in covT.values() for mm in ct}))
    egdb = genome_coverage_info(covT, bin2scaffolds,
                                set(gsi["genome"]), s2l, scaff2sequence, mms)

    # read-report rollup
    rdb = rdb[rdb["scaffold"] != "all_scaffolds"]
    rdb = _add_stb(rdb, s2b)
    rdb = genome_wide_rr(rdb)
    rdb = rdb.rename(columns={
        "reads_filtered_pairs": "filtered_read_pair_count"})
    if "reads_pass_pairing_filter" in rdb.columns:
        del rdb["reads_pass_pairing_filter"]

    mdb = pd.merge(gsi, egdb, on=["genome", "mm"], how="outer")
    mdb = pd.merge(mdb, rdb, on=["genome"], how="left")

    if ldb is not None and len(ldb) > 0:
        if skip_mm_profiling:
            ldb = (ldb.sort_values("mm")
                      .drop_duplicates(subset=["scaffold", "position_A",
                                               "position_B"], keep="last"))
            ldb["mm"] = 1000
        ldb = _add_stb(ldb, s2b)
        lw = genome_wide_linkage(ldb, mms)
        if len(lw):
            mdb = pd.merge(mdb, lw, on=["genome", "mm"], how="left")
    for col in ["SNV_distance_mean", "d_prime_mean", "linked_SNV_count",
                "r2_mean"]:
        if col not in mdb.columns:
            mdb[col] = np.nan
    if skip_mm_profiling and "mm" in mdb.columns:
        del mdb["mm"]
    return mdb


def _genome_scaffold_info(gdb, stb, b2l) -> pd.DataFrame:
    """reference: _genomeLevel_scaffold_info_v3 (545-605)."""
    table = defaultdict(list)
    for mm in sorted(gdb["mm"].unique()):
        odb = (gdb[gdb["mm"] <= mm].sort_values("mm")
               .drop_duplicates(subset=["scaffold"], keep="last"))
        for genome, df in odb.groupby("genome"):
            cols = list(df.columns)
            table["mm"].append(mm)
            table["genome"].append(genome)
            table["detected_scaffolds"].append(len(df))
            table["true_scaffolds"].append(
                len([True for s, b in stb.items() if b == genome]))
            table["length"].append(int(b2l[genome]))
            for col in ["SNS_count", "SNV_count", "divergent_site_count",
                        "consensus_divergent_sites",
                        "population_divergent_sites"]:
                if col in cols:
                    table[col].append(df[col].fillna(0).sum())
            for col in ["breadth", "coverage"]:
                table[col].append(
                    float((df[col].fillna(0) * df["length"]).sum()) /
                    b2l[genome])
            considered = (df["breadth_minCov"] * df["length"])
            considered_leng = float(considered.sum())
            for col in ["nucl_diversity", "nucl_diversity_rarefied"]:
                if col not in df.columns:
                    continue
                if considered_leng != 0:
                    table[col].append(
                        float((df[col].fillna(0) * considered).sum()) /
                        considered_leng)
                else:
                    table[col].append(np.nan)
            if "consensus_divergent_sites" in cols:
                if considered_leng != 0:
                    table["conANI_reference"].append(
                        (considered_leng -
                         df["consensus_divergent_sites"].sum()) /
                        considered_leng)
                    table["popANI_reference"].append(
                        (considered_leng -
                         df["population_divergent_sites"].sum()) /
                        considered_leng)
                else:
                    table["conANI_reference"].append(0)
                    table["popANI_reference"].append(0)
            table["breadth_minCov"].append(considered_leng / b2l[genome])
            table["breadth_expected"].append(
                estimate_breadth(table["coverage"][-1]))
    return pd.DataFrame(table)


def genome_coverage_info(covT, bin2scaffolds, relevant_genomes, s2l,
                         scaff2sequence, mms) -> pd.DataFrame:
    """reference: genomeLevel_coverage_info (297-365) over
    generate_genome_coverage_array (932-981): at each mm level of `mms`
    (ascending), a genome's coverage is its scaffolds' covT summed over
    mm <= level, longest scaffold first, 100 bp edges masked (a scaffold
    under 200 bp adds nothing), concatenated; its median, SEM and std a
    row, and iRep at mm 1 and 1000. Spans as genome_wide's.

    The concatenated float64 array is built once a genome as a running
    sum: each level adds only the series whose mm lies above the level
    before it, so every covT series is added once (counted in
    `genome_coverage_info.series_added`). The median is read from a
    histogram of the counts and std and SEM from one sum of squared
    deviations (_coverage_stats), equal bit for bit to int(np.median),
    np.std and scipy.stats.sem of the same array."""
    mms = list(mms)
    if mms != sorted(mms):
        raise ValueError(f"mm levels must ascend: {mms}")
    dbs = []
    for genome, scaffolds in bin2scaffolds.items():
        if genome not in relevant_genomes:
            continue
        table = defaultdict(list)
        scaffolds = scaffolds.intersection(set(s2l.keys()))
        scaffolds = sorted(scaffolds, key=s2l.get, reverse=True)

        gc_windows = None
        if scaff2sequence is not None:
            with spans.span("genome.irep"):
                try:
                    gc_windows = generate_gc_windows(scaffolds,
                                                     scaff2sequence)
                except Exception:
                    pass

        with spans.span("genome.coverage"):
            by_level, length = _series_by_level(covT, s2l, scaffolds, mms)
            covs = np.zeros(length)
            scratch = np.empty(max(length, 1))
        iRep = np.nan
        iRep_acc = {"iRep_GC_corrected": np.nan}
        for mm, added in zip(mms, by_level):
            with spans.span("genome.coverage"):
                for start, kept, series in added:
                    _add_series(covs, start, kept, series)
                genome_coverage_info.series_added += len(added)
            if mm == 1 or mm == 1000:
                with spans.span("genome.irep"):
                    try:
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore")
                            iRep, iRep_acc = calculate_irep(
                                covs, len(scaffolds), gc_windows)
                    except Exception:
                        log_failure("iRepError", f"{genome} {mm}")
                        iRep = np.nan
                        iRep_acc = {"iRep_GC_corrected": np.nan}
            with spans.span("genome.coverage"):
                table["mm"].append(mm)
                table["genome"].append(genome)
                median, sem, std = _coverage_stats(
                    covs if length else np.zeros(1), scratch)
                table["coverage_median"].append(median)
                table["coverage_SEM"].append(sem)
                table["coverage_std"].append(std)
        del covs, scratch
        gdb = pd.DataFrame(table)
        gdb["iRep"] = iRep
        gdb["iRep_GC_corrected"] = iRep_acc.get("iRep_GC_corrected", np.nan)
        dbs.append(gdb)
    return (pd.concat(dbs).reset_index(drop=True) if dbs
            else pd.DataFrame(columns=["mm", "genome"]))


genome_coverage_info.series_added = 0

_MASK_EDGES = 100


def _series_by_level(covT, s2l, order, mms):
    """The covT series of the scaffolds in `order`, in one list a level of
    `mms`: a series goes to the first level at or above its mm (none past
    the top level), as (start, kept, series), its positions kept in
    [_MASK_EDGES, _MASK_EDGES + kept) and shifted by start into the
    genome's masked, concatenated layout. Also the layout's length."""
    by_level = [[] for _ in mms]
    offset = 0
    for scaff in order:
        kept = max(s2l[scaff] - 2 * _MASK_EDGES, 0)
        for mm, series in covT.get(scaff, {}).items():
            level = bisect.bisect_left(mms, mm)
            if level < len(mms):
                by_level[level].append((offset - _MASK_EDGES, kept, series))
        offset += kept
    return by_level, offset


def _add_series(covs, start, kept, series):
    """Adds one covT series into the layout (see _series_by_level)."""
    values = series.values
    if values.dtype.kind not in "iu":
        raise ValueError(f"covT holds counts, not {values.dtype}")
    pos = series.index.values
    inside = (pos >= _MASK_EDGES) & (pos < _MASK_EDGES + kept)
    covs[pos[inside] + start] += values[inside]


def _coverage_stats(covs, scratch):
    """(int(np.median(covs)), scipy.stats.sem(covs), np.std(covs)) of a
    non-empty float64 array of non-negative whole counts, bit for bit.
    The median is read from the counts' histogram (even lengths: the two
    middle values' mean, truncated by int() as there). std and SEM share
    one sum of squared deviations, reduced as numpy's _var does: add.reduce
    / n, subtract, multiply in place, add.reduce; SEM is std with one
    degree of freedom less over sqrt(n), as SciPy computes it. `scratch`
    (at least len(covs) float64) holds the counts as integers, then the
    deviations."""
    n = len(covs)
    counts = scratch[:n].view(np.int64)
    np.copyto(counts, covs, casting="unsafe")
    below = np.cumsum(np.bincount(counts))
    upper = int(np.searchsorted(below, n // 2, side="right"))
    if n % 2:
        median = upper
    else:
        lower = int(np.searchsorted(below, n // 2 - 1, side="right"))
        median = (lower + upper) // 2
    dev = np.subtract(covs, np.add.reduce(covs) / n, out=scratch[:n])
    np.multiply(dev, dev, out=dev)
    ss = np.add.reduce(dev)
    with np.errstate(invalid="ignore", divide="ignore"):
        return median, np.sqrt(ss / (n - 1)) / n ** 0.5, np.sqrt(ss / n)


def genome_wide_rr(gdb: pd.DataFrame) -> pd.DataFrame:
    """reference: _genome_wide_rr (617-634)."""
    table = defaultdict(list)
    for genome, df in gdb.groupby("genome"):
        table["genome"].append(genome)
        for col in [c for c in df.columns if c not in ("scaffold", "genome")]:
            if len(df[col].dropna()) == 0:
                table["reads_" + col].append(np.nan)
            elif (col.startswith("pass") or col.startswith("unfiltered_")
                  or col.startswith("filtered")):
                table["reads_" + col].append(df[col].sum())
            else:
                table["reads_" + col].append(df[col].mean())
    return pd.DataFrame(table)


def genome_wide_linkage(ldb: pd.DataFrame, mms) -> pd.DataFrame:
    """reference: _genome_wide_linkage (636-659)."""
    table = defaultdict(list)
    for mm in mms:
        odb = (ldb[ldb["mm"] <= mm].sort_values("mm")
               .drop_duplicates(subset=["scaffold", "position_A",
                                        "position_B"], keep="last"))
        if len(odb) == 0:
            continue
        for genome, df in odb.groupby("genome"):
            table["genome"].append(genome)
            table["mm"].append(mm)
            table["r2_mean"].append(df["r2"].mean())
            table["d_prime_mean"].append(df["d_prime"].mean())
            table["SNV_distance_mean"].append(df["distance"].mean())
            table["linked_SNV_count"].append(len(df))
    return pd.DataFrame(table)


def genome_wide_readcomparer(gdb, s2b, b2l, mm_level=False) -> pd.DataFrame:
    """reference: _genome_wide_readComparer (739-800)."""
    if not mm_level:
        gdb = (gdb.sort_values("mm")
                  .drop_duplicates(subset=["scaffold", "name1", "name2"],
                                   keep="last").sort_values("scaffold"))
        gdb["mm"] = 0
    table = defaultdict(list)
    for mm in sorted(gdb["mm"].unique()):
        odb = (gdb[gdb["mm"] <= mm].sort_values("mm")
               .drop_duplicates(subset=["scaffold", "name1", "name2"],
                                keep="last"))
        for (genome, name1, name2), db in odb.groupby(
                ["genome", "name1", "name2"]):
            table["genome"].append(genome)
            table["name1"].append(name1)
            table["name2"].append(name2)
            table["mm"].append(mm)
            tcb = db["compared_bases_count"].sum()
            for col in ["coverage_overlap"]:
                table[col].append(
                    np.nan if tcb == 0 else
                    float((db[col] * db["compared_bases_count"]).sum()) / tcb)
            for col in ["compared_bases_count", "consensus_SNPs",
                        "population_SNPs"]:
                if col in db.columns:
                    table[col].append(db[col].sum())
            for col in ["ANI", "popANI", "conANI"]:
                if col in db.columns:
                    if tcb == 0:
                        table[col].append(np.nan)
                    else:
                        table[col].append(sum(
                            a * c if a == a else 0 for a, c in
                            zip(db[col], db["compared_bases_count"])) / tcb)
            if b2l is not None:
                table["percent_compared"].append(tcb / b2l[genome])
    db = pd.DataFrame(table)
    if not mm_level and "mm" in db.columns:
        del db["mm"]
    return db


def _load_scaff2sequence(isdir, fasta_loc):
    from ..io import fasta as fasta_io
    loc = fasta_loc or isdir.get("fasta_loc")
    if loc is None:
        return None
    try:
        return {n: s.tobytes().decode()
                for n, s in fasta_io.read_fasta(loc).items()}
    except Exception:
        logging.error(f"Could not load fasta {loc}; no GC correction")
        return None


# ---------------- iRep ----------------

def calculate_irep(rcov: np.ndarray, num_contigs: int,
                   gc_windows: Optional[pd.DataFrame] = None):
    """reference: calculate_iRep_from_coverage_array (irep_utilities:22-81),
    with the lmfit linear least-squares replaced by an exact closed-form
    fit (identical model: y = m x + b minimizing squared error)."""
    crit = {"kept_windows": np.nan, "avg_cov": np.nan, "r2": np.nan,
            "fragMbp": np.nan}
    length = len(rcov)
    crit["avg_cov"] = np.mean(rcov) if length else np.nan
    crit["fragMbp"] = num_contigs / (float(length) / 1e6) if length else np.nan

    oIdb = _irep_windows(rcov)
    if gc_windows is not None:
        oIdb = pd.merge(oIdb, gc_windows, on="index")
    Idb = _irep_filter_windows(oIdb)
    crit["kept_windows"] = len(Idb) / len(oIdb) if len(oIdb) else np.nan

    Idb = Idb.copy()
    Idb["coverage_OLT"] = _irep_log_transform(Idb["coverage"])
    iRep = _calc_irep(Idb, length, on="coverage_OLT", crit=crit)
    crit["unfiltered_raw_iRep"] = iRep

    crit["iRep_GC_corrected"] = False
    if gc_windows is not None and len(Idb):
        Idb = _irep_gc_bias(Idb)
        Idb["coverage_LT"] = _irep_log_transform(Idb["corrected_coverage"])
        iRep = _calc_irep(Idb, length, on="coverage_LT", crit=crit)
        crit["iRep_GC_corrected"] = True

    if ((crit["kept_windows"] < 0.98) or (crit["avg_cov"] < 5) or
            (crit["r2"] < 0.9) or (crit["fragMbp"] > 175)):
        iRep = np.nan
    return iRep, crit


def generate_gc_windows(order, scaff2sequence, mask_edges=100):
    """reference: generate_gc_windows (83-134)."""
    parts = []
    for scaff in order:
        seq = scaff2sequence[scaff]
        if mask_edges:
            seq = seq[mask_edges:len(seq) - mask_edges]
        parts.append(seq)
    genome_seq = "".join(parts)
    gc = np.frombuffer(genome_seq.encode(), dtype=np.uint8)
    isgc = ((gc == ord("G")) | (gc == ord("C"))).astype(float)
    window, slide = 5000, 100
    conv = scipy.signal.fftconvolve(isgc, np.ones(window), "valid")[::slide]
    return pd.DataFrame({"index": np.arange(len(conv)) * slide,
                         "GC_content": conv / window})


def _irep_windows(cov, window=5000, slide=100):
    conv = scipy.signal.fftconvolve(cov, np.ones(window), "valid")[::slide]
    return pd.DataFrame({"index": np.arange(len(conv)) * slide,
                         "coverage": conv / window})


def _irep_filter_windows(cov, on="coverage", mdif=8.0):
    med = np.median(cov[on]) if len(cov) else 0
    keep = [bool((y > 0) and (med > 0) and
                 (abs(float(max(y, med)) / float(min(y, med))) <= mdif))
            for y in cov[on]]
    return cov[keep]


def _irep_log_transform(array):
    eps = 1e-50
    return [np.log2(eps) if x < eps else np.log2(x) for x in array]


def _fit_line(x, y):
    """Least-squares y = m x + b; returns m, b, r2."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if len(x) <= 2:
        return np.nan, np.nan, np.nan
    A = np.vstack([x, np.ones_like(x)]).T
    (m, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    resid = y - (m * x + b)
    r2 = 1 - (resid.var() / y.var()) if y.var() > 0 else np.nan
    return m, b, r2


def _calc_irep(db, length, on="coverage_OLT", crit=None):
    """reference: _calc_iRep (186-206)."""
    Ys = sorted(db[on])
    windows = len(Ys)
    if windows == 0:
        return np.nan
    dif = float(length) / float(windows)
    Xs = [int(i * dif) + 1 for i in range(windows)]
    Xt, Yt = _trim_data(Xs, Ys)
    m, b, r2 = _fit_line(Xt, Yt)
    if crit is not None:
        crit["r2"] = r2
    return 2 ** (m * length)


def _trim_data(X, Y, p=0.1):
    length = len(X)
    num = int(length * (p / 2))
    return X[num:length - num], Y[num:length - num]


def _irep_gc_bias(Idb, correction_threshold=0.0):
    """reference: _iRep_gc_bias (268-294)."""
    m, b, r2 = _fit_line(Idb["GC_content"], Idb["coverage"])
    Idb = Idb.copy()
    Idb["error"] = [abs(cov - (m * gc + b)) for gc, cov in
                    zip(Idb["GC_content"], Idb["coverage"])]
    try:
        cutoff = sorted(Idb["error"], reverse=True)[
            int(len(Idb["error"]) * 0.01)]
    except Exception:
        cutoff = 0
    fidb = Idb[~(Idb["error"] >= cutoff)]
    m, b, r2 = _fit_line(fidb["GC_content"], fidb["coverage"])
    if not (r2 >= correction_threshold):
        Idb["corrected_coverage"] = Idb["coverage"]
        return Idb
    av = np.average(Idb["coverage"])
    Idb["corrected_coverage"] = [cov + (av - (m * gc + b)) for cov, gc in
                                 zip(Idb["coverage"], Idb["GC_content"])]
    return Idb
