"""
Cross-sample SNV pooling (reference: inStrain/polymorpher.py) — the
counterpart of instrain_tpu/compare/pooling.py.

For every SNV position called in any sample, extract base counts at that
position from every sample's BAM (for samples that didn't call it
themselves), producing the dense per-sample x position count table (DSTdb)
and the per-position summary table (PMdb).

The BAM re-extraction uses the profile's decode path, ranged to the
needed scaffolds where a .bai exists: counts are the filtered pairs'
(Rdic) bases of quality >= 30 at each position, over all mm levels.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from ..io.bam import decode_bam

_C2P_ARR = np.array(list("ACTG"), dtype=object)


def run_pooling(SCs, name2bam: Dict[str, str], threads: int = 6
                ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """reference: PoolController.main (polymorpher.py:85-142)."""
    # Load (deduped, non-cryptic) SNP tables per sample
    name2snp: Dict[str, pd.DataFrame] = {}
    name2scaffs: Dict[str, List[str]] = defaultdict(list)
    name2prof = {}
    for sc in SCs:
        for prof, name in zip(sc.profiles, sc.names):
            name2scaffs[name].append(sc.scaffold)
            if name in name2snp:
                continue
            db = prof.get("cumulative_snv_table")
            db = db.rename(columns={
                "conBase": "con_base", "refBase": "ref_base",
                "varBase": "var_base", "baseCoverage": "position_coverage"})
            if "cryptic" in db:
                db = db[db["cryptic"] == False]  # noqa: E712
            db["scaffold"] = db["scaffold"].astype(str)
            if "mm" in db.columns:
                db = (db.sort_values("mm")
                        .drop_duplicates(subset=["scaffold", "position"],
                                         keep="last")
                        .sort_index().drop(columns=["mm"]))
            name2snp[name] = db
            name2prof[name] = prof

    # each sample's rows split by scaffold once (row order kept), in
    # place of a filter of the whole table per scaffold
    name2split = {name: {s: d for s, d in t.groupby("scaffold", sort=False)}
                  for name, t in name2snp.items()}

    # union of SNV positions per scaffold; per sample, the positions it
    # didn't call itself (extract_SNV_positions, polymorpher.py:318-375)
    scaff2all: Dict[str, set] = {}
    for name, split in name2split.items():
        for scaff in sorted(split):
            if scaff not in name2scaffs[name]:
                continue
            scaff2all.setdefault(scaff, set()).update(split[scaff]["position"])
    name2scaff2locs: Dict[str, Dict[str, set]] = {}
    for name, split in name2split.items():
        d = name2scaff2locs.setdefault(name, {})
        for scaff in name2scaffs[name]:
            if scaff not in scaff2all:
                continue
            called = (set(split[scaff]["position"]) if scaff in split
                      else set())
            d[scaff] = scaff2all[scaff] - called

    # pull counts from BAMs
    scaff2name2position2counts: Dict[str, Dict[str, tuple]] = \
        defaultdict(dict)
    for name, scaff2locs in name2scaff2locs.items():
        counts = extract_snvs_from_bam(name2bam[name],
                                       name2prof[name].get("Rdic"),
                                       scaff2locs, threads)
        for scaff, p2c in counts.items():
            scaff2name2position2counts[scaff][name] = p2c

    dst = _pooled_snv_table(name2split, name2scaffs,
                            scaff2name2position2counts, scaff2all)
    pmdb = _pooled_summary_table(dst, name2snp, name2scaffs)
    return dst, pmdb


def extract_snvs_from_bam(bam_loc: str, rdic, scaff2locs, threads: int = 6
                          ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Counts of filtered-pair bases at requested positions (reference:
    extract_SNVS_from_bam, polymorpher.py:275-310): per scaffold, the
    positions ascending (int64) and their A, C, T, G counts [n, 4]. With a
    .bai present, only the requested scaffolds are decoded (io.bam ranged
    path); a full decode otherwise. The events are selected natively
    (BamArrays.select_events: quality >= 30, ACTG, the position mask and
    the allowed pairs)."""
    bam = decode_bam(bam_loc, threads=threads, baq=False,
                     scaffolds=sorted(scaff2locs))
    name_to_rid = bam.name_to_ref_id
    qname_index = pd.Index(bam.qnames or [])      # qname -> id
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for scaff, locs in scaff2locs.items():
        locs_arr = np.array(sorted(locs), dtype=np.int64)
        counts = np.zeros((len(locs_arr), 4), dtype=np.int64)
        out[scaff] = (locs_arr, counts)
        if not locs or scaff not in name_to_rid:
            continue
        r2m = rdic.get(scaff, {}) if rdic else {}
        # r2m is {qname: mm} or a set of qnames (skip_mm profiles):
        # either way iteration yields the allowed qnames
        allowed = qname_index.get_indexer(list(r2m))
        allowed = allowed[allowed >= 0]
        if not len(allowed):
            continue
        # the decode's own qname count sizes the map (an empty decode has
        # no allowed pairs and never reaches here: no qname_id.max())
        qid2mmidx = np.full(bam.n_qnames, -1, dtype=np.int32)
        qid2mmidx[allowed] = 0
        rid = name_to_rid[scaff]
        L = int(bam.ref_lens[rid])
        mask = np.zeros(L, np.uint8)
        mask[locs_arr[(locs_arr >= 0) & (locs_arr < L)]] = 1
        pos, base, _mm, _qn = bam.select_events(rid, qid2mmidx, mask)
        np.add.at(counts, (np.searchsorted(locs_arr, pos), base), 1)
    return out


def _pooled_snv_table(name2split, name2scaffs, scaff2name2position2counts,
                      scaff2all) -> pd.DataFrame:
    """The dense (sample, position) x A, C, T, G table (reference:
    genreate_pooled_SNV_table, 397-448): scaffold by scaffold in the order
    the counts were gathered, the samples that hold the scaffold in turn,
    each with every SNV position of the scaffold ascending, its counts
    pulled from the BAM or, where the sample called the SNV, its own."""
    names, positions, counts, scaffolds = [], [], [], []
    for scaff, name2position2counts in scaff2name2position2counts.items():
        want = np.array(sorted(scaff2all[scaff]), dtype=np.int64)
        for name, split in name2split.items():
            if scaff not in name2scaffs[name]:
                continue
            pos, cnt = name2position2counts.get(
                name, (np.zeros(0, np.int64), np.zeros((0, 4), np.int64)))
            ori = split.get(scaff)
            if ori is not None and len(ori):
                pos = np.concatenate([pos, ori["position"].to_numpy()])
                cnt = np.concatenate([cnt, ori[["A", "C", "T", "G"]]
                                      .to_numpy(dtype=np.int64)])
            order = np.argsort(pos, kind="stable")
            assert np.array_equal(pos[order], want), scaff
            names.append(np.full(len(pos), name, dtype=object))
            positions.append(pos[order])
            counts.append(cnt[order])
            scaffolds.append(np.full(len(pos), scaff, dtype=object))
    if not names:
        return pd.DataFrame()
    dst = pd.DataFrame(np.concatenate(counts), columns=["A", "C", "T", "G"],
                       index=pd.MultiIndex.from_arrays(
                           [np.concatenate(names),
                            np.concatenate(positions)]))
    dst["scaffold"] = np.concatenate(scaffolds)
    return dst


_CLASSES = ["DivergentSite", "SNS", "SNV", "con_SNV", "pop_SNV"]


def _pooled_summary_table(dst, name2snp, name2scaffs) -> pd.DataFrame:
    """The per-position summary of the dense table (reference:
    generate_pooled_SNV_summary_table, 471-551), for every scaffold at
    once, keyed by (scaffold, position) in the reference's order
    (scaffolds sorted, positions ascending): the samples' summed counts and
    depth, the reference base, how many samples reach 5x and detect any
    base, the class counts and consensus bases of the samples' own SNV
    rows, and the pooled consensus and variant bases."""
    if len(dst) == 0:
        return pd.DataFrame()
    key = ["scaffold", "position"]
    acgt = ["A", "C", "T", "G"]
    d = pd.DataFrame({"scaffold": dst["scaffold"].to_numpy(),
                      "position": dst.index.get_level_values(1).to_numpy()})
    vals = dst[acgt].to_numpy(dtype=np.int64)
    d[acgt] = vals
    d["x5"] = vals.sum(axis=1) >= 5
    d["xd"] = (vals > 0).any(axis=1)
    g = d.groupby(key, sort=True)
    mdb = g[acgt].sum()
    mdb["depth"] = mdb[acgt].sum(axis=1)

    # the samples' own rows of each scaffold, in sample order within a
    # position (a stable sort keeps it)
    cdb = pd.concat([t[t["scaffold"].isin(name2scaffs[name])]
                     for name, t in name2snp.items()])
    cdb = cdb.sort_values(key, kind="stable")
    bdb = (cdb[key + ["ref_base"]].drop_duplicates().set_index(key))
    ccdb = (cdb.groupby(key + ["class"]).size().unstack(fill_value=0)
            .reindex(columns=_CLASSES, fill_value=0).astype(int))
    ccdb.columns = [c + "_count" for c in _CLASSES]
    dedb = pd.DataFrame({"sample_5x_detections": g["x5"].sum(),
                         "sample_detections": g["xd"].sum()})
    dedb = dedb[(dedb["sample_5x_detections"] > 0) &
                (dedb["sample_detections"] > 0)]
    mdb = (mdb.join(bdb, how="inner").join(dedb).join(ccdb)
           .join(_sample_con_bases(cdb, key)))
    mdb = mdb.astype({c: int for c in acgt + ["depth", "sample_detections",
                                                "sample_5x_detections"] +
                      list(ccdb.columns)})
    # the consensus base is the first base of the most counts, the
    # variant base the first of the most among the other three (the
    # reference's row loop, polymorpher.py:540-549)
    counts = mdb[acgt].to_numpy()
    con = counts.argmax(axis=1)
    mdb["con_base"] = _C2P_ARR[con]
    counts[np.arange(len(con)), con] = 0
    mdb["var_base"] = _C2P_ARR[counts.argmax(axis=1)]
    mdb = mdb.reset_index().set_index("position")
    mdb.index.name = None
    return mdb[acgt + ["scaffold", "depth", "ref_base",
                       "sample_5x_detections", "sample_detections"] +
               list(ccdb.columns) + ["sample_con_bases", "con_base",
                                     "var_base"]]


def _sample_con_bases(cdb: pd.DataFrame, key) -> pd.DataFrame:
    """Per (scaffold, position), the text of its samples' distinct
    consensus bases in sample order: the reference's
    cdb.groupby("position")["con_base"].unique().astype(str). The text of
    each distinct tuple of bases is made by that pandas expression on the
    rows of one position that has it (it prints the array's type, so it
    is taken from pandas rather than written out here), and reused."""
    k = cdb[key].to_numpy()
    con = cdb["con_base"].to_numpy(dtype=object)
    new = np.r_[True, (k[1:] != k[:-1]).any(axis=1)]
    starts = np.flatnonzero(new)
    ends = np.r_[starts[1:], len(k)]
    cache: Dict[tuple, str] = {}
    texts = []
    for a, b in zip(starts, ends):
        bases = tuple(dict.fromkeys(con[a:b]))
        if bases not in cache:
            cache[bases] = (cdb.iloc[a:b].groupby("position")["con_base"]
                            .unique().astype(str).iloc[0])
        texts.append(cache[bases])
    return pd.DataFrame({"sample_con_bases": texts},
                        index=pd.MultiIndex.from_arrays(
                            [k[starts, 0], k[starts, 1]], names=key))
