"""
dRep-style strain clustering from genome-level popANI (reference:
inStrain/compare_utils.py:169-284) — the counterpart of
instrain_tpu/compare/clustering.py, scipy's hierarchy as there.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np
import pandas as pd
import scipy.cluster.hierarchy
import scipy.spatial.distance


def add_av_rc(db, v1="popANI", v2="percent_compared",
              n1="av_ani", n2="av_cov") -> pd.DataFrame:
    """Symmetrize pairwise values (reference: add_av_RC, 169-203)."""
    combo1 = defaultdict(lambda: np.nan)
    combo2 = defaultdict(lambda: np.nan)
    for _, row in db.iterrows():
        combo1[f"{row['name1']}-vs-{row['name2']}"] = row[v1]
        combo2[f"{row['name1']}-vs-{row['name2']}"] = row[v2]
    table = defaultdict(list)
    samples = set(db["name1"]) | set(db["name2"])
    for s1 in samples:
        for s2 in samples:
            table["name1"].append(s1)
            table["name2"].append(s2)
            if s1 == s2:
                table[n1].append(1)
                table[n2].append(1)
            else:
                table[n1].append(np.nanmean(
                    [combo1[f"{s1}-vs-{s2}"], combo1[f"{s2}-vs-{s1}"]]))
                table[n2].append(np.nanmean(
                    [combo2[f"{s1}-vs-{s2}"], combo2[f"{s2}-vs-{s1}"]]))
    return pd.DataFrame(table)


def cluster_genome_strains(mdb: pd.DataFrame, cfg) -> pd.DataFrame:
    """reference: cluster_genome_strains (205-255)."""
    method = cfg.clusterAlg
    thresh = 1 - cfg.ani_threshold
    cov_thresh = cfg.coverage_treshold

    cdbs = []
    cluster_num = 1
    for genome, gdb in mdb.groupby("genome"):
        edb = gdb[gdb["compared_bases_count"] == 0]
        if len(edb) > 0:
            logging.error(f"Cannot cluster genome {genome}; {len(edb)} of "
                          f"{len(gdb)} comparisons have no overlap")
            continue
        gdb = add_av_rc(gdb)
        gdb["dist"] = 1 - gdb["av_ani"]
        gdb["dist"] = [1 if c < cov_thresh else d
                       for d, c in zip(gdb["dist"], gdb["av_cov"])]
        db = gdb.pivot(index="name1", columns="name2", values="dist")
        names = db.columns
        arr = scipy.spatial.distance.squareform(np.asarray(db), checks=True)
        linkage = scipy.cluster.hierarchy.linkage(arr, method=method)
        fclust = scipy.cluster.hierarchy.fcluster(linkage, thresh,
                                                  criterion="distance")
        cdb = pd.DataFrame({"cluster": fclust, "sample": list(names)})
        cdb["genome"] = genome
        cdb["cluster"] = [f"{cluster_num}_{x}" for x in cdb["cluster"]]
        cluster_num += 1
        cdbs.append(cdb)
    if not cdbs:
        return pd.DataFrame()
    return pd.concat(cdbs).reset_index(drop=True)
