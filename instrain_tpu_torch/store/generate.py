"""
User-facing output table generation for `profile` (reference:
SNVprofile.generate, SNVprofile.py:192-443) with the exact column orders,
plus the non-redundant (highest-mm) views (SNVprofile.py:471-548). The
counterpart of instrain_tpu/store/generate.py for the tables this port
writes: profile's (SNVs, scaffold_info, linkage, gene_info,
mapping_info), the genome-wide genome_info, and compare's
(comparisonsTable, pairwise_SNP_locations, pooled_SNV_info,
pooled_SNV_data and its keys).
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Optional

import numpy as np
import pandas as pd

from .profile_dir import ProfileDir

COLUMN_ORDERS = {
    "SNVs": ["scaffold", "position", "position_coverage", "allele_count",
             "ref_base", "con_base", "var_base",
             "ref_freq", "con_freq", "var_freq",
             "A", "C", "T", "G",
             "gene", "mutation", "mutation_type", "cryptic"],
    "scaffold_info": ["scaffold", "length", "coverage", "breadth",
                      "nucl_diversity",
                      "coverage_median", "coverage_std", "coverage_SEM",
                      "breadth_minCov", "breadth_expected",
                      "nucl_diversity_median",
                      "nucl_diversity_rarefied",
                      "nucl_diversity_rarefied_median",
                      "breadth_rarefied",
                      "conANI_reference", "popANI_reference",
                      "SNS_count", "SNV_count", "divergent_site_count"],
    "linkage": ["scaffold", "position_A", "position_B", "distance",
                "r2", "d_prime",
                "r2_normalized", "d_prime_normalized",
                "allele_A", "allele_a",
                "allele_B", "allele_b",
                "countab", "countAb", "countaB", "countAB", "total"],
    "gene_info": ["scaffold", "gene", "gene_length",
                  "coverage", "breadth", "breadth_minCov", "nucl_diversity",
                  "start", "end", "direction", "partial",
                  "dNdS_substitutions", "pNpS_variants",
                  "SNV_count", "SNV_S_count", "SNV_N_count",
                  "SNS_count", "SNS_S_count", "SNS_N_count",
                  "divergent_site_count"],
    "genome_info": ["genome", "coverage", "breadth", "nucl_diversity",
                    "length", "true_scaffolds", "detected_scaffolds",
                    "coverage_median", "coverage_std", "coverage_SEM",
                    "breadth_minCov", "breadth_expected",
                    "nucl_diversity_rarefied",
                    "conANI_reference", "popANI_reference",
                    "iRep", "iRep_GC_corrected",
                    "linked_SNV_count", "SNV_distance_mean", "r2_mean",
                    "d_prime_mean",
                    "consensus_divergent_sites",
                    "population_divergent_sites",
                    "SNS_count", "SNV_count",
                    "filtered_read_pair_count",
                    "reads_unfiltered_pairs",
                    "reads_mean_PID"],
    "mapping_info": ["scaffold", "pass_pairing_filter", "filtered_pairs"],
    "pairwise_SNP_locations": [
        "mm", "scaffold", "position", "name1", "name2",
        "consensus_SNP", "population_SNP",
        "con_base_1", "ref_base_1", "var_base_1", "position_coverage_1",
        "A_1", "C_1", "T_1", "G_1",
        "con_base_2", "ref_base_2", "var_base_2", "position_coverage_2",
        "A_2", "C_2", "T_2", "G_2"],
    "pooled_SNV_info": ["scaffold", "position", "depth", "A", "C", "T", "G",
                        "ref_base", "con_base", "var_base",
                        "sample_detections", "sample_5x_detections",
                        "DivergentSite_count", "SNS_count", "SNV_count",
                        "con_SNV_count", "pop_SNV_count"],
}


def reorder_columns(db: pd.DataFrame, order) -> pd.DataFrame:
    if db is None or len(db) == 0:
        return db
    cols = [c for c in order if c in db.columns]
    extra = [c for c in db.columns if c not in order]
    return db[cols + extra]


# ---------- non-redundant views ----------

def nonredundant(db: Optional[pd.DataFrame], subset,
                 drop_cryptic: bool = False) -> pd.DataFrame:
    """sort by mm, keep the highest-mm row per key
    (reference: SNVprofile.py:471-522)."""
    if db is None or len(db) == 0:
        return pd.DataFrame()
    if drop_cryptic and "cryptic" in db:
        db = db[db["cryptic"] == False]  # noqa: E712
    return (db.sort_values("mm")
              .drop_duplicates(subset=subset, keep="last")
              .sort_index().drop(columns=["mm"]))


def nonredundant_snv_table(isdir: ProfileDir) -> pd.DataFrame:
    return nonredundant(isdir.get("cumulative_snv_table"),
                        ["scaffold", "position"], drop_cryptic=True)


def nonredundant_scaffold_table(isdir: ProfileDir) -> pd.DataFrame:
    return nonredundant(isdir.get("cumulative_scaffold_table"), ["scaffold"])


def nonredundant_linkage_table(isdir: ProfileDir) -> pd.DataFrame:
    return nonredundant(isdir.get("raw_linkage_table"),
                        ["scaffold", "position_A", "position_B"])


def nonredundant_rc_table(isdir: ProfileDir) -> pd.DataFrame:
    return nonredundant(isdir.get("comparisonsTable"),
                        ["scaffold", "name1", "name2"])


# ---------- generate ----------

_NONREDUNDANT = {
    "SNVs": nonredundant_snv_table,
    "scaffold_info": nonredundant_scaffold_table,
    "linkage": nonredundant_linkage_table,
    "comparisonsTable": nonredundant_rc_table,
}


def _write(isdir: ProfileDir, name: str, db: pd.DataFrame,
           force_compress: bool) -> None:
    ft = ".tsv.gz" if (len(db) > 1e6 or force_compress) else ".tsv"
    db.to_csv(isdir.get_output_base() + name + ft, index=False, sep="\t")


def generate(isdir: ProfileDir, name: str, mm_level: bool = False,
             force_compress: bool = False, store: bool = True,
             return_table: bool = False):
    """Write <output>/<base>_<name>.tsv in the reference's schema (unless
    not store) and return the table if return_table. mm_level keeps
    every mm level of genome_info and pairwise_SNP_locations instead of
    the highest."""
    if name == "mapping_info":
        from ..profile.filter_reads import write_mapping_info
        db = isdir.get("mapping_info")
        if store and db is not None:
            ft = ".tsv.gz" if force_compress else ".tsv"
            location = isdir.get_output_base() + name + ft
            if os.path.exists(location):
                os.remove(location)
            write_mapping_info(
                reorder_columns(db, COLUMN_ORDERS["mapping_info"]),
                location, isdir.get("mapping_info_values"))
        return db if return_table else None
    if name == "pooled_SNV_data":
        db = _generate_pooled_data(isdir, store, force_compress)
        return db if return_table else None

    if name in _NONREDUNDANT:
        db = _NONREDUNDANT[name](isdir)
        if name == "SNVs":
            mdb = isdir.get("SNP_mutation_types")
            if mdb is not None and len(mdb) > 0 and len(db) > 0:
                mdb = mdb[["scaffold", "position", "mutation_type",
                           "mutation", "gene"]]
                db = pd.merge(db, mdb, how="left",
                              on=["scaffold", "position"])
        if name in COLUMN_ORDERS:
            db = reorder_columns(db, COLUMN_ORDERS[name])
    elif name == "gene_info":
        db = _gene_info(isdir)
        if db is None:
            return None
    elif name == "genome_info":
        db = _genome_info(isdir.get("genome_level_info"), mm_level)
    elif name == "pairwise_SNP_locations":
        db = reorder_columns(isdir.get("pairwise_SNP_locations"),
                             COLUMN_ORDERS[name])
        if db is not None and not mm_level and len(db) > 0:
            db = (db.sort_values("mm")
                    .drop_duplicates(subset=["scaffold", "position",
                                             "name1", "name2"], keep="last")
                    .sort_index().drop(columns=["mm"]))
    elif name == "pooled_SNV_info":
        db = isdir.get("PMdb")
        if db is not None:
            # PMdb's (unnamed) index is the position (reference:
            # SNVprofile.py:373-375 assigns it explicitly)
            db["position"] = db.index
            db = reorder_columns(db.reset_index(drop=True),
                                 COLUMN_ORDERS[name])
    else:
        raise ValueError(f"do not know how to generate {name}")

    if db is None:
        logging.info(f"Could not create {name}")
        return None
    if store:
        _write(isdir, name, db, force_compress)
    return db if return_table else None


def _gene_info(isdir: ProfileDir) -> Optional[pd.DataFrame]:
    """gene_info: the gene table with each per-gene table at its highest
    mm, genes without coverage left out (instrain_tpu/store/generate.py:
    146-164); None where no genes were profiled."""
    gdb = isdir.get("genes_table")
    if gdb is None:
        logging.info("Cannot generate genes_table; no genes profiled")
        return None
    for thing in ["genes_coverage", "genes_clonality", "genes_SNP_count"]:
        db2 = isdir.get(thing)
        if db2 is None or len(db2) == 0:
            continue
        db2 = db2.sort_values("mm").drop_duplicates(subset=["gene"],
                                                    keep="last")
        del db2["mm"]
        gdb = pd.merge(gdb, db2, on="gene", how="left")
    for c in ["N_sites", "S_sites"]:
        if c in gdb.columns:
            del gdb[c]
    db = reorder_columns(gdb, COLUMN_ORDERS["gene_info"])
    if db is not None and len(db) > 0 and "coverage" in db:
        db = db[db["coverage"] > 0]
    return db


def _genome_info(db: Optional[pd.DataFrame], mm_level: bool):
    """genome_info from genome_level_info (instrain_tpu/store/generate.py:
    166-180)."""
    db = reorder_columns(db, COLUMN_ORDERS["genome_info"])
    if db is None:
        return None
    read_cols = [c for c in db.columns if c.startswith("reads_")]
    keep = [c for c in read_cols if c in
            ["reads_unfiltered_reads", "reads_unfiltered_pairs",
             "reads_mean_PID"]]
    for c in set(read_cols) - set(keep):
        del db[c]
    if not mm_level and "mm" in db.columns:
        db = (db.sort_values("mm")
                .drop_duplicates(subset=["genome"], keep="last")
                .sort_values("genome"))
        del db["mm"]
    return db


def _generate_pooled_data(isdir: ProfileDir, store: bool,
                          force_compress: bool) -> Optional[pd.DataFrame]:
    """pooled_SNV_data and its keys table (reference:
    SNVprofile.py:377-421)."""
    DSTdb = isdir.get("DSTdb")
    if DSTdb is None:
        return None
    sa2k = {s: i for i, s in enumerate(set(DSTdb.index.get_level_values(0)))}
    sc2k = {s: i for i, s in enumerate(set(DSTdb["scaffold"]))}
    db = DSTdb.copy()
    db["sample"] = [sa2k[s] for s in DSTdb.index.get_level_values(0)]
    db["scaffold"] = db["scaffold"].map(sc2k).astype(int)
    db["position"] = DSTdb.index.get_level_values(1).astype(int)
    db = db.reset_index(drop=True)
    db = db[["sample", "scaffold", "position", "A", "C", "T", "G"]]

    table = defaultdict(list)
    k2sa = {v: k for k, v in sa2k.items()}
    k2sc = {v: k for k, v in sc2k.items()}
    for i in sorted(set(k2sa) | set(k2sc)):
        table["key"].append(i)
        table["sample"].append(k2sa.get(i, np.nan))
        table["scaffold"].append(k2sc.get(i, np.nan))
    if store:
        _write(isdir, "pooled_SNV_data_keys", pd.DataFrame(table),
               force_compress)
        _write(isdir, "pooled_SNV_data", db, force_compress)
    return db
