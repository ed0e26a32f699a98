"""
parse_annotations: aggregate gene annotations across samples — the
counterpart of instrain_tpu/compare/annotations.py (reference:
inStrain/parse_annotations.py). Host pandas over the gene_info and
genome_info outputs of gene-profiled profiles.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Dict, List, Set

import pandas as pd

from ..store.profile_dir import ProfileDir


def load_annotation_table(locs) -> Dict[str, Set[str]]:
    """CSV(s) with columns gene,anno -> gene -> set of annotations
    (reference: load_annotation_table2, 164-202). A line without exactly
    two fields is logged and skipped."""
    gene2annos: Dict[str, Set[str]] = {}
    if not isinstance(locs, list):
        locs = [locs]
    for loc in locs:
        with open(loc) as f:
            header = [c.strip() for c in next(f).split(",")]
            for c in ("gene", "anno"):
                if c not in header:
                    raise ValueError(
                        f"required column {c} not in annotation table {loc}")
            for line in f:
                lw = [l.strip() for l in line.split(",")]
                if len(lw) != 2:
                    logging.error(f"The line {line!r} cannot be parsed!")
                    continue
                gene2annos.setdefault(lw[0], set()).add(lw[1])
    return gene2annos


def _load_output(isdir: ProfileDir, name: str) -> pd.DataFrame:
    try:
        return isdir.load_output(name)
    except AssertionError:
        return pd.DataFrame()


def filter_gene_table(gdb, genomes=None, stb=None, min_gene_breadth=0.5):
    """reference: filter_gene_table (204-215)."""
    db = gdb[gdb["coverage"] > 0]
    db = db[db["breadth"] >= min_gene_breadth]
    if genomes is not None:
        db = db.copy()
        db["genome"] = db["scaffold"].map(stb)
        db = db[db["genome"].isin(genomes)]
    return db


def parse_annotations(inputs: List[str], annotations: List[str],
                      output: str, min_genome_breadth: float = 0.5,
                      min_gene_breadth: float = 0.8,
                      store_rawdata: bool = False) -> ProfileDir:
    """The parse_annotations operation (reference: PAController)."""
    od = ProfileDir(output)
    gene2anno = load_annotation_table(annotations)

    gdbs, names = [], []
    for loc in inputs:
        isdir = ProfileDir(loc)
        gdb = _load_output(isdir, "gene_info")
        if len(gdb) == 0:
            logging.error(f"{loc} has no gene_info output")
            continue
        gdb = gdb.copy()
        gdb["annos"] = gdb["gene"].map(gene2anno)
        name = os.path.basename(str(isdir.get("bam_loc")))
        if min_genome_breadth > 0:
            genome_db = _load_output(isdir, "genome_info")
            stb = isdir.get("scaffold2bin")
            if len(genome_db) > 0:
                genomes = set(genome_db[
                    genome_db["breadth"] >= min_genome_breadth]["genome"])
            else:
                logging.error("No genomes detected in this sample!")
                genomes = []
        else:
            genomes, stb = None, None
        gdbs.append(filter_gene_table(gdb, genomes, stb, min_gene_breadth))
        names.append(name)

    sdb = calculate_gene_sum_stats(gdbs, names)
    s2a2g2vals = calculate_annotation_counts(gdbs, names)
    metric2table = create_annotation_tables(sdb, s2a2g2vals)

    if store_rawdata:
        od.store("gene2anno", {g: sorted(a) for g, a in gene2anno.items()},
                 "dictionary", "Dictionary of genes 2 annotations")
    outloc = od.get_location("output")
    sdb.to_csv(outloc + "SampleAnnotationTotals.csv", index=False)
    m2n = {"long_data": "LongFormData.csv"}
    for metric, table in metric2table.items():
        name = m2n.get(metric, "ParsedGeneAnno_" + metric + ".csv")
        table.to_csv(outloc + name, index=False)
    return od


def calculate_gene_sum_stats(gdbs, names) -> pd.DataFrame:
    """reference: calculate_gene_sum_stats (217-237)."""
    table = defaultdict(list)
    for db, name in zip(gdbs, names):
        db = db.copy()
        db["gene_length"] = abs(db["end"] - db["start"]) + 1
        db["mb"] = (db["gene_length"] * db["coverage"]).astype(int)
        table["sample"].append(name)
        table["detected_genes"].append(len(db))
        if "genome" in db.columns:
            table["detected_genomes"].append(len(db["genome"].unique()))
        table["bases_mapped_to_genes"].append(int(db["mb"].sum()))
        table["detected_annotations"].append(
            sum(len(a) for a in db["annos"] if a == a))
        table["detected_genes_with_anno"].append(
            len(db[~db["annos"].isna()]))
    return pd.DataFrame(table)


def calculate_annotation_counts(gdbs, names):
    """reference: calculate_annotation_counts2 (264-291)."""
    s2a2g2vals = {}
    for db, name in zip(gdbs, names):
        db = db.copy()
        db["gene_length"] = abs(db["end"] - db["start"]) + 1
        db["mb"] = (db["gene_length"] * db["coverage"]).astype(int)
        a2g2vals = {}
        for _, row in db[~db["annos"].isna()].iterrows():
            g = row["genome"] if "genome" in row else None
            for k in row["annos"]:
                a2g2vals.setdefault(k, {})
                if g in a2g2vals[k]:
                    a2g2vals[k][g][1] += 1
                    a2g2vals[k][g][2] += row["mb"]
                else:
                    a2g2vals[k][g] = [{g}, 1, row["mb"]]
        s2a2g2vals[name] = a2g2vals
    return s2a2g2vals


def create_annotation_tables(sdb, s2a2g2vals):
    """reference: create_annotation_tables2 (367-443)."""
    metrics = (["genes", "bases", "genomes"]
               if "detected_genomes" in sdb.columns else ["genes", "bases"])
    metric2table = {m: defaultdict(list) for m in metrics}
    total_kos = set()
    for a2g2vals in s2a2g2vals.values():
        total_kos |= set(a2g2vals)
    for sample, a2g2vals in s2a2g2vals.items():
        for m in metrics:
            metric2table[m]["sample"].append(sample)
        for ko in sorted(total_kos):
            if ko in a2g2vals:
                genomes = len(a2g2vals[ko])
                genes = sum(v[1] for v in a2g2vals[ko].values())
                bases = sum(v[2] for v in a2g2vals[ko].values())
            else:
                genomes = genes = bases = 0
            vals = {"genes": genes, "bases": bases, "genomes": genomes}
            for m in metrics:
                metric2table[m][ko].append(vals[m])
    for m in metrics:
        metric2table[m] = pd.DataFrame(metric2table[m])
    norms = {"genes": "detected_genes", "bases": "bases_mapped_to_genes",
             "genomes": "detected_genomes"}
    for m in metrics:
        s2norm = sdb.set_index("sample")[norms[m]].to_dict()
        db = metric2table[m].copy()
        for ko in total_kos:
            db[ko] = [x / s2norm[s] if s2norm[s] != 0 else 0
                      for x, s in zip(db[ko], db["sample"])]
        metric2table[m + "_fraction"] = db
    # long-form table
    table = defaultdict(list)
    for sample, a2g2vals in s2a2g2vals.items():
        for a, g2vals in a2g2vals.items():
            for g, vals in g2vals.items():
                table["sample"].append(sample)
                table["anno"].append(a)
                table["genome"].append(g)
                table["genes"].append(vals[1])
                table["bases"].append(vals[2])
    metric2table["long_data"] = pd.DataFrame(table)
    return metric2table
