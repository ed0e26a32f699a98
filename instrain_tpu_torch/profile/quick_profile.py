"""
quick_profile: fast genome coverage/breadth estimates
(reference: inStrain/quickProfile.py, which shells out to coverM; here the
native decoder computes the same contig metrics directly — no external
binary needed). The counterpart of instrain_tpu/profile/quick_profile.py:
host numpy over this package's decoder, no device work. Writes
coverm_raw.tsv, genomeCoverage.csv and scaffolds.txt into the output
directory.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List, Optional

import numpy as np
import pandas as pd

from ..io import fasta as fasta_io
from ..io.bam import decode_bam
from ..io.stb import load_scaff2bin


def quick_profile(bam_path: str, fasta_path: str,
                  stb: Optional[List[str]] = None,
                  output: Optional[str] = None,
                  breadth_cutoff: float = 0.5,
                  stringent_breadth_cutoff: float = 0.0,
                  threads: int = 6) -> pd.DataFrame:
    if output is None:
        output = os.path.basename(bam_path)[:-4]
    os.makedirs(output, exist_ok=True)
    if not output.endswith("/"):
        output += "/"

    seqs = fasta_io.read_fasta(fasta_path)
    s2l = {n: len(s) for n, s in seqs.items()}
    s2b = load_scaff2bin(stb, s2l)
    if not s2b:
        s2b = {s: "all_scaffolds" for s in s2l}
    genome2length = defaultdict(int)
    for scaffold, length in s2l.items():
        if scaffold in s2b:
            genome2length[s2b[scaffold]] += length

    # contig metrics from the decoder (mean / covered bases / read count,
    # matching coverm contig -m mean covered_bases length count)
    bam = decode_bam(bam_path, baq=False, tweak_overlaps=False,
                     threads=threads)
    rows = []
    primary = (bam.flag & 0x904) == 0  # mapped, primary, non-supplementary
    for rid, name in enumerate(bam.ref_names):
        if name not in s2l:
            continue
        L = s2l[name]
        recs = np.nonzero((bam.ref_id == rid) & primary)[0]
        if len(recs) == 0:
            continue
        # bulk event gather + one bincount per scaffold, not a
        # per-record np.add.at loop
        starts = bam.ev_off[recs].astype(np.int64)
        lens = bam.ev_len[recs].astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            rows.append({"Contig": name, "Mean": 0.0, "Covered Bases": 0,
                         "Length": L, "Read Count": len(recs)})
            continue
        ends = starts + lens
        if total == int(ends[-1] - starts[0]):
            evp = bam.ev_pos[starts[0]:ends[-1]]   # contiguous: no copy
        else:
            offs = np.repeat(
                starts - np.concatenate(([0], np.cumsum(lens)[:-1])),
                lens)
            evp = bam.ev_pos[offs + np.arange(total, dtype=np.int64)]
        cov = np.bincount(evp, minlength=L)
        covered = int((cov > 0).sum())
        rows.append({"Contig": name, "Mean": cov.sum() / L,
                     "Covered Bases": covered, "Length": L,
                     "Read Count": len(recs)})
    cdb = pd.DataFrame(rows)
    if len(cdb) and stringent_breadth_cutoff > 0:
        cdb = cdb[cdb["Covered Bases"] / cdb["Length"] >
                  stringent_breadth_cutoff]
    cdb.to_csv(output + "coverm_raw.tsv", sep="\t", index=False)

    # genome rollup (reference: parse_coverm, quickProfile.py:98-132)
    cdb = cdb.copy()
    cdb["genome"] = cdb["Contig"].map(s2b)
    table = defaultdict(list)
    for genome, db in cdb.groupby("genome"):
        gl = genome2length[genome]
        table["genome"].append(genome)
        table["length"].append(gl)
        table["breadth"].append(db["Covered Bases"].sum() / gl)
        table["coverage"].append(
            float((db["Mean"] * db["Length"]).sum()) / gl)
        table["reads"].append(int(db["Read Count"].sum()))
    cgdb = pd.DataFrame(table)
    cgdb.to_csv(output + "genomeCoverage.csv", index=False)

    if len(cgdb) > 0:
        genomes = set(cgdb[cgdb["breadth"] >= breadth_cutoff]["genome"])
        with open(output + "scaffolds.txt", "w") as f:
            for scaffold, b in s2b.items():
                if b in genomes:
                    f.write(scaffold + "\n")
    return cgdb
