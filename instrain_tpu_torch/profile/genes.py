"""
Gene-level profiling — the counterpart of instrain_tpu/profile/genes.py
(reference: inStrain/GeneProfile.py). Host numpy and pandas: it reads
what the profile engines already brought to the host and adds no device
work.

Parses prodigal .fna / GenBank gene files, computes per-gene per-mm
coverage, clonality and SNP counts, classifies SNVs as synonymous /
non-synonymous / intergenic / in more than one gene by codon
translation, and derives dN/dS (substitutions) and pN/pS (variants).

The reference's quirks, kept byte for byte:
  - direction is compared against the string '-1'
    (GeneProfile.py:666,682), so GenBank genes, whose strands are the
    integers +-1, never take the reverse-complement branch
  - the mutation label uses the nucleotide offset within the gene
    (GeneProfile.py:694-698)
  - gene SNV counts use allele_count == 2 exactly (GeneProfile.py:578)

The reference's per-row loops lie on profile's main path and are
vectorised here with the same arithmetic: count_sites sums a per-codon
table in codon order; the per-gene coverage and clonality come from one
native pass over a scaffold's positions per mm level (gene_range_sums);
the SNV counts take all genes of an mm level at once; characterize_snps
translates only the codon an SNV changes.
"""

from __future__ import annotations

import ctypes as ct
import functools
import logging
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from ..io import fasta as fasta_io
from ..io.bam import _load_lib
from ..obs import spans

# ---------------- codon machinery ----------------

_BASES = "TCAG"
_AAS = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRR"
        "IIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
CODON_TABLE: Dict[str, str] = {}
STOP_CODONS: List[str] = []
for _i, (_b1, _b2, _b3) in enumerate(
        [(a, b, c) for a in _BASES for b in _BASES for c in _BASES]):
    _codon = _b1 + _b2 + _b3
    if _AAS[_i] == "*":
        STOP_CODONS.append(_codon)
    CODON_TABLE[_codon] = _AAS[_i]

_COMP = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")

# codepoint -> index in _BASES (U reads as T, either case); -1 elsewhere
_BASE_IDX = np.full(256, -1, dtype=np.int64)
for _i, _b in enumerate(_BASES):
    _BASE_IDX[ord(_b)] = _BASE_IDX[ord(_b.lower())] = _i
_BASE_IDX[ord("U")] = _BASE_IDX[ord("u")] = 0


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def translate(seq: str) -> str:
    """Standard-table translation, stops as '*', X for ambiguous codons."""
    aas = []
    for i in range(0, len(seq) - len(seq) % 3, 3):
        aas.append(CODON_TABLE.get(seq[i:i + 3].upper(), "X"))
    return "".join(aas)


@functools.lru_cache(maxsize=None)
def _codon_sites(k: float) -> np.ndarray:
    """[65, 2] synonymous / non-synonymous sites of each codon (index
    16 * b1 + 4 * b2 + b3 over _BASES) with transversions weighted by k,
    normalized to 3 sites; row 64 and stop codons are 0 (codons that
    count_sites skips)."""
    purine = ("A", "G")
    pyrimidine = ("T", "C")
    out = np.zeros((65, 2))
    for ci, codon in enumerate(CODON_TABLE):
        if codon in STOP_CODONS:
            continue
        aa = CODON_TABLE[codon]
        s = n = 0.0
        for pos_in_codon, orig in enumerate(codon):
            for sub in "ATCG":
                if sub == orig:
                    continue
                transition = ((orig in purine and sub in purine) or
                              (orig in pyrimidine and sub in pyrimidine))
                w = 1.0 if transition else k
                neighbor = (codon[:pos_in_codon] + sub +
                            codon[pos_in_codon + 1:])
                if neighbor in STOP_CODONS:
                    n += w
                elif CODON_TABLE[neighbor] == aa:
                    s += w
                else:
                    n += w
        norm = (n + s) / 3.0
        if norm > 0:
            out[ci] = (s / norm, n / norm)
    return out


def count_sites(seq: str, k: float = 1.0) -> Tuple[float, float]:
    """
    Synonymous / non-synonymous site counts per codon with transversions
    weighted by k, normalized to 3 sites per codon
    (reference: GeneProfile.count_sites, 448-512). Codons with a base
    outside ACGTU (N, '-') and stop codons add nothing; the per-codon
    sites are summed in codon order, as the reference's loop adds them.
    """
    n = len(seq) - len(seq) % 3
    if n == 0:
        return 0.0, 0.0
    cp = np.frombuffer(seq[:n].encode("utf-32-le"), dtype=np.uint32)
    b = _BASE_IDX[np.minimum(cp, 255)].reshape(-1, 3)
    idx = np.where((b >= 0).all(axis=1), b[:, 0] * 16 + b[:, 1] * 4 + b[:, 2],
                   64)
    sums = np.cumsum(_codon_sites(k)[idx], axis=0)[-1]
    return float(sums[0]), float(sums[1])


# ---------------- gene file parsing ----------------

@dataclass
class GeneData:
    gene_table: pd.DataFrame                  # all scaffolds concatenated
    scaff2genes: Dict[str, pd.DataFrame]
    gene2sequence: Dict[str, str]


def parse_genes(path: str) -> GeneData:
    """Dispatch on extension (reference: GeneProfile.parse_genes)."""
    if path.endswith(".fna") or path.endswith(".fa"):
        return parse_prodigal_genes(path)
    if path.endswith(".gb") or path.endswith(".gbk"):
        return parse_genbank_genes(path)
    raise ValueError(f"do not know how to parse gene file {path}")


def _gene_data(scaff2rows: Dict[str, list],
               gene2seq: Dict[str, str]) -> GeneData:
    scaff2genes = {s: pd.DataFrame(rows) for s, rows in scaff2rows.items()}
    gene_table = (pd.concat(scaff2genes.values()).reset_index(drop=True)
                  if scaff2genes else pd.DataFrame())
    return GeneData(gene_table, scaff2genes, gene2seq)


def parse_prodigal_genes(path: str) -> GeneData:
    """
    Prodigal .fna headers: >gene # start # end # strand # meta
    (1-based inclusive -> converted to 0-based;
    reference: GeneProfile.py:770-811).
    """
    scaff2rows: Dict[str, list] = defaultdict(list)
    gene2seq: Dict[str, str] = {}
    name = None
    desc = None
    chunks: List[str] = []

    def flush():
        if name is None:
            return
        seq = "".join(chunks)
        parts = desc.split("#")
        start = int(parts[1].strip()) - 1
        end = int(parts[2].strip()) - 1
        scaff = "_".join(name.split("_")[:-1])
        scaff2rows[scaff].append(dict(
            gene=name, scaffold=scaff,
            direction=parts[3].strip(),
            partial="partial=01" in desc,
            start=start, end=end))
        gene2seq[name] = seq
        if (end - start) + 1 != len(seq):
            logging.error(f"ERROR PARSING GENE {name}; start={start} "
                          f"end={end} length={len(seq)}")

    with fasta_io._open(path) as f:
        for raw in f:
            line = raw.decode().rstrip()
            if line.startswith(">"):
                flush()
                desc = line[1:]
                name = desc.split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    flush()
    return _gene_data(scaff2rows, gene2seq)


def parse_genbank_genes(path: str, gene_name: str = "gene") -> GeneData:
    """Minimal GenBank CDS parser (reference: GeneProfile.py:813-850)."""
    scaff2rows: Dict[str, list] = defaultdict(list)
    gene2seq: Dict[str, str] = {}
    with open(path) as f:
        text = f.read()
    for record in text.split("//\n"):
        if "LOCUS" not in record:
            continue
        m = re.search(r"^VERSION\s+(\S+)", record, re.M)
        if not m:
            m = re.search(r"^LOCUS\s+(\S+)", record, re.M)
        scaffold = m.group(1)
        origin = record.split("ORIGIN")[-1]
        seq = "".join(re.findall("[a-zA-Z]+", origin)).upper()

        for fm in re.finditer(
                r"^ {5}CDS {13}(.+?)(?=^ {5}\S|^ORIGIN)", record,
                re.M | re.S):
            block = fm.group(1)
            header = block.splitlines()[0].strip()
            # continuation lines of the location
            loc_str = header
            for line in block.splitlines()[1:]:
                ls = line.strip()
                if ls.startswith("/"):
                    break
                loc_str += ls
            gm = re.search(r'/%s="([^"]+)"' % gene_name, block)
            if not gm:
                continue
            gene = gm.group(1)
            compound = "join" in loc_str
            strand = -1 if "complement" in loc_str else 1
            spans = [(int(a) - 1, int(b) - 1) for a, b in
                     re.findall(r"<?(\d+)\.\.>?(\d+)", loc_str)]
            if not spans:
                continue
            start = min(s for s, _ in spans)
            end = max(e for _, e in spans)
            gseq = "".join(seq[s:e + 1] for s, e in spans)
            if strand == -1:
                gseq = revcomp(gseq)
            scaff2rows[scaffold].append(dict(
                gene=gene, scaffold=scaffold, direction=strand,
                partial="compound" if compound else False,
                start=start, end=end))
            gene2seq[gene] = gseq
    return _gene_data(scaff2rows, gene2seq)


# ---------------- per-scaffold gene profiling ----------------

def profile_genes_for_scaffold(scaffold: str, gene_data: GeneData, stats,
                               cumulative_snv_table: pd.DataFrame):
    """
    reference: GeneProfile.profile_genes_from_profile (304-350).
    `stats` is the scaffold's host-side stats from any engine: the dense
    ScaffoldStats, or the hybrid and batch engines' CompactStats.
    Returns (coverage, clonality, SNP_counts, SNP_mutation_types) tables.
    Its spans (obs/spans.py) time the steps genes.coverage,
    genes.mutations and genes.counts.
    """
    gdb = gene_data.scaff2genes[scaffold]
    with spans.span("genes.coverage"):
        sums = gene_range_sums(gdb, stats)
        cdb = calc_gene_coverage(sums)
        cldb = calc_gene_clonality(sums)
    with spans.span("genes.mutations"):
        sdb = characterize_snps_wrapper(cumulative_snv_table, gdb,
                                        gene_data.gene2sequence)
        if len(sdb) > 0:
            sdb = sdb.copy()
            sdb["scaffold"] = scaffold
    with spans.span("genes.counts"):
        ldb = calc_gene_snp_counts(gdb, cumulative_snv_table, sdb,
                                   gene_data.gene2sequence)
    return cdb, cldb, ldb, sdb


def _gene_ranges(gdb: pd.DataFrame, L: int):
    starts = gdb["start"].values.astype(int)
    ends = np.minimum(gdb["end"].values.astype(int), L - 1)
    lens = np.abs(gdb["end"].values - gdb["start"].values) + 1
    return starts, ends, lens


def _prefix_index(idx: np.ndarray, L: int) -> np.ndarray:
    """`idx` as numpy reads it into the L + 1 prefix sums of a row: a
    negative index counts from the end, one outside raises numpy's
    IndexError (logged as the scaffold's GeneException)."""
    bad = np.flatnonzero((idx < -(L + 1)) | (idx > L))
    if len(bad):
        raise IndexError(f"index {idx[bad[0]]} is out of bounds for axis 1 "
                         f"with size {L + 1}")
    return np.where(idx < 0, idx + L + 1, idx)


@dataclass
class GeneRangeSums:
    """One scaffold's per-gene sums at each mm level (gene_range_sums):
    [M, G] over the positions start..end (clipped to the scaffold)."""

    genes: np.ndarray          # object [G], in the gene table's order
    lens: np.ndarray           # [G] lengths, unclipped
    mm: np.ndarray             # int64 [M]
    coverage: np.ndarray       # int64: sum of the cumulative coverage
    breadth: np.ndarray        # int64: positions covered
    clon_n: np.ndarray         # int64: positions with a clonality
    clon_sum: np.ndarray       # float64: sum of the filled clonality
    level_covered: np.ndarray  # bool [M]: the level covers a position
    level_clon: np.ndarray     # bool [M]: the level has a clonality


def gene_range_sums(gdb: pd.DataFrame, stats) -> GeneRangeSums:
    """The genes' coverage, breadth and clonality sums at every mm level
    of a scaffold, from one native pass over its positions per level
    (csrc/host/gene_ranges.cc) that keeps running sums only at the genes'
    bounds; a gene's sum is the difference of its two bounds', as the
    reference's prefix sums give it. total (int32 or int64) and clon
    (float32) are read in place, row stride and all. The clonality is
    forward-filled along mm (a position keeps the value of the highest
    level <= m that has one, as tables._ffill_along_mm) and summed in
    float64 from the scaffold's start: an f32 sum along a 40 kb
    scaffold, differenced at gene ends, is off by up to a fifth of a
    gene's diversity."""
    L = stats.pileup.length
    M = len(stats.mm_values)
    starts, ends, lens = _gene_ranges(gdb, L)
    hi = _prefix_index(ends + 1, L)
    lo = _prefix_index(starts, L)
    bounds = np.unique(np.concatenate([lo, hi, [L]])).astype(np.int64)
    total, clon = stats.total, stats.clon
    if total.dtype not in (np.int32, np.int64) or clon.dtype != np.float32:
        raise TypeError(f"total {total.dtype} / clon {clon.dtype}: want "
                        "int32 or int64 / float32")
    for a in (total, clon):
        if a.shape[0] < M or a.shape[1] < L:
            raise ValueError(f"{a.shape} holds less than [{M}, {L}]")
    nb = len(bounds)
    out = [np.empty((M, nb), dtype=np.int64) for _ in range(3)]
    s_clon = np.empty((M, nb), dtype=np.float64)
    i64 = ct.POINTER(ct.c_int64)
    rc = _load_lib().gr_range_sums(
        total.ctypes.data, int(total.dtype == np.int64),
        total.strides[0] // total.itemsize, total.strides[1] // total.itemsize,
        clon.ctypes.data_as(ct.POINTER(ct.c_float)),
        clon.strides[0] // clon.itemsize, clon.strides[1] // clon.itemsize,
        M, L, bounds.ctypes.data_as(i64), nb,
        *(o.ctypes.data_as(i64) for o in out),
        s_clon.ctypes.data_as(ct.POINTER(ct.c_double)))
    if rc != 0:
        raise ValueError(f"gene bounds not sorted within [0, {L}]")
    a = np.searchsorted(bounds, lo)
    b = np.searchsorted(bounds, hi)
    cov, brd, n_clon = (o[:, b] - o[:, a] for o in out)
    return GeneRangeSums(
        genes=gdb["gene"].to_numpy(dtype=object), lens=lens,
        mm=np.asarray(stats.mm_values, dtype=np.int64),
        coverage=cov, breadth=brd, clon_n=n_clon,
        clon_sum=s_clon[:, b] - s_clon[:, a],
        level_covered=out[1][:, -1] > 0, level_clon=out[2][:, -1] > 0)


def _per_level_table(sums: GeneRangeSums, kept: np.ndarray,
                     columns: Dict[str, np.ndarray]) -> pd.DataFrame:
    """Rows gene by gene within each kept level, levels in mm order; no
    kept level gives an empty table, as the reference's."""
    if not kept.any():
        return pd.DataFrame()
    table = {"gene": np.tile(sums.genes, int(kept.sum()))}
    table.update((k, v[kept].ravel()) for k, v in columns.items())
    table["mm"] = np.repeat(sums.mm[kept], len(sums.genes))
    return pd.DataFrame(table)


def calc_gene_coverage(sums: GeneRangeSums) -> pd.DataFrame:
    """Per-gene per-mm coverage/breadth (reference: 352-371); levels that
    cover no position of the scaffold give no rows (358-360)."""
    return _per_level_table(sums, sums.level_covered,
                            {"coverage": sums.coverage / sums.lens,
                             "breadth": sums.breadth / sums.lens})


def calc_gene_clonality(sums: GeneRangeSums) -> pd.DataFrame:
    """Per-gene per-mm nucleotide diversity (reference: 396-422); levels
    with no clonality on the scaffold give no rows (402-404), a gene
    with none NaN."""
    n = sums.clon_n
    micro = np.where(n > 0, 1 - sums.clon_sum / np.maximum(n, 1), np.nan)
    return _per_level_table(sums, sums.level_clon,
                            {"nucl_diversity": micro,
                             "breadth_minCov": n / sums.lens})


def characterize_snps_wrapper(Ldb: pd.DataFrame, gdb: pd.DataFrame,
                              gene2sequence: Dict[str, str]) -> pd.DataFrame:
    """reference: Characterize_SNPs_wrapper (600-642)."""
    if Ldb is None or len(Ldb) == 0:
        return pd.DataFrame()
    Sdb = (Ldb.drop_duplicates(subset=["scaffold", "position"], keep="last")
              .sort_index().drop(columns=["mm"]))
    Sdb = Sdb.copy()
    Sdb["position"] = Sdb["position"].astype(int)
    col = "morphia" if "morphia" in Sdb.columns else "allele_count"
    Sdb[col] = Sdb[col].astype(int)
    Sdb = Sdb[(Sdb[col] > 0) & (Sdb[col] <= 2)]
    if len(Sdb) == 0:
        return pd.DataFrame()
    sdb = characterize_snps(gdb, Sdb, gene2sequence)
    merged = pd.merge(Sdb, sdb, on=["position"], how="left").reset_index(
        drop=True)
    return merged


# SNVs whose gene hits are found in one [rows, genes] comparison
_HIT_ROWS = 4096


def _mutation(original: str, reverse: bool, snp_start: int, con_base,
              var_base) -> Tuple[str, str]:
    """The reference's S/N call for one SNV in one gene (GeneProfile.py:
    666-698): put con_base at snp_start of the gene's forward-strand
    sequence (var_base where con_base is already there), translate the
    old and the new sequence (reverse-complemented back for a '-1'
    gene) and report the first amino acid that changed. Only the codon
    holding snp_start can change, so only it is translated."""
    mut = ("S", "S:" + str(snp_start))
    if not 0 <= snp_start < len(original):
        return mut
    new = con_base
    if new == original[snp_start]:
        new = var_base
    i = snp_start
    frame = original
    if reverse:
        i = len(original) - 1 - snp_start
        frame = revcomp(original)
        new = new.translate(_COMP)
    if i >= len(frame) - len(frame) % 3:
        return mut                      # in the untranslated tail
    c0 = i - i % 3
    old_codon = frame[c0:c0 + 3]
    new_codon = old_codon[:i - c0] + new + old_codon[i - c0 + 1:]
    old_aa = CODON_TABLE.get(old_codon.upper(), "X")
    new_aa = CODON_TABLE.get(new_codon.upper(), "X")
    if new_aa != old_aa:
        return "N", "N:" + str(old_aa) + str(snp_start) + str(new_aa)
    return mut


def characterize_snps(gdb: pd.DataFrame, Sdb: pd.DataFrame,
                      gene2sequence: Dict[str, str]) -> pd.DataFrame:
    """reference: characterize_SNPs (644-707): I where an SNV is in no
    gene, M in more than one (the genes joined in gene-table order), else
    S or N (_mutation)."""
    table = defaultdict(list)
    starts = gdb["start"].values
    ends = gdb["end"].values
    genes = gdb["gene"].tolist()
    # string equality like the reference (GeneProfile.py:666): GenBank
    # integer strands never match
    reverse = (gdb["direction"] == "-1").values
    positions = Sdb["position"].values
    con_bases = Sdb["con_base"].tolist()
    var_bases = Sdb["var_base"].tolist()
    for r0 in range(0, len(positions), _HIT_ROWS):
        pos = positions[r0:r0 + _HIT_ROWS]
        hit = ((starts[None, :] <= pos[:, None]) &
               (ends[None, :] >= pos[:, None]))
        n_hits = hit.sum(axis=1)
        for r, p in enumerate(pos.tolist()):
            table["position"].append(p)
            if n_hits[r] == 0:
                table["mutation_type"].append("I")
                table["mutation"].append("")
                table["gene"].append("")
            elif n_hits[r] > 1:
                table["mutation_type"].append("M")
                table["mutation"].append("")
                table["gene"].append(",".join(
                    genes[j] for j in np.nonzero(hit[r])[0]))
            else:
                j = int(np.argmax(hit[r]))
                original = gene2sequence[genes[j]]
                if reverse[j]:
                    original = revcomp(original)
                mut_type, mut = _mutation(
                    original, bool(reverse[j]), int(p - starts[j]),
                    con_bases[r0 + r], var_bases[r0 + r])
                table["mutation_type"].append(mut_type)
                table["mutation"].append(mut)
                table["gene"].append(genes[j])
    return pd.DataFrame(table)


def calc_gene_snp_counts(gdb: pd.DataFrame, ldb: pd.DataFrame,
                         sdb: pd.DataFrame,
                         gene2sequence: Dict[str, str]) -> pd.DataFrame:
    """reference: calc_gene_snp_counts (522-598), on one scaffold's
    cumulative SNV table `ldb` (one row per position and mm level) and
    its SNVs' mutation types `sdb` (one row per position). At each mm
    level the reference keeps, per position, the row of the highest mm
    up to it; here that is the last row of each position in (position,
    mm) order. Every gene of a level is counted at once: its SNVs are a
    range of the level's position-sorted rows, so each count is a
    difference of prefix sums."""
    if ldb is None or len(ldb) == 0:
        return pd.DataFrame()
    types = (dict(zip(sdb["position"].tolist(),
                      sdb["mutation_type"].tolist())) if len(sdb) else {})

    site_rows = []
    for g in gdb["gene"]:
        try:
            S_site, N_site = count_sites(gene2sequence[g])
        except Exception:
            S_site = N_site = np.nan
        site_rows.append((g, S_site, N_site))
    SiteDb = pd.DataFrame(site_rows, columns=["gene", "S_sites", "N_sites"])

    genes = gdb["gene"].tolist()
    starts = gdb["start"].values.astype(np.int64)
    ends = gdb["end"].values.astype(np.int64)
    g_len = (np.abs(gdb["end"].values - gdb["start"].values) + 1).tolist()
    pos = ldb["position"].to_numpy()
    mms = ldb["mm"].to_numpy()
    order = np.lexsort((mms, pos))
    pos, mms = pos[order], mms[order]
    ac = ldb["allele_count"].to_numpy()[order]
    mt = [types.get(p) for p in pos.tolist()]
    is_type = {t: np.array([m == t for m in mt], dtype=bool)
               for t in ("N", "S")}
    table = defaultdict(list)
    for mm in sorted(np.unique(mms)):
        rows = np.flatnonzero(mms <= mm)
        rows = rows[np.append(pos[rows[1:]] != pos[rows[:-1]], True)]
        pos_arr = pos[rows]
        lo = np.searchsorted(pos_arr, starts, side="left")
        hi = np.searchsorted(pos_arr, ends, side="right")
        table["mm"].extend([int(mm)] * len(genes))
        table["gene"].extend(genes)
        table["gene_length"].extend(g_len)
        table["divergent_site_count"].extend((hi - lo).tolist())
        for allele_count, nm in zip([1, 2], ["SNS", "SNV"]):
            is_ac = ac[rows] == allele_count
            for key, sel in ((f"{nm}_count", is_ac),
                             (f"{nm}_N_count", is_ac & is_type["N"][rows]),
                             (f"{nm}_S_count", is_ac & is_type["S"][rows])):
                c = np.concatenate([[0], np.cumsum(sel, dtype=np.int64)])
                table[key].extend((c[hi] - c[lo]).tolist())
    GGdb = pd.DataFrame(table).merge(SiteDb, on="gene",
                                     how="left").reset_index(drop=True)
    GGdb["dNdS_substitutions"] = [
        ((nC / nS) / (sC / sS)) if ((sC > 0) and (sS > 0)) else np.nan
        for nC, nS, sC, sS in zip(GGdb["SNS_N_count"], GGdb["N_sites"],
                                  GGdb["SNS_S_count"], GGdb["S_sites"])]
    GGdb["pNpS_variants"] = [
        ((nC / nS) / (sC / sS)) if ((sC > 0) and (sS > 0)) else np.nan
        for nC, nS, sC, sS in zip(GGdb["SNV_N_count"], GGdb["N_sites"],
                                  GGdb["SNV_S_count"], GGdb["S_sites"])]
    return GGdb


# ---------------- standalone operation (from a stored profile) ----------------

def _series_gene_slices(series: pd.Series, starts, ends):
    """sum and count of series values within [start, end] per gene."""
    pos = series.index.values
    vals = series.values.astype(np.float64)
    csum = np.concatenate([[0], np.cumsum(vals)])
    lo = np.searchsorted(pos, starts, side="left")
    hi = np.searchsorted(pos, ends + 1, side="left")
    return csum[hi] - csum[lo], hi - lo


def calc_gene_coverage_series(gdb: pd.DataFrame, covT) -> pd.DataFrame:
    """calc_gene_coverage working on stored mm->Series coverage
    (reference: GeneProfile.py:352-394)."""
    starts = gdb["start"].values.astype(int)
    ends = gdb["end"].values.astype(int)
    lens = np.abs(gdb["end"].values - gdb["start"].values) + 1
    table = defaultdict(list)
    counts = pd.Series(dtype="float64")
    for mm in sorted(int(m) for m in covT.keys()):
        counts = counts.add(covT[mm], fill_value=0)
        if len(counts) == 0:
            continue
        sums, ns = _series_gene_slices(counts, starts, ends)
        for g, s, n, ln in zip(gdb["gene"], sums, ns, lens):
            table["gene"].append(g)
            table["coverage"].append(s / ln)
            table["breadth"].append(n / ln)
            table["mm"].append(mm)
    return pd.DataFrame(table)


def calc_gene_clonality_series(gdb: pd.DataFrame, clonT) -> pd.DataFrame:
    """calc_gene_clonality on stored mm->Series clonality
    (reference: GeneProfile.py:373-422, union-of-latest semantics)."""
    starts = gdb["start"].values.astype(int)
    ends = gdb["end"].values.astype(int)
    lens = np.abs(gdb["end"].values - gdb["start"].values) + 1
    table = defaultdict(list)
    p2c: Dict[int, float] = {}
    for mm in sorted(int(m) for m in clonT.keys()):
        for pos, val in clonT[mm].items():
            p2c[pos] = val
        if not p2c:
            continue
        combined = pd.Series(p2c).sort_index()
        sums, ns = _series_gene_slices(combined, starts, ends)
        for g, s, n, ln in zip(gdb["gene"], sums, ns, lens):
            table["gene"].append(g)
            table["nucl_diversity"].append(
                1 - (s / n) if n > 0 else np.nan)
            table["breadth_minCov"].append(n / ln)
            table["mm"].append(mm)
    return pd.DataFrame(table)


def profile_genes_from_store(isdir, gene_file: str,
                             store_everything: bool = False):
    """
    The standalone `profile_genes` operation: load covT/clonT/SNV table
    from a stored profile and compute all gene-level tables
    (reference: GeneProfile.Controller.main, 37-69). Host only.
    """
    from ..obs.logging import log_failure
    from ..store import generate as gen_mod

    gene_data = parse_genes(gene_file)
    scaffolds_with_genes = set(gene_data.scaff2genes.keys())
    scaffolds_in = set(isdir.covt_scaffolds())
    todo = sorted(scaffolds_with_genes & scaffolds_in)
    logging.info(f"{len(scaffolds_with_genes)} scaffolds with genes; "
                 f"{len(scaffolds_in)} in profile; {len(todo)} to profile")

    snv = isdir.get("cumulative_snv_table")
    if snv is None or len(snv) == 0:
        snv = pd.DataFrame(columns=["scaffold"])
    else:
        snv = snv.rename(columns={
            "conBase": "con_base", "refBase": "ref_base",
            "varBase": "var_base", "baseCoverage": "position_coverage"})
        snv = snv.sort_values("mm")
    covTs = isdir.get("covT", scaffolds=todo)
    clonTs = isdir.get("clonT", scaffolds=todo)

    results = []
    for scaffold in todo:
        try:
            gdb = gene_data.scaff2genes[scaffold]
            cdb = (calc_gene_coverage_series(gdb, covTs[scaffold])
                   if scaffold in covTs else pd.DataFrame())
            cldb = (calc_gene_clonality_series(gdb, clonTs[scaffold])
                    if scaffold in clonTs else pd.DataFrame())
            ldb_in = snv[snv["scaffold"] == scaffold]
            sdb = characterize_snps_wrapper(ldb_in, gdb,
                                            gene_data.gene2sequence)
            ldb = calc_gene_snp_counts(gdb, ldb_in, sdb,
                                       gene_data.gene2sequence)
            if len(sdb):
                sdb = sdb.copy()
                sdb["scaffold"] = scaffold
            results.append((cdb, cldb, ldb, sdb))
        except Exception as e:
            log_failure("GeneException", scaffold, str(e))

    def cat(i):
        dfs = [r[i] for r in results if len(r[i])]
        return pd.concat(dfs).reset_index(drop=True) if dfs \
            else pd.DataFrame()

    store_gene_tables(isdir, gene_file, gene_data, [cat(i) for i in range(4)])
    if store_everything:
        isdir.store("scaff2gene2sequence",
                    {s: {g: gene_data.gene2sequence[g]
                         for g in df["gene"]}
                     for s, df in gene_data.scaff2genes.items()},
                    "pickle", "scaffold -> gene -> sequence")
    gen_mod.generate(isdir, "gene_info")
    gen_mod.generate(isdir, "SNVs")
    return isdir


_GENE_TABLES = (
    ("genes_coverage", "Coverage of individual genes"),
    ("genes_clonality", "Clonality of individual genes"),
    ("genes_SNP_count", "SNP density and counts of individual genes"),
    ("SNP_mutation_types", "The mutation types of SNPs"),
)


def store_gene_tables(isdir, gene_file: str, gene_data: GeneData,
                      tables) -> None:
    """Store the gene file's location, its gene table and the four
    per-gene tables (coverage, clonality, SNP counts, SNP mutation types)
    with the reference's descriptions."""
    isdir.store("genes_fileloc", gene_file, "value",
                "Location of genes file that was used to call genes")
    isdir.store("genes_table", gene_data.gene_table, "pandas",
                "Location of genes in the associated genes_file")
    for (attr, descr), table in zip(_GENE_TABLES, tables):
        isdir.store(attr, table, "pandas", descr)
