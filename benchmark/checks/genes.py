"""
The genes check (benchmark/checks/<name>.py): a profile run with `-g
<genes.fna>` against a plain reference of its gene tables, worked out in
NumPy and pandas from the genes file and the base reference
(benchmark/ref/profile.py: covT, clonT, the SNVs and scaffold_info of the
same sample). It imports nothing of the program.

What inStrain v1.9.1 reports with -g (GeneProfile.py), at its defaults:
  - gene_info: one row per gene of a profiled scaffold whose coverage is
    above 0, each number at the highest mm: coverage (the summed coverage
    of the gene's positions over its length), breadth (its covered
    positions over its length), nucl_diversity (1 - the mean clonality of
    its positions that have one, each position's clonality at the highest
    mm where it has one) and breadth_minCov (those positions over its
    length); start, end (0-based), direction and partial from the genes
    file; per gene, from the SNV table's rows at the highest mm
    (position by position, cryptic SNVs included), divergent_site_count
    (every row), SNS_count and SNV_count (allele_count 1 and 2) and their
    S and N counts, and gene_length (on a scaffold with no such row, all
    of these are NaN: inStrain merges the counts table, which has no rows
    there); dNdS_substitutions and pNpS_variants, (N count / N sites) /
    (S count / S sites) of the SNS and the SNV counts, NaN unless both S
    terms are above 0, the sites counted over the gene's codons;
  - the SNVs table's gene, mutation and mutation_type: a position with
    allele_count 1 or 2 on a scaffold with genes is I in no gene, M in
    several (the genes joined by commas in file order), else S or N by the
    amino acid its consensus base (or its variant base, where the
    consensus is the reference base) makes of its codon.
The quirks of inStrain that the program keeps (its profile/genes.py
docstring, citing GeneProfile.py), kept here too:
  - the strand is compared with the string '-1' (GeneProfile.py:666,682);
  - the label holds the nucleotide's offset in the gene, `N:<aa><offset>
    <aa>` or `S:<offset>` (GeneProfile.py:694-698);
  - the SNV counts take allele_count == 2 exactly (GeneProfile.py:578);
  - partial is True only for `partial=01` (GeneProfile.py:770-811).

Two gaps hold the float columns: gene_info_gap the sums of exact counts
(coverage, breadth, breadth_minCov, dN/dS and pN/pS), and
gene_diversity_gap nucl_diversity, a mean of float32 per-site
clonalities (the configuration's precision): a site's clonality may
differ from the reference's in its last bits (clonT_rel_gap), and a gene
with few sites carries that into its mean.

`precision` "control" computes the gene aggregates in float32 over the
base reference's own control (clonality in bfloat16, aggregates in
float32), one step below what the configuration states; the integer and
string columns do not change with it.

Cryptic SNVs (an SNV at one mm that a higher mm calls otherwise) are
counted in a gene's divergent sites but are no row of the SNVs table; on
a scaffold whose divergent sites outnumber its SNV rows, the rows at the
highest mm are worked out again with the base reference's own read
filter and pileup, every position kept.
"""

from __future__ import annotations

import os
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import pandas as pd

from benchmark.gen import reads as gen
from benchmark.ref import profile as refp

LIMITS = {"gene_rows_mismatched": 0,
          "gene_info_mismatches": 0,
          "gene_info_gap": 1e-10,
          "gene_diversity_gap": 1e-6,
          "snv_gene_mismatches": 0}

GENE_EXACT = ["scaffold", "gene_length", "start", "end", "direction",
              "partial", "SNV_count", "SNV_S_count", "SNV_N_count",
              "SNS_count", "SNS_S_count", "SNS_N_count",
              "divergent_site_count"]
GENE_FLOAT = ["coverage", "breadth", "breadth_minCov",
              "dNdS_substitutions", "pNpS_variants"]
GENE_DIVERSITY = ["nucl_diversity"]
SNV_GENE = ["gene", "mutation", "mutation_type"]
ONE_SIDED = 1e300

# the standard genetic code over codons in TCAG order; stops are "*"
_BASES = "TCAG"
_AAS = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRR"
        "IIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
CODE = {a + b + c: _AAS[16 * i + 4 * j + k]
        for i, a in enumerate(_BASES) for j, b in enumerate(_BASES)
        for k, c in enumerate(_BASES)}
_COMP = str.maketrans("ACGT", "TGCA")


def _revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def _codon_sites() -> Dict[str, tuple]:
    """(synonymous, non-synonymous) sites of each codon but the stops:
    each of the 9 single-base changes is synonymous or not (a change to a
    stop is not), normalised to 3 sites (inStrain's count_sites at k = 1,
    where transitions and transversions weigh alike)."""
    out = {}
    for codon, aa in CODE.items():
        if aa == "*":
            continue
        s = sum(CODE[codon[:i] + b + codon[i + 1:]] == aa
                for i in range(3) for b in "ACGT" if b != codon[i])
        out[codon] = (s / 3.0, (9 - s) / 3.0)
    return out


SITES = _codon_sites()


def count_sites(seq: str):
    """(S sites, N sites) of a gene's sequence, codon by codon, stops and
    codons with another letter than ACGT adding nothing."""
    s = n = 0.0
    for i in range(0, len(seq) - len(seq) % 3, 3):
        v = SITES.get(seq[i:i + 3])
        if v is not None:
            s += v[0]
            n += v[1]
    return s, n


def read_genes(path: str) -> pd.DataFrame:
    """The genes file: gene, scaffold, start, end (0-based), direction (the
    strand as written), partial and the sequence as written."""
    rows, seq = [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if rows:
                    rows[-1]["seq"] = "".join(seq)
                seq = []
                head = line[1:]
                parts = [p.strip() for p in head.split("#")]
                name = parts[0]
                rows.append(dict(gene=name, scaffold=name.rsplit("_", 1)[0],
                                 start=int(parts[1]) - 1,
                                 end=int(parts[2]) - 1, direction=parts[3],
                                 partial="partial=01" in head))
            elif line:
                seq.append(line)
    if rows:
        rows[-1]["seq"] = "".join(seq)
    return pd.DataFrame(rows)


def _mutation(fwd: str, reverse: bool, offset: int, con: str, var: str):
    """The S/N call of an SNV `offset` bases into a gene whose
    forward-strand sequence is `fwd`: the consensus base there (the
    variant base where the consensus is the reference base) against the
    reference, in the gene's own frame."""
    new = var if con == fwd[offset] else con
    frame, i = fwd, offset
    if reverse:
        frame, i, new = _revcomp(fwd), len(fwd) - 1 - offset, new.translate(
            _COMP)
    c0 = i - i % 3
    old = frame[c0:c0 + 3]
    old_aa = CODE.get(old, "X")
    new_aa = CODE.get(old[:i - c0] + new + old[i - c0 + 1:], "X")
    if new_aa != old_aa:
        return "N", f"N:{old_aa}{offset}{new_aa}"
    return "S", f"S:{offset}"


def _top_rows_block(sc, P0, counts, ref, thr_null, thr_freq, st, low):
    """In place of ref/profile.py's _block_stats: every position's SNV
    table row at its highest mm (cryptic ones kept), with the same site
    calls: allele_count, con_base and var_base."""
    M = counts.shape[0]
    cum = np.cumsum(counts, axis=0)
    total = cum.sum(axis=1)
    tc = np.minimum(total, st["max_coverage"])
    thresh = np.maximum(thr_null[tc], thr_freq[tc])
    morphia = (cum >= thresh[:, None, :]).sum(axis=1)
    con, var = refp._first_two(cum)
    row = ((counts.sum(axis=1) > 0) & (total >= st["min_cov"]) &
           ((morphia != 1) | (con != ref[None, :])))
    top = np.where(row, np.arange(M)[:, None], -1).max(axis=0)
    cols = np.nonzero(top >= 0)[0]
    lv = top[cols]
    sc.snv_rows.append(pd.DataFrame({
        "position": P0 + cols, "allele_count": morphia[lv, cols],
        "con_base": refp.BASES[con[lv, cols]],
        "var_base": refp.BASES[var[lv, cols]]}))


def _top_rows(cfg, seed, layout, names, low) -> Dict[str, pd.DataFrame]:
    """The highest-mm SNV rows of the named scaffolds, cryptic ones kept:
    the base reference's scaffold pass (its read filter and pileup), its
    site statistics replaced by _top_rows_block and nothing else of it
    (scaffold row, linkage) worked out."""
    st = refp.DEFAULTS
    one = types.FunctionType(
        refp._one_scaffold.__code__,
        dict(vars(refp), _block_stats=_top_rows_block,
             _scaffold_row=lambda sc, low: None,
             _linkage=lambda *a: pd.DataFrame()))
    ctx = dict(cfg=cfg, seed=seed, lay=layout, st=st, low=low,
               thr_null=refp.null_thresholds(st["max_coverage"], st["fdr"],
                                             st["error_rate"]),
               thr_freq=refp.freq_thresholds(st["max_coverage"],
                                             st["min_freq"]))
    inserts = [gen.scaffold_fragments(cfg, layout, s, seed)[1]["insert"]
               for s in range(len(layout.names))]
    ctx["max_insert"] = (np.median(np.concatenate(inserts)) *
                         st["max_insert_relative"])
    index = {n: s for s, n in enumerate(layout.names)}
    with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as pool:
        ctx["pool"] = pool
        return {n: one(ctx, index[n])["snvs"] for n in names}


def reference(cfg, seed, layout, paths, base, precision):
    """gene_info (indexed by gene) and the SNVs table's gene columns
    (indexed by scaffold and position) that inStrain reports for this
    sample, at `precision`."""
    low = precision == "control"
    dt = np.float32 if low else np.float64
    genes = read_genes(paths["genes"])
    scaf = base["scaffold_info"]
    snvs = base["snvs"]
    by_scaf = ({s: d.reset_index(level=0, drop=True)
                for s, d in snvs.groupby(level=0)} if len(snvs) else {})
    cryptic = [s for s in scaf.index
               if scaf.at[s, "divergent_site_count"] !=
               len(by_scaf.get(s, ()))]
    again = _top_rows(cfg, seed, layout, cryptic, low) if cryptic else {}
    info, typed = [], []
    for s, g in genes.groupby("scaffold", sort=False):
        if s not in scaf.index:
            continue
        L = int(scaf.at[s, "length"])
        cov = np.zeros(L, dtype=np.int64)
        for pos, vals in base["covT"].get(s, {}).values():
            cov[pos] += vals.astype(np.int64)
        clon = np.full(L, np.nan)
        for m in sorted(base["clonT"].get(s, {})):
            pos, vals = base["clonT"][s][m]
            clon[pos] = vals
        has_clon = bool(base["clonT"].get(s))
        top = (again[s] if s in again else
               by_scaf[s].reset_index() if s in by_scaf else pd.DataFrame(
                   columns=["position", "allele_count", "con_base",
                            "var_base"]))
        top = top.sort_values("position")
        tpos = top["position"].to_numpy(np.int64)
        ac = top["allele_count"].to_numpy(np.int64)
        starts, ends = g["start"].to_numpy(), g["end"].to_numpy()
        fwd = [q if d != "-1" else _revcomp(q)
               for q, d in zip(g["seq"], g["direction"])]
        # each typed position's gene, label and type
        kind = {}
        for p, a, c, v in zip(tpos.tolist(), ac.tolist(),
                              top["con_base"].tolist(),
                              top["var_base"].tolist()):
            if a not in (1, 2):
                continue
            hit = np.nonzero((starts <= p) & (ends >= p))[0]
            if len(hit) == 0:
                kind[p] = ("", "", "I")
            elif len(hit) > 1:
                kind[p] = (",".join(g["gene"].iloc[hit]), "", "M")
            else:
                j = int(hit[0])
                t, lab = _mutation(fwd[j], g["direction"].iloc[j] == "-1",
                                   p - int(starts[j]), c, v)
                kind[p] = (g["gene"].iloc[j], lab, t)
        for p, k in kind.items():
            typed.append((s, p) + k)
        tkind = np.array([kind.get(p, ("", "", ""))[2]
                          for p in tpos.tolist()])
        for row in g.itertuples(index=False):
            a, b = int(row.start), int(row.end)
            n = b - a + 1
            c = cov[a:b + 1]
            r = dict(gene=row.gene, scaffold=s, start=a, end=b,
                     direction=int(row.direction), partial=row.partial,
                     coverage=float(c.astype(dt).sum() / dt(n)),
                     breadth=float(dt((c > 0).sum()) / dt(n)))
            if has_clon:
                x = clon[a:b + 1]
                x = x[~np.isnan(x)].astype(dt)
                r["breadth_minCov"] = float(dt(len(x)) / dt(n))
                r["nucl_diversity"] = (float(dt(1) - x.sum() / dt(len(x)))
                                       if len(x) else np.nan)
            else:
                r["breadth_minCov"] = r["nucl_diversity"] = np.nan
            if len(top):
                lo, hi = np.searchsorted(tpos, [a, b + 1])
                S_sites, N_sites = count_sites(row.seq)
                r["gene_length"] = n
                r["divergent_site_count"] = int(hi - lo)
                for want, nm in ((1, "SNS"), (2, "SNV")):
                    sel = ac[lo:hi] == want
                    r[f"{nm}_count"] = int(sel.sum())
                    for t in ("N", "S"):
                        r[f"{nm}_{t}_count"] = int(
                            (sel & (tkind[lo:hi] == t)).sum())
                for nm, col in (("SNS", "dNdS_substitutions"),
                                ("SNV", "pNpS_variants")):
                    sc, nc = r[f"{nm}_S_count"], r[f"{nm}_N_count"]
                    r[col] = ((nc / N_sites) / (sc / S_sites)
                              if sc > 0 and S_sites > 0 else np.nan)
            info.append(r)
    gi = pd.DataFrame(info).reindex(columns=["gene"] + GENE_EXACT +
                                    GENE_FLOAT + GENE_DIVERSITY)
    gi = gi[gi["coverage"] > 0].set_index("gene")
    sv = pd.DataFrame(typed, columns=["scaffold", "position"] + SNV_GENE)
    sv = sv.set_index(["scaffold", "position"])
    rows = snvs.index if len(snvs) else sv.index[:0]
    return dict(gene_info=gi, snvs=sv.reindex(rows).fillna(""))


def read(outdir):
    """gene_info and the SNVs table's gene columns, as the run wrote them
    (a column the SNVs table lacks reads empty)."""
    base = os.path.join(outdir, "output", os.path.basename(outdir) + "_")
    gi = pd.read_csv(base + "gene_info.tsv", sep="\t").set_index("gene")
    sv = (pd.read_csv(base + "SNVs.tsv", sep="\t")
            .reindex(columns=["scaffold", "position"] + SNV_GENE)
            .set_index(["scaffold", "position"]))
    return dict(gene_info=gi, snvs=sv.fillna(""))


def _gap(a, b) -> float:
    """The widest |a - b| / max(|b|, 1); NaN on both sides agrees, on one
    side reads ONE_SIDED."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not len(a):
        return 0.0
    one = np.isnan(a) ^ np.isnan(b)
    with np.errstate(invalid="ignore"):
        g = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    g = np.where(one, ONE_SIDED, np.where(np.isnan(g), 0.0, g))
    return float(g.max())


def _differ(a: pd.Series, b: pd.Series) -> int:
    """Cells that differ, NaN agreeing with NaN (a TSV reads an integer
    column with NaN as floats: 951.0 equals 951)."""
    return sum(not (u == v or (pd.isna(u) and pd.isna(v)))
               for u, v in zip(a.to_numpy(object), b.to_numpy(object)))


def judge(prog, ref):
    pg, rg = prog["gene_info"], ref["gene_info"]
    common = pg.index.intersection(rg.index)
    ps, rs = prog["snvs"], ref["snvs"]
    both = ps.index.intersection(rs.index)
    cols = GENE_EXACT + GENE_FLOAT + GENE_DIVERSITY
    pg = pg.reindex(index=common, columns=cols)
    rg = rg.reindex(index=common, columns=cols)
    return {
        "gene_rows_mismatched": len(prog["gene_info"].index.symmetric_difference(
            ref["gene_info"].index)),
        "gene_info_mismatches": sum(_differ(pg[c], rg[c])
                                    for c in GENE_EXACT),
        "gene_info_gap": max(_gap(pg[c], rg[c]) for c in GENE_FLOAT),
        "gene_diversity_gap": _gap(pg["nucl_diversity"],
                                   rg["nucl_diversity"]),
        "snv_gene_mismatches": (
            len(ps.index.symmetric_difference(rs.index)) +
            sum(int((ps.loc[both, c].astype(str) !=
                     rs.loc[both, c].astype(str)).sum())
                for c in SNV_GENE)),
    }
