"""
The plain reference of `profile`: what inStrain's profile should report for
the benchmark's generated sample, worked out in NumPy from the generator's
own read arrays and scaffold sequences (benchmark/gen/reads.py). It imports
nothing of the program under test and reads nothing it wrote.

It follows inStrain v1.9.1's definitions at its profile defaults:
  - read filter (filter_reads.py): a pair passes when its PID, 1 - (NM of
    both mates) / (their summed length), exceeds min_read_ani, its insert
    lies strictly between min_insert and max_insert_relative times the
    median insert of all pairs, and its mapq exceeds min_mapq;
  - pileup (pysam with ignore_overlaps, min base quality 30): every base of
    a passing pair counts at the pair's mismatch level (mm, its summed NM),
    except where the mates overlap: there only the mate that starts first
    counts (the other's quality is zeroed; with equal qualities the first
    keeps 0.8 of its quality on a disagreement, still over 30);
  - site statistics (snv_utilities.py): counts cumulative over mm' <= mm;
    a base is present at a position when its count reaches both the
    null-model threshold at the position's coverage (the smallest count an
    error base exceeds with probability under fdr, 3 * P(Binom(cov,
    0.001 / 3) >= e)) and min_freq of the coverage; SNV rows, consensus and
    variant bases, SNP classes, clonality sum(p_b^2) where coverage >=
    min_cov, and the cryptic-SNV scan over ascending mm;
  - scaffold_info, SNVs and linkage as the output tables hold them: each
    scaffold's, position's or SNV pair's row at its highest mm;
  - linkage (linkage.py): pairs of SNV-site bases read within one read pair
    and one 10 kb window, counted by the pair's mm, r2 and D' from the two
    major alleles of each site, where more than min_snp pairs link them;
  - genome_info (genomeUtilities.py): length-weighted coverage and breadth,
    nucl_diversity weighted by the length at min_cov, summed counts; the
    coverage distribution of the genome's positions (its scaffolds, longest
    first, each without 100 bases at either end): median, std and SEM at
    the highest mm; and iRep (irep_utilities.py) over the coverage of the
    pairs with mm <= 1: 5 kb windows every 100 bases, those within 8x of
    the median kept, GC bias fitted out, the slope of the sorted log2
    window coverages with 5 % trimmed at either end, NaN unless 98 % of
    the windows are kept, the mean coverage reaches 5, the fit's r2 0.9
    and the genome has at most 175 scaffolds per Mbp.

`precision` selects the arithmetic: "reference" computes clonality and
every aggregate in float64; "control" computes clonality in bfloat16 and
the aggregates in float32, one step below what the configuration states
(float32 clonality, float64 aggregates), so that the comparison can be
shown to fail a program that took that step. The result has the same form
as benchmark/harness/outputs.read_profile's.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import pandas as pd
import torch
from scipy.signal import fftconvolve
from scipy.stats import binom, sem

from ..gen import reads as gen

BASES = np.array(list("ACTG"))
_ACTG = np.full(256, 4, dtype=np.int64)           # ASCII -> ACTG index
for _i, _b in enumerate(b"ACTG"):
    _ACTG[_b] = _i
_ACTG8 = _ACTG.astype(np.uint8)

# inStrain's profile defaults (argumentParser.py)
DEFAULTS = dict(min_read_ani=0.95, min_mapq=-1, max_insert_relative=3.0,
                min_insert=50, min_cov=5, min_freq=0.05, fdr=1e-6,
                error_rate=0.001, max_coverage=10000, min_snp=20,
                window_length=10000, min_scaffold_reads=1,
                min_base_quality=30)

BLOCK = 1 << 18      # positions per block of the pileup


def null_thresholds(max_cov: int, fdr: float, error_rate: float,
                    columns: int = 18) -> np.ndarray:
    """thr[c]: the count an error base must exceed at coverage c, i.e. e - 1
    for the first e in 1..columns with 3 * P(Binom(c, p / 3) >= e) < fdr
    (inStrain's NullModel table read at its fdr), else columns - 1."""
    c = np.arange(max_cov + 1)
    thr = np.full(max_cov + 1, columns - 1, dtype=np.int64)
    found = np.zeros(max_cov + 1, dtype=bool)
    for e in range(1, columns + 1):
        hit = ~found & (3.0 * binom.sf(e - 1, c, error_rate / 3.0) < fdr)
        thr[hit] = e - 1
        found |= hit
    thr[0] = thr[1]
    return thr


def freq_thresholds(max_cov: int, min_freq: float) -> np.ndarray:
    """The smallest count c with c / T >= min_freq, for T = 0..max_cov."""
    T = np.arange(max_cov + 1, dtype=np.float64)
    c = np.ceil(min_freq * T)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where((c - 1) / T >= min_freq, c - 1, c)
        c = np.where(c / T < min_freq, c + 1, c)
    c[0] = 0
    return c.astype(np.int64)


def _f(x, low: bool):
    return np.asarray(x, dtype=np.float32 if low else np.float64)


def _clonality(cum: np.ndarray, total: np.ndarray, low: bool) -> np.ndarray:
    """sum_b (cum_b / total)^2 over [M, 4, B] counts: float64, or for the
    control every operation rounded to bfloat16."""
    if not low:
        p = cum / np.maximum(total, 1)[:, None, :]
        return (p * p).sum(axis=1)
    t = torch.from_numpy(np.ascontiguousarray(cum)).to(torch.float32)
    d = torch.from_numpy(np.maximum(total, 1)).to(torch.float32)
    p = (t / d[:, None, :]).to(torch.bfloat16)
    s = p[:, 0] * p[:, 0]
    for b in range(1, 4):
        s = s + p[:, b] * p[:, b]
    return s.to(torch.float64).numpy()


class _Scaffold:
    """One scaffold's reference tables, built block by block."""

    def __init__(self, name: str, L: int, mm_values: np.ndarray):
        self.name, self.L, self.mm = name, L, mm_values
        self.covT: Dict[int, List] = {int(m): [] for m in mm_values}
        self.clonT: Dict[int, List] = {int(m): [] for m in mm_values}
        self.total = np.zeros(L, dtype=np.int64)
        self.clon_final = np.full(L, np.nan)
        self.snv_rows: List[pd.DataFrame] = []
        self.counts = dict(divergent_site_count=0, SNS_count=0, SNV_count=0,
                           con_snps=0, pop_snps=0)
        self.link_pos: List[np.ndarray] = []
        self.link_mask: List[np.ndarray] = []     # [4, k]
        self.link_cum: List[np.ndarray] = []      # [M, 4, k]
        self.link_present: List[np.ndarray] = []  # [M, k]

    def part(self) -> "_Scaffold":
        """An accumulator for one block: its own lists and counts, the
        per-position arrays shared (each block writes its own slice)."""
        p = _Scaffold(self.name, 0, self.mm)
        p.L, p.total, p.clon_final = self.L, self.total, self.clon_final
        return p

    def merge(self, p: "_Scaffold") -> None:
        """Append a block's lists, blocks taken in position order."""
        for m in self.covT:
            self.covT[m] += p.covT[m]
            self.clonT[m] += p.clonT[m]
        for k in self.counts:
            self.counts[k] += p.counts[k]
        for k in ("snv_rows", "link_pos", "link_mask", "link_cum",
                  "link_present"):
            getattr(self, k).extend(getattr(p, k))


def _first_two(cum: np.ndarray):
    """The consensus base (the first of the largest counts, in ACTG order)
    and the variant base (the first of the largest among the others; A
    where they are all 0, as numpy's argmax over the counts with the
    consensus zeroed gives it), over [M, 4, B] counts."""
    con = np.zeros(cum.shape[::2], dtype=np.int64)
    best = cum[:, 0].copy()
    for b in range(1, 4):
        gt = cum[:, b] > best
        con[gt] = b
        np.maximum(best, cum[:, b], out=best)
    var = np.zeros_like(con)
    best = np.where(con == 0, 0, cum[:, 0])
    for b in range(1, 4):
        c = np.where(con == b, 0, cum[:, b])
        gt = c > best
        var[gt] = b
        np.maximum(best, c, out=best)
    return con, var


def _block_stats(sc: _Scaffold, P0: int, counts: np.ndarray,
                 ref: np.ndarray, thr_null, thr_freq, cfg, low) -> None:
    """Site statistics of positions P0.. of one block; counts [M, 4, B]
    exact-mm, ref [B] ACTG index (4: other)."""
    M, _, B = counts.shape
    pos = P0 + np.arange(B)
    exact = counts.sum(axis=1)
    present = exact > 0
    cum = np.cumsum(counts, axis=0)
    total = cum.sum(axis=1)                                   # [M, B]
    tc = np.minimum(total, cfg["max_coverage"])
    thresh = np.maximum(thr_null[tc], thr_freq[tc])
    morphia = (cum >= thresh[:, None, :]).sum(axis=1)
    con, var = _first_two(cum)
    counted = total >= cfg["min_cov"]
    con_is_ref = con == ref[None, :]
    base_call = (morphia > 1) | ((morphia == 1) & ~con_is_ref) | (morphia == 0)
    row = present & counted & base_call
    call_nosnp = counted & ~base_call
    ref_sel = np.minimum(ref, 3)
    ref_count = np.take_along_axis(
        cum, np.broadcast_to(ref_sel[None, None, :], (M, 1, B)), axis=1)[:, 0]
    min_null = thr_null[tc]
    ref_present = (ref_count >= min_null) & (ref_count >= thr_freq[tc])
    var_is_ref = var == ref[None, :]
    cls = np.full((M, B), 3)                                  # pop_SNV
    cls[var_is_ref | ref_present] = 2                         # con_SNV
    cls[con_is_ref] = 1                                       # SNV
    cls[morphia == 1] = 0                                     # SNS
    cls[morphia == 0] = 4                                     # divergent
    cls[np.broadcast_to(ref[None, :] >= 4, (M, B))] = 5

    clon_set = present & counted
    clon = np.where(clon_set, _clonality(cum, total, low), np.nan)
    emits = row & (morphia >= 2)
    any_incl = np.cumsum(emits, axis=0) > 0
    before = np.zeros_like(any_incl)
    before[1:] = any_incl[:-1]
    cryptic = (present & counted & before &
               (call_nosnp | (morphia == 1))).any(axis=0)
    any_snp = any_incl[-1]

    for i, m in enumerate(sc.mm):
        k = np.nonzero(present[i])[0]
        sc.covT[int(m)].append((pos[k], exact[i, k]))
        k = np.nonzero(clon_set[i])[0]
        sc.clonT[int(m)].append((pos[k], clon[i, k]))
    sc.total[P0:P0 + B] = total[-1]
    lvl = np.arange(M)[:, None]
    top_clon = np.where(clon_set, lvl, -1).max(axis=0)
    has = top_clon >= 0
    sc.clon_final[P0:P0 + B][has] = clon[top_clon[has], np.nonzero(has)[0]]

    top = np.where(row, lvl, -1).max(axis=0)                 # highest row
    have = top >= 0
    cols = np.nonzero(have)[0]
    lv = top[have]
    mor_at, cls_at = morphia[lv, cols], cls[lv, cols]
    c = sc.counts
    c["divergent_site_count"] += len(cols)
    c["SNS_count"] += int((mor_at == 1).sum())
    c["SNV_count"] += int((mor_at > 1).sum())
    c["con_snps"] += int(np.isin(cls_at, [0, 2, 3]).sum())
    c["pop_snps"] += int(np.isin(cls_at, [0, 3]).sum())

    keep = ~cryptic[cols]
    cols, lv = cols[keep], lv[keep]
    if len(cols):
        cc = cum[lv, :, cols]                                 # [k, 4]
        pc = total[lv, cols]
        pcf = _f(pc, low)
        ci, vi, ri = con[lv, cols], var[lv, cols], ref[cols]
        rows = np.arange(len(cols))
        ref_freq = np.full(len(cols), np.nan)
        ok = ri < 4
        ref_freq[ok] = _f(cc[rows[ok], ri[ok]], low) / pcf[ok]
        sc.snv_rows.append(pd.DataFrame({
            "scaffold": sc.name, "position": pos[cols],
            "position_coverage": pc, "allele_count": morphia[lv, cols],
            "ref_base": np.where(ok, BASES[np.minimum(ri, 3)], "N"),
            "con_base": BASES[ci], "var_base": BASES[vi],
            "A": cc[:, 0], "C": cc[:, 1], "T": cc[:, 2], "G": cc[:, 3],
            "ref_freq": ref_freq,
            "con_freq": (_f(cc[rows, ci], low) / pcf).astype(np.float64),
            "var_freq": (_f(cc[rows, vi], low) / pcf).astype(np.float64)}))

    k = np.nonzero(any_snp)[0]
    if len(k):
        mask = np.zeros((4, len(k)), dtype=bool)
        for b in range(4):
            mask[b] = (((con[:, k] == b) | (var[:, k] == b)) &
                       emits[:, k]).any(axis=0)
        sc.link_pos.append(pos[k])
        sc.link_mask.append(mask)
        sc.link_cum.append(cum[:, :, k])
        sc.link_present.append(present[:, k])


def _window_starts(L: int, window: int) -> np.ndarray:
    """inStrain's splits (profile/fasta.py): len // window + 1 chunks of
    int(len / chunks) bases, the last taking the rest."""
    n = L // window + 1
    size = int(L / n)
    return np.arange(n, dtype=np.int64) * size


def _ld(fAB, fAb, faB, fab):
    """r2 and D' (linkage.py:_calc_ld_single), in the arrays' dtype."""
    fA, fa = fAB + fAb, fab + faB
    fB, fb = fAB + faB, fab + fAb
    linkD = fAB - fA * fB
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where((fa == 0) | (fA == 0) | (fB == 0) | (fb == 0), np.nan,
                      linkD * linkD / (fA * fa * fB * fb))
        linkd = fab - fa * fb
        dp = np.where(linkd < 0, linkd / np.maximum(-fA * fB, -fa * fb),
                      np.where(linkD > 0, linkd / np.minimum(fA * fb, fa * fB),
                               np.nan))
    return r2, dp


def _linkage(sc: _Scaffold, rd: Dict, read_lvl, cstart, cend, keep_read,
             cfg, low) -> pd.DataFrame:
    """The linkage table of one scaffold at each SNV pair's highest mm."""
    if not sc.link_pos:
        return pd.DataFrame()
    spos = np.concatenate(sc.link_pos)
    smask = np.concatenate(sc.link_mask, axis=1)
    scum = np.concatenate(sc.link_cum, axis=2)              # [M, 4, S]
    spres = np.concatenate(sc.link_present, axis=1)          # [M, S]
    M = len(sc.mm)
    R = rd["bases"].shape[1]
    # counted bases at SNV sites: (read, site) incidences
    r_idx = np.nonzero(keep_read)[0]
    lo = np.searchsorted(spos, cstart[r_idx])
    hi = np.searchsorted(spos, cend[r_idx])
    cnt = hi - lo
    rr = np.repeat(r_idx, cnt)
    si = np.repeat(lo, cnt) + (np.arange(cnt.sum()) -
                               np.repeat(np.cumsum(cnt) - cnt, cnt))
    base = _ACTG[rd["bases"][rr, spos[si] - rd["pos"][rr]]]
    ok = (base < 4) & smask[np.minimum(base, 3), si]
    rr, si, base = rr[ok], si[ok], base[ok]
    if len(rr) < 2:
        return pd.DataFrame()
    p = spos[si]
    win = np.searchsorted(_window_starts(sc.L, cfg["window_length"]), p,
                          side="right") - 1
    q = rd["pair"][rr]
    o = np.lexsort((p, win, q))
    q, win, si, base, lvl = q[o], win[o], si[o], base[o], read_lvl[rr[o]]
    new = np.ones(len(q), dtype=bool)
    new[1:] = (q[1:] != q[:-1]) | (win[1:] != win[:-1])
    starts = np.nonzero(new)[0]
    sizes = np.diff(np.append(starts, len(q)))
    e1, e2, b1, b2, ml = [], [], [], [], []
    for k in np.unique(sizes[sizes >= 2]):
        g = starts[sizes == k]
        i, j = np.triu_indices(int(k), 1)
        a, b = (g[:, None] + i[None, :]).ravel(), (g[:, None] + j[None, :]).ravel()
        e1.append(si[a]); e2.append(si[b])
        b1.append(base[a]); b2.append(base[b]); ml.append(lvl[a])
    if not e1:
        return pd.DataFrame()
    e1, e2 = np.concatenate(e1), np.concatenate(e2)
    b1, b2, ml = np.concatenate(b1), np.concatenate(b2), np.concatenate(ml)
    key = e1 * len(spos) + e2
    ukey, eidx = np.unique(key, return_inverse=True)
    E = len(ukey)
    u1, u2 = ukey // len(spos), ukey % len(spos)
    cntc = np.bincount((eidx * M + ml) * 16 + b1 * 4 + b2,
                       minlength=E * M * 16).reshape(E, M, 16)
    cum16 = np.cumsum(cntc, axis=1)
    c1 = scum[:, :, u1].transpose(2, 0, 1)                   # [E, M, 4]
    c2 = scum[:, :, u2].transpose(2, 0, 1)
    both = spres[:, u1].T & spres[:, u2].T
    sums_ok = (c1.sum(axis=2) + c2.sum(axis=2)) >= cfg["min_snp"]
    o1 = np.argsort(-c1, axis=2, kind="stable")
    o2 = np.argsort(-c2, axis=2, kind="stable")
    A, a_, B, b_ = o1[..., 0], o1[..., 1], o2[..., 0], o2[..., 1]

    def take(c, idx):
        return np.take_along_axis(c, idx[..., None], axis=2)[..., 0]

    nonzero = ((take(c1, A) > 0) & (take(c1, a_) > 0) & (take(c2, B) > 0) &
               (take(c2, b_) > 0))

    def combo(x, y):
        return np.take_along_axis(cum16, (x * 4 + y)[..., None], axis=2)[..., 0]

    AB, Ab, aB, ab = combo(A, B), combo(A, b_), combo(a_, B), combo(a_, b_)
    tot = AB + Ab + aB + ab
    valid = (both & sums_ok & nonzero & (tot > cfg["min_snp"]) &
             (cntc.sum(axis=2) > 0))
    # each SNV pair's row at its highest valid mm
    top = np.where(valid, np.arange(M)[None, :], -1).max(axis=1)
    ei = np.nonzero(top >= 0)[0]
    if not len(ei):
        return pd.DataFrame()
    mi = top[ei]
    t = _f(tot[ei, mi], low)
    fr = [_f(x[ei, mi], low) / t for x in (AB, Ab, aB, ab)]
    r2, dp = _ld(*fr)
    pa, pb = spos[u1[ei]], spos[u2[ei]]
    return pd.DataFrame({
        "scaffold": sc.name, "position_A": pa, "position_B": pb,
        "distance": np.abs(pb - pa),
        "r2": r2.astype(np.float64), "d_prime": dp.astype(np.float64),
        "allele_A": BASES[A[ei, mi]], "allele_a": BASES[a_[ei, mi]],
        "allele_B": BASES[B[ei, mi]], "allele_b": BASES[b_[ei, mi]],
        "countab": ab[ei, mi], "countAb": Ab[ei, mi], "countaB": aB[ei, mi],
        "countAB": AB[ei, mi], "total": tot[ei, mi]})


def reference(cfg: dict, seed: int, precision: str = "reference",
              settings: dict = DEFAULTS, threads: int = 0) -> Dict:
    """The expected profile of the sample that benchmark/gen/reads.py
    writes for (cfg, seed), in the form of outputs.read_profile. Scaffolds,
    and blocks of a long scaffold's positions, are worked out on `threads`
    threads (0: one per CPU, at most 8); the result does not depend on
    how many."""
    if precision not in ("reference", "control"):
        raise ValueError(precision)
    low = precision == "control"
    st = settings
    if cfg["base_quality"] < st["min_base_quality"]:
        raise ValueError("the reference counts every base: base_quality "
                         "must reach the pileup's minimum")
    lay = gen.layout(cfg, seed)
    ctx = dict(cfg=cfg, seed=seed, lay=lay, st=st, low=low,
               thr_null=null_thresholds(st["max_coverage"], st["fdr"],
                                        st["error_rate"]),
               thr_freq=freq_thresholds(st["max_coverage"], st["min_freq"]))
    threads = threads or min(os.cpu_count() or 1, 8)
    with ThreadPoolExecutor(threads) as pool:
        # the read filter needs the median insert of every pair first; the
        # reads are drawn again scaffold by scaffold after it
        inserts = list(pool.map(
            lambda s: gen.scaffold_fragments(cfg, lay, s, seed)[1]["insert"],
            range(len(lay.names))))
        ctx["max_insert"] = (np.median(np.concatenate(inserts)) *
                             st["max_insert_relative"])
        del inserts
        ctx["pool"] = pool
        if len(lay.names) == 1:
            done = [_one_scaffold(ctx, 0)]
        else:
            with ThreadPoolExecutor(threads) as scaffolds:
                done = list(scaffolds.map(lambda s: _one_scaffold(ctx, s),
                                          range(len(lay.names))))
    mapping = pd.DataFrame([d["mapping"] for d in done]).set_index("scaffold")
    kept = [d for d in done if "row" in d]
    scaf = pd.DataFrame([d["row"] for d in kept]).set_index("scaffold")
    snvs = [d["snvs"] for d in kept if len(d["snvs"])]
    links = [d["linkage"] for d in kept if len(d["linkage"])]
    snv = (pd.concat(snvs).set_index(["scaffold", "position"])
           if snvs else pd.DataFrame())
    link = (pd.concat(links).set_index(["scaffold", "position_A",
                                        "position_B"])
            if links else pd.DataFrame())
    genomes = _genome_info(lay, cfg, scaf, mapping, low)
    genomes = genomes.join(_genome_coverage(lay, cfg, done, low))
    return dict(mapping=mapping,
                covT={d["name"]: d["covT"] for d in kept},
                clonT={d["name"]: d["clonT"] for d in kept},
                scaffold_info=scaf, snvs=snv, linkage=link,
                genome_info=genomes, pairs=lay.total_pairs)


def _one_scaffold(ctx: dict, s: int) -> dict:
    """Everything the reference reports of scaffold s."""
    cfg, lay, st, low = ctx["cfg"], ctx["lay"], ctx["st"], ctx["low"]
    name = lay.names[s]
    R = int(cfg["read_length"])
    rd = gen.scaffold_reads(cfg, lay, s, ctx["seed"])
    L = int(lay.lengths[s])
    n = len(rd["insert"])
    nm_pair = np.zeros(n, dtype=np.int64)
    np.add.at(nm_pair, rd["pair"], rd["nm"])
    pid = 1.0 - nm_pair / (2.0 * R)
    ani = pid > st["min_read_ani"]
    ins_max = rd["insert"] < ctx["max_insert"]
    ins_min = rd["insert"] > st["min_insert"]
    passed = ani & ins_max & ins_min & (int(cfg["mapq"]) > st["min_mapq"])
    out = dict(name=name, ref=rd["ref"], mapping=dict(
        scaffold=name, unfiltered_pairs=n, pass_min_read_ani=int(ani.sum()),
        pass_max_insert=int(ins_max.sum()),
        pass_min_insert=int(ins_min.sum()), filtered_pairs=int(passed.sum())))
    if passed.sum() < st["min_scaffold_reads"] or not passed.any():
        return out
    # counted span of each read: the first-starting mate whole, the other
    # from where the first ends (the records are in coordinate order, so a
    # pair's first record is the mate that starts first)
    pos, pair = rd["pos"], rd["pair"]
    first_pos = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(first_pos, pair, pos)
    firstrec = np.zeros(len(pos), dtype=bool)
    firstrec[np.unique(pair, return_index=True)[1]] = True
    cstart = np.where(firstrec, pos, np.maximum(pos, first_pos[pair] + R))
    cend = pos + R
    keep_read = passed[pair] & (cend > cstart)
    mm_values = np.unique(nm_pair[passed])
    read_lvl = np.searchsorted(mm_values, nm_pair[pair])
    sc = _Scaffold(name, L, mm_values)
    ref_idx = _ACTG[rd["ref"]]
    M = len(mm_values)
    live = np.nonzero(keep_read)[0]

    def block(P0: int) -> _Scaffold:
        B = min(BLOCK, L - P0)
        a = np.searchsorted(pos[live], P0 - R, side="right")
        b = np.searchsorted(pos[live], P0 + B, side="left")
        rs = live[a:b]
        # offsets into the block, int32: a block holds 2^18 positions
        p = ((pos[rs] - P0).astype(np.int32)[:, None] +
             np.arange(R, dtype=np.int32)[None, :])
        lo_ = np.maximum(cstart[rs] - P0, 0).astype(np.int32)
        hi_ = np.minimum(cend[rs] - P0, B).astype(np.int32)
        m = (p >= lo_[:, None]) & (p < hi_[:, None])
        bc = _ACTG8[rd["bases"][rs]]
        m &= bc < 4
        flat = ((read_lvl[rs].astype(np.int32)[:, None] * 4 + bc) * B +
                p)[m]
        counts = np.bincount(flat, minlength=M * 4 * B).reshape(M, 4, B)
        part = sc.part()
        _block_stats(part, P0, counts, ref_idx[P0:P0 + B], ctx["thr_null"],
                     ctx["thr_freq"], st, low)
        return part

    starts = range(0, L, BLOCK)
    parts = (list(ctx["pool"].map(block, starts)) if len(starts) > 1
             else [block(0)])
    for part in parts:
        sc.merge(part)
    out["covT"] = {m: tuple(np.concatenate(x) for x in zip(*v))
                   for m, v in sc.covT.items() if v}
    out["clonT"] = {m: tuple(np.concatenate(x) for x in zip(*v))
                    for m, v in sc.clonT.items() if v}
    out["covT"] = {m: v for m, v in out["covT"].items() if len(v[0])}
    out["clonT"] = {m: v for m, v in out["clonT"].items() if len(v[0])}
    out["total"] = sc.total
    out["row"] = _scaffold_row(sc, low)
    out["snvs"] = pd.concat(sc.snv_rows) if sc.snv_rows else pd.DataFrame()
    out["linkage"] = _linkage(sc, rd, read_lvl, cstart, cend, keep_read, st,
                              low)
    return out


def _scaffold_row(sc: _Scaffold, low: bool) -> dict:
    L = sc.L
    total = sc.total.astype(np.float32 if low else np.float64)
    has = ~np.isnan(sc.clon_final)
    counted = int(has.sum())
    c = sc.counts
    if counted:
        clon = sc.clon_final[has].astype(np.float32 if low else np.float64)
        nd = float(1 - clon.mean())
    else:
        nd = np.nan
    return dict(
        scaffold=sc.name, length=L,
        coverage=float(total.mean()),
        breadth=float(_f((sc.total > 0).sum(), low) / _f(L, low)),
        nucl_diversity=nd,
        coverage_median=int(np.median(sc.total)),
        coverage_std=float(total.std()),
        breadth_minCov=float(_f(counted, low) / _f(L, low)),
        conANI_reference=(float(_f(counted - c["con_snps"], low) /
                                _f(max(counted, 1), low)) if counted else 0.0),
        popANI_reference=(float(_f(counted - c["pop_snps"], low) /
                                _f(max(counted, 1), low)) if counted else 0.0),
        SNS_count=c["SNS_count"], SNV_count=c["SNV_count"],
        divergent_site_count=c["divergent_site_count"])


def _genome_info(lay, cfg, scaf: pd.DataFrame, mapping: pd.DataFrame,
                 low: bool) -> pd.DataFrame:
    """genome_info at the highest mm: every profiled scaffold's row."""
    g_of = (dict(zip(lay.names, lay.genomes)) if cfg.get("stb") else
            {n: "all_scaffolds" for n in lay.names})
    glen: Dict[str, int] = {}
    for n, L in zip(lay.names, lay.lengths):
        glen[g_of[n]] = glen.get(g_of[n], 0) + int(L)
    rows = []
    for g in sorted(glen):
        names = [n for n in lay.names if g_of[n] == g]
        d = scaf.loc[[n for n in names if n in scaf.index]]
        if not len(d):
            continue
        gl = _f(glen[g], low)
        Ld = _f(d["length"].values, low)
        considered = _f(d["breadth_minCov"].values, low) * Ld
        cl = considered.sum()
        nd = (float((_f(d["nucl_diversity"].fillna(0).values, low) *
                     considered).sum() / cl) if cl != 0 else np.nan)
        rows.append(dict(
            genome=g, length=int(glen[g]), true_scaffolds=len(names),
            detected_scaffolds=len(d),
            coverage=float((_f(d["coverage"].values, low) * Ld).sum() / gl),
            breadth=float((_f(d["breadth"].values, low) * Ld).sum() / gl),
            nucl_diversity=nd,
            breadth_minCov=float(cl / gl),
            SNS_count=int(d["SNS_count"].sum()),
            SNV_count=int(d["SNV_count"].sum()),
            filtered_read_pair_count=int(
                mapping.loc[names, "filtered_pairs"].sum())))
    return pd.DataFrame(rows).set_index("genome")


EDGE = 100           # bases left out at either end of a scaffold
IREP_WINDOW, IREP_SLIDE = 5000, 100


def _genome_coverage(lay, cfg, done: List[dict], low: bool) -> pd.DataFrame:
    """genome_info's coverage distribution and iRep, per genome with a
    profiled scaffold (`done`: every scaffold's result)."""
    g_of = (dict(zip(lay.names, lay.genomes)) if cfg.get("stb") else
            {n: "all_scaffolds" for n in lay.names})
    seqs = {d["name"]: d["ref"] for d in done}
    done = {d["name"]: d for d in done if "row" in d}
    levels = {m for d in done.values() for m in d["covT"]}
    dt = np.float32 if low else np.float64
    rows = []
    for g in sorted({g_of[n] for n in done}):
        # longest first, as the program orders them; where two scaffolds of
        # a genome share a length its order is its own set's, so iRep may
        # differ: the configurations here give no genome two such scaffolds
        order = sorted((n for n in lay.names if g_of[n] == g),
                       key=lambda n: -int(lay.lengths[lay.names.index(n)]))
        total, low_mm, seq = [], [], []
        for n in order:
            L = int(lay.lengths[lay.names.index(n)])
            t = np.zeros(L, dtype=dt)
            c1 = np.zeros(L, dtype=dt)
            if n in done:
                t[:] = done[n]["total"]
                for m, (pos, val) in done[n]["covT"].items():
                    if m <= 1:
                        c1[pos] += val
            keep = slice(EDGE, L - EDGE) if L >= 2 * EDGE else slice(0, 0)
            total.append(t[keep])
            low_mm.append(c1[keep])
            seq.append(seqs[n][keep])
        covs = np.concatenate(total)
        if not len(covs):
            covs = np.zeros(1, dtype=dt)
        irep, corrected = np.nan, np.nan
        if 1 in levels:
            irep, corrected = _irep(np.concatenate(low_mm),
                                    np.concatenate(seq), len(order), dt)
        rows.append(dict(genome=g, coverage_median=int(np.median(covs)),
                         coverage_std=float(np.std(covs)),
                         coverage_SEM=float(sem(covs)), iRep=irep,
                         iRep_GC_corrected=corrected))
    return pd.DataFrame(rows).set_index("genome")


def _line(x: np.ndarray, y: np.ndarray):
    """Least squares y = m x + b: (m, b, r2); NaN for 2 points or fewer."""
    if len(x) <= 2:
        return np.nan, np.nan, np.nan
    A = np.stack([x, np.ones_like(x)], axis=1)
    (m, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    v = y.var()
    return m, b, (1 - (y - (m * x + b)).var() / v) if v > 0 else np.nan


def _log2(x: np.ndarray) -> np.ndarray:
    return np.log2(np.where(x < 1e-50, 1e-50, x))


def _slope_irep(y: np.ndarray, length: int, dt):
    """2 ** (slope * length) of the sorted values against their evenly
    spaced positions, 5 % of them left out at either end; and the fit's
    r2."""
    n = len(y)
    if not n:
        return np.nan, np.nan
    y = np.sort(y)
    x = (np.arange(n) * (float(length) / n)).astype(np.int64) + 1
    k = int(n * 0.05)
    m, _, r2 = _line(x[k:n - k].astype(dt), y[k:n - k].astype(dt))
    return 2 ** (m * length), r2


def _irep(cov: np.ndarray, seq: np.ndarray, contigs: int, dt):
    """(iRep, whether the GC bias was fitted out) of one genome's
    coverage."""
    length = len(cov)
    if not length:
        return np.nan, np.nan
    ones = np.ones(IREP_WINDOW, dtype=dt)
    win = fftconvolve(cov, ones, "valid")[::IREP_SLIDE] / dt(IREP_WINDOW)
    gcs = ((seq == ord("G")) | (seq == ord("C"))).astype(dt)
    gc = fftconvolve(gcs, ones, "valid")[::IREP_SLIDE] / dt(IREP_WINDOW)
    med = np.median(win)
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = ((win > 0) & (med > 0) &
                (np.maximum(win, med) / np.minimum(win, med) <= 8.0))
    kept = keep.sum() / len(win)
    w, g = win[keep], gc[keep]
    irep, r2 = _slope_irep(_log2(w), length, dt)
    corrected = False
    if len(w):
        m, b, _ = _line(g, w)
        err = np.abs(w - (m * g + b))
        cut = np.sort(err)[::-1][int(len(err) * 0.01)]
        fit = ~(err >= cut)
        m, b, r2g = _line(g[fit], w[fit])
        fixed = w + (w.mean() - (m * g + b)) if r2g >= 0 else w
        irep, r2 = _slope_irep(_log2(fixed), length, dt)
        corrected = True
    if (kept < 0.98 or cov.mean() < 5 or r2 < 0.9 or
            contigs / (length / 1e6) > 175):
        irep = np.nan
    return float(irep), corrected
