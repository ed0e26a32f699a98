"""
Per-site statistics in plain PyTorch: the counterpart of
instrain_tpu/kernels/sitestats.py:site_stats (and its rarefied-clonality
helpers), with the same output dict, dtypes and values.

Takes the dense per-scaffold pileup counts[M, 4, L] (M = read-pair
mismatch levels observed on the scaffold, 4 = ACTG, L = positions) and
computes for every (mm level, position) cell what the reference computes
per pileup column (inStrain/profile/snv_utilities.py:update_snp_table
40-145 and call_snv_site 147-196): cumulative counts over mm' <= mm,
null-model SNV calls through integer LUTs, consensus/variant bases, SNP
classes, clonality and its rarefied variant, the cryptic-SNV scan over
ascending mm, and the linkage position masks.

These are the plain versions the CUDA kernels are held against
(kernels/cuda_sitestats.py); they run on any device. Float arithmetic
follows the JAX function as XLA's CPU backend evaluates it, so every
output is bit-identical to it: p = cum / max(total, 1) in f32, cdf = p0,
p0+p1, (p0+p1)+p2, sums of four squares as the FMA chain XLA contracts
them into (_sum_squares4), and the rarefied frequencies as counts times
the f32 reciprocal of the draw count.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

# class codes (order matches reference string names for table emission)
CLASS_NAMES = ["SNS", "SNV", "con_SNV", "pop_SNV", "DivergentSite",
               "AmbiguousReference"]
SNS, SNV, CON_SNV, POP_SNV, DIVERGENT, AMBIG = range(6)

# call codes
CALL_UNCOUNTED = -2  # coverage below min_cov (reference: None)
CALL_NOSNP = -1      # one dominant reference base (reference: -1)

_M32 = 0xFFFFFFFF


def freq_min_count_lut(min_freq: float,
                       max_coverage: int = 10000) -> np.ndarray:
    """
    LUT: for each total coverage T, the smallest count c with
    float64(c / T) >= min_freq — reproducing the reference's float division
    semantics (snv_utilities.py:179) with integer comparisons.
    """
    T = np.arange(max_coverage + 1, dtype=np.float64)
    c = np.ceil(min_freq * T).astype(np.int64)
    # fix boundary rounding: the true smallest c may be c-1 or c+1
    for delta in (-1, 0, 1):
        cc = c + delta
        with np.errstate(divide="ignore", invalid="ignore"):
            ok = (cc.astype(np.float64) / np.maximum(T, 1)) >= min_freq
        c = np.where(ok & (cc >= 0), np.minimum(c, cc), c)
    c[0] = 0
    return c.astype(np.int32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11 — the permutation
    JAX's default PRNG uses). uint32 values held in int64 tensors (or
    Python ints), every sum reduced mod 2^32: torch has no uint32
    arithmetic on every device."""
    ks0, ks1 = k0, k1
    ks2 = 0x1BD11BDA ^ ks0 ^ ks1

    def four(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    ra = (13, 15, 26, 6)
    rb = (17, 29, 16, 24)
    x0 = (x0 + ks0) & _M32
    x1 = (x1 + ks1) & _M32
    x0, x1 = four(x0, x1, ra)
    x0 = (x0 + ks1) & _M32
    x1 = (x1 + ks2 + 1) & _M32
    x0, x1 = four(x0, x1, rb)
    x0 = (x0 + ks2) & _M32
    x1 = (x1 + ks0 + 2) & _M32
    x0, x1 = four(x0, x1, ra)
    x0 = (x0 + ks0) & _M32
    x1 = (x1 + ks1 + 3) & _M32
    x0, x1 = four(x0, x1, rb)
    x0 = (x0 + ks1) & _M32
    x1 = (x1 + ks2 + 4) & _M32
    x0, x1 = four(x0, x1, ra)
    x0 = (x0 + ks2) & _M32
    x1 = (x1 + ks0 + 5) & _M32
    return x0, x1


def _ctr_uniform(k0: int, k1: int, ctr0, ctr1):
    """Uniform [0, 1) float32 at counter (ctr0, ctr1) under key (k0, k1):
    the first threefry output word, mantissa-stuffed into [1, 2) and
    shifted down (jax.random.uniform's bits->float construction)."""
    b0, _ = _threefry2x32(k0, k1, ctr0, ctr1)
    bits = ((b0 >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def key_words(key) -> Sequence[int]:
    """(k0, k1) Python ints from a uint32[2] key (compact._fold_keys)."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _clonR_values(key, cdf, pos_idx, rarefied_draws: int,
                  m_stride: int):
    """Rarefied clonality from `rarefied_draws` categorical draws of the
    per-base cumulative probabilities cdf [M, 3, P] (f32) at positions
    pos_idx [P] (int64). Draw d at mm row m, position p uses counter
    (d * m_stride + m, p): m_stride is the mm extent of the counter space
    (the JAX package pads M to a multiple of 8 and counts in the padded
    extent). Returns [M, P] f32 sum((count_b / draws)^2)."""
    k0, k1 = key_words(key)
    M, _, P = cdf.shape
    dev = cdf.device
    m_idx = torch.arange(M, dtype=torch.int64, device=dev)[:, None]
    p_idx = pos_idx.to(torch.int64)[None, :].expand(M, P)
    rcounts = torch.zeros((4, M, P), dtype=torch.float32, device=dev)
    for d in range(rarefied_draws):
        u = _ctr_uniform(k0, k1, (d * m_stride + m_idx) & _M32, p_idx)
        cat = ((u > cdf[:, 0]).to(torch.int64) + (u > cdf[:, 1]) +
               (u > cdf[:, 2]))
        rcounts.scatter_add_(0, cat[None], torch.ones_like(rcounts[:1]))
    # XLA rewrites the reference's division by the constant draw count
    # into a product with the f32 reciprocal; so does this
    inv = torch.tensor(np.float32(1.0) / np.float32(rarefied_draws),
                       device=dev)
    rp = rcounts * inv
    return _sum_squares4(rp[0], rp[1], rp[2], rp[3])


def _cdf(cum, total):
    """f32 cumulative base probabilities [M, 3, L] in the JAX order."""
    p = cum.to(torch.float32) / torch.clamp(
        total.to(torch.float32), min=1.0)[:, None, :]
    c0 = p[:, 0]
    c1 = c0 + p[:, 1]
    c2 = c1 + p[:, 2]
    return torch.stack([c0, c1, c2], dim=1), p


def _fma32(a, b, c):
    """Single-rounding f32 a * b + c (the CUDA kernels' __fmaf_rn), exact
    for finite non-negative normal values: a * b is exact in f64, the f64
    sum's rounding error is recovered with TwoSum, and the one case where
    rounding the f64 sum to f32 could round twice — the sum lying exactly
    halfway between two f32 values — is resolved by the error's sign."""
    prod = a.double() * b.double()
    cd = c.double()
    s = prod + cd
    bb = s - prod
    err = (prod - (s - bb)) + (cd - bb)
    halfway = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(halfway & (err != 0), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _sum_squares4(x0, x1, x2, x3):
    """x0^2 + x1^2 + x2^2 + x3^2 in f32 as the JAX reference computes it
    on its CPU backend: XLA contracts the 4-term reduce of squares into
    the chain fma(x3, x3, fma(x2, x2, fma(x1, x1, x0 * x0)))."""
    return _fma32(x3, x3, _fma32(x2, x2, _fma32(x1, x1, x0 * x0)))


def site_stats(counts, ref_codes, null_lut, freq_lut, key,
               min_cov: int = 5, min_covR: int = 50,
               rarefied_draws: int = 50, with_clonR: bool = True,
               m_stride: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """
    Args:
      counts: int [M, 4, L] — exact-mm base counts per position
      ref_codes: uint8 [L] — reference base codes (A0 C1 T2 G3, 4=other)
      null_lut: int32 [maxcov+1] — null-model min alternate count by coverage
      freq_lut: int32 [maxcov+1] — min count satisfying min_freq by coverage
      key: uint32[2] key for the rarefied draws
      m_stride: mm extent of the rarefied-draw counter (default M)

    Returns the JAX function's dict: [M, L] arrays (present, total int64,
    morphia/con/var/call/cls int8, row, clon/clonR f32, clonR_set,
    ref_count int64), cum [M, 4, L] int32, and [L] / [4, L] position
    masks (cryptic, any_snp, bases_mask). with_clonR=False leaves out
    clonR (the CUDA path computes it with its own kernel).
    """
    counts = counts.to(torch.int32)
    M, _, L = counts.shape
    dev = counts.device
    maxcov = null_lut.shape[0] - 1
    ref_b = ref_codes.to(torch.int64)                          # [L]

    present = counts.sum(dim=1, dtype=torch.int64) > 0          # [M, L]
    cum = torch.cumsum(counts, dim=0, dtype=torch.int32)        # [M, 4, L]
    total = cum.sum(dim=1, dtype=torch.int64)                   # [M, L]
    total_c = torch.clamp(total, max=maxcov)

    # ---- null-model base presence ----
    min_bases = null_lut.to(torch.int64)[total_c]               # [M, L]
    freq_min = freq_lut.to(torch.int64)[total_c]
    thresh = torch.maximum(min_bases, freq_min)[:, None, :]
    morphia = (cum >= thresh).sum(dim=1).to(torch.int8)

    # argmax returns the first maximum: ties go to the lower ACTG code
    con = torch.argmax(cum, dim=1)                              # [M, L]
    novar = cum.masked_fill(
        torch.arange(4, device=dev)[None, :, None] == con[:, None, :], 0)
    var = torch.argmax(novar, dim=1)

    counted = total >= min_cov
    con_is_ref = con == ref_b[None, :]
    is_base_call = (morphia > 1) | ((morphia == 1) & ~con_is_ref) | \
        (morphia == 0)
    call = torch.where(is_base_call, con.to(torch.int8),
                       torch.tensor(CALL_NOSNP, dtype=torch.int8,
                                    device=dev))
    call = torch.where(counted, call,
                       torch.tensor(CALL_UNCOUNTED, dtype=torch.int8,
                                    device=dev))
    row = present & counted & is_base_call

    # ---- SNP class ----
    ref_sel = torch.clamp(ref_b, 0, 3)                          # 4 -> G
    ref_count = torch.gather(
        cum, 1, ref_sel[None, None, :].expand(M, 1, L))[:, 0].to(
            torch.int64)
    ref_present = (ref_count >= min_bases) & (ref_count >= freq_min)
    var_is_ref = var == ref_b[None, :]
    cls = torch.full((M, L), POP_SNV, dtype=torch.int8, device=dev)
    cls[var_is_ref | ref_present] = CON_SNV
    cls[con_is_ref] = SNV
    cls[morphia == 1] = SNS
    cls[morphia == 0] = DIVERGENT
    cls[(ref_b >= 4)[None, :].expand(M, L)] = AMBIG

    # ---- clonality ----
    _, p = _cdf(cum, total)
    clon_val = _sum_squares4(p[:, 0], p[:, 1], p[:, 2], p[:, 3])
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    clon = torch.where(present & counted, clon_val, nan)

    clonR_set = present & (total >= min_covR)

    # ---- cryptic state machine over ascending mm ----
    emits_snp = row & (morphia >= 2)
    any_snp_incl = torch.cumsum(emits_snp.to(torch.int32), dim=0) > 0
    any_snp_before = torch.zeros_like(any_snp_incl)
    any_snp_before[1:] = any_snp_incl[:-1]
    cryptic_here = present & counted & any_snp_before & (
        (call == CALL_NOSNP) | (morphia == 1))
    cryptic = cryptic_here.any(dim=0)
    any_snp = any_snp_incl[-1]
    bases = torch.arange(4, device=dev)[None, :, None]
    bases_mask = (((con[:, None, :] == bases) | (var[:, None, :] == bases))
                  & emits_snp[:, None, :]).any(dim=0)           # [4, L]

    out = dict(
        present=present, cum=cum, total=total, morphia=morphia,
        con=con.to(torch.int8), var=var.to(torch.int8), call=call, row=row,
        cls=cls, clon=clon, clonR_set=clonR_set,
        cryptic=cryptic, any_snp=any_snp, bases_mask=bases_mask,
        ref_count=ref_count,
    )
    if with_clonR:
        out["clonR"] = clonR_values(cum, total, clonR_set, key,
                                    rarefied_draws,
                                    M if m_stride is None else m_stride)
    return out


def clonR_values(cum, total, clonR_set, key, rarefied_draws: int,
                 m_stride: int):
    """Rarefied clonality [M, L] f32 at the cells where clonR_set holds
    (NaN elsewhere), drawn densely over every cell."""
    cdf, _ = _cdf(cum, total)
    L = cum.shape[2]
    vals = _clonR_values(key, cdf,
                         torch.arange(L, dtype=torch.int64,
                                      device=cum.device),
                         rarefied_draws, m_stride)
    return torch.where(clonR_set, vals,
                       torch.tensor(float("nan"), dtype=torch.float32,
                                    device=cum.device))


# ---------------------------------------------------------------------------
# Device compaction (K4): the counterpart of instrain_tpu/kernels/
# sitestats.py:_compact_from_full (:533-646). From the dense site_stats
# outputs it computes the SNP rows (position-major), the per-mm scaffold
# aggregates make_coverage_table needs (exact medians, f64 clonality sums),
# the SNV-position count profiles linkage needs, and the position masks.
# The outputs are sized exactly: no capacities, no -1 padding, so the
# JAX dicts' `valid` fields have no counterpart here.

AGG_INT = ("cov_sum", "cov_sumsq", "nonzeros", "counted", "rarefied",
           "div_sites", "sns", "snv", "con_snps", "pop_snps")
AGG_F64 = ("clon_sum", "clonR_sum")
AGG_MEDIAN = ("cov_median", "clon_median", "clonR_median")


def first_set_indices(mask):
    """Ascending indices (int64) of the set elements of a 1-D bool mask."""
    return torch.nonzero(mask).flatten()


def ffill_expand(vals_list, set_mask, fills):
    """Forward-fill each array down the mm axis (axis 0): out[m] = value at
    the highest m' <= m where set_mask (else that array's fill). Returns
    (filled_list, have) with have[m] = any(set_mask[:m+1])."""
    M = set_mask.shape[0]
    m_idx = torch.arange(M, device=set_mask.device).view(
        (M,) + (1,) * (set_mask.dim() - 1))
    last = torch.where(set_mask, m_idx, -1).cummax(dim=0).values
    have = last >= 0
    src = last.clamp(min=0)
    outs = [torch.where(have, torch.gather(v, 0, src),
                        torch.full_like(v, f))
            for v, f in zip(vals_list, fills)]
    return outs, have


def median_select(vals_f32, count):
    """Exact masked median per row: vals [R, L] f32 with non-members set
    to +inf (members >= 0), count [R] members per row. The mean, in f32,
    of the lower and upper middle order statistics (k1 = (c-1)//2 + 1,
    k2 = c//2 + 1); NaN where count is 0."""
    c = count.clamp(min=1).to(torch.int64)
    srt = torch.sort(vals_f32, dim=1).values
    v1 = torch.gather(srt, 1, ((c - 1) // 2)[:, None])[:, 0]
    v2 = torch.gather(srt, 1, (c // 2)[:, None])[:, 0]
    med = (v1 + v2) / 2
    return torch.where(count > 0, med, torch.full_like(med, float("nan")))


def select_rows(full):
    """(rows, linkage): the SNP rows where full["row"] holds, ascending
    (position, mm), and the linkage count profiles at the positions where
    full["any_snp"] holds."""
    row, cum = full["row"], full["cum"]
    M = row.shape[0]
    ridx = first_set_indices(row.T.reshape(-1))
    r_pos, r_mm = ridx // M, ridx % M
    rows = dict(pos=r_pos.to(torch.int32), mm_idx=r_mm.to(torch.int32))
    for b, name in enumerate("ACTG"):
        rows[name] = cum[r_mm, b, r_pos]
    rows["total"] = full["total"][r_mm, r_pos]
    for k in ("con", "var", "morphia", "cls"):
        rows[k] = full[k][r_mm, r_pos]
    rows["cryptic"] = full["cryptic"][r_pos]
    rows["n_rows"] = int(ridx.numel())
    pidx = first_set_indices(full["any_snp"])
    linkage = dict(pos=pidx.to(torch.int32), cum=cum[:, :, pidx],
                   present=full["present"][:, pidx],
                   n_pos=int(pidx.numel()))
    return rows, linkage


def mm_aggregates(full):
    """(agg, clon_f, clonR_f): the integer and f64 per-mm aggregates
    (AGG_INT, AGG_F64, mm_active), and the forward-filled clon / clonR
    [M, L] f32 with +inf where no mm' <= m is set — the median inputs."""
    total, row, clon, clonR = (full["total"], full["row"], full["clon"],
                               full["clonR"])
    inf = float("inf")
    agg = dict(cov_sum=total.sum(dim=1), cov_sumsq=(total * total).sum(dim=1),
               nonzeros=(total > 0).sum(dim=1))
    filled = {}
    for name, vals, cnt, sm in (("clon", clon, "counted", "clon_sum"),
                                ("clonR", clonR, "rarefied", "clonR_sum")):
        (f,), has = ffill_expand([vals], ~torch.isnan(vals), [inf])
        agg[cnt] = has.sum(dim=1)
        agg[sm] = torch.where(has, f, 0.0).to(torch.float64).sum(dim=1)
        filled[name] = f
    # morphia and class share the `row` mask: fill one packed code
    enc = (full["morphia"].to(torch.int32) << 3) | full["cls"].to(torch.int32)
    (enc_f,), have_row = ffill_expand([enc], row, [-1])
    mor_f, cls_f = enc_f >> 3, enc_f & 7
    agg["div_sites"] = have_row.sum(dim=1)
    agg["sns"] = (have_row & (mor_f == 1)).sum(dim=1)
    agg["snv"] = (have_row & (mor_f > 1)).sum(dim=1)
    agg["con_snps"] = (have_row & ((cls_f == SNS) | (cls_f == CON_SNV) |
                                   (cls_f == POP_SNV))).sum(dim=1)
    agg["pop_snps"] = (have_row & ((cls_f == SNS) |
                                   (cls_f == POP_SNV))).sum(dim=1)
    agg["mm_active"] = full["present"].any(dim=1)
    return agg, filled["clon"], filled["clonR"]


def masked_medians(total, clon_f, clonR_f, counted, rarefied):
    """cov_median (total as f32 over every position, zeros included),
    clon_median and clonR_median (over the filled values), each [M] f32."""
    M, L = total.shape
    every = torch.full((M,), L, dtype=torch.int64, device=total.device)
    return dict(cov_median=median_select(total.to(torch.float32), every),
                clon_median=median_select(clon_f, counted),
                clonR_median=median_select(clonR_f, rarefied))


def compact_from_full(full, M: int, L: int) -> Dict[str, Dict]:
    """K4 on the site_stats outputs of an [M, L] scaffold: dict(rows, agg,
    linkage, masks) with the JAX function's key names and dtypes."""
    assert tuple(full["total"].shape) == (M, L), (full["total"].shape, M, L)
    rows, linkage = select_rows(full)
    agg, clon_f, clonR_f = mm_aggregates(full)
    agg.update(masked_medians(full["total"], clon_f, clonR_f,
                              agg["counted"], agg["rarefied"]))
    masks = {k: full[k] for k in ("cryptic", "any_snp", "bases_mask")}
    return dict(rows=rows, agg=agg, linkage=linkage, masks=masks)


# ---------------------------------------------------------------------------
# Chunks of scaffolds (K5): the counterpart of instrain_tpu/kernels/
# sitestats.py:site_stats_compact_batch (:446-465). The JAX package pads a
# chunk's scaffolds to one [S, Mp, 4, Lp] shape and vmaps over them; here
# they lie end to end on the position axis, [M, 4, Ltot], so nothing is
# padded to a common length (Segments). site_stats is position-local and
# runs on the chunk as it is; the rarefied draws and the compaction work
# per segment, each with its own key and with positions counted from the
# segment's start. The plain versions below loop over the segments with
# the one-scaffold functions above, which is what the JAX batch gives per
# scaffold (its pos_ok mask keeps padded positions out of every
# aggregate).

TILE = 256              # positions per block of the tiled kernels (kTile)
BIG_TILE = 2048         # positions per block of mm_aggregates (kBigTile)


class Segments:
    """The segment table of a chunk: S scaffolds of the given lengths laid
    end to end, each with its uint32[2] key. `table` is the kernels' copy
    on `device` (csrc/segments.cuh): offsets, first tiles, keys and first
    big tiles; a chunk of one segment has none (None), and its kernels
    take the key `key0` as an argument instead."""

    def __init__(self, lengths, keys, device="cpu"):
        lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
        self.keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
        assert len(lengths) == len(self.keys) >= 1 and (lengths >= 1).all()
        self.S = len(lengths)
        self.off = np.concatenate([[0], np.cumsum(lengths)])
        self.tile0 = np.concatenate([[0], np.cumsum(-(-lengths // TILE))])
        self.btile0 = np.concatenate([[0], np.cumsum(-(-lengths //
                                                        BIG_TILE))])
        self.L = int(self.off[-1])
        self.n_tiles = int(self.tile0[-1])
        self.n_btiles = int(self.btile0[-1])
        packed = ((self.keys[:, 0].astype(np.uint64) << np.uint64(32)) |
                  self.keys[:, 1].astype(np.uint64))
        self.key0 = int(packed[0])
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # as the device of a tensor placed on "cuda" reads
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.table = None
        if self.S > 1 and self.device.type == "cuda":
            # from pinned memory on the current stream, so that the host
            # does not wait for the stream's earlier work
            self.table = torch.from_numpy(np.concatenate(
                [self.off, self.tile0, packed.view(np.int64), [0],
                 self.btile0])
            ).pin_memory().to(self.device, non_blocking=True)

    def table_ptr(self):
        """The table's device address for the kernels (None: one segment)."""
        return None if self.table is None else self.table.data_ptr()

    def bounds(self, s: int):
        return int(self.off[s]), int(self.off[s + 1])


def _slice_positions(full, a: int, b: int):
    """The [a, b) positions of every array of a site_stats dict (the
    position axis is the last)."""
    return {k: v[..., a:b] for k, v in full.items()}


def clonR_values_seg(cum, total, clonR_set, seg: Segments,
                     rarefied_draws: int, m_stride: int):
    """clonR_values per segment, under the segment's key."""
    return torch.cat([clonR_values(cum[:, :, a:b], total[:, a:b],
                                   clonR_set[:, a:b], seg.keys[s],
                                   rarefied_draws, m_stride)
                      for s, (a, b) in enumerate(map(seg.bounds,
                                                     range(seg.S)))], dim=1)


def select_rows_seg(full, seg: Segments):
    """select_rows per segment, the records of all segments in segment
    order (positions counted from each segment's start), with
    rows["seg_start"] / linkage["seg_start"] [S + 1]: each segment's first
    record and first SNV position."""
    parts = [select_rows(_slice_positions(full, *seg.bounds(s)))
             for s in range(seg.S)]
    rows = {k: torch.cat([r[k] for r, _ in parts])
            for k in parts[0][0] if k != "n_rows"}
    link = dict(pos=torch.cat([lk["pos"] for _, lk in parts]),
                cum=torch.cat([lk["cum"] for _, lk in parts], dim=2),
                present=torch.cat([lk["present"] for _, lk in parts], dim=1))
    for d, n in ((rows, "n_rows"), (link, "n_pos")):
        counts = [(r if d is rows else lk)[n] for r, lk in parts]
        d[n] = int(sum(counts))
        d["seg_start"] = torch.tensor(np.concatenate([[0], np.cumsum(
            counts)]), dtype=torch.int32, device=full["row"].device)
    return rows, link


def mm_aggregates_seg(full, seg: Segments):
    """mm_aggregates per segment: each aggregate [S, M]; the filled clon /
    clonR [M, Ltot]."""
    parts = [mm_aggregates(_slice_positions(full, *seg.bounds(s)))
             for s in range(seg.S)]
    agg = {k: torch.stack([p[0][k] for p in parts]) for k in parts[0][0]}
    return (agg, torch.cat([p[1] for p in parts], dim=1),
            torch.cat([p[2] for p in parts], dim=1))


def masked_medians_seg(total, clon_f, clonR_f, counted, rarefied,
                       seg: Segments):
    """masked_medians per segment, each median [S, M]."""
    parts = []
    for s in range(seg.S):
        a, b = seg.bounds(s)
        parts.append(masked_medians(total[:, a:b], clon_f[:, a:b],
                                    clonR_f[:, a:b], counted[s],
                                    rarefied[s]))
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
