"""
SNV linkage disequilibrium (r2, D, D') — vectorized reimplementation of the
reference's networkx-based pipeline (inStrain/profile/linkage.py); the
host path of instrain_tpu/profile/linkage.py.

Capture model (reference: update_linked_reads, linkage.py:254-283): at every
position flagged anySNP, each counted read carrying one of the position's
{con, var} bases (over morphia>=2 calls) contributes "position:base"; pairs
of captured bases WITHIN a read (and within the same profile window — the
reference computes linkage per 10 kb split, reads never link across splits,
SURVEY §5.7) become combo counts keyed by the read pair's mismatch level.

LD model (reference: _iterator_ld_sites + _calc_ld_single, linkage.py:
78-240): per edge, iterate mm levels present at BOTH positions; cumulative
combo counts over mm' <= mm; require every single-allele count > 0 and
combo total > min_snp; compute r2 / D' plus rarefied variants from a
min_snp-sized multinomial draw. On a CUDA device, scaffolds with many
captured pairs run the same model through the device LD kernel
(kernels/cuda_linkage.py), as the JAX package does on an accelerator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch

from .pileup import ScaffoldStats

BASES = "ACTG"

LINKAGE_COLUMNS = ["r2", "d_prime", "r2_normalized", "d_prime_normalized",
                   "total", "countAB", "countAb", "countaB", "countab",
                   "allele_A", "allele_a", "allele_B", "allele_b",
                   "distance", "position_A", "position_B", "mm", "scaffold"]


def _pair_templates(max_k: int = 64):
    cache = {}

    def get(k: int):
        if k not in cache:
            i, j = np.triu_indices(k, 1)
            cache[k] = (i, j)
        return cache[k]

    return get


def counted_snv_events(stats: ScaffoldStats):
    """Counted events at SNV positions, filtered to the con/var linkage
    bases — computed ONCE per scaffold and memoized on the stats object.
    Both linkage capture and the read-to-SNV export need exactly this
    extraction, and each native select_events call scans every event of
    the scaffold (two passes measured ~3.5 s per 48-scaffold batch
    iteration). Returns (pos, base, mm_idx, qname) arrays."""
    ev = getattr(stats, "_snv_events", None)
    if ev is not None:
        return ev
    pu = stats.pileup
    any_snp = np.asarray(stats.any_snp)
    if not any_snp.any():
        ev = (np.zeros(0, np.int32), np.zeros(0, np.uint8),
              np.zeros(0, np.int32), np.zeros(0, np.int64))
    else:
        pos, base, mm_idx, qname = pu.select_events(
            any_snp.astype(np.uint8))
        keep = stats.bases_mask[base, pos]
        ev = (pos[keep], base[keep], mm_idx[keep], qname[keep])
    stats._snv_events = ev
    return ev


def capture_read_pairs(stats: ScaffoldStats,
                       window_starts: np.ndarray) -> np.ndarray:
    """
    Enumerate within-read SNV base pairs.

    Returns int64 array [N, 5]: (p1, p2, b1, b2, mm_idx) with p1 < p2 in
    the same window. mm_idx indexes stats.mm_values (the read pair's mm).
    """
    pos, base, mm_idx, qname = counted_snv_events(stats)
    if len(pos) == 0:
        return np.zeros((0, 5), dtype=np.int64)

    win = np.searchsorted(window_starts, pos, side="right") - 1
    order = np.lexsort((pos, win, qname))
    pos, base, mm_idx, qname, win = (pos[order], base[order], mm_idx[order],
                                     qname[order], win[order])
    key_change = np.empty(len(pos), dtype=bool)
    key_change[0] = True
    key_change[1:] = (qname[1:] != qname[:-1]) | (win[1:] != win[:-1])
    starts = np.nonzero(key_change)[0]
    sizes = np.diff(np.append(starts, len(pos)))

    tmpl = _pair_templates()
    out = []
    for k in np.unique(sizes):
        if k < 2:
            continue
        gi = starts[sizes == k]
        i, j = tmpl(int(k))
        # [G, P] absolute indices
        ai = gi[:, None] + i[None, :]
        aj = gi[:, None] + j[None, :]
        out.append(np.stack([pos[ai].ravel(), pos[aj].ravel(),
                             base[ai].ravel(), base[aj].ravel(),
                             mm_idx[ai].ravel()], axis=1))
    if not out:
        return np.zeros((0, 5), dtype=np.int64)
    return np.concatenate(out).astype(np.int64)


# engine="auto" runs the device LD kernel on a CUDA device from this many
# captured pairs on (instrain_tpu/profile/linkage.py:135-138)
DEVICE_MIN_PAIRS = 100_000


def resolve_linkage_engine(engine: str, device, n_pairs: int) -> str:
    """The engine one scaffold's linkage runs, as the JAX package picks it:
    auto is device on an accelerator at >= DEVICE_MIN_PAIRS captured
    pairs, host otherwise."""
    if engine == "auto":
        dev = torch.device(device) if device is not None else None
        return ("device" if dev is not None and dev.type == "cuda" and
                n_pairs >= DEVICE_MIN_PAIRS else "host")
    if engine not in ("host", "device"):
        raise ValueError(f"unknown linkage engine {engine!r}")
    return engine


def calculate_linkage(stats: ScaffoldStats, window_starts: np.ndarray,
                      min_snp: int = 20, seed: int = 42,
                      scaffold: Optional[str] = None,
                      engine: str = "auto", device=None) -> pd.DataFrame:
    """Build the raw_linkage_table for one scaffold.

    engine: "host" (numpy), "device" (the ld kernel, csrc/linkage.cu, on
    `device`; its plain PyTorch version on the CPU), or "auto"
    (resolve_linkage_engine). The two engines agree in every column but
    the rarefied ones, which the device engine draws with the
    counter-based generator of the JAX package's device engine and the
    host engine with numpy's."""
    scaffold = scaffold or stats.pileup.name
    pairs = capture_read_pairs(stats, window_starts)
    if len(pairs) == 0:
        return pd.DataFrame()

    M = len(stats.mm_values)
    # unique edges
    edge_key = pairs[:, 0] * (1 << 32) + pairs[:, 1]
    uedges, e_idx = np.unique(edge_key, return_inverse=True)
    E = len(uedges)
    p1 = (uedges >> 32).astype(np.int64)
    p2 = (uedges & 0xFFFFFFFF).astype(np.int64)

    if resolve_linkage_engine(engine, device, len(pairs)) == "device":
        return _calculate_linkage_device(stats, pairs, e_idx, M, p1, p2,
                                         min_snp, seed, scaffold,
                                         device or "cpu")

    combo = pairs[:, 2] * 4 + pairs[:, 3]
    flat = (e_idx * M + pairs[:, 4]) * 16 + combo
    cnt = np.bincount(flat, minlength=E * M * 16).reshape(E, M, 16)
    cumcombo = np.cumsum(cnt, axis=1)                 # [E, M, 16]

    c1, pr1 = _gather_pos_stats(stats, p1)            # [E, M, 4], [E, M]
    c2, pr2 = _gather_pos_stats(stats, p2)
    both_present = pr1 & pr2                          # [E, M]

    sums_ok = (c1.sum(axis=2) + c2.sum(axis=2)) >= min_snp

    # major/minor alleles: stable argsort of -counts keeps ACTG tie order,
    # matching sorted(d, key=d.get, reverse=True) (linkage.py:133-136)
    o1 = np.argsort(-c1, axis=2, kind="stable")
    o2 = np.argsort(-c2, axis=2, kind="stable")
    A, a_ = o1[:, :, 0], o1[:, :, 1]
    B, b_ = o2[:, :, 0], o2[:, :, 1]

    def take(c, idx):
        return np.take_along_axis(c, idx[:, :, None], axis=2)[:, :, 0]

    A_c, a_c = take(c1, A), take(c1, a_)
    B_c, b_c = take(c2, B), take(c2, b_)
    nonzero_ok = (A_c > 0) & (a_c > 0) & (B_c > 0) & (b_c > 0)

    def combo_at(x, y):
        idx = (x * 4 + y)[:, :, None]
        return np.take_along_axis(cumcombo, idx, axis=2)[:, :, 0]

    AB = combo_at(A, B)
    Ab = combo_at(A, b_)
    aB = combo_at(a_, B)
    ab = combo_at(a_, b_)
    total = AB + Ab + aB + ab
    total_ok = total > min_snp

    # the reference only evaluates mm levels carrying combo records on this
    # edge (it iterates mm2combo2counts keys, linkage.py:93)
    has_combo_exact = cnt.sum(axis=2) > 0

    valid = (both_present & sums_ok & nonzero_ok & total_ok &
             has_combo_exact)  # [E, M]
    if not valid.any():
        return pd.DataFrame()

    ei, mi = np.nonzero(valid)
    fAB = AB[ei, mi] / total[ei, mi]
    fAb = Ab[ei, mi] / total[ei, mi]
    faB = aB[ei, mi] / total[ei, mi]
    fab = ab[ei, mi] / total[ei, mi]

    r2, d_prime = _ld_math(fAB, fAb, faB, fab)

    # rarefied draw (reference uses an unseeded np.random.choice,
    # linkage.py:200; we use a fixed-seed multinomial — deterministic,
    # statistically equivalent)
    rng = np.random.default_rng(seed)
    draws = rng.multinomial(min_snp, np.stack([fAB, fAb, faB, fab], axis=1))
    rAB, rAb, raB, rab = (draws[:, k] / min_snp for k in range(4))
    r2n, d_primen = _ld_math(rAB, rAb, raB, rab)

    base_arr = np.array(list(BASES))
    df = pd.DataFrame({
        "r2": r2, "d_prime": d_prime,
        "r2_normalized": r2n, "d_prime_normalized": d_primen,
        "total": total[ei, mi],
        "countAB": AB[ei, mi], "countAb": Ab[ei, mi],
        "countaB": aB[ei, mi], "countab": ab[ei, mi],
        "allele_A": base_arr[A[ei, mi]], "allele_a": base_arr[a_[ei, mi]],
        "allele_B": base_arr[B[ei, mi]], "allele_b": base_arr[b_[ei, mi]],
        "distance": np.abs(p1[ei] - p2[ei]),
        "position_A": p1[ei], "position_B": p2[ei],
        "mm": stats.mm_values[mi].astype(np.int64),
        "scaffold": scaffold,
    })
    return df.sort_values(["position_A", "position_B", "mm"]).reset_index(
        drop=True)


# ld's inputs in the staging buffer: each at a multiple of this many bytes
_STAGE_ALIGN = 128


def _copy_to_device(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """The one copy of the device linkage engine's inputs to `dev`."""
    return host.to(dev, non_blocking=True) if dev.type == "cuda" else host


def _copy_to_host(buf: torch.Tensor) -> torch.Tensor:
    """The one copy of ld's output buffer back to the host."""
    if buf.device.type != "cuda":
        return buf
    host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    torch.cuda.current_stream(buf.device).synchronize()
    return host


def _stage(arrays, device) -> list:
    """The host arrays in one buffer (pinned for a GPU), each at a
    multiple of _STAGE_ALIGN bytes, copied to `device` in one copy:
    tensors on `device` viewing it, in the arrays' order, shapes and
    dtypes."""
    dev = torch.device(device)
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
    host = torch.empty(n, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    view = host.numpy()
    for a, o in zip(arrays, offs):
        view[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = _copy_to_device(host, dev)
    return [buf[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def _device_ld_args(stats, pairs, e_idx, M, p1, p2, min_snp, seed,
                    device):
    """The ld kernel's arguments for one scaffold, its tensors views of one
    buffer on `device` (one copy from the host): the pairs' edge, mm and
    combo indices, the cumulative counts and presence at each edge's two
    positions, the key fold_in(seed, rid), min_snp and the counter's mm
    stride ceil8(M)."""
    from .compact import _fold_keys

    c1, pr1 = _gather_pos_stats(stats, p1)            # [E, M, 4], [E, M]
    c2, pr2 = _gather_pos_stats(stats, p2)
    tensors = _stage([np.ascontiguousarray(a, dtype=dt) for a, dt in (
        (e_idx, np.int32), (pairs[:, 4], np.int32),
        (pairs[:, 2] * 4 + pairs[:, 3], np.int32), (c1, np.int32),
        (c2, np.int32), (pr1, np.bool_), (pr2, np.bool_))], device)
    return (*tensors, _fold_keys(seed, [stats.pileup.rid])[0], int(min_snp),
            -(-M // 8) * 8)


def _calculate_linkage_device(stats, pairs, e_idx, M, p1, p2, min_snp,
                              seed, scaffold, device) -> pd.DataFrame:
    """Device LD (instrain_tpu/profile/linkage.py:222-292): the combo
    scatter-add and the allele/gate/r2/D' math in the ld kernel; the host
    enumerates the pairs and builds the table. Nothing is padded: the
    kernel counts its draws in the JAX caller's padded mm extent
    ceil8(M), which is all the padding changes. One copy each way: the
    inputs in one buffer, ld's outputs in one buffer, unpacked here."""
    from ..kernels import cuda_linkage

    host = _copy_to_host(cuda_linkage.ld_packed(
        *_device_ld_args(stats, pairs, e_idx, M, p1, p2, min_snp, seed,
                         device)))
    out = {k: v.numpy() for k, v in
           cuda_linkage.unpack_ld(host, len(p1), M).items()}
    valid = out.pop("valid")
    if not valid.any():
        return pd.DataFrame()
    ri, mj = np.nonzero(valid)
    out = {k: v[ri, mj] for k, v in out.items()}
    base_arr = np.array(list(BASES))
    df = pd.DataFrame({
        "r2": out["r2"], "d_prime": out["d_prime"],
        "r2_normalized": out["r2_normalized"],
        "d_prime_normalized": out["d_prime_normalized"],
        "total": out["total"],
        "countAB": out["AB"], "countAb": out["Ab"],
        "countaB": out["aB"], "countab": out["ab"],
        "allele_A": base_arr[out["A"]], "allele_a": base_arr[out["a"]],
        "allele_B": base_arr[out["B"]], "allele_b": base_arr[out["b"]],
        "distance": np.abs(p1[ri] - p2[ri]),
        "position_A": p1[ri], "position_B": p2[ri],
        "mm": stats.mm_values[mj].astype(np.int64),
        "scaffold": scaffold,
    })
    return df.sort_values(["position_A", "position_B", "mm"]).reset_index(
        drop=True)


def _gather_pos_stats(stats, positions):
    """(cum counts [E, M, 4], exact-mm presence [E, M]) at positions —
    from dense arrays or from the compacted per-SNV-position profiles."""
    if hasattr(stats, "linkage"):  # CompactStats
        lk = stats.linkage
        idx = np.searchsorted(lk["pos"], positions)
        assert np.array_equal(lk["pos"][idx], positions), "position missing"
        return (lk["cum"][:, :, idx].transpose(2, 0, 1),
                lk["present"][:, idx].T)
    cum = stats.cum
    present = stats.present
    return (cum[:, :, positions].transpose(2, 0, 1),
            (present[:, positions]).T)


def _ld_math(fAB, fAb, faB, fab):
    """r2 and D' from haplotype frequencies (linkage.py:168-228)."""
    fA = fAB + fAb
    fa = fab + faB
    fB = fAB + faB
    fb = fab + fAb
    linkD = fAB - fA * fB
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where((fa == 0) | (fA == 0) | (fB == 0) | (fb == 0), np.nan,
                      linkD * linkD / (fA * fa * fB * fb))
    linkd = fab - fa * fb
    d_prime = np.full_like(linkd, np.nan)
    neg = linkd < 0
    with np.errstate(divide="ignore", invalid="ignore"):
        denom_neg = np.maximum(-fA * fB, -fa * fb)
        d_prime = np.where(neg, linkd / denom_neg, d_prime)
        pos = linkD > 0
        denom_pos = np.minimum(fA * fb, fa * fB)
        d_prime = np.where(pos & ~neg, linkd / denom_pos, d_prime)
    return r2, d_prime


def window_starts_for(length: int, window_length: int = 10000) -> np.ndarray:
    """Window start positions matching the reference's split layout."""
    from ..io.fasta import iterate_splits
    return np.array([s for s, _ in iterate_splits(length, window_length)],
                    dtype=np.int64)
