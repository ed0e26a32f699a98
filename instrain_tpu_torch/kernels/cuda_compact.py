"""
The hand-written Hopper kernels of the device compaction (K4) and their
wrappers — the counterpart of instrain_tpu/kernels/sitestats.py:
_compact_from_full (:533-646) and site_stats_compact (:426-441).

Three kernels, CUDA C++ in csrc/compact.cu (built with the others by
build.cuda_kernels_library, bound with ctypes):

  select_rows    C1: the SNP rows and the linkage profiles at SNV
                 positions, by a two-pass stream compaction sized exactly
                 (replaces _first_set_indices and the row/linkage gathers,
                 :545-567, :629-642).
  mm_aggregates  C2: the per-mm integer and f64 aggregates and the
                 forward-filled clon / clonR (replaces _ffill_expand and
                 :569-627).
  masked_median  C3: the exact per-mm medians of coverage, clon and clonR
                 by radix select (replaces _median_select, :379-423).

As in cuda_sitestats.py, each wrapper takes its plain PyTorch version
(kernels/sitestats.py) only because the tensors it was given lie on the
CPU; for CUDA tensors it launches its kernel on the current stream or
raises KernelError. Each counts its launches in `.launches`
(reset_launch_counts / launch_counts below).
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import Dict

import numpy as np
import torch

from . import cuda_sitestats as cs
from . import sitestats as plain
from .cuda_sitestats import _check, _require, _stream

_bound = False
_bind_lock = threading.Lock()


def _lib():
    """The kernels' library with this module's entry points declared."""
    global _bound
    lib = cs._load()
    with _bind_lock:
        if not _bound:
            P, I, I64 = ct.c_void_p, ct.c_int, ct.c_int64
            lib.instrain_rows_count.restype = I
            lib.instrain_rows_count.argtypes = [P, P, I, I64, P, P, P, P]
            lib.instrain_rows_gather.restype = I
            lib.instrain_rows_gather.argtypes = (
                [P] * 10 + [I, I64, P, P, I, I] + [P] * 7 + [P])
            lib.instrain_mm_aggregates.restype = I
            lib.instrain_mm_aggregates.argtypes = (
                [P] * 7 + [I, I64] + [P] * 5 + [P])
            lib.instrain_masked_median.restype = I
            lib.instrain_masked_median.argtypes = [P] * 5 + [I, I64, P, P]
            _bound = True
    return lib


_THREADS = 256          # positions per block of C1 (compact.cu kThreads)

# the site_stats outputs each kernel reads: name -> (dtype, shape kind)
_FULL = {"row": (torch.bool, "ML"), "any_snp": (torch.bool, "L"),
         "cum": (torch.int32, "M4L"), "total": (torch.int64, "ML"),
         "con": (torch.int8, "ML"), "var": (torch.int8, "ML"),
         "morphia": (torch.int8, "ML"), "cls": (torch.int8, "ML"),
         "cryptic": (torch.bool, "L"), "present": (torch.bool, "ML"),
         "clon": (torch.float32, "ML"), "clonR": (torch.float32, "ML")}


def _check_full(full, keys, name):
    """(M, L, device) of a site_stats output dict, after checking the
    dtype, shape, device and layout of every array the kernel reads."""
    missing = [k for k in keys if k not in full]
    _require(not missing, name, f"missing site_stats outputs {missing}")
    _require(full["total"].dim() == 2, name,
             "site_stats outputs must be [M, L]")
    M, L = full["total"].shape
    dev = full["total"].device
    _require(dev.type == "cuda", name, f"unsupported device {dev}")
    _require(M >= 1 and L >= 1 and M * L < 2 ** 31, name,
             f"[M, L] = [{M}, {L}] out of range")
    shapes = {"ML": (M, L), "L": (L,), "M4L": (M, 4, L)}
    for k in keys:
        dt, kind = _FULL[k]
        t = full[k]
        _require(t.dtype == dt and tuple(t.shape) == shapes[kind], name,
                 f"{k} must be {dt} {shapes[kind]}, got {t.dtype} "
                 f"{tuple(t.shape)}")
        _require(t.device == dev, name, "inputs on two devices")
        _require(t.is_contiguous(), name, "inputs must be contiguous")
    return M, L, dev


# ---------------------------------------------------------------------------
# kernel wrappers


def select_rows(full):
    """(rows, linkage) as kernels/sitestats.py:select_rows: SNP records in
    ascending (position, mm) order and the [M, 4, n_pos] / [M, n_pos]
    linkage profiles at the SNV positions, each sized exactly."""
    name = "select_rows"
    if full["row"].device.type == "cpu":
        return plain.select_rows(full)
    keys = ("row", "any_snp", "cum", "total", "con", "var", "morphia",
            "cls", "cryptic", "present")
    M, L, dev = _check_full(full, keys, name)
    lib = _lib()
    nblocks = -(-L // _THREADS)
    row_off = torch.empty(nblocks, dtype=torch.int32, device=dev)
    pos_off = torch.empty(nblocks, dtype=torch.int32, device=dev)
    sizes = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        s = _stream(full["row"])
        _check(lib.instrain_rows_count(
            full["row"].data_ptr(), full["any_snp"].data_ptr(), M, L,
            row_off.data_ptr(), pos_off.data_ptr(), sizes.data_ptr(), s),
            name)
        n_rows, n_pos = (int(x) for x in sizes.tolist())   # 8-byte D2H
        r_i32 = torch.empty((6, n_rows), dtype=torch.int32, device=dev)
        r_total = torch.empty(n_rows, dtype=torch.int64, device=dev)
        r_codes = torch.empty((4, n_rows), dtype=torch.int8, device=dev)
        r_cryptic = torch.empty(n_rows, dtype=torch.bool, device=dev)
        l_pos = torch.empty(n_pos, dtype=torch.int32, device=dev)
        l_cum = torch.empty((M, 4, n_pos), dtype=torch.int32, device=dev)
        l_present = torch.empty((M, n_pos), dtype=torch.bool, device=dev)
        if n_rows or n_pos:
            _check(lib.instrain_rows_gather(
                *[full[k].data_ptr() for k in keys], M, L,
                row_off.data_ptr(), pos_off.data_ptr(), n_rows, n_pos,
                r_i32.data_ptr(), r_total.data_ptr(), r_codes.data_ptr(),
                r_cryptic.data_ptr(), l_pos.data_ptr(), l_cum.data_ptr(),
                l_present.data_ptr(), s), name)
    select_rows.launches += 1
    rows = dict(pos=r_i32[0], mm_idx=r_i32[1], A=r_i32[2], C=r_i32[3],
                T=r_i32[4], G=r_i32[5], total=r_total, con=r_codes[0],
                var=r_codes[1], morphia=r_codes[2], cls=r_codes[3],
                cryptic=r_cryptic, n_rows=n_rows)
    linkage = dict(pos=l_pos, cum=l_cum, present=l_present, n_pos=n_pos)
    return rows, linkage


select_rows.launches = 0


def mm_aggregates(full):
    """(agg, clon_f, clonR_f) as kernels/sitestats.py:mm_aggregates."""
    name = "mm_aggregates"
    if full["total"].device.type == "cpu":
        return plain.mm_aggregates(full)
    keys = ("total", "clon", "clonR", "row", "morphia", "cls", "present")
    M, L, dev = _check_full(full, keys, name)
    lib = _lib()
    agg_i = torch.zeros((len(plain.AGG_INT), M), dtype=torch.int64,
                        device=dev)
    agg_f = torch.zeros((len(plain.AGG_F64), M), dtype=torch.float64,
                        device=dev)
    active = torch.zeros(M, dtype=torch.bool, device=dev)
    clon_f = torch.empty((M, L), dtype=torch.float32, device=dev)
    clonR_f = torch.empty((M, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _check(lib.instrain_mm_aggregates(
            *[full[k].data_ptr() for k in keys], M, L, agg_i.data_ptr(),
            agg_f.data_ptr(), active.data_ptr(), clon_f.data_ptr(),
            clonR_f.data_ptr(), _stream(agg_i)), name)
    mm_aggregates.launches += 1
    agg = dict(zip(plain.AGG_INT, agg_i))
    agg.update(zip(plain.AGG_F64, agg_f))
    agg["mm_active"] = active
    return agg, clon_f, clonR_f


mm_aggregates.launches = 0


def masked_median(total, clon_f, clonR_f, counted, rarefied):
    """cov_median, clon_median, clonR_median [M] f32 as
    kernels/sitestats.py:masked_medians."""
    name = "masked_median"
    if total.device.type == "cpu":
        return plain.masked_medians(total, clon_f, clonR_f, counted,
                                    rarefied)
    _require(total.device.type == "cuda", name,
             f"unsupported device {total.device}")
    _require(total.dim() == 2 and total.dtype == torch.int64, name,
             "total must be int64 [M, L]")
    M, L = total.shape
    _require(M >= 1 and L >= 1 and M * L < 2 ** 31, name,
             f"[M, L] = [{M}, {L}] out of range")
    for t, dt, shape in ((clon_f, torch.float32, (M, L)),
                         (clonR_f, torch.float32, (M, L)),
                         (counted, torch.int64, (M,)),
                         (rarefied, torch.int64, (M,))):
        _require(t.dtype == dt and tuple(t.shape) == shape, name,
                 f"expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in (total, clon_f, clonR_f, counted, rarefied):
        _require(t.device == total.device, name, "inputs on two devices")
        _require(t.is_contiguous(), name, "inputs must be contiguous")
    out = torch.empty((3, M), dtype=torch.float32, device=total.device)
    with torch.cuda.device(total.device):
        _check(_lib().instrain_masked_median(
            total.data_ptr(), clon_f.data_ptr(), clonR_f.data_ptr(),
            counted.data_ptr(), rarefied.data_ptr(), M, L, out.data_ptr(),
            _stream(total)), name)
    masked_median.launches += 1
    return dict(zip(plain.AGG_MEDIAN, out))


masked_median.launches = 0


def reset_launch_counts() -> None:
    select_rows.launches = 0
    mm_aggregates.launches = 0
    masked_median.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"select_rows": select_rows.launches,
            "mm_aggregates": mm_aggregates.launches,
            "masked_median": masked_median.launches}


# ---------------------------------------------------------------------------
# K4 and the compact site-stats path


def compact_from_full(full, M: int, L: int) -> Dict[str, Dict]:
    """K4 through the three kernels (or their plain versions, for CPU
    tensors): dict(rows, agg, linkage, masks) as
    kernels/sitestats.py:compact_from_full."""
    _require(tuple(full["total"].shape) == (M, L), "compact",
             f"site_stats outputs are {tuple(full['total'].shape)}, "
             f"not [{M}, {L}]")
    rows, linkage = select_rows(full)
    agg, clon_f, clonR_f = mm_aggregates(full)
    agg.update(masked_median(full["total"], clon_f, clonR_f,
                             agg["counted"], agg["rarefied"]))
    masks = {k: full[k] for k in ("cryptic", "any_snp", "bases_mask")}
    return dict(rows=rows, agg=agg, linkage=linkage, masks=masks)


def site_stats_compact(counts, ref_codes, null_lut, freq_lut, key,
                       m_stride: int, min_cov: int = 5, min_covR: int = 50,
                       rarefied_draws: int = 50) -> Dict[str, Dict]:
    """cuda_sitestats.site_stats followed by compact_from_full, with every
    dense tensor kept on the counts' device. The result also holds
    dense=dict(clon, clonR), the [M, L] f32 arrays storage needs."""
    full = cs.site_stats(counts, ref_codes, null_lut, freq_lut, key,
                         min_cov=min_cov, min_covR=min_covR,
                         rarefied_draws=rarefied_draws, m_stride=m_stride)
    M, _, L = counts.shape
    out = compact_from_full(full, M, L)
    out["dense"] = dict(clon=full["clon"], clonR=full["clonR"])
    return out


def to_host(tree) -> Dict:
    """A nested dict of tensors as numpy arrays, with one copy per
    underlying buffer: the views the kernels' outputs are split into
    (rows, aggregates) come back together. Non-tensor leaves pass
    through."""
    if isinstance(tree, dict):
        copies: Dict[int, torch.Tensor] = {}
        return {k: _leaf_to_host(v, copies) if not isinstance(v, dict)
                else to_host(v) for k, v in tree.items()}
    return tree


def _leaf_to_host(t, copies):
    if not isinstance(t, torch.Tensor):
        return t
    if t.device.type == "cpu":
        return t.numpy()
    base = t if t._base is None else t._base
    host = copies.get(id(base))
    if host is None:
        host = copies[id(base)] = base.cpu()
    return np.asarray(host.as_strided(
        t.shape, t.stride(), t.storage_offset() - base.storage_offset()))
