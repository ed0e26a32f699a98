"""
The hand-written Hopper kernels of the device compaction (K4) and their
wrappers — the counterpart of instrain_tpu/kernels/sitestats.py:
_compact_from_full (:533-646) and site_stats_compact (:426-441), over
the segment table (sitestats.Segments) of site_stats_compact_batch
(:446-465, K5): one launch of each kernel for a chunk of scaffolds laid
end to end. One scaffold is a chunk of one segment
(cuda_sitestats.single_segment).

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
            seg = [P, I, I64]          # segment table, S, tiles
            lib.instrain_rows_count.restype = I
            lib.instrain_rows_count.argtypes = ([P, P, I, I64] + seg +
                                                [P] * 5 + [P])
            lib.instrain_rows_gather.restype = I
            lib.instrain_rows_gather.argtypes = (
                [P] * 10 + [I, I64] + seg + [P, P, I, I] + [P] * 7 + [P])
            lib.instrain_mm_aggregates.restype = I
            lib.instrain_mm_aggregates.argtypes = (
                [P] * 7 + [I, I64] + seg + [P] * 5 + [P])
            lib.instrain_masked_median.restype = I
            lib.instrain_masked_median.argtypes = ([P] * 5 + [I, I64, P, I] +
                                                   [P, P])
            _bound = True
    return lib


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


def _check_seg(total, seg, name):
    _require(seg.L == total.shape[-1] and seg.device == total.device, name,
             "segment table does not match the inputs")


def select_rows(full, seg: plain.Segments):
    """(rows, linkage) as kernels/sitestats.py:select_rows_seg: the SNP
    records of each segment of the chunk in turn, in ascending (position,
    mm) order with positions counted from the segment's start, and the
    [M, 4, n_pos] / [M, n_pos] linkage profiles at the SNV positions, each
    sized exactly; rows["seg_start"] / linkage["seg_start"] [S + 1] hold
    each segment's first record and first SNV position."""
    name = "select_rows"
    if full["row"].device.type == "cpu":
        return plain.select_rows_seg(full, seg)
    keys = ("row", "any_snp", "cum", "total", "con", "var", "morphia",
            "cls", "cryptic", "present")
    M, L, dev = _check_full(full, keys, name)
    _check_seg(full["total"], seg, name)
    lib = _lib()
    row_off = torch.empty(seg.n_tiles, dtype=torch.int32, device=dev)
    pos_off = torch.empty(seg.n_tiles, dtype=torch.int32, device=dev)
    starts = torch.empty((2, seg.S + 1), dtype=torch.int32, device=dev)
    sizes = torch.empty(2, dtype=torch.int32, device=dev)
    st = (seg.table_ptr(), seg.S, seg.n_tiles)
    with torch.cuda.device(dev):
        s = _stream(full["row"])
        _check(lib.instrain_rows_count(
            full["row"].data_ptr(), full["any_snp"].data_ptr(), M, L, *st,
            row_off.data_ptr(), pos_off.data_ptr(), sizes.data_ptr(),
            starts[0].data_ptr(), starts[1].data_ptr(), s), name)
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
                *[full[k].data_ptr() for k in keys], M, L, *st,
                row_off.data_ptr(), pos_off.data_ptr(), n_rows, n_pos,
                r_i32.data_ptr(), r_total.data_ptr(), r_codes.data_ptr(),
                r_cryptic.data_ptr(), l_pos.data_ptr(), l_cum.data_ptr(),
                l_present.data_ptr(), s), name)
    select_rows.launches += 1
    rows = dict(pos=r_i32[0], mm_idx=r_i32[1], A=r_i32[2], C=r_i32[3],
                T=r_i32[4], G=r_i32[5], total=r_total, con=r_codes[0],
                var=r_codes[1], morphia=r_codes[2], cls=r_codes[3],
                cryptic=r_cryptic, n_rows=n_rows)
    rows["seg_start"] = starts[0]
    linkage = dict(pos=l_pos, cum=l_cum, present=l_present, n_pos=n_pos,
                   seg_start=starts[1])
    return rows, linkage


select_rows.launches = 0


def mm_aggregates(full, seg: plain.Segments):
    """(agg, clon_f, clonR_f) as kernels/sitestats.py:mm_aggregates_seg:
    each aggregate [S, M], the filled clon / clonR [M, Ltot]."""
    name = "mm_aggregates"
    if full["total"].device.type == "cpu":
        return plain.mm_aggregates_seg(full, seg)
    keys = ("total", "clon", "clonR", "row", "morphia", "cls", "present")
    M, L, dev = _check_full(full, keys, name)
    _check_seg(full["total"], seg, name)
    lib = _lib()
    shape = (seg.S, M)
    agg_i = torch.zeros((len(plain.AGG_INT),) + shape, dtype=torch.int64,
                        device=dev)
    agg_f = torch.zeros((len(plain.AGG_F64),) + shape, dtype=torch.float64,
                        device=dev)
    active = torch.zeros(shape, dtype=torch.bool, device=dev)
    clon_f = torch.empty((M, L), dtype=torch.float32, device=dev)
    clonR_f = torch.empty((M, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _check(lib.instrain_mm_aggregates(
            *[full[k].data_ptr() for k in keys], M, L, seg.table_ptr(),
            seg.S, seg.n_tiles, agg_i.data_ptr(), agg_f.data_ptr(),
            active.data_ptr(), clon_f.data_ptr(), clonR_f.data_ptr(),
            _stream(agg_i)), name)
    mm_aggregates.launches += 1
    agg = dict(zip(plain.AGG_INT, agg_i))
    agg.update(zip(plain.AGG_F64, agg_f))
    agg["mm_active"] = active
    return agg, clon_f, clonR_f


mm_aggregates.launches = 0


def masked_median(total, clon_f, clonR_f, counted, rarefied,
                  seg: plain.Segments):
    """cov_median, clon_median, clonR_median [S, M] f32 of [S, M] counted
    and rarefied, as kernels/sitestats.py:masked_medians_seg."""
    name = "masked_median"
    if total.device.type == "cpu":
        return plain.masked_medians_seg(total, clon_f, clonR_f, counted,
                                        rarefied, seg)
    _require(total.device.type == "cuda", name,
             f"unsupported device {total.device}")
    _require(total.dim() == 2 and total.dtype == torch.int64, name,
             "total must be int64 [M, L]")
    M, L = total.shape
    _require(M >= 1 and L >= 1 and M * L < 2 ** 31, name,
             f"[M, L] = [{M}, {L}] out of range")
    _check_seg(total, seg, name)
    _require(seg.S * M < 2 ** 31, name, "too many (segment, mm) rows")
    agg_shape = (seg.S, M)
    for t, dt, shape in ((clon_f, torch.float32, (M, L)),
                         (clonR_f, torch.float32, (M, L)),
                         (counted, torch.int64, agg_shape),
                         (rarefied, torch.int64, agg_shape)):
        _require(t.dtype == dt and tuple(t.shape) == shape, name,
                 f"expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in (total, clon_f, clonR_f, counted, rarefied):
        _require(t.device == total.device, name, "inputs on two devices")
        _require(t.is_contiguous(), name, "inputs must be contiguous")
    out = torch.empty((3,) + agg_shape, dtype=torch.float32,
                      device=total.device)
    with torch.cuda.device(total.device):
        _check(_lib().instrain_masked_median(
            total.data_ptr(), clon_f.data_ptr(), clonR_f.data_ptr(),
            counted.data_ptr(), rarefied.data_ptr(), M, L, seg.table_ptr(),
            seg.S, out.data_ptr(), _stream(total)),
            name)
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


def compact_from_full(full, seg: plain.Segments) -> Dict[str, Dict]:
    """K4 through the three kernels (or their plain versions, for CPU
    tensors): dict(rows, agg, linkage, masks) as
    kernels/sitestats.py:compact_from_full, of every segment of the chunk
    ([S, M] aggregates, rows and linkage with seg_start)."""
    rows, linkage = select_rows(full, seg)
    agg, clon_f, clonR_f = mm_aggregates(full, seg)
    agg.update(masked_median(full["total"], clon_f, clonR_f,
                             agg["counted"], agg["rarefied"], seg))
    masks = {k: full[k] for k in ("cryptic", "any_snp", "bases_mask")}
    return dict(rows=rows, agg=agg, linkage=linkage, masks=masks)


def site_stats_compact(counts, ref_codes, null_lut, freq_lut,
                       seg: plain.Segments, m_stride: int, min_cov: int = 5,
                       min_covR: int = 50, rarefied_draws: int = 50
                       ) -> Dict[str, Dict]:
    """cuda_sitestats.site_stats followed by compact_from_full, with every
    dense tensor kept on the counts' device, for the chunk of scaffolds
    `seg` describes. The result also holds dense=dict(clon, clonR), the
    [M, Ltot] f32 arrays storage needs."""
    full = cs.site_stats(counts, ref_codes, null_lut, freq_lut, seg,
                         min_cov=min_cov, min_covR=min_covR,
                         rarefied_draws=rarefied_draws, m_stride=m_stride)
    out = compact_from_full(full, seg)
    out["dense"] = dict(clon=full["clon"], clonR=full["clonR"])
    return out
