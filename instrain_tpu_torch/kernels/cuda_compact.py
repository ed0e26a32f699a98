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
                 :545-567, :629-642): per-tile counts with 16-byte loads,
                 one scan, one 8-byte read of the totals, then each tile's
                 selected cells listed in shared memory and every record
                 column written as one contiguous run.
  mm_aggregates  C2: the per-mm integer and f64 aggregates and the
                 forward-filled clon / clonR (replaces _ffill_expand and
                 :569-627): 2048 positions a block, 8 a thread (256
                 and 1 a thread where that leaves the card few
                 blocks), the
                 per-level sums in registers, packed 0/1 counts folded by
                 one REDUX a word, one atomic per (block, level,
                 quantity) into one buffer zeroed by the launch.
  masked_median  C3: the exact per-mm medians of coverage, clon and clonR
                 by radix select (replaces _median_select, :379-423): a
                 row of a segment of at most MEDIAN_SHORT_KEYS positions is
                 read once into one block's shared memory; a longer row is
                 split over enough blocks to fill the card and read two or
                 three times, its state kept on the device between
                 launches. median_plan says which rows go which way.

As in cuda_sitestats.py, each wrapper takes its plain PyTorch version
(kernels/sitestats.py) only because the tensors it was given lie on the
CPU; for CUDA tensors it launches its kernel on the current stream or
raises KernelError. Each counts its launches in `.launches`
(reset_launch_counts / launch_counts below).
"""

from __future__ import annotations

import ctypes as ct
import itertools
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from . import cuda_sitestats as cs
from . import sitestats as plain
from .cuda_sitestats import _check, _fail, _stream

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
                [P] * 7 + [I, I64, P, I, I, I64] + [P] * 3 + [P])
            med = [P] * 5 + [I, I64, P, I]     # inputs, M, L, segments
            lib.instrain_median_short.restype = I
            lib.instrain_median_short.argtypes = med + [I, P, P]
            lib.instrain_median_long.restype = I
            lib.instrain_median_long.argtypes = med + [P, I, I64, I64] + [
                P, P, P]
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
    dtype, shape, device and layout of every array the kernel reads (each
    message is built only when its check fails: the checks run on every
    call)."""
    missing = [k for k in keys if k not in full]
    if missing:
        _fail(name, f"missing site_stats outputs {missing}")
    total = full["total"]
    if total.dim() != 2:
        _fail(name, "site_stats outputs must be [M, L]")
    M, L = total.shape
    dev = total.device
    if dev.type != "cuda":
        _fail(name, f"unsupported device {dev}")
    if not (M >= 1 and L >= 1 and M * L < 2 ** 31):
        _fail(name, f"[M, L] = [{M}, {L}] out of range")
    shapes = {"ML": (M, L), "L": (L,), "M4L": (M, 4, L)}
    for k in keys:
        dt, kind = _FULL[k]
        t = full[k]
        if t.dtype != dt or t.shape != shapes[kind]:
            _fail(name, f"{k} must be {dt} {shapes[kind]}, got {t.dtype} "
                        f"{tuple(t.shape)}")
        if t.device != dev:
            _fail(name, "inputs on two devices")
        if not t.is_contiguous():
            _fail(name, "inputs must be contiguous")
    return M, L, dev


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_seg(total, seg, name):
    if seg.L != total.shape[-1] or seg.device != total.device:
        _fail(name, "segment table does not match the inputs")


def select_rows(full, seg: plain.Segments):
    """(rows, linkage) as kernels/sitestats.py:select_rows_seg: the SNP
    records of each segment of the chunk in turn, in ascending (position,
    mm) order with positions counted from the segment's start, and the
    [M, 4, n_pos] / [M, n_pos] linkage profiles at the SNV positions, each
    sized exactly; rows["seg_start"] / linkage["seg_start"] [S + 1] hold
    each segment's first record and first SNV position."""
    if full["row"].device.type == "cpu":
        return plain.select_rows_seg(full, seg)
    job = _rows_count(full, seg)
    n_rows, n_pos = (int(x) for x in job.sizes.tolist())   # 8-byte D2H
    out = _rows_gather(job, n_rows, n_pos)
    select_rows.launches += 1
    return out


class _RowsJob(NamedTuple):
    """select_rows between its two launches: the inputs' addresses and the
    device arrays the count launch filled."""
    M: int
    L: int
    dev: torch.device
    ptrs: list
    st: tuple
    row_off: torch.Tensor
    pos_off: torch.Tensor
    starts: torch.Tensor
    sizes: torch.Tensor


def _rows_count(full, seg: plain.Segments) -> _RowsJob:
    """select_rows' first launch (count and scan) on CUDA tensors."""
    name = "select_rows"
    keys = ("row", "any_snp", "cum", "total", "con", "var", "morphia",
            "cls", "cryptic", "present")
    M, L, dev = _check_full(full, keys, name)
    _check_seg(full["total"], seg, name)
    ptrs = [full[k].data_ptr() for k in keys]
    # per tile counts, scanned in place into offsets (entry n_tiles: the
    # totals), each segment's first row and SNV position, the two totals
    T, S = seg.n_tiles + 1, seg.S + 1
    ints = torch.empty(2 * T + 2 * S + 2, dtype=torch.int32, device=dev)
    job = _RowsJob(M, L, dev, ptrs, (seg.table_ptr(), seg.S, seg.n_tiles),
                   ints[:T], ints[T:2 * T], ints[2 * T:2 * T + 2 * S].view(
                       2, S), ints[2 * T + 2 * S:])
    with torch.cuda.device(dev):
        _check(_lib().instrain_rows_count(
            ptrs[0], ptrs[1], M, L, *job.st, job.row_off.data_ptr(),
            job.pos_off.data_ptr(), job.sizes.data_ptr(),
            job.starts[0].data_ptr(), job.starts[1].data_ptr(),
            _stream(full["row"])), name)
    return job


def _rows_gather(job: _RowsJob, n_rows: int, n_pos: int):
    """select_rows' second launch, the outputs sized by the totals: every
    output in one allocation, widest types first (r_total, r_i32, l_pos,
    l_cum, r_codes, r_cryptic, l_present), the views made after the
    launch."""
    M = job.M
    nbytes = [8 * n_rows, 24 * n_rows, 4 * n_pos, 16 * M * n_pos,
              4 * n_rows, n_rows, M * n_pos]
    buf = torch.empty(sum(nbytes), dtype=torch.uint8, device=job.dev)
    at = list(itertools.accumulate(nbytes, initial=buf.data_ptr()))
    if n_rows or n_pos:
        with torch.cuda.device(job.dev):
            _check(_lib().instrain_rows_gather(
                *job.ptrs, M, job.L, *job.st, job.row_off.data_ptr(),
                job.pos_off.data_ptr(), n_rows, n_pos,
                *(at[i] for i in (1, 0, 4, 5, 2, 3, 6)), _stream(buf)),
                "select_rows")
    parts = buf.split(nbytes)
    r_total = parts[0].view(torch.int64)
    r_i32 = parts[1].view(torch.int32).view(6, n_rows)
    r_codes = parts[4].view(torch.int8).view(4, n_rows)
    rows = dict(pos=r_i32[0], mm_idx=r_i32[1], A=r_i32[2], C=r_i32[3],
                T=r_i32[4], G=r_i32[5], total=r_total, con=r_codes[0],
                var=r_codes[1], morphia=r_codes[2], cls=r_codes[3],
                cryptic=parts[5].view(torch.bool), n_rows=n_rows,
                seg_start=job.starts[0])
    linkage = dict(pos=parts[2].view(torch.int32),
                   cum=parts[3].view(torch.int32).view(M, 4, n_pos),
                   present=parts[6].view(torch.bool).view(M, n_pos),
                   n_pos=n_pos, seg_start=job.starts[1])
    return rows, linkage


select_rows.launches = 0


# mm_aggregates takes AGG_PER positions a thread (blocks of a big tile,
# sitestats.BIG_TILE) while that gives the card AGG_MIN_BLOCKS_PER_SM
# blocks a SM, else one (blocks of a tile, sitestats.TILE): a launch of
# few big tiles (one 250 kb segment: 123 for 132 SMs) waits on its few
# blocks' per-level latency
AGG_PER = 8
AGG_MIN_BLOCKS_PER_SM = 2


def aggregates_per_thread(n_btiles: int, sms: int) -> int:
    """mm_aggregates' positions a thread for a chunk of n_btiles big
    tiles on a card of `sms` SMs."""
    return AGG_PER if n_btiles >= AGG_MIN_BLOCKS_PER_SM * sms else 1


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
    S = seg.S
    per = aggregates_per_thread(seg.n_btiles, _sms(dev))
    # the aggregates in one buffer, zeroed by the launch: [10, S, M] int64,
    # [2, S, M] f64, [S, M] bool
    n_i, n_f = len(plain.AGG_INT), len(plain.AGG_F64)
    agg_buf = torch.empty((8 * (n_i + n_f) + 1) * S * M, dtype=torch.uint8,
                          device=dev)
    clon_f = torch.empty((M, L), dtype=torch.float32, device=dev)
    clonR_f = torch.empty((M, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _check(lib.instrain_mm_aggregates(
            *[full[k].data_ptr() for k in keys], M, L, seg.table_ptr(),
            S, per, seg.n_btiles if per > 1 else seg.n_tiles,
            agg_buf.data_ptr(), clon_f.data_ptr(), clonR_f.data_ptr(),
            _stream(clon_f)), name)
    parts = agg_buf.split([8 * n_i * S * M, 8 * n_f * S * M, S * M])
    agg_i = parts[0].view(torch.int64).view(n_i, S, M)
    agg_f = parts[1].view(torch.float64).view(n_f, S, M)
    active = parts[2].view(torch.bool).view(S, M)
    mm_aggregates.launches += 1
    agg = dict(zip(plain.AGG_INT, agg_i))
    agg.update(zip(plain.AGG_F64, agg_f))
    agg["mm_active"] = active
    return agg, clon_f, clonR_f


mm_aggregates.launches = 0


# masked_median: the longest segment whose rows one block holds in shared
# memory (4 bytes a key, beside the kernel's own 8 KB histogram, within the
# 227 KB a block may take; compact.cu's kShortKeysMax, to which it raises
# the short kernel's shared memory once); longer rows are split over blocks
# of at least MEDIAN_MIN_CHUNK keys, enough to give each SM
# MEDIAN_BLOCKS_PER_SM, each row with 8 words of state, a histogram of
# MEDIAN_BINS bins and a ticket.
MEDIAN_SHORT_KEYS = 49152
MEDIAN_MIN_CHUNK = 16384
MEDIAN_BLOCKS_PER_SM = 8
MEDIAN_BINS = 2048


class MedianPlan(NamedTuple):
    """How masked_median splits a chunk's rows (one per segment, mm level
    and value set): every row of a segment of at most MEDIAN_SHORT_KEYS
    positions is one block's, short_keys the longest such segment rounded
    up to a multiple of 4 (0 when there is none); the rows of each long
    segment are split into chunks of `chunk` positions, one block each,
    long segment i's chunk blocks starting at first_block[i]
    (first_block[-1]: the chunk blocks in all)."""
    short_keys: int
    short_segments: Tuple[int, ...]
    long_segments: Tuple[int, ...]
    chunk: int
    first_block: Tuple[int, ...]


def median_plan(lengths, M: int, sms: int = 132) -> MedianPlan:
    """The plan for segments of `lengths` at M mm levels on a card of
    `sms` SMs (plain Python: it runs before every launch)."""
    short = tuple(s for s, n in enumerate(lengths) if n <= MEDIAN_SHORT_KEYS)
    long_ = tuple(s for s, n in enumerate(lengths) if n > MEDIAN_SHORT_KEYS)
    short_keys = -(-max(lengths[s] for s in short) // 4) * 4 if short else 0
    chunk, first = 0, [0]
    if long_:
        keys = sum(lengths[s] for s in long_) * 3 * M
        # a multiple of 4096 keys, rounded down: at least the blocks asked
        chunk = max(MEDIAN_MIN_CHUNK,
                    keys // (sms * MEDIAN_BLOCKS_PER_SM) // 4096 * 4096)
        for s in long_:
            first.append(first[-1] - (-lengths[s] // chunk))
    return MedianPlan(short_keys, short, long_, chunk, tuple(first))


_SMS: Dict[int, int] = {}


def _sms(dev) -> int:
    """The device's SM count, read once."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def masked_median(total, clon_f, clonR_f, counted, rarefied,
                  seg: plain.Segments):
    """cov_median, clon_median, clonR_median [S, M] f32 of [S, M] counted
    and rarefied, as kernels/sitestats.py:masked_medians_seg."""
    name = "masked_median"
    if total.device.type == "cpu":
        return plain.masked_medians_seg(total, clon_f, clonR_f, counted,
                                        rarefied, seg)
    if total.device.type != "cuda":
        _fail(name, f"unsupported device {total.device}")
    if total.dim() != 2 or total.dtype != torch.int64:
        _fail(name, "total must be int64 [M, L]")
    M, L = total.shape
    if not (M >= 1 and L >= 1 and M * L < 2 ** 31):
        _fail(name, f"[M, L] = [{M}, {L}] out of range")
    _check_seg(total, seg, name)
    if seg.S * M >= 2 ** 31:
        _fail(name, "too many (segment, mm) rows")
    agg_shape = (seg.S, M)
    for t, dt, shape in ((clon_f, torch.float32, (M, L)),
                         (clonR_f, torch.float32, (M, L)),
                         (counted, torch.int64, agg_shape),
                         (rarefied, torch.int64, agg_shape)):
        if t.dtype != dt or t.shape != shape:
            _fail(name, f"expected {dt} {shape}, got {t.dtype} "
                        f"{tuple(t.shape)}")
    for t in (total, clon_f, clonR_f, counted, rarefied):
        if t.device != total.device:
            _fail(name, "inputs on two devices")
        if not t.is_contiguous():
            _fail(name, "inputs must be contiguous")
    dev = total.device
    off = seg.off.tolist()
    plan = median_plan([b - a for a, b in zip(off, off[1:])], M, _sms(dev))
    n_long = len(plan.long_segments)
    n_blocks = plan.first_block[-1]
    if seg.S * 3 * M >= 2 ** 31 or n_blocks * 3 * M >= 2 ** 31:
        _fail(name, "too many (segment, mm, value set) rows")
    out = torch.empty((3,) + agg_shape, dtype=torch.float32, device=dev)
    args = (total.data_ptr(), clon_f.data_ptr(), clonR_f.data_ptr(),
            counted.data_ptr(), rarefied.data_ptr(), M, L, seg.table_ptr(),
            seg.S)
    lib = _lib()
    with torch.cuda.device(dev):
        s = _stream(total)
        if plan.short_keys:
            _check(lib.instrain_median_short(*args, plan.short_keys,
                                             out.data_ptr(), s), name)
        if n_long:
            # the long segments and their first chunk blocks, from pinned
            # memory on the stream (none for a chunk of one segment)
            table = None
            if seg.S > 1:
                table = torch.tensor(
                    plan.long_segments + plan.first_block,
                    dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
            # per long row: 8 words of state, a histogram, a ticket
            scratch = torch.empty(n_long * 3 * M * (8 + MEDIAN_BINS + 1),
                                  dtype=torch.int32, device=dev)
            _check(lib.instrain_median_long(
                *args, None if table is None else table.data_ptr(), n_long,
                plan.chunk, n_blocks, scratch.data_ptr(), out.data_ptr(), s),
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
