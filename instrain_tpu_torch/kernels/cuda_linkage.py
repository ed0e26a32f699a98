"""
The hand-written Hopper kernel of device linkage (K6) and its wrapper —
the counterpart of instrain_tpu/kernels/linkage.py:ld_device.

  ld    csrc/linkage.cu — one cooperative launch per call (ld_plan
        sizes its grid): the combo histogram of the captured pairs in
        device memory, the mm prefix as a segmented scan over a block's
        threads, and one thread per (edge, mm level) cell for the allele
        sort, the gates, r2 / D' and the rarefied draws. Built with the
        other kernels (build.cuda_kernels_library), bound with ctypes.

Its 14 outputs are planar columns of one byte buffer (ld_layout):
ld_packed returns the buffer, ld the dict of views into it (unpack_ld).
As in cuda_sitestats.py, the wrapper takes its plain PyTorch version
(kernels/linkage.py) only because the tensors it was given lie on the
CPU; for CUDA tensors it launches the kernel on the current stream or
raises KernelError. It counts its launches in `ld.launches`.
"""

from __future__ import annotations

import ctypes as ct
import itertools
import threading
from typing import Dict, List, NamedTuple, Tuple

import torch

from . import cuda_sitestats as cs
from . import linkage as plain
from .cuda_sitestats import _check, _fail, _stream
from .sitestats import key_words

# The output columns in buffer order (widest first) and where each starts:
# a multiple of LD_ALIGN bytes (csrc/linkage.cu: layout)
LD_COLUMNS = (("r2", torch.float64), ("d_prime", torch.float64),
              ("r2_normalized", torch.float64),
              ("d_prime_normalized", torch.float64),
              ("A", torch.int64), ("a", torch.int64), ("B", torch.int64),
              ("b", torch.int64), ("AB", torch.int32), ("Ab", torch.int32),
              ("aB", torch.int32), ("ab", torch.int32),
              ("total", torch.int32), ("valid", torch.bool))
LD_ALIGN = 128
_SIZE = {torch.float64: 8, torch.int64: 8, torch.int32: 4, torch.bool: 1}

# csrc/linkage.cu: one cooperative grid of LD_THREADS-thread blocks, as
# many as fit on the card, each owning a run of whole edges; the histogram
# after the outputs, LD_ROW_BYTES a cell. While half of a block's threads
# add its share of the pairs, the other half make the draws of its first
# cells and keep their high Threefry words in shared memory: at most
# LD_PRE_SMEM bytes (three blocks an SM fit, as the kernel's registers
# allow), and about LD_DRAWS_PER_PAIR draws for each pair the block adds,
# so that the draws end before the pairs do (a draw takes a block less
# time than an add). Below LD_THREADS pairs a block nothing is drawn
# ahead and every thread adds pairs: halving the adders costs more than
# the few draws save (PERF.md: 0.92x at 23 pairs a block, 1.06x at 335).
LD_THREADS = 256
LD_ROW_BYTES = 64
LD_PRE_SMEM = 64 * 1024
LD_DRAWS_PER_PAIR = 3


class LdPlan(NamedTuple):
    """One launch of the ld kernel: its blocks, the edges each owns, the
    cells of each whose draws are made while the pairs are added, and the
    bytes of device scratch after the outputs (the histogram)."""
    grid: int
    edges_per_block: int
    pre_cells: int
    scratch_bytes: int


def ld_plan(E: int, M: int, N: int, min_snp: int, sms: int,
            per_sm: int) -> LdPlan:
    """The grid of ld for E edges over M mm levels, N pairs and `min_snp`
    draws a cell, on a card of `sms` SMs that fit `per_sm` of its blocks
    each: every block that fits (they zero the histogram and add the
    pairs), the edges split evenly, and the cells whose draws a block
    makes ahead."""
    grid = sms * per_sm
    epb = -(-E // grid)
    pre = 0
    if N >= grid * LD_THREADS:
        pre = min(epb * M, LD_PRE_SMEM // (4 * min_snp),
                  -(-LD_DRAWS_PER_PAIR * N // (grid * min_snp)))
    return LdPlan(grid, epb, pre, E * M * LD_ROW_BYTES)


def ld_layout(n_cells: int) -> Tuple[List[Tuple[str, torch.dtype, int]],
                                     int]:
    """([(column, dtype, byte offset)], bytes) of ld's output buffer for
    n_cells cells."""
    cols, off = [], 0
    for name, dt in LD_COLUMNS:
        cols.append((name, dt, off))
        off += -(-n_cells * _SIZE[dt] // LD_ALIGN) * LD_ALIGN
    return cols, off


# LD_COLUMNS in runs of one dtype: [(dtype, names)]
_RUNS = [(dt, [name for name, _ in run])
         for dt, run in itertools.groupby(LD_COLUMNS, key=lambda c: c[1])]


def unpack_ld(buf: torch.Tensor, E: int, M: int) -> Dict[str, torch.Tensor]:
    """ld's dict of [E, M] views into its output buffer (uint8, on any
    device, at least ld_layout's bytes): one strided view of each run of
    columns of one dtype, unbound into its columns (four runs, so that
    the views cost a few PyTorch calls and not one a column)."""
    out, off = {}, 0
    for dt, names in _RUNS:
        size = _SIZE[dt]
        col = -(-E * M * size // LD_ALIGN) * LD_ALIGN    # bytes a column
        typed = buf[off:off + col * len(names)].view(dt)
        out.update(zip(names, typed.as_strided(
            (len(names), E, M), (col // size, M, 1)).unbind(0)))
        off += col * len(names)
    return out


def pack_ld(out: Dict[str, torch.Tensor], E: int, M: int) -> torch.Tensor:
    """ld's output dict in one buffer of ld_layout (on the CPU; padding
    zero)."""
    buf = torch.zeros(ld_layout(E * M)[1], dtype=torch.uint8)
    for name, view in unpack_ld(buf, E, M).items():
        view.copy_(out[name])
    return buf


_bound = False
_bind_lock = threading.Lock()
_OCCUPANCY: Dict[int, Tuple[int, int]] = {}


def _lib():
    global _bound
    lib = cs._load()
    with _bind_lock:
        if not _bound:
            P, I, I64, U32 = ct.c_void_p, ct.c_int, ct.c_int64, ct.c_uint32
            lib.instrain_ld.restype = I
            lib.instrain_ld.argtypes = ([P, P, P, I64, P, P, P, P, I, I, I,
                                         U32, U32, U32, I, I, I, P, P])
            lib.instrain_ld_occupancy.restype = I
            lib.instrain_ld_occupancy.argtypes = [I, ct.POINTER(I)]
            _bound = True
    return lib


def _occupancy(dev: torch.device) -> Tuple[int, int]:
    """(SMs, blocks of the kernel that fit an SM with LD_PRE_SMEM bytes of
    shared memory) of a device, read once."""
    if dev.index not in _OCCUPANCY:
        per_sm = ct.c_int(0)
        with torch.cuda.device(dev):
            _check(_lib().instrain_ld_occupancy(LD_PRE_SMEM,
                                                ct.byref(per_sm)), "ld")
        if per_sm.value < 1:
            _fail("ld", "the kernel fits no SM")
        _OCCUPANCY[dev.index] = (torch.cuda.get_device_properties(
            dev).multi_processor_count, per_sm.value)
    return _OCCUPANCY[dev.index]


def ld_plain(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
             min_snp: int, m_stride: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the ld kernel."""
    return plain.ld_device(e_idx, mm_idx, combo, c1, c2, present1, present2,
                           key, min_snp, m_stride)


def _check_inputs(e_idx, mm_idx, combo, c1, c2, present1, present2,
                  min_snp, m_stride):
    """(E, M, N, device) after checking what the kernel's memory accesses
    rest on (each message is built only when its check fails)."""
    dev = c1.device
    if dev.type != "cuda":
        _fail("ld", f"unsupported device {dev}")
    if c1.dim() != 3 or c1.shape[2] != 4:
        _fail("ld", f"c1 must be [E, M, 4], got {tuple(c1.shape)}")
    E, M = c1.shape[0], c1.shape[1]
    N = e_idx.shape[0] if e_idx.dim() == 1 else -1
    if not (E >= 1 and M >= 1 and E * M * 16 < 2 ** 31 and 0 <= N < 2 ** 31):
        _fail("ld", f"[E, M] = [{E}, {M}], N = {N} out of range")
    if not (min_snp >= 1 and M <= m_stride < 2 ** 32):
        _fail("ld", "bad min_snp or counter stride")
    i32, em = torch.int32, (E, M)
    for t, dt, shape in ((e_idx, i32, (N,)), (mm_idx, i32, (N,)),
                         (combo, i32, (N,)), (c1, i32, (E, M, 4)),
                         (c2, i32, (E, M, 4)), (present1, torch.bool, em),
                         (present2, torch.bool, em)):
        if (t.dtype != dt or t.shape != shape or t.device != dev or
                not t.is_contiguous()):
            _fail("ld", f"expected a contiguous {dt} {shape} on {dev}, got "
                        f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if (e_idx.data_ptr() | mm_idx.data_ptr() | combo.data_ptr() |
            c1.data_ptr() | c2.data_ptr()) % 16:
        _fail("ld", "the int32 inputs must start at multiples of 16 bytes")
    return E, M, N, dev


def ld_packed(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
              min_snp: int, m_stride: int) -> torch.Tensor:
    """kernels/linkage.py:ld_device's outputs as one uint8 buffer of
    ld_layout, on the inputs' device (unpack_ld gives the columns).

    e_idx, mm_idx, combo int32 [N]; c1, c2 int32 [E, M, 4]; present1,
    present2 bool [E, M]; all contiguous on one device."""
    if c1.device.type == "cpu":
        return pack_ld(ld_plain(e_idx, mm_idx, combo, c1, c2, present1,
                                present2, key, min_snp, m_stride),
                       c1.shape[0], c1.shape[1])
    E, M, N, dev = _check_inputs(e_idx, mm_idx, combo, c1, c2, present1,
                                 present2, min_snp, m_stride)
    lib = _lib()
    plan = ld_plan(E, M, N, min_snp, *_occupancy(dev))
    n_out = ld_layout(E * M)[1]
    buf = torch.empty(n_out + plan.scratch_bytes, dtype=torch.uint8,
                      device=dev)
    k0, k1 = key_words(key)
    with torch.cuda.device(dev):
        _check(lib.instrain_ld(
            e_idx.data_ptr(), mm_idx.data_ptr(), combo.data_ptr(), N,
            c1.data_ptr(), c2.data_ptr(), present1.data_ptr(),
            present2.data_ptr(), E, M, min_snp, m_stride, k0, k1,
            plan.grid, plan.edges_per_block, plan.pre_cells, buf.data_ptr(),
            _stream(c1)), "ld")
    ld.launches += 1
    return buf[:n_out]


def ld(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
       min_snp: int, m_stride: int) -> Dict[str, torch.Tensor]:
    """kernels/linkage.py:ld_device on the card: its dict of [E, M]
    columns, views into ld_packed's buffer. Inputs as ld_packed's."""
    if c1.device.type == "cpu":
        return ld_plain(e_idx, mm_idx, combo, c1, c2, present1, present2,
                        key, min_snp, m_stride)
    buf = ld_packed(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
                    min_snp, m_stride)
    return unpack_ld(buf, c1.shape[0], c1.shape[1])


ld.launches = 0


def reset_launch_counts() -> None:
    ld.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"ld": ld.launches}
