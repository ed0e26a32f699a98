"""
The hand-written Hopper kernel of `compare` (K7) and its wrapper — the
counterpart of instrain_tpu/kernels/compare.py:_overlap_counts_device.

  overlap_counts_group  csrc/compare.cu — all-pairs AND + popcount of
                        packed coverage masks for every scaffold of a
                        comparison group in one launch (group table:
                        kernels/compare.py:group_plan): each (scaffold, mm
                        level) row cut into blocks of about equal work, a
                        slab of all samples in shared memory, a warp per
                        strip of pairs with its lanes over the words, one
                        64-bit atomicAdd per pair and block into the
                        group's output, zeroed once. Bound by the
                        popcounts (N(N+1)/2 * Mg * W per scaffold). Built
                        with the other kernels (build.cuda_kernels_library),
                        bound with ctypes.

As in cuda_sitestats.py, the wrapper takes its plain PyTorch version
(kernels/compare.py:overlap_counts_group_plain) only because the tensor it
was given lies on the CPU; for a CUDA tensor it launches the kernel on the
current stream or raises KernelError. It counts its launches in
`overlap_counts_group.launches` (reported as "overlap_counts").
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import Dict

import torch

from . import cuda_sitestats as cs
from .compare import GroupPlan, overlap_counts_group_plain
from .cuda_sitestats import _check, _fail, _stream

MAX_SAMPLES = 64      # csrc/compare.cu kMaxN

_bound = False
_bind_lock = threading.Lock()


def _lib():
    global _bound
    lib = cs._load()
    with _bind_lock:
        if not _bound:
            P, I, I64 = ct.c_void_p, ct.c_int, ct.c_longlong
            lib.instrain_overlap_counts_group.restype = I
            lib.instrain_overlap_counts_group.argtypes = [P, I, P, I64, P,
                                                          I64, P]
            _bound = True
    return lib


def overlap_counts_group(buf: torch.Tensor, plan: GroupPlan
                         ) -> torch.Tensor:
    """|t_i & t_j| and |t_i| of every scaffold of a group: buf int64
    [table | words] as kernels/compare.py:group_buffer lays it out for
    `plan`, contiguous. Returns int64 [plan.n_out] (split_counts splits
    it scaffold by scaffold)."""
    name = "overlap_counts"
    if buf.device.type == "cpu":
        return overlap_counts_group_plain(buf, plan)
    dev = buf.device
    if dev.type != "cuda":
        _fail(name, f"unsupported device {dev}")
    n_table = plan.table.size
    if not (buf.dim() == 1 and buf.dtype == torch.int64 and
            buf.numel() == n_table + plan.n_words and buf.is_contiguous()):
        _fail(name, f"buf must be contiguous int64 "
                    f"[{n_table + plan.n_words}], got {buf.dtype} "
                    f"{tuple(buf.shape)}")
    if max(n for n, _, _ in plan.shapes) > MAX_SAMPLES:
        _fail(name, f"more than {MAX_SAMPLES} samples")
    out = torch.empty(plan.n_out, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _check(_lib().instrain_overlap_counts_group(
            buf.data_ptr(), len(plan.shapes), buf.data_ptr() + 8 * n_table,
            plan.n_blocks, out.data_ptr(), plan.n_out, _stream(buf)), name)
    overlap_counts_group.launches += 1
    return out


overlap_counts_group.launches = 0


def reset_launch_counts() -> None:
    overlap_counts_group.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"overlap_counts": overlap_counts_group.launches}
