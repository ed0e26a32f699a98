"""
The hand-written Hopper kernel of `compare` (K7) and its wrapper — the
counterpart of instrain_tpu/kernels/compare.py:_overlap_counts_device.

  overlap_counts  csrc/compare.cu — all-pairs AND + popcount of packed
                  coverage masks, one block per (mm level, slab of words),
                  the slab of all samples in shared memory, 64-bit sums in
                  registers and one atomicAdd per pair and block. Bound by
                  the popcounts (N(N+1)/2 * Mg * W of them against
                  N * Mg * W * 8 bytes read). Built with the other kernels
                  (build.cuda_kernels_library), bound with ctypes.

As in cuda_sitestats.py, the wrapper takes its plain PyTorch version
(kernels/compare.py:overlap_counts_plain) only because the tensor it was
given lies on the CPU; for a CUDA tensor it launches the kernel on the
current stream or raises KernelError. It counts its launches in
`overlap_counts.launches`.
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import Dict, Tuple

import torch

from . import cuda_sitestats as cs
from .compare import overlap_counts_plain
from .cuda_sitestats import _check, _require, _stream

MAX_SAMPLES = 64      # csrc/compare.cu kMaxN

_bound = False
_bind_lock = threading.Lock()


def _lib():
    global _bound
    lib = cs._load()
    with _bind_lock:
        if not _bound:
            P, I, I64 = ct.c_void_p, ct.c_int, ct.c_longlong
            lib.instrain_overlap_counts.restype = I
            lib.instrain_overlap_counts.argtypes = [P, I, I, I64, P, P, I, P]
            _bound = True
    return lib


def overlap_counts(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """|t_i & t_j| and |t_i| of packed masks: words int64 [N, Mg, W] (the
    uint64 words' bits, zero past L), contiguous. Returns (both int64
    [Mg, N, N], single int64 [Mg, N])."""
    name = "overlap_counts"
    if words.device.type == "cpu":
        return overlap_counts_plain(words)
    dev = words.device
    _require(dev.type == "cuda", name, f"unsupported device {dev}")
    _require(words.dim() == 3 and words.dtype == torch.int64, name,
             f"words must be int64 [N, Mg, W], got {words.dtype} "
             f"{tuple(words.shape)}")
    N, Mg, W = words.shape
    _require(1 <= N <= MAX_SAMPLES and 1 <= Mg < 2 ** 31 and W >= 1, name,
             f"[N, Mg, W] = [{N}, {Mg}, {W}] out of range (N <= "
             f"{MAX_SAMPLES})")
    _require(words.is_contiguous(), name, "words must be contiguous")
    both = torch.zeros((Mg, N, N), dtype=torch.int64, device=dev)
    single = torch.zeros((Mg, N), dtype=torch.int64, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        _check(_lib().instrain_overlap_counts(
            words.data_ptr(), N, Mg, W, both.data_ptr(), single.data_ptr(),
            n_sm, _stream(words)), name)
    overlap_counts.launches += 1
    return both, single


overlap_counts.launches = 0


def reset_launch_counts() -> None:
    overlap_counts.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"overlap_counts": overlap_counts.launches}
