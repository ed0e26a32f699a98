"""
The hand-written Hopper kernel of device linkage (K6) and its wrapper —
the counterpart of instrain_tpu/kernels/linkage.py:ld_device.

  ld    csrc/linkage.cu — the combo scatter-add (one thread per captured
        pair) and one thread per (edge, mm level) for the mm prefix, the
        allele sort, the gates, r2 / D' and the rarefied draws. Built with
        the other kernels (build.cuda_kernels_library), bound with ctypes.

As in cuda_sitestats.py, the wrapper takes its plain PyTorch version
(kernels/linkage.py) only because the tensors it was given lie on the
CPU; for CUDA tensors it launches the kernel on the current stream or
raises KernelError. It counts its launches in `ld.launches`.
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import Dict

import torch

from . import cuda_sitestats as cs
from . import linkage as plain
from .cuda_sitestats import _check, _require, _stream
from .sitestats import key_words

_bound = False
_bind_lock = threading.Lock()


def _lib():
    global _bound
    lib = cs._load()
    with _bind_lock:
        if not _bound:
            P, I, U32 = ct.c_void_p, ct.c_int, ct.c_uint32
            lib.instrain_ld.restype = I
            lib.instrain_ld.argtypes = ([P, P, P, I, P, P, P, P, I, I, I,
                                         U32, U32, U32] + [P] * 5 + [P])
            _bound = True
    return lib


def ld_plain(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
             min_snp: int, m_stride: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the ld kernel."""
    return plain.ld_device(e_idx, mm_idx, combo, c1, c2, present1, present2,
                           key, min_snp, m_stride)


def ld(e_idx, mm_idx, combo, c1, c2, present1, present2, key,
       min_snp: int, m_stride: int) -> Dict[str, torch.Tensor]:
    """kernels/linkage.py:ld_device on the card.

    e_idx, mm_idx, combo int32 [N]; c1, c2 int32 [E, M, 4]; present1,
    present2 bool [E, M]; all contiguous on one device."""
    name = "ld"
    if c1.device.type == "cpu":
        return ld_plain(e_idx, mm_idx, combo, c1, c2, present1, present2,
                        key, min_snp, m_stride)
    dev = c1.device
    _require(dev.type == "cuda", name, f"unsupported device {dev}")
    _require(c1.dim() == 3 and c1.shape[2] == 4, name,
             f"c1 must be [E, M, 4], got {tuple(c1.shape)}")
    E, M, _ = c1.shape
    N = e_idx.shape[0]
    _require(E >= 1 and M >= 1 and E * M * 16 < 2 ** 31 and N < 2 ** 31,
             name, f"[E, M] = [{E}, {M}], N = {N} out of range")
    _require(1 <= min_snp and M <= m_stride < 2 ** 32, name,
             "bad min_snp or counter stride")
    for t, dt, shape in ((e_idx, torch.int32, (N,)),
                         (mm_idx, torch.int32, (N,)),
                         (combo, torch.int32, (N,)),
                         (c1, torch.int32, (E, M, 4)),
                         (c2, torch.int32, (E, M, 4)),
                         (present1, torch.bool, (E, M)),
                         (present2, torch.bool, (E, M))):
        _require(t.dtype == dt and tuple(t.shape) == shape, name,
                 f"expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        _require(t.device == dev, name, "inputs on two devices")
        _require(t.is_contiguous(), name, "inputs must be contiguous")
    k0, k1 = key_words(key)
    cnt = torch.zeros((E, M, 16), dtype=torch.int32, device=dev)
    valid = torch.empty((E, M), dtype=torch.bool, device=dev)
    counts = torch.empty((5, E, M), dtype=torch.int32, device=dev)
    alleles = torch.empty((4, E, M), dtype=torch.int64, device=dev)
    f = torch.empty((4, E, M), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        _check(_lib().instrain_ld(
            e_idx.data_ptr(), mm_idx.data_ptr(), combo.data_ptr(), N,
            c1.data_ptr(), c2.data_ptr(), present1.data_ptr(),
            present2.data_ptr(), E, M, min_snp, m_stride, k0, k1,
            cnt.data_ptr(), valid.data_ptr(), counts.data_ptr(),
            alleles.data_ptr(), f.data_ptr(), _stream(c1)), name)
    ld.launches += 1
    out = dict(valid=valid)
    out.update(zip(("AB", "Ab", "aB", "ab", "total"), counts))
    out.update(zip(("A", "a", "B", "b"), alleles))
    out.update(zip(("r2", "d_prime", "r2_normalized", "d_prime_normalized"),
                   f))
    return out


ld.launches = 0


def reset_launch_counts() -> None:
    ld.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"ld": ld.launches}
