"""
The hand-written Hopper kernels of the site-stats path and their
wrappers — the counterpart of instrain_tpu/kernels/pallas_sitestats.py.

Two kernels, CUDA C++ in csrc/, built with nvcc for sm_90a at first use
(build.cuda_kernels_library) and bound with ctypes:

  site_stats_core  csrc/site_stats.cu — replaces pallas_sitestats.py:_kernel
                   (pallas_call at :247) fused with the rest of
                   sitestats.py:site_stats (:173-299). Memory-bound; one
                   thread per position walks the mm levels in registers.
                   Position-local, so a chunk of scaffolds laid end to end
                   (the batch engine) runs through it as it is.
  clonR            csrc/clonr.cu — replaces sitestats.py:_clonR_values
                   (:136-166), per scaffold or per segment of a chunk
                   (sitestats.Segments). Integer-ALU-bound
                   (Threefry-2x32); one thread per qualifying cell.

Each wrapper takes its plain PyTorch version (`*_plain`, below) only
because the tensor it was given lies on the CPU. For a CUDA tensor it
launches the kernel on the current stream or raises KernelError — there
is no fallback. Each wrapper counts its launches in `.launches` (a plain
integer, reset by callers), so a run can show its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import Dict, Optional

import torch

from . import sitestats as plain

_lib = None
_lib_lock = threading.Lock()

_CORE_OUTPUTS = (  # name, dtype, shape kind ("M4L", "ML", "L", "4L")
    ("cum", torch.int32, "M4L"), ("present", torch.bool, "ML"),
    ("total", torch.int64, "ML"), ("morphia", torch.int8, "ML"),
    ("con", torch.int8, "ML"), ("var", torch.int8, "ML"),
    ("call", torch.int8, "ML"), ("row", torch.bool, "ML"),
    ("cls", torch.int8, "ML"), ("clon", torch.float32, "ML"),
    ("ref_count", torch.int64, "ML"), ("clonR_set", torch.bool, "ML"),
    ("cryptic", torch.bool, "L"), ("any_snp", torch.bool, "L"),
    ("bases_mask", torch.bool, "4L"),
)


class KernelError(RuntimeError):
    """A kernel could not be launched, or was given inputs it does not
    take. The profile pipeline never contains this error per scaffold."""


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..build import cuda_kernels_library
            lib = ct.CDLL(cuda_kernels_library())
            P, I, I64, U32 = ct.c_void_p, ct.c_int, ct.c_int64, ct.c_uint32
            U64 = ct.c_uint64
            lib.instrain_site_stats.restype = I
            lib.instrain_site_stats.argtypes = (
                [P, P, P, P, I, I, I64, I, I, I] + [P] * 15 + [P])
            lib.instrain_clonr.restype = I
            lib.instrain_clonr.argtypes = [P, P, P, I, I64, P, I, I64, U64,
                                           I64, U32, I, P, P]
            lib.instrain_cuda_error_string.restype = ct.c_char_p
            lib.instrain_cuda_error_string.argtypes = [I]
            _lib = lib
    return _lib


def load_kernels() -> None:
    """Build (if needed) and load the kernels' library."""
    _load()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _load().instrain_cuda_error_string(rc).decode()
        raise KernelError(f"{name}: launch failed, CUDA error {rc} ({msg})")


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        _fail(name, what)


def _fail(name: str, what: str) -> None:
    """Raise KernelError for a kernel's input check: called only once the
    check failed, so that a message is formatted only then."""
    raise KernelError(f"{name}: {what}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# plain versions


def site_stats_core_plain(counts, ref_codes, null_lut, freq_lut,
                          min_cov: int = 5, min_covR: int = 50,
                          pallas: bool = False) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the site_stats kernel: every output of
    sitestats.site_stats except clonR (clon rounded as the Pallas core
    rounds it where `pallas`)."""
    return plain.site_stats(counts, ref_codes, null_lut, freq_lut,
                            (0, 0), min_cov=min_cov, min_covR=min_covR,
                            with_clonR=False, pallas=pallas)


def clonR_plain(cum, total, clonR_set, seg: plain.Segments,
                rarefied_draws: int, m_stride: int) -> torch.Tensor:
    """Plain PyTorch version of the clonR kernel."""
    return plain.clonR_values_seg(cum, total, clonR_set, seg,
                                  rarefied_draws, m_stride)


# ---------------------------------------------------------------------------
# kernel wrappers


def site_stats_core(counts, ref_codes, null_lut, freq_lut,
                    min_cov: int = 5, min_covR: int = 50,
                    pallas: bool = False) -> Dict[str, torch.Tensor]:
    """Per-cell site statistics (all of site_stats but clonR).

    counts int32 [M, 4, L], ref_codes uint8 [L], LUTs int32 [maxcov+1];
    all contiguous, on one device. `pallas` rounds clon as the JAX
    package's Pallas core does (`--engine pallas`; the kernel's
    kPallasOrder instance)."""
    name = "site_stats"
    if counts.device.type == "cpu":
        return site_stats_core_plain(counts, ref_codes, null_lut, freq_lut,
                                     min_cov=min_cov, min_covR=min_covR,
                                     pallas=pallas)
    _require(counts.device.type == "cuda", name,
             f"unsupported device {counts.device}")
    _require(counts.dim() == 3 and counts.shape[1] == 4, name,
             f"counts must be [M, 4, L], got {tuple(counts.shape)}")
    M, _, L = counts.shape
    _require(M >= 1 and L >= 1, name, "empty counts")
    _require(counts.dtype == torch.int32, name, "counts must be int32")
    _require(ref_codes.dtype == torch.uint8 and
             tuple(ref_codes.shape) == (L,), name, "ref_codes must be u8[L]")
    _require(null_lut.dtype == torch.int32 and freq_lut.dtype == torch.int32
             and null_lut.dim() == 1 and null_lut.shape == freq_lut.shape,
             name, "LUTs must be int32 [maxcov+1] of one length")
    for t in (counts, ref_codes, null_lut, freq_lut):
        _require(t.device == counts.device, name, "inputs on two devices")
        _require(t.is_contiguous(), name, "inputs must be contiguous")
    shapes = {"M4L": (M, 4, L), "ML": (M, L), "L": (L,), "4L": (4, L)}
    out = {k: torch.empty(shapes[s], dtype=dt, device=counts.device)
           for k, dt, s in _CORE_OUTPUTS}
    lib = _load()
    with torch.cuda.device(counts.device):
        rc = lib.instrain_site_stats(
            counts.data_ptr(), ref_codes.data_ptr(), null_lut.data_ptr(),
            freq_lut.data_ptr(), null_lut.shape[0] - 1, M, L, min_cov,
            min_covR, int(pallas),
            *[out[k].data_ptr() for k, _, _ in _CORE_OUTPUTS],
            _stream(counts))
    _check(rc, name)
    site_stats_core.launches += 1
    return out


site_stats_core.launches = 0


def clonR(cum, total, clonR_set, seg: plain.Segments, rarefied_draws: int,
          m_stride: int) -> torch.Tensor:
    """Rarefied clonality [M, L] f32 (NaN outside clonR_set).

    cum int32 [M, 4, L], total int64 [M, L], clonR_set bool [M, L] (the
    site_stats kernel's outputs); draw counter (d * m_stride + m,
    seg.pos0 + p). The scaffolds of `seg` lie end to end on the position
    axis, each drawn under its own key with p counted from its start (one
    scaffold: single_segment; a shard of one scaffold's positions:
    single_segment with the shard's first position as pos0)."""
    name = "clonR"
    if cum.device.type == "cpu":
        return clonR_plain(cum, total, clonR_set, seg, rarefied_draws,
                           m_stride)
    _require(cum.device.type == "cuda", name,
             f"unsupported device {cum.device}")
    _require(cum.dim() == 3 and cum.shape[1] == 4 and
             cum.dtype == torch.int32, name, "cum must be int32 [M, 4, L]")
    M, _, L = cum.shape
    _require(total.dtype == torch.int64 and
             tuple(total.shape) == (M, L), name, "total must be i64[M, L]")
    _require(clonR_set.dtype == torch.bool and
             tuple(clonR_set.shape) == (M, L), name,
             "clonR_set must be bool [M, L]")
    _require(rarefied_draws >= 1 and 0 < m_stride < 2 ** 32 and
             M < 65536, name, "bad draw count, counter stride or M")
    for t in (cum, total, clonR_set):
        _require(t.device == cum.device, name, "inputs on two devices")
        _require(t.is_contiguous(), name, "inputs must be contiguous")
    _require(seg.L == L and seg.device == cum.device, name,
             "segment table does not match the inputs")
    _require(0 <= seg.pos0 and seg.pos0 + L < 2 ** 31, name,
             "positions must lie in [0, 2^31)")
    out = torch.empty((M, L), dtype=torch.float32, device=cum.device)
    lib = _load()
    with torch.cuda.device(cum.device):
        rc = lib.instrain_clonr(cum.data_ptr(), total.data_ptr(),
                                clonR_set.data_ptr(), M, L, seg.table_ptr(),
                                seg.S, seg.n_tiles, seg.key0, seg.pos0,
                                m_stride,
                                rarefied_draws, out.data_ptr(),
                                _stream(cum))
    _check(rc, name)
    clonR.launches += 1
    return out


clonR.launches = 0


def single_segment(L: int, key, device, pos0: int = 0) -> plain.Segments:
    """The segment table of one scaffold of L positions under `key`
    (uint32[2]; the compaction kernels read no key), its draws at
    positions from pos0 on (a shard of a longer scaffold)."""
    return plain.Segments([L], [plain.key_words(key)], device, pos0)


def reset_launch_counts() -> None:
    site_stats_core.launches = 0
    clonR.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"site_stats": site_stats_core.launches,
            "clonR": clonR.launches}


def site_stats(counts, ref_codes, null_lut, freq_lut, seg: plain.Segments,
               min_cov: int = 5, min_covR: int = 50,
               rarefied_draws: int = 50, m_stride: Optional[int] = None,
               pallas: bool = False) -> Dict[str, torch.Tensor]:
    """sitestats.site_stats through the two kernels (same output dict), of
    the chunk of scaffolds `seg` lays end to end (one scaffold under a
    key: single_segment(L, key, device)); `pallas`: clon as the JAX
    package's Pallas core rounds it. Inputs are cast to the kernels'
    dtypes; the LUTs and ref codes move to the counts' device."""
    dev = counts.device
    counts = counts.to(torch.int32).contiguous()
    ref_codes = ref_codes.to(device=dev, dtype=torch.uint8).contiguous()
    null_lut = null_lut.to(device=dev, dtype=torch.int32).contiguous()
    freq_lut = freq_lut.to(device=dev, dtype=torch.int32).contiguous()
    out = site_stats_core(counts, ref_codes, null_lut, freq_lut,
                          min_cov=min_cov, min_covR=min_covR, pallas=pallas)
    out["clonR"] = clonR(out["cum"], out["total"], out["clonR_set"], seg,
                         rarefied_draws,
                         counts.shape[0] if m_stride is None else m_stride)
    return out
