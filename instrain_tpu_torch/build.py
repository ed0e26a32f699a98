"""
Builds the port's native libraries at first use, into `_build/` inside
the package (listed in .gitignore):

  - the BAM decoder, from the repository's native/bam.cc and baq.cc, with
    g++ (native/Makefile's flags with -mfma in place of -march=native on
    x86-64, so the library runs on any host with FMA and contracts the
    float products as the JAX package's build does);
  - the CUDA kernels, from csrc/*.cu, with nvcc for sm_90a (Hopper).

Each library's file name carries a hash of its sources and flags, so an
edited source builds anew. Builds are safe when several processes start
them at once (pytest-xdist workers): a per-library lock file serialises
them, and the compiler writes to a temporary name that is renamed into
place. A library is never loaded from anywhere else. The CUDA sources
compile in parallel, one nvcc each, and are then linked.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")


class BuildError(RuntimeError):
    """A compiler was missing or failed; the message holds its output."""


def _digest(paths: List[str], flags: List[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


Stages = List[List[List[str]]]


def _run_stage(name: str, cmds: List[List[str]], log) -> None:
    """Run the commands of one build stage at once; raise on a failure."""
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    except FileNotFoundError as e:
        for p in procs:
            p.kill()
            p.wait()
        raise BuildError(f"{name}: compiler not found: {e}") from None
    failed = []
    for c, p in zip(cmds, procs):
        out = p.communicate()[0]
        log.write(" ".join(c) + "\n" + out)
        if p.returncode != 0:
            failed.append(f"{' '.join(c)}:\n{out}")
    if failed:
        raise BuildError(f"{name}: build failed ({failed[0]})")


# (name, sources, headers, stages) of one library
Spec = Tuple[str, List[str], List[str], Callable[[str], Stages]]


def library_path(name: str, sources: List[str], headers: List[str],
                 stages: Callable[[str], Stages]) -> str:
    """Where the library of these sources and commands is built:
    _build/lib<name>-<hash>.so."""
    probe = [a for stage in stages("OUT") for c in stage for a in c]
    return os.path.join(
        BUILD_DIR, f"lib{name}-{_digest(sources + headers, probe)}.so")


def build_library(name: str, sources: List[str], headers: List[str],
                  stages: Callable[[str], Stages]) -> str:
    """Path of lib<name>-<hash>.so, building it unless it exists.
    `stages(out_path)` gives the compiler commands: those of a stage run
    at once, the stages in order. Compiler output goes to a .log beside
    the library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = library_path(name, sources, headers, stages)
    if os.path.exists(target):
        return target
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(target):          # another process built it
            return target
        tmp = f"{target}.tmp{os.getpid()}"
        try:
            with open(target[:-3] + ".log", "w") as log:
                for stage in stages(tmp):
                    _run_stage(name, stage, log)
            os.replace(tmp, target)
        finally:
            for f in os.listdir(BUILD_DIR):
                if f.startswith(os.path.basename(tmp)):
                    os.remove(os.path.join(BUILD_DIR, f))
    return target


def build_log(path: str) -> str:
    """The compiler output saved beside a built library."""
    log = path[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def _has_libdeflate() -> bool:
    import ctypes.util
    have_header = any(os.path.exists(os.path.join(d, "libdeflate.h"))
                      for d in ("/usr/include", "/usr/local/include"))
    return have_header and ctypes.util.find_library("deflate") is not None


def native_io_library(use_libdeflate: Optional[bool] = None) -> str:
    """The BAM decoder (native/bam.cc, baq.cc). Uses libdeflate where its
    header and library are installed, else csrc/zlib_shim/libdeflate.h,
    which implements the one libdeflate call bam.cc makes over zlib
    (use_libdeflate=False forces the shim)."""
    return build_library(*_native_io_spec(use_libdeflate))


def _native_io_spec(use_libdeflate: Optional[bool] = None) -> Spec:
    sources = [os.path.join(NATIVE_DIR, f) for f in ("bam.cc", "baq.cc")]
    headers = [os.path.join(NATIVE_DIR, "instrain_io.h")]
    if use_libdeflate is None:
        use_libdeflate = _has_libdeflate()
    if use_libdeflate:
        extra, libs = [], ["-ldeflate"]
    else:
        shim = os.path.join(CSRC_DIR, "zlib_shim")
        headers.append(os.path.join(shim, "libdeflate.h"))
        extra, libs = [f"-I{shim}"], ["-lz"]
    cxx = os.environ.get("CXX", "g++")
    # g++ contracts a * b + c into one fused multiply-add where the target
    # has FMA, as native/Makefile's -march=native build does: the f32
    # clonality of bd_clon_cum16 then rounds as the JAX package's does
    if platform.machine() in ("x86_64", "AMD64"):
        extra = ["-mfma"] + extra

    def command(out: str) -> Stages:
        return [[[cxx, "-O3", "-fPIC", "-std=c++17", "-Wall"] + extra +
                 sources + ["-o", out, "-shared"] + libs + ["-lpthread"]]]

    return "instrain_io", sources, headers, command


def _nvcc() -> Optional[str]:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else shutil.which("nvcc")


def cuda_kernels_library() -> str:
    """The hand-written Hopper kernels (csrc/*.cu) as one shared library
    with a plain C interface (loaded with ctypes)."""
    nvcc = _nvcc()
    if nvcc is None:
        raise BuildError("nvcc not found (set CUDA_HOME)")
    return build_library(*_cuda_kernels_spec(nvcc))


def _cuda_kernels_spec(nvcc: str) -> Spec:
    sources = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cu"))
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))

    def command(out: str) -> Stages:
        # one nvcc per source, all at once, then one link; no
        # --use_fast_math: divisions stay IEEE (bit parity with the plain
        # versions); -Xptxas -v records registers/spills in the log
        objs = [f"{out}.{os.path.basename(s)}.o" for s in sources]
        return [[[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                  "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v", "-o", o, s]
                 for s, o in zip(sources, objs)],
                [[nvcc, "-shared", "-o", out] + objs]]

    return "instrain_kernels", sources, headers, command


def built_libraries() -> Dict[str, Optional[str]]:
    """For the decoder (instrain_io) and the CUDA kernels
    (instrain_kernels): the path of the library built from this
    checkout's sources with the compiler found here, or None where it is
    not built yet (or, for the kernels, where no nvcc is found). Builds
    nothing."""
    nvcc = _nvcc()
    out = {"instrain_io": library_path(*_native_io_spec()),
           "instrain_kernels": (library_path(*_cuda_kernels_spec(nvcc))
                                if nvcc else None)}
    return {k: p if p and os.path.exists(p) else None
            for k, p in out.items()}
