#!/usr/bin/env python3
"""
A short first check of compare's overlap kernel (K7), mm_aggregates and
site_stats' --engine pallas instance on one NVIDIA GPU, for a kernel's
first builds: builds the kernels, prints what ptxas says of their
registers and spills, holds K7 at groups of (samples, mm levels,
positions), up to 193 samples, against the host popcount, mm_aggregates
at chunks of segments and the pallas instance of site_stats against
their plain versions, exact, and prints their times (K7 warm, by CUDA
events; mm_aggregates on the device after an L2 flush, with its bytes
bound). Given an earlier
compare.cu (one launch per scaffold, instrain_overlap_counts), it also
times that kernel beside this one at three shapes, L2 flushed:

    mkdir -p .scratch
    git show 60a2909:instrain_tpu_torch/csrc/compare.cu > .scratch/compare.cu
    python3 kernel_probe.py .scratch/compare.cu

(not under .smoke/, which chip_smoke.py clears). Imports nothing of
JAX; writes only under .smoke/.
"""

import ctypes as ct
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as smoke

GROUPS = [[(2, 1, 1), (3, 2, 4099), (8, 5, 40000)], [(16, 4, 1 << 23)],
          [(64, 3, 100000)],
          [(1, 1, 63), (2, 5, 64), (8, 3, 4099), (17, 2, 40000), (64, 4, 1)],
          smoke.STUDY_GROUP, [(65, 4, 40000)], [(128, 3, 100000)],
          [(8, 5, 4099), (65, 2, 63), (130, 3, 40000), (1, 1, 1)],
          [(193, 1, 4099), (66, 2, 1)]]
CHUNKS = [(8, [40000] * 52), (8, [1 << 20]),
          (8, [1, 1237, 40000, 1_048_577, 300, 4096]),
          (33, [160, 1, 5000, 40000]), (1, [7, 3000]), (80, [700])]


def earlier_k7(path):
    """The earlier compare.cu's per-scaffold entry, built alone."""
    from instrain_tpu_torch import build
    out = os.path.join(smoke.WORK, "probe", "earlier_compare.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, path],
                   check=True)
    lib = ct.CDLL(out)
    lib.instrain_overlap_counts.restype = ct.c_int
    lib.instrain_overlap_counts.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_int, ct.c_longlong, ct.c_void_p,
        ct.c_void_p, ct.c_int, ct.c_void_p]
    return lib


def main():
    import torch
    from instrain_tpu_torch import build
    from instrain_tpu_torch.kernels import compare as K
    from instrain_tpu_torch.kernels import cuda_compact as CP
    from instrain_tpu_torch.kernels import cuda_compare as CC
    from instrain_tpu_torch.kernels import sitestats as S
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    print(smoke.nvidia_smi_line(), flush=True)
    t0 = time.time()
    lib = build.cuda_kernels_library()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for line in build.build_log(lib).splitlines():
        if any(k in line for k in ("registers", "spill", "overlap",
                                   "mm_aggregates")):
            print("ptxas:", line.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    ok = True
    for shapes in GROUPS:
        words = smoke.group_words(rng, shapes)
        plan, _, dbuf = smoke.group_on_card(torch, words)
        got = CC.overlap_counts_group(dbuf, plan).cpu()
        exact = all(np.array_equal(b, hb) and np.array_equal(s, hs)
                    for w, (b, s) in zip(words, K.split_counts(
                        got.numpy(), plan))
                    for hb, hs in [K.pairwise_overlap_counts_host(w)])
        ok &= exact
        ms = smoke.cuda_ms(torch, lambda: CC.overlap_counts_group(dbuf,
                                                                  plan), 20)
        print(f"K7 group of {len(shapes)} from {shapes[0]}: exact={exact} "
              f"blocks={plan.n_blocks} warm {ms:.4f} ms", flush=True)
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.kernels.nullmodel import \
        analytic_null_thresholds
    nl = torch.as_tensor(analytic_null_thresholds(max_coverage=10000),
                         device=dev)
    fl = torch.as_tensor(S.freq_min_count_lut(0.05, max_coverage=10000),
                         device=dev)
    for M, lengths in ((8, [1 << 20]), (3, [1237, 40000])):
        counts, ref = smoke.segment_inputs(M, lengths, 5)
        c, r = torch.from_numpy(counts).to(dev), torch.from_numpy(ref).to(dev)
        got = C.site_stats_core(c, r, nl, fl, 5, 50, pallas=True)
        smoke.compare_exact(C.site_stats_core_plain(c, r, nl, fl, 5, 50,
                                                    pallas=True), got,
                            f"site_stats pallas M={M} {lengths}")
        dense = C.site_stats_core(c, r, nl, fl, 5, 50)
        differ = int((smoke._bits(dense["clon"]) !=
                      smoke._bits(got["clon"])).sum())
        ms = smoke.cuda_ms(torch, lambda: C.site_stats_core(
            c, r, nl, fl, 5, 50, pallas=True), 20)
        ms_d = smoke.cuda_ms(torch, lambda: C.site_stats_core(
            c, r, nl, fl, 5, 50), 20)
        print(f"site_stats pallas M={M} L={sum(lengths)}: exact against "
              f"its plain version, clon differs from dense at {differ} "
              f"cells; warm {ms:.4f} ms, dense instance {ms_d:.4f} ms",
              flush=True)
    keys = ("total", "clon", "clonR", "row", "morphia", "cls", "present")
    for M, lengths in CHUNKS:
        full, seg = smoke.site_stats_chunk(torch, M, lengths, 3)
        agg, cf, rf = CP.mm_aggregates(full, seg)
        pagg, pcf, prf = S.mm_aggregates_seg(full, seg)
        smoke.compare_exact({"agg": pagg, "clon_f": pcf, "clonR_f": prf},
                            {"agg": agg, "clon_f": cf, "clonR_f": rf},
                            f"mm_aggregates M={M} {len(lengths)} segments")
        ms = smoke.cold_ms(torch, lambda: CP.mm_aggregates(full, seg), 10,
                           busy=True)
        b = smoke.bound(smoke.nbytes([full[k] for k in keys], agg, cf, rf))
        print(f"mm_aggregates M={M} {len(lengths)} segments L={seg.L}: "
              f"exact, device {ms:.4f} ms after an L2 flush, bound "
              f"{b[0]:.4f} ms", flush=True)
        del full
    if len(sys.argv) > 1:
        old = earlier_k7(sys.argv[1])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for shapes in ([(16, 4, 1 << 23)], [(64, 3, 100000)],
                       [(8, 5, 40000)]):
            words = smoke.group_words(rng, shapes)
            plan, _, dbuf = smoke.group_on_card(torch, words)
            t = torch.from_numpy(words[0].view(np.int64)).to(dev)
            N, Mg, W = t.shape
            both = torch.zeros((Mg, N, N), dtype=torch.int64, device=dev)
            single = torch.zeros((Mg, N), dtype=torch.int64, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def run_old():
                both.zero_()
                single.zero_()
                old.instrain_overlap_counts(t.data_ptr(), N, Mg, W,
                                            both.data_ptr(),
                                            single.data_ptr(), sms, stream)
            run_old()
            got = CC.overlap_counts_group(dbuf, plan)
            equal = torch.equal(got[:Mg * N * N].view(Mg, N, N), both)
            ok &= equal
            for _ in range(2):
                a = smoke.cold_ms(torch, run_old, 20, busy=True)
                b = smoke.cold_ms(torch, lambda: CC.overlap_counts_group(
                    dbuf, plan), 20, busy=True)
                print(f"K7 {shapes[0]}: equal={equal} earlier {a:.4f} ms, "
                      f"this {b:.4f} ms (device, L2 flushed)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
