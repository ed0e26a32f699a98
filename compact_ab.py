#!/usr/bin/env python3
"""
select_rows and masked_median of this checkout (csrc/compact.cu) against
an earlier design of the same two kernels, in one process on one NVIDIA
GPU, at the shapes chip_smoke.py times them at: the inputs
compact_from_full gets in the three --engine auto runs of its main paths
(the metagenome's largest chunk, the isolate, the deep input), a 52 x 40
kb chunk and one segment of M = 8, L = 2^20.

    mkdir -p .smoke/base
    git archive 64c74d6 instrain_tpu_torch/csrc | tar -x -C .smoke/base
    python3 compact_ab.py .smoke/base/instrain_tpu_torch/csrc

The earlier design is that of commit 64c74d6: its compact.cu exports
instrain_rows_count and instrain_rows_gather with the arguments of this
checkout's, and masked_median as one launch, instrain_masked_median. It
is built alone (nvcc, sm_90a, beside its directory's segments.cuh) into
the package's _build/, and its outputs are held to this checkout's
kernels bit for bit at every shape. Then, for each shape and kernel, in
turns (earlier, this, this, earlier), every call after an L2 flush and
timed by CUDA events: the device time of the launches alone (the card
kept busy while the host enqueues them; select_rows' count and gather
launches timed apart, the host read of its totals between them left
out), and the wrapper's time, that read included. The bound is
chip_smoke.py's. Prints a line per shape, then the card's name and power
limit, then every time as one JSON object on the last line. Imports
nothing of JAX; writes only under .smoke/ab/.
"""

import ctypes as ct
import json
import os
import shutil
import sys

import chip_smoke as smoke

WORK = os.path.join(smoke.WORK, "ab")
N = 10                                  # calls per timing


def stream_ptr():
    import torch
    return torch.cuda.current_stream().cuda_stream


class EarlierDesign:
    """The earlier select_rows and masked_median, built from `csrc` and
    called as their wrappers called them, input checks included."""

    KEYS = ("row", "any_snp", "cum", "total", "con", "var", "morphia",
            "cls", "cryptic", "present")

    def __init__(self, csrc):
        from instrain_tpu_torch import build
        src = os.path.join(csrc, "compact.cu")
        hdr = os.path.join(csrc, "segments.cuh")
        nvcc = build._nvcc()
        smoke.check(nvcc is not None, "nvcc not found")
        smoke.check(os.path.exists(src) and os.path.exists(hdr),
                    f"no compact.cu and segments.cuh in {csrc}")

        def stages(out):
            return [[[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                      "-I", csrc, "-o", out, src]]]

        lib = ct.CDLL(build.build_library("instrain_compact_earlier", [src],
                                          [hdr], stages))
        P, I, I64 = ct.c_void_p, ct.c_int, ct.c_int64
        seg = [P, I, I64]                 # segment table, S, tiles
        lib.instrain_rows_count.restype = I
        lib.instrain_rows_count.argtypes = [P, P, I, I64] + seg + [P] * 6
        lib.instrain_rows_gather.restype = I
        lib.instrain_rows_gather.argtypes = ([P] * 10 + [I, I64] + seg +
                                             [P, P, I, I] + [P] * 8)
        lib.instrain_masked_median.restype = I
        lib.instrain_masked_median.argtypes = [P] * 5 + [I, I64, P, I, P, P]
        self.lib = lib

    def count(self, full, seg):
        import torch
        from instrain_tpu_torch.kernels import cuda_compact as CC
        M, L, dev = CC._check_full(full, self.KEYS, "select_rows")
        CC._check_seg(full["total"], seg, "select_rows")
        job = [torch.empty(seg.n_tiles, dtype=torch.int32, device=dev),
               torch.empty(seg.n_tiles, dtype=torch.int32, device=dev),
               torch.empty((2, seg.S + 1), dtype=torch.int32, device=dev),
               torch.empty(2, dtype=torch.int32, device=dev)]
        rc = self.lib.instrain_rows_count(
            full["row"].data_ptr(), full["any_snp"].data_ptr(), M, L,
            seg.table_ptr(), seg.S, seg.n_tiles, job[0].data_ptr(),
            job[1].data_ptr(), job[3].data_ptr(), job[2][0].data_ptr(),
            job[2][1].data_ptr(), stream_ptr())
        smoke.check(rc == 0, f"earlier rows_count: CUDA error {rc}")
        return job

    def gather(self, full, seg, job, n_rows, n_pos):
        import torch
        M, L = full["total"].shape
        dev = full["total"].device
        r_i32 = torch.empty((6, n_rows), dtype=torch.int32, device=dev)
        r_total = torch.empty(n_rows, dtype=torch.int64, device=dev)
        r_codes = torch.empty((4, n_rows), dtype=torch.int8, device=dev)
        r_cryptic = torch.empty(n_rows, dtype=torch.bool, device=dev)
        l_pos = torch.empty(n_pos, dtype=torch.int32, device=dev)
        l_cum = torch.empty((M, 4, n_pos), dtype=torch.int32, device=dev)
        l_present = torch.empty((M, n_pos), dtype=torch.bool, device=dev)
        if n_rows or n_pos:
            rc = self.lib.instrain_rows_gather(
                *[full[k].data_ptr() for k in self.KEYS], M, L,
                seg.table_ptr(), seg.S, seg.n_tiles, job[0].data_ptr(),
                job[1].data_ptr(), n_rows, n_pos, r_i32.data_ptr(),
                r_total.data_ptr(), r_codes.data_ptr(),
                r_cryptic.data_ptr(), l_pos.data_ptr(), l_cum.data_ptr(),
                l_present.data_ptr(), stream_ptr())
            smoke.check(rc == 0, f"earlier rows_gather: CUDA error {rc}")
        rows = dict(pos=r_i32[0], mm_idx=r_i32[1], A=r_i32[2], C=r_i32[3],
                    T=r_i32[4], G=r_i32[5], total=r_total, con=r_codes[0],
                    var=r_codes[1], morphia=r_codes[2], cls=r_codes[3],
                    cryptic=r_cryptic, n_rows=n_rows, seg_start=job[2][0])
        linkage = dict(pos=l_pos, cum=l_cum, present=l_present, n_pos=n_pos,
                       seg_start=job[2][1])
        return rows, linkage

    def select_rows(self, full, seg):
        job = self.count(full, seg)
        n_rows, n_pos = (int(x) for x in job[3].tolist())   # 8-byte D2H
        return self.gather(full, seg, job, n_rows, n_pos)

    def masked_median(self, total, clon_f, clonR_f, counted, rarefied, seg):
        import torch
        from instrain_tpu_torch.kernels import cuda_compact as CC
        from instrain_tpu_torch.kernels import sitestats as S
        from instrain_tpu_torch.kernels.cuda_sitestats import _require
        name = "masked_median"
        _require(total.dim() == 2 and total.dtype == torch.int64, name,
                 "total must be int64 [M, L]")
        M, L = total.shape
        _require(M >= 1 and L >= 1 and M * L < 2 ** 31, name,
                 f"[M, L] = [{M}, {L}] out of range")
        CC._check_seg(total, seg, name)
        _require(seg.S * M < 2 ** 31, name, "too many (segment, mm) rows")
        for t, dt, shape in ((clon_f, torch.float32, (M, L)),
                             (clonR_f, torch.float32, (M, L)),
                             (counted, torch.int64, (seg.S, M)),
                             (rarefied, torch.int64, (seg.S, M))):
            _require(t.dtype == dt and tuple(t.shape) == shape, name,
                     f"expected {dt} {shape}, got {t.dtype} "
                     f"{tuple(t.shape)}")
        for t in (total, clon_f, clonR_f, counted, rarefied):
            _require(t.device == total.device, name, "inputs on two devices")
            _require(t.is_contiguous(), name, "inputs must be contiguous")
        out = torch.empty((3, seg.S, M), dtype=torch.float32,
                          device=total.device)
        rc = self.lib.instrain_masked_median(
            total.data_ptr(), clon_f.data_ptr(), clonR_f.data_ptr(),
            counted.data_ptr(), rarefied.data_ptr(), M, L, seg.table_ptr(),
            seg.S, out.data_ptr(), stream_ptr())
        smoke.check(rc == 0, f"earlier masked_median: CUDA error {rc}")
        return dict(zip(S.AGG_MEDIAN, out))


def captured_shapes():
    """(name, full, seg) of the largest chunk of each main path's --engine
    auto run, on inputs made as chip_smoke.py makes them."""
    from instrain_tpu_torch.synth import synth
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    with smoke.CompactCapture() as capture:
        for name, S, L, cov in smoke.MAIN_CASES:
            d = os.path.join(WORK, name)
            os.makedirs(d)
            fasta, bam, _ = synth(d, S=S, L=L, COV=cov, seed=7)
            capture.run = name
            smoke.run_profile(bam, fasta, os.path.join(d, "auto.IS"), "auto")
    return [(f"{n} (captured)", *capture.inputs[n])
            for n, *_ in smoke.MAIN_CASES]


def ab_shape(torch, earlier, name, full, seg, card):
    """Both designs of both kernels at one shape: checked equal, then
    timed in turns."""
    from instrain_tpu_torch.kernels import cuda_compact as CC
    M, L = full["total"].shape
    agg, cf, rf = CC.mm_aggregates(full, seg)
    med_args = (full["total"], cf, rf, agg["counted"], agg["rarefied"], seg)
    rows, link = CC.select_rows(full, seg)
    med = CC.masked_median(*med_args)
    old_rows, old_link = earlier.select_rows(full, seg)
    torch.cuda.synchronize()
    smoke.compare_exact({"rows": rows, "linkage": link},
                        {"rows": old_rows, "linkage": old_link},
                        f"select_rows, {name}: this design vs the earlier")
    smoke.compare_exact(med, earlier.masked_median(*med_args),
                        f"masked_median, {name}: this design vs the earlier")
    n_rows, n_pos = rows["n_rows"], link["n_pos"]
    job, old_job = CC._rows_count(full, seg), earlier.count(full, seg)
    torch.cuda.synchronize()
    # per design: (the launches, each timed alone; the wrapper)
    kernels = {
        "select_rows": {
            "earlier": ([lambda: earlier.count(full, seg),
                         lambda: earlier.gather(full, seg, old_job, n_rows,
                                                n_pos)],
                        lambda: earlier.select_rows(full, seg)),
            "this": ([lambda: CC._rows_count(full, seg),
                      lambda: CC._rows_gather(job, n_rows, n_pos)],
                     lambda: CC.select_rows(full, seg))},
        "masked_median": {
            "earlier": ([lambda: earlier.masked_median(*med_args)],
                        lambda: earlier.masked_median(*med_args)),
            "this": ([lambda: CC.masked_median(*med_args)],
                     lambda: CC.masked_median(*med_args))}}
    bounds = {"select_rows": smoke.select_rows_bound(full, rows, link),
              "masked_median": smoke.bound(smoke.nbytes(med_args[:5], med))}
    res = {}
    for kname, designs in kernels.items():
        t = {}
        for d in ("earlier", "this", "this", "earlier"):
            launches, wrapper = designs[d]
            dev = sum(smoke.cold_ms(torch, f, N, busy=True)
                      for f in launches)
            t.setdefault(f"{d}_device_ms", []).append(dev)
            t.setdefault(f"{d}_ms", []).append(smoke.cold_ms(torch, wrapper,
                                                             N))
        r = res[kname] = {k: sum(v) / len(v) for k, v in t.items()}
        r.update(bound_ms=bounds[kname][0], bound_by=bounds[kname][1])
    smoke.log("ab", f"{name} (M={M}, {seg.S} segment(s), {L} positions, "
                    f"{n_rows} SNP rows, {n_pos} SNV positions) on {card}, "
                    f"cold L2, outputs equal bit for bit: " + "; ".join(
                        f"{k} device {v['this_device_ms']:.4f} ms (earlier "
                        f"{v['earlier_device_ms']:.4f}, "
                        f"{v['earlier_device_ms'] / v['this_device_ms']:.2f}"
                        f"x), wrapper {v['this_ms']:.4f} ms (earlier "
                        f"{v['earlier_ms']:.4f}), bound {v['bound_ms']:.4f} "
                        f"ms ({v['bound_by']})" for k, v in res.items()))
    return res


def main():
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this comparison "
              "needs an NVIDIA GPU", flush=True)
        return 1
    card = smoke.nvidia_smi_line()
    smoke.phase_build()
    earlier = EarlierDesign(os.path.abspath(sys.argv[1]))
    results = {}
    try:
        for name, full, seg in captured_shapes() + smoke.synthetic_shapes(
                torch):
            results[name] = ab_shape(torch, earlier, name, full, seg, card)
    except smoke.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    smoke.check("jax" not in sys.modules and "instrain_tpu" not in
                sys.modules, "jax or instrain_tpu was imported")
    print(card, flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
