#!/usr/bin/env python3
"""
The short first check of K8 (csrc/densify.cu, cuda_compact.densify_sparse)
on one NVIDIA GPU, about a minute of command:

    python3 densify_probe.py

Builds the kernels and prints densify.cu's ptxas lines (registers, shared
memory, spills of its index and fill kernels); holds K8, writing into an
output filled with a sentinel (so every cell is shown written), against
its plain version and the int16 tensors its wire was packed from at
synth.densify_case's cases: the edge cases (an empty scaffold, counts of
254-32,767, a gap over 65,535 into the padding, a chunk of uneven
scaffolds, Ltot % 4 != 0, windows over two rows and scaffolds, scaffolds
with no entries in the middle and at the end, no entries at all,
corrections in a window's first and last cell, one scaffold over many
tiles), each also with zero-value tails after each scaffold's entries, a
52 x 40 kb chunk (M = 8, 10 % of cells nonzero), a 2.5 Mb scaffold
(M = 8, 5 %) and a deep 250 kb one (M = 5, 7.8 %, most over 255), with
its warm time (CUDA events over 20 launches) and each launch's device
time (torch.profiler); then
profiles a 17 x 4 kb input at 30x and synth_mixed's overflow input with
--engine batch and hybrid on the card and the CPU, TSVs and stored
covT/clonT/clonTR held equal, launches printed. Writes under .scratch/k8w.

    python3 densify_probe.py variants densify_variants.json

builds each variant of csrc/densify.cu that the JSON file names ({name:
{"edits": [[text, replacement], ...], "window": cells}}: string edits of
this checkout's source, the window its fill uses) with nvcc, beside this
checkout's kernels, calls each through the same C entry with the
wrapper's scratch, holds its output to the plain version (a variant that
skips work is timed all the same), and times every variant and a bare
zero_() of the output in turns (there and back, three rounds; medians)
at the 52 x 40 kb chunk, the 2.5 Mb scaffold and the deep 250 kb one:
device time with the L2 flushed, and each launch's under
torch.profiler. Writes under .scratch/k8v.
"""
import ctypes as ct
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from instrain_tpu_torch import build  # noqa: E402
from instrain_tpu_torch.cli import main  # noqa: E402
from instrain_tpu_torch.kernels import cuda_compact as CC  # noqa: E402
from instrain_tpu_torch.kernels import sitestats as S  # noqa: E402
from instrain_tpu_torch.profile import compact as PC  # noqa: E402
from instrain_tpu_torch.store.profile_dir import ProfileDir  # noqa: E402
from instrain_tpu_torch.synth import (DENSIFY_CASES,  # noqa: E402
                                      DENSIFY_EDGE_CASES, densify_case,
                                      synth, synth_mixed,
                                      wire_with_zero_tail)

def kernels():
    t = time.time()
    lib = build.cuda_kernels_library()
    print("built", time.time() - t, flush=True)
    on = False
    for line in build.build_log(lib).splitlines():
        if "nvcc" in line and line.startswith("/"):
            on = "densify" in line
        if on and ("ptxas" in line or "Compiling entry" in line):
            print(line)
    import chip_smoke as smoke
    dev = torch.device("cuda")
    ok = True
    for name in DENSIFY_CASES:
        tensors, lengths, M = densify_case(name, seed=0)
        Ltot = sum(lengths)
        buf, layout = PC.stage_wire(tensors, lengths, [
            np.zeros(L, np.uint8) for L in lengths], pin=True)
        want = S.densify_sparse_plain(PC.wire_views(buf, layout)[0], M,
                                      Ltot)
        wire, _ = PC.wire_views(buf.to(dev), layout)
        CC.reset_launch_counts()
        got = smoke.densify_into_sentinel(torch, wire, M, Ltot)
        torch.cuda.synchronize()
        launches = CC.launch_counts()["densify_sparse"]
        off = np.concatenate([[0], np.cumsum(lengths)])
        exact = all(np.array_equal(
            got[:, :, off[s]:off[s + 1]].cpu().numpy(),
            t[:M, :, :lengths[s]].astype(np.int32))
            for s, t in enumerate(tensors))
        plain = torch.equal(got.cpu(), want)
        tail = "-"
        if name in DENSIFY_EDGE_CASES:
            tail = torch.equal(smoke.densify_into_sentinel(
                torch, wire_with_zero_tail(wire, 3), M, Ltot).cpu(), want)
        ok &= plain and exact and tail is not False and launches == 1
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            CC.densify_sparse(wire, M, Ltot)
        a.record()
        for _ in range(20):
            CC.densify_sparse(wire, M, Ltot)
        b.record()
        b.synchronize()
        print(f"{name}: equal to plain {plain}, to the tensors {exact}, "
              f"with zero tails {tail}, launches {launches}, entries "
              f"{wire.vals.numel()}, corrections {wire.corr_idx.numel()}, "
              f"tiles {wire.n_tiles}, warm {a.elapsed_time(b) / 20:.4f} "
              f"ms, wire bytes {buf.numel()}, out bytes {16 * M * Ltot}",
              flush=True)
        if name not in DENSIFY_EDGE_CASES:
            times = kernel_times(lambda: CC.densify_sparse(wire, M, Ltot))
            print(f"{name}: per kernel, {times}", flush=True)
    return ok


def kernel_times(call, n=10):
    """{kernel: mean device ms} of the launches of K8's kernels (the
    sums, index, marks and fill kernels of csrc/densify.cu) over n calls,
    each after an L2 flush, by torch.profiler."""
    import chip_smoke as smoke
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            smoke.flush_l2(torch)
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"(sums|index|marks|fill)_kernel\(", ev.key)
        t = getattr(ev, "device_time_total", 0)
        if m and t:
            out[m.group(1)] = round(out.get(m.group(1), 0) + t / 1e3 / n, 4)
    return out


def profiles():
    w = os.path.join(".scratch", "k8w")
    shutil.rmtree(w, ignore_errors=True)
    os.makedirs(os.path.join(w, "a"))
    os.makedirs(os.path.join(w, "b"))
    inputs = {"small": synth(os.path.join(w, "a"), S=17, L=4000, COV=30,
                             seed=5),
              "mixed": synth_mixed(os.path.join(w, "b"))}
    for name, (fa, bam, _) in inputs.items():
        for eng in ("batch", "hybrid"):
            o = {}
            for d in ("cuda", "cpu"):
                o[d] = os.path.join(w, f"{name}_{eng}_{d}.IS")
                CC.reset_launch_counts()
                t = time.time()
                assert main(["profile", bam, fa, "-o", o[d], "--device", d,
                             "--engine", eng, "--skip_genome_wide",
                             "--skip_plot_generation"]) == 0
                print(name, eng, d, f"{time.time() - t:.2f} s",
                      CC.launch_counts(), flush=True)
            same = True
            for t in ("SNVs", "scaffold_info", "linkage", "mapping_info"):
                texts = []
                for d in ("cuda", "cpu"):
                    with open(os.path.join(o[d], "output", os.path.basename(
                            o[d]) + f"_{t}.tsv")) as f:
                        texts.append(f.read())
                same &= texts[0] == texts[1]
            views = True
            for k in ("covT", "clonT", "clonTR"):
                x = ProfileDir(o["cuda"]).get(k)
                y = ProfileDir(o["cpu"]).get(k)
                views &= list(x) == list(y) and all(
                    list(x[s]) == list(y[s]) and
                    all(x[s][m].equals(y[s][m]) for m in x[s]) for s in x)
            print(name, eng, "TSVs equal", same, "specials equal", views,
                  flush=True)


def build_variant(name, spec, work):
    """(nvcc process, library path) of one variant's source."""
    d = os.path.join(work, re.sub(r"\W", "_", name))
    os.makedirs(d, exist_ok=True)
    src = os.path.join(os.path.dirname(build.__file__), "csrc")
    with open(os.path.join(src, "densify.cu")) as f:
        text = f.read()
    for a, b in spec.get("edits", []):
        if a not in text:
            raise SystemExit(f"variant {name}: no {a!r} in densify.cu")
        text = text.replace(a, b)
    with open(os.path.join(d, "densify.cu"), "w") as f:
        f.write(text)
    shutil.copy(os.path.join(src, "scan.cuh"), d)
    so = os.path.join(d, "libdensify.so")
    cmd = [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
           "-v", "-o", so, os.path.join(d, "densify.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def variants(path):
    from statistics import median
    import chip_smoke as smoke
    with open(path) as f:
        specs = json.load(f)
    work = os.path.join(".scratch", "k8v")
    shutil.rmtree(work, ignore_errors=True)
    procs = {n: build_variant(n, v, work) for n, v in specs.items()}
    libs = {}
    for n, (p, so) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"variant {n} failed to build:\n{out}")
        print(n, [line.split("info    :")[1].strip()
                  for line in out.splitlines() if "registers" in line],
              flush=True)
        lib = ct.CDLL(so)
        P, I, I64 = ct.c_void_p, ct.c_int, ct.c_int64
        lib.instrain_densify.restype = I
        lib.instrain_densify.argtypes = [P, I, I64, P, P, P, P, I, I64, I64,
                                         I64, P, P, P]
        libs[n] = (lib, specs[n].get("window", CC.DENSIFY_WINDOW))
    print(smoke.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    results = {}
    for case in ("metachunk", "isolate", "deep"):
        tensors, lengths, M = densify_case(case, seed=0)
        Ltot = sum(lengths)
        buf, layout = PC.stage_wire(tensors, lengths, [
            np.zeros(L, np.uint8) for L in lengths])
        wire, _ = PC.wire_views(buf.to(dev), layout)
        want = S.densify_sparse_plain(wire, M, Ltot)
        V = wire.vals.numel()
        outs = {}

        def call(n):
            lib, window = libs[n]
            windows = -(-4 * M * Ltot // window)
            scratch = torch.empty(CC.densify_geometry(
                V, wire.n_tiles, wire.S, M, Ltot)[1] + 16 * windows,
                dtype=torch.uint8, device=dev)
            rc = lib.instrain_densify(
                wire.table.data_ptr(), wire.S, wire.n_tiles,
                wire.deltas.data_ptr(), wire.vals.data_ptr(),
                wire.corr_idx.data_ptr(), wire.corr_val.data_ptr(), M, Ltot,
                window, windows, scratch.data_ptr(), outs[n].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"variant {n}: error {rc}")

        for n in libs:
            outs[n] = torch.full((M, 4, Ltot), smoke.SENTINEL,
                                 dtype=torch.int32, device=dev)
            call(n)
            torch.cuda.synchronize()
            print(case, n, "equal to plain", torch.equal(outs[n], want),
                  flush=True)
        calls = {n: (lambda n=n: call(n)) for n in libs}
        calls["zero_()"] = lambda: outs[next(iter(libs))].zero_()
        t = {n: [] for n in calls}
        for rnd in range(3):
            for n in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                t[n].append(smoke.cold_ms(torch, calls[n], 10, busy=True))
        res = {n: {"ms": median(v)} for n, v in t.items()}
        for n in libs:
            res[n]["kernels_ms"] = kernel_times(calls[n])
        bound = smoke.densify_bound(wire, M, Ltot)[0]
        for n, r in res.items():
            print(f"{case}: {n} {r['ms']:.4f} ms {r.get('kernels_ms', '')} "
                  f"(bound {bound:.4f} ms)", flush=True)
        results[case] = res
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["variants"]:
        variants(sys.argv[2])
        sys.exit(0)
    good = kernels()
    profiles()
    print("all kernel cases equal" if good else "FAIL: a kernel case "
          "differs", flush=True)
    sys.exit(0 if good else 1)
