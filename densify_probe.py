#!/usr/bin/env python3
"""
The short first check of K8 (csrc/densify.cu, cuda_compact.densify_sparse)
on one NVIDIA GPU, about a minute of command:

    python3 densify_probe.py

Builds the kernels and prints densify.cu's ptxas lines (registers, shared
memory, spills); holds K8 against its plain version and the int16 tensors
its wire was packed from at edge cases (an empty scaffold, counts of
254-32,767, a gap over 65,535 into the padding, a chunk of uneven
scaffolds), at a 52 x 40 kb chunk (M = 8, 10 % of cells nonzero) and a
2.5 Mb scaffold (M = 8, 5 %), with its warm time (CUDA events over 20
launches); then profiles a 17 x 4 kb input at 30x and synth_mixed's
overflow input with --engine batch and hybrid on the card and the CPU,
TSVs and stored covT/clonT/clonTR held equal, launches printed. Writes
under .scratch/k8w.
"""
import os
import shutil
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
from instrain_tpu_torch.synth import synth, synth_mixed  # noqa: E402

rng = np.random.default_rng(0)


def case(name):
    """(int16 tensors, true lengths, M) of a chunk."""
    if name == "empty":
        t = [np.zeros((8, 4, 4096), np.int16),
             np.zeros((8, 4, 8192), np.int16)]
        t[1][2, 1, 17] = 3
        return t + [np.zeros((8, 4, 4096), np.int16)], [100, 5000, 4096], 3
    if name == "values":
        t = np.zeros((8, 4, 4096), np.int16)
        for k, v in enumerate((254, 255, 256, 32767, 1)):
            t[k % 3, k % 4, 100 * k:100 * k + 50] = v
        t[2, 3, 4000] = 32767
        return [t], [4001], 3
    if name == "gap":
        t = np.zeros((8, 4, 24576), np.int16)
        t[0, 0, 4617] = 7
        t[0, 3, 10] = 300
        t[0, 3, 19999] = 2
        return [t], [20000], 1
    if name == "chunk":
        out, lengths = [], [1, 4000, 17, 4096, 9000]
        for L in lengths:
            t = np.zeros((8, 4, -(-L // 4096) * 4096), np.int16)
            t[:5, :, :L] = rng.integers(0, 40, (5, 4, L)) * (
                rng.random((5, 4, L)) < 0.3)
            t[1, 2, L - 1] = 1000
            out.append(t)
        return out, lengths, 5
    if name == "metachunk":
        out, lengths = [], [40000] * 52
        for L in lengths:
            t = np.zeros((8, 4, 40960), np.int16)
            t[:, :, :L] = rng.integers(0, 60, (8, 4, L)) * (
                rng.random((8, 4, L)) < 0.1)
            out.append(t)
        return out, lengths, 8
    if name == "isolate":
        L = 2_500_000
        t = np.zeros((8, 4, 2502656), np.int16)
        t[:, :, :L] = rng.integers(0, 300, (8, 4, L)) * (
            rng.random((8, 4, L)) < 0.05)
        return [t], [L], 8
    raise ValueError(name)


def kernels():
    t = time.time()
    lib = build.cuda_kernels_library()
    print("built", time.time() - t, flush=True)
    on = False
    for line in build.build_log(lib).splitlines():
        if "nvcc" in line and line.startswith("/"):
            on = "densify" in line
        if on and "ptxas" in line:
            print(line)
    dev = torch.device("cuda")
    for name in ("empty", "values", "gap", "chunk", "metachunk", "isolate"):
        tensors, lengths, M = case(name)
        Ltot = sum(lengths)
        buf, layout = PC.stage_wire(tensors, lengths, [
            np.zeros(L, np.uint8) for L in lengths], pin=True)
        want = S.densify_sparse_plain(PC.wire_views(buf, layout)[0], M,
                                      Ltot)
        wire, _ = PC.wire_views(buf.to(dev), layout)
        CC.reset_launch_counts()
        got = CC.densify_sparse(wire, M, Ltot)
        torch.cuda.synchronize()
        off = np.concatenate([[0], np.cumsum(lengths)])
        exact = all(np.array_equal(
            got[:, :, off[s]:off[s + 1]].cpu().numpy(),
            t[:M, :, :lengths[s]].astype(np.int32))
            for s, t in enumerate(tensors))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            CC.densify_sparse(wire, M, Ltot)
        a.record()
        for _ in range(20):
            CC.densify_sparse(wire, M, Ltot)
        b.record()
        b.synchronize()
        print(f"{name}: equal to plain {torch.equal(got.cpu(), want)}, to "
              f"the tensors {exact}, launches "
              f"{CC.launch_counts()['densify_sparse']}, entries "
              f"{wire.vals.numel()}, warm {a.elapsed_time(b) / 20:.4f} ms, "
              f"wire bytes {buf.numel()}, out bytes {16 * M * Ltot}",
              flush=True)


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


if __name__ == "__main__":
    kernels()
    profiles()
