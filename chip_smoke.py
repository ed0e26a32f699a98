#!/usr/bin/env python3
"""
Smoke run of instrain_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, that its kernels are right on the card, and that its
main path (`profile`) runs through them.

    python3 chip_smoke.py

Phases (each prints its own lines; the first failure exits non-zero):
  1. environment: torch/CUDA versions, the card, host packages;
  2. build: the CUDA kernels (nvcc, sm_90a, one process per source) and
     the native BAM decoder (g++) from this checkout's sources, with the
     seconds each took;
  3. kernels: the site-stats and clonR kernels against their plain
     PyTorch versions on the card (M in {1, 8}, L in {4096, 1048576,
     1237}, with reference code 4, coverage above the LUT cap and
     zero-count levels) and against the golden outputs of the JAX package
     (tests/data/); integers, masks and codes exact, clon within 1e-6,
     clonR bit for bit. Then the three compaction (K4) kernels against
     their plain versions, bit for bit (M in {1, 8, 33}, L in {1237,
     4096, 1048576}, and M = 8 at L = 2502656), and against the JAX
     package's compaction golden file. Kernel and plain times from CUDA
     events;
  4. end to end: `instrain_tpu_torch profile` through the CLI on a small
     synthetic BAM, --engine dense and --engine hybrid, each on
     --device cuda and --device cpu (each pair's TSVs byte-identical);
     then the main path: with every launch count reset, the synthetic
     metagenome (128 x 40 kb at 30x) and a one-scaffold isolate (2.5 Mb
     at 60x) through --engine auto, which is hybrid on the card, checking
     the output tables, the launch counts and the absence of scaffold
     failures; then both again through --engine dense (with their own
     launch counts), compared with the hybrid runs under the reference's
     cross-engine tolerances.
The last two lines are the kernels' JSON record and the device record.
Imports nothing of JAX. Needs no network; writes only under .smoke/.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(),
          f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1


def phase_environment(torch):
    import ctypes.util
    import importlib.util
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}, "
               f"{torch.cuda.device_count()} device(s)")
    card = nvidia_smi_line()
    log("env", f"card: {card}")
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "h5py", "tqdm")}
    header = any(os.path.exists(os.path.join(d, "libdeflate.h"))
                 for d in ("/usr/include", "/usr/local/include"))
    have["libdeflate.h"] = header
    have["libdeflate.so"] = ctypes.util.find_library("deflate") is not None
    log("env", "host packages: " + ", ".join(
        f"{k} {'yes' if v else 'no'}" for k, v in have.items()))
    if not (header and have["libdeflate.so"]):
        log("env", "libdeflate missing: the decoder builds over the zlib "
                   "shim (instrain_tpu_torch/csrc/zlib_shim)")
    if not have["h5py"]:
        log("env", "h5py missing: covT/clonT/clonTR are stored as pickles")
    check(have["pandas"], "pandas is required by the profile tables")
    return card


# ---------------------------------------------------------------- phase 2


def phase_build():
    from instrain_tpu_torch import build
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    t0 = time.perf_counter()
    kernels = build.cuda_kernels_library()
    t1 = time.perf_counter()
    io = build.native_io_library()
    t2 = time.perf_counter()
    log("build", f"CUDA kernels {os.path.basename(kernels)}: "
                 f"{t1 - t0:.2f} s")
    for line in build.build_log(kernels).splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())
    log("build", f"native decoder {os.path.basename(io)}: {t2 - t1:.2f} s")
    C.load_kernels()


# ---------------------------------------------------------------- phase 3


def compare(want, got, what):
    """Exact for integers/masks/codes, <= 1e-6 for clon, bitwise for
    clonR. Returns the largest absolute float difference."""
    import torch
    err = 0.0
    check(set(want) <= set(got), f"{what}: missing {set(want) - set(got)}")
    for k, a in want.items():
        b = got[k]
        a = torch.as_tensor(a).to(b.device)
        check(a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape),
              f"{what}/{k}: {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            check(torch.equal(torch.isnan(a), torch.isnan(b)),
                  f"{what}/{k}: NaN masks differ")
            d = (torch.nan_to_num(a) - torch.nan_to_num(b)).abs()
            e = float(d.max()) if d.numel() else 0.0
            if k == "clon":
                check(e <= 1e-6, f"{what}/{k}: max abs err {e}")
            else:
                check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                      f"{what}/{k}: not bit-identical (max abs err {e})")
            err = max(err, e)
        else:
            check(torch.equal(a, b), f"{what}/{k}: values differ")
    return err


def cuda_ms(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def timed_pair(torch, kernel, plain, n_kernel, n_plain):
    """(kernel ms, plain ms), taken in turns plain, kernel, kernel,
    plain within this call."""
    p1 = cuda_ms(torch, plain, n_plain)
    k1 = cuda_ms(torch, kernel, n_kernel)
    k2 = cuda_ms(torch, kernel, n_kernel)
    p2 = cuda_ms(torch, plain, n_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels(torch, card):
    import numpy as np
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.kernels.nullmodel import \
        analytic_null_thresholds
    from instrain_tpu_torch.kernels.sitestats import freq_min_count_lut
    from instrain_tpu_torch.profile.compact import _fold_keys
    from instrain_tpu_torch.synth import site_stats_inputs

    dev = torch.device("cuda")
    nl = torch.as_tensor(analytic_null_thresholds(max_coverage=10000),
                         device=dev)
    fl = torch.as_tensor(freq_min_count_lut(0.05, max_coverage=10000),
                         device=dev)
    errs = {"site_stats": 0.0, "clonR": 0.0}
    for M in (1, 8):
        for L in (4096, 1 << 20, 1237):
            counts, ref = site_stats_inputs(M, L, seed=M * 31 + L % 97)
            c = torch.from_numpy(counts).to(dev)
            r = torch.from_numpy(ref).to(dev)
            key = _fold_keys(42, [M + L])[0]
            Mp = max(-(-M // 8) * 8, 8)
            core_k = C.site_stats_core(c, r, nl, fl, 5, 50)
            core_p = C.site_stats_core_plain(c, r, nl, fl, 5, 50)
            torch.cuda.synchronize()
            e1 = compare(core_p, core_k, f"site_stats M={M} L={L}")
            args = (core_p["cum"], core_p["total"], core_p["clonR_set"],
                    key, 50, Mp)
            cr_k = C.clonR(*args)
            cr_p = C.clonR_plain(*args)
            torch.cuda.synchronize()
            e2 = compare({"clonR": cr_p}, {"clonR": cr_k},
                         f"clonR M={M} L={L}")
            n_set = int(core_p["clonR_set"].sum())
            errs["site_stats"] = max(errs["site_stats"], e1)
            errs["clonR"] = max(errs["clonR"], e2)
            log("kernels", f"M={M} L={L}: site_stats == plain (clon max "
                           f"abs err {e1:.3g}), clonR == plain bitwise "
                           f"({n_set} drawn cells)")

    golden = os.path.join(ROOT, "tests", "data",
                          "torch_sitestats_golden.npz")
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    gl = (torch.as_tensor(g["null_lut"], device=dev),
          torch.as_tensor(g["freq_lut"], device=dev))
    tags = sorted({k.split("/")[0] for k in g if "/" in k})
    for tag in tags:
        got = C.site_stats(torch.from_numpy(g[f"{tag}/counts"]).to(dev),
                           torch.from_numpy(g[f"{tag}/ref"]).to(dev), *gl,
                           g[f"{tag}/key"], min_cov=5, min_covR=50,
                           rarefied_draws=50,
                           m_stride=int(g[f"{tag}/m_stride"]))
        torch.cuda.synchronize()
        want = {k.split("/")[-1]: v for k, v in g.items()
                if k.startswith(f"{tag}/out/")}
        e = compare(want, got, f"golden {tag}")
        errs["site_stats"] = max(errs["site_stats"], e)
        log("kernels", f"golden {tag}: all {len(want)} outputs match the "
                       f"JAX package (clon max abs err {e:.3g}, clonR "
                       f"bitwise)")

    times = {}
    for M, L in ((8, 40000), (8, 1 << 20)):
        counts, ref = site_stats_inputs(M, L, seed=7)
        c = torch.from_numpy(counts).to(dev)
        r = torch.from_numpy(ref).to(dev)
        key = _fold_keys(42, [0])[0]
        core = C.site_stats_core_plain(c, r, nl, fl, 5, 50)
        args = (core["cum"], core["total"], core["clonR_set"], key, 50, 8)
        t_core = timed_pair(torch, lambda: C.site_stats_core(
            c, r, nl, fl, 5, 50), lambda: C.site_stats_core_plain(
            c, r, nl, fl, 5, 50), 20, 3)
        t_clonr = timed_pair(torch, lambda: C.clonR(*args),
                             lambda: C.clonR_plain(*args), 20, 3)
        times[(M, L)] = {"site_stats": t_core, "clonR": t_clonr}
        log("kernels", f"time M={M} L={L} on {card}: site_stats kernel "
                       f"{t_core[0]:.4f} ms vs plain {t_core[1]:.4f} ms; "
                       f"clonR kernel {t_clonr[0]:.4f} ms vs plain "
                       f"{t_clonr[1]:.4f} ms "
                       f"({int(core['clonR_set'].sum())} drawn cells)")
    return errs, times[(8, 1 << 20)]


def _bits(t):
    import torch
    return t.view({torch.float64: torch.int64,
                   torch.float32: torch.int32}.get(t.dtype, t.dtype))


def compare_exact(want, got, what):
    """Bit for bit over a (nested) dict of tensors and ints. Returns the
    largest absolute float difference (0.0 when the check passes)."""
    import torch
    check(set(want) == set(got), f"{what}: keys {set(want) ^ set(got)}")
    err = 0.0
    for k, a in want.items():
        b = got[k]
        if isinstance(a, dict):
            err = max(err, compare_exact(a, b, f"{what}/{k}"))
            continue
        if not isinstance(a, torch.Tensor):
            check(int(a) == int(b), f"{what}/{k}: {a} vs {b}")
            continue
        a = a.to(b.device)
        check(a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape),
              f"{what}/{k}: {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point and a.numel():
            d = (torch.nan_to_num(a, posinf=0.0) -
                 torch.nan_to_num(b, posinf=0.0)).abs()
            err = max(err, float(d.max()))
        check(torch.equal(_bits(a), _bits(b)),
              f"{what}/{k}: not bit-identical (max abs err {err})")
    return err


def phase_compact(torch, card):
    import numpy as np
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.kernels import sitestats as S
    from instrain_tpu_torch.kernels.nullmodel import \
        analytic_null_thresholds
    from instrain_tpu_torch.profile.compact import _fold_keys
    from instrain_tpu_torch.synth import site_stats_inputs

    dev = torch.device("cuda")
    nl = torch.as_tensor(analytic_null_thresholds(max_coverage=10000),
                         device=dev)
    fl = torch.as_tensor(S.freq_min_count_lut(0.05, max_coverage=10000),
                         device=dev)

    def full_for(M, L, seed):
        counts, ref = site_stats_inputs(M, L, seed=seed)
        Mp = max(-(-M // 8) * 8, 8)
        return C.site_stats(torch.from_numpy(counts).to(dev),
                            torch.from_numpy(ref).to(dev), nl, fl,
                            _fold_keys(42, [seed])[0], m_stride=Mp)

    errs = dict.fromkeys(("select_rows", "mm_aggregates", "masked_median"),
                         0.0)
    shapes = [(M, L) for M in (1, 8, 33) for L in (1237, 4096, 1 << 20)]
    for M, L in shapes + [(8, 2_502_656)]:
        full = full_for(M, L, M * 13 + L % 89)
        rows, link = CC.select_rows(full)
        agg, cf, rf = CC.mm_aggregates(full)
        med = CC.masked_median(full["total"], cf, rf, agg["counted"],
                               agg["rarefied"])
        torch.cuda.synchronize()
        prows, plink = S.select_rows(full)
        pagg, pcf, prf = S.mm_aggregates(full)
        pmed = S.masked_medians(full["total"], pcf, prf, pagg["counted"],
                                pagg["rarefied"])
        tag = f"M={M} L={L}"
        errs["select_rows"] = max(errs["select_rows"], compare_exact(
            {"rows": prows, "linkage": plink}, {"rows": rows,
                                                "linkage": link},
            f"select_rows {tag}"))
        errs["mm_aggregates"] = max(errs["mm_aggregates"], compare_exact(
            {"agg": pagg, "clon_f": pcf, "clonR_f": prf},
            {"agg": agg, "clon_f": cf, "clonR_f": rf},
            f"mm_aggregates {tag}"))
        errs["masked_median"] = max(errs["masked_median"], compare_exact(
            pmed, med, f"masked_median {tag}"))
        log("compact", f"{tag}: select_rows, mm_aggregates, masked_median "
                       f"== plain bit for bit ({rows['n_rows']} SNP rows, "
                       f"{link['n_pos']} SNV positions, "
                       f"{int(agg['rarefied'].sum())} rarefied cells)")
        del full

    golden = os.path.join(ROOT, "tests", "data", "torch_compact_golden.npz")
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    tags = sorted({k.split("/")[0] for k in g if "/" in k})
    for tag in tags:
        counts = torch.from_numpy(g[f"{tag}/counts"]).to(dev)
        M, _, L = counts.shape
        full = C.site_stats(counts, torch.from_numpy(g[f"{tag}/ref"]).to(
            dev), torch.as_tensor(g["null_lut"], device=dev),
            torch.as_tensor(g["freq_lut"], device=dev), g[f"{tag}/key"],
            min_cov=5, min_covR=50, rarefied_draws=50,
            m_stride=int(g[f"{tag}/m_stride"]))
        got = CC.compact_from_full(full, M, L)
        torch.cuda.synchronize()
        want = {grp: {} for grp in ("rows", "agg", "linkage", "masks")}
        for k, v in g.items():
            parts = k.split("/")
            if parts[0] == tag and parts[1] in want:
                want[parts[1]][parts[2]] = (
                    int(v) if v.ndim == 0 else torch.from_numpy(v))
        compare_exact(want, got, f"compact golden {tag}")
        log("compact", f"golden {tag}: rows, aggregates, linkage and masks "
                       f"equal the JAX package bit for bit")

    times = {}
    for M, L in ((8, 40000), (8, 1 << 20)):
        full = full_for(M, L, 7)
        agg, cf, rf = CC.mm_aggregates(full)
        med_args = (full["total"], cf, rf, agg["counted"], agg["rarefied"])
        times[(M, L)] = t = {
            "select_rows": timed_pair(torch, lambda: CC.select_rows(full),
                                      lambda: S.select_rows(full), 20, 5),
            "mm_aggregates": timed_pair(
                torch, lambda: CC.mm_aggregates(full),
                lambda: S.mm_aggregates(full), 20, 5),
            "masked_median": timed_pair(
                torch, lambda: CC.masked_median(*med_args),
                lambda: S.masked_medians(*med_args), 20, 5)}
        log("compact", f"time M={M} L={L} on {card}: " + "; ".join(
            f"{k} kernel {v[0]:.4f} ms vs plain {v[1]:.4f} ms"
            for k, v in t.items()))
    return errs, times[(8, 1 << 20)]


# ---------------------------------------------------------------- phase 4


def read_table(out, name):
    import pandas as pd
    path = os.path.join(out, "output", f"{os.path.basename(out)}_{name}.tsv")
    check(os.path.exists(path), f"{path} was not written")
    return pd.read_csv(path, sep="\t", header=1 if name == "mapping_info"
                       else 0)


def run_profile(bam, fasta, out, engine):
    from instrain_tpu_torch.cli import main
    from instrain_tpu_torch.profile import pipeline
    pipeline.PHASES = {}
    t0 = time.perf_counter()
    rc = main(["profile", bam, fasta, "-o", out, "--device", "cuda",
               "--engine", engine] + FLAGS)
    torch_sync()
    wall = time.perf_counter() - t0
    check(rc == 0, f"profile exited {rc}")
    phases = dict(pipeline.PHASES)
    pipeline.PHASES = None
    with open(os.path.join(out, "log", "log.log")) as f:
        failures = [l for l in f if "FAILURE" in l or
                    "whole scaffold exception" in l]
    check(not failures, f"scaffold failures logged: {failures[:3]}")
    return wall, phases


def torch_sync():
    import torch
    torch.cuda.synchronize()


def check_outputs(out, n_scaffolds, cov):
    import numpy as np
    info = read_table(out, "scaffold_info")
    check(len(info) == n_scaffolds,
          f"{out}: {len(info)} scaffold rows, expected {n_scaffolds}")
    for col in ("coverage", "breadth", "nucl_diversity",
                "breadth_minCov"):
        check(np.isfinite(info[col]).all(), f"{out}: {col} not finite")
    check(((info["coverage"] > 0.8 * cov) &
           (info["coverage"] < 1.2 * cov)).all(),
          f"{out}: coverage off target {cov}")
    check((info["breadth"] > 0.99).all(), f"{out}: breadth below 0.99")
    rows = {t: len(read_table(out, t))
            for t in ("SNVs", "linkage", "mapping_info")}
    rows["scaffold_info"] = len(info)
    for t, n in rows.items():
        check(n > 0, f"{out}: {t} has no rows")
    return rows, int(info["SNV_count"].sum())


class D2HBytes:
    """Counts the bytes each engine brings back to the host per scaffold,
    from the host arrays its stats object holds (every one of them came
    over from the device), by wrapping the two engine calls the pipeline
    makes."""

    def __init__(self):
        from instrain_tpu_torch.profile import compact, pipeline
        self.mods = (compact, pipeline)
        self.bytes = []

    def _nbytes(self, tree):
        if isinstance(tree, dict):
            return sum(self._nbytes(v) for v in tree.values())
        return getattr(tree, "nbytes", 0)

    def __enter__(self):
        compact, pipeline = self.mods
        self.saved = (compact.run_site_stats_hybrid, pipeline.run_site_stats)

        def hybrid(*a, **k):
            st = self.saved[0](*a, **k)
            # + the 8-byte read of the row and position counts
            self.bytes.append(8 + sum(self._nbytes(d) for d in (
                st.rows, st.agg, st.linkage, st.masks)) +
                st.clon.nbytes + st.clonR.nbytes)
            return st

        def dense(*a, **k):
            st = self.saved[1](*a, **k)
            self.bytes.append(self._nbytes(st.arrays))
            return st

        compact.run_site_stats_hybrid, pipeline.run_site_stats = hybrid, dense
        return self

    def __exit__(self, *exc):
        compact, pipeline = self.mods
        compact.run_site_stats_hybrid, pipeline.run_site_stats = self.saved
        return False


def compare_tables(a_dir, b_dir, skip=()):
    """The reference's cross-engine tolerances (tests/test_compact.py:
    45-49): strings and integers exact, nucl_diversity* within 1e-6, other
    floats within 1e-9. Returns the largest absolute difference of each
    column in `skip`, which is not held to them."""
    import numpy as np
    diffs = {}
    for t in ("SNVs", "scaffold_info", "linkage", "mapping_info"):
        a, b = read_table(a_dir, t), read_table(b_dir, t)
        check(list(a.columns) == list(b.columns) and len(a) == len(b),
              f"{t}: shapes differ between engines")
        for col in a.columns:
            va, vb = a[col].values, b[col].values
            if va.dtype.kind == "f" or vb.dtype.kind == "f":
                va, vb = va.astype(float), vb.astype(float)
                if col in skip:
                    diffs[col] = float(np.nanmax(np.abs(va - vb)))
                    continue
                check(np.array_equal(np.isnan(va), np.isnan(vb)),
                      f"{t}/{col}: NaN masks differ between engines")
                m = ~np.isnan(va)
                tol = 1e-6 if col.startswith("nucl_diversity") else 1e-9
                check(np.allclose(va[m], vb[m], rtol=tol, atol=tol),
                      f"{t}/{col}: engines differ beyond {tol}")
            else:
                check(np.array_equal(va, vb),
                      f"{t}/{col}: engines differ")
    return diffs


def phase_end_to_end(torch):
    from instrain_tpu_torch.cli import main
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.synth import synth

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # a small input, each engine on the card against the CPU, byte for byte
    small = os.path.join(WORK, "small")
    os.makedirs(small)
    fasta, bam, _ = synth(small, S=4, L=5000, COV=60, seed=3)
    for engine in ("dense", "hybrid"):
        outs = {}
        for device in ("cuda", "cpu"):
            outs[device] = os.path.join(small, f"{engine}_{device}.IS")
            check(main(["profile", bam, fasta, "-o", outs[device],
                        "--device", device, "--engine", engine] +
                       FLAGS) == 0, f"small {engine} {device} run failed")
        for t in ("SNVs", "scaffold_info", "linkage", "mapping_info"):
            texts = [open(os.path.join(o, "output",
                                       f"{os.path.basename(o)}_{t}.tsv")
                          ).read() for o in outs.values()]
            check(texts[0] == texts[1],
                  f"small input, --engine {engine}: {t} differs GPU vs CPU")
        log("e2e", f"small input (4 x 5 kb, 60x), --engine {engine}: GPU "
                   f"TSVs byte-identical to the --device cpu run")

    cases = [("metagenome", 128, 40_000, 30), ("isolate", 1, 2_500_000, 60)]
    data = {}
    for name, S, L, cov in cases:
        d = os.path.join(WORK, name)
        os.makedirs(d)
        t0 = time.perf_counter()
        data[name] = synth(d, S=S, L=L, COV=cov, seed=7)
        log("e2e", f"synth {name} ({S} x {L} bp, {cov}x, "
                   f"{data[name][2]} pairs): "
                   f"{time.perf_counter() - t0:.2f} s")

    def drive(engine):
        """Both inputs through one engine, launch counts reset just
        before and read just after."""
        C.reset_launch_counts()
        CC.reset_launch_counts()
        outs = {}
        for name, S, L, cov in cases:
            fasta, bam, n_pairs = data[name]
            out = outs[name] = os.path.join(WORK, name, f"{name}_{engine}.IS")
            with D2HBytes() as d2h:
                wall, phases = run_profile(bam, fasta, out, engine)
            rows, snvs = check_outputs(out, S, cov)
            mi = read_table(out, "mapping_info")
            filtered = int(mi["filtered_pairs"].iloc[0])
            check(filtered > 0.9 * n_pairs, f"{name}: {filtered} of "
                                            f"{n_pairs} pairs pass filtering")
            log("e2e", f"{name} --engine {engine}: wall {wall:.2f} s, "
                       f"{filtered} filtered pairs -> "
                       f"{filtered / wall:.0f} filtered pairs/s; rows "
                       f"{rows}; {snvs} SNV sites")
            log("e2e", f"{name} --engine {engine} phases (s): " + ", ".join(
                f"{k} {v:.3f}" for k, v in phases.items()))
            log("e2e", f"{name} --engine {engine} D2H: {sum(d2h.bytes)} "
                       f"bytes over {len(d2h.bytes)} engine calls, "
                       f"{sum(d2h.bytes) / len(d2h.bytes):.0f} per call")
        return outs, {**C.launch_counts(), **CC.launch_counts()}

    # the main path: --engine auto, which is the hybrid engine on the card
    n_scaffolds = sum(S for _, S, _, _ in cases)
    hybrid, launches = drive("auto")
    log("e2e", f"launches in the main path: {launches} "
               f"({n_scaffolds} scaffolds)")
    for k, n in launches.items():
        check(n >= n_scaffolds,
              f"kernel {k} launched {n} times for {n_scaffolds} scaffolds")

    # the dense engine, with its position chunks
    dense, dense_launches = drive("dense")
    chunks = sum(S * math.ceil(L / (1 << 20)) for _, S, L, _ in cases)
    log("e2e", f"launches in the dense runs: {dense_launches} "
               f"({chunks} scaffold chunks)")
    for k, n in dense_launches.items():
        want = chunks if k in ("site_stats", "clonR") else 0
        check(n == want, f"dense runs: kernel {k} launched {n} times, "
                         f"expected {want}")
    compare_tables(hybrid["metagenome"], dense["metagenome"])
    rare = ("nucl_diversity_rarefied", "nucl_diversity_rarefied_median")
    diffs = compare_tables(hybrid["isolate"], dense["isolate"], skip=rare)
    log("e2e", "metagenome: hybrid and dense tables agree within the "
               "reference's cross-engine tolerances; isolate: the same, "
               "except the rarefied columns, drawn per 1 Mb chunk by the "
               "dense engine and once per scaffold by the hybrid engine "
               "(max abs difference " + ", ".join(
                   f"{k} {v:.3g}" for k, v in diffs.items()) + ")")
    return launches


# ---------------------------------------------------------------- main


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run "
              "needs an NVIDIA GPU", flush=True)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import instrain_tpu_torch
    except ImportError:
        print("FAIL: instrain_tpu_torch is not beside chip_smoke.py",
              flush=True)
        return 1
    pkg = os.path.join(ROOT, "instrain_tpu_torch")
    if os.path.dirname(os.path.abspath(instrain_tpu_torch.__file__)) != pkg:
        print(f"FAIL: instrain_tpu_torch imported from "
              f"{instrain_tpu_torch.__file__}, not {pkg}", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_environment(torch)
    phase_build()
    errs, times = phase_kernels(torch, card)
    cerrs, ctimes = phase_compact(torch, card)
    errs.update(cerrs)
    times.update(ctimes)
    launches = phase_end_to_end(torch)
    check("jax" not in sys.modules and "instrain_tpu" not in sys.modules,
          "jax or instrain_tpu was imported")

    kernels = [
        {"name": "site_stats", "route": "cuda",
         "source": "instrain_tpu_torch/csrc/site_stats.cu",
         "replaces": "instrain_tpu/kernels/pallas_sitestats.py:247",
         "launches": launches["site_stats"],
         "max_abs_err": errs["site_stats"],
         "ms": times["site_stats"][0], "plain_ms": times["site_stats"][1]},
        {"name": "clonR", "route": "cuda",
         "source": "instrain_tpu_torch/csrc/clonr.cu",
         "replaces": "instrain_tpu/kernels/sitestats.py:136",
         "launches": launches["clonR"],
         "max_abs_err": errs["clonR"],
         "ms": times["clonR"][0], "plain_ms": times["clonR"][1]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "instrain_tpu_torch/csrc/compact.cu",
         "replaces": f"instrain_tpu/kernels/sitestats.py:{line}",
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, line in (("select_rows", 325), ("mm_aggregates", 346),
                           ("masked_median", 379))
    ]
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
