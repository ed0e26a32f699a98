#!/usr/bin/env python3
"""
Smoke run of instrain_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, that its kernels are right on the card, and that its
main paths (`profile` and `compare`) run through them.

    python3 chip_smoke.py

Phases (each prints its own lines; the first failure exits non-zero):
  1. environment: torch/CUDA versions, the card, host packages;
  2. build: the CUDA kernels (nvcc, sm_90a, one process per source) and
     the native BAM decoder (g++) from this checkout's sources, with the
     seconds each took; then `check_deps`, whose report names the card
     and the CUDA build and finds both libraries built;
  3. kernels: the site-stats and clonR kernels against their plain
     PyTorch versions on the card (M in {1, 8}, L in {4096, 1048576,
     1237}, with reference code 4, coverage above the LUT cap and
     zero-count levels) and against the golden outputs of the JAX package
     (tests/data/); integers, masks and codes exact, clon within 1e-6,
     clonR bit for bit. Then the three compaction (K4) kernels against
     their plain versions, bit for bit (M in {1, 8, 33}, L in {1237,
     4096, 1048576}, and M = 8 at L = 2502656), and against the JAX
     package's compaction golden file. Then the batch engine's form of
     clonR and K4 (K5: a chunk of scaffolds laid end to end, one segment
     each) against their plain versions at segments of unequal length, a
     single position and one past 1 Mb among them, M in {1, 8, 33}, and
     the engine's chunk path against the JAX package's batch golden file;
     select_rows and masked_median at edge shapes, bit for bit (M = 33
     over 40 kb segments, M = 80, one position, masked_median's short-row
     bound of 49,152 positions and one past; all-equal values, rows of
     0-3 counted values among +inf, values on the select's digit
     boundaries); and the linkage kernel (K6) against its plain version
     and the JAX package's golden file, every column bit for bit, one
     launch a call, at the golden shapes, one cell, 5,000 x 12 x 150,000,
     64 x 33 x 9,000, 50,000 x 8 x 4,000,000 (its device and wrapper time
     there) and either side of the grid's one-tile blocks. Then the
     overlap kernel of compare (K7), one launch per comparison group,
     against its plain group version and the host popcount, exact, at
     groups of one scaffold of (samples, mm levels, positions) up to
     (16, 4, 2^23) and (64, 3, 100000), groups of mixed N (1-64), Mg (1-5)
     and L (1, 63, 64, 4099, 40000, one of 2^23 among short ones) and the
     study's group of 128 x (8, 5, 40 kb); timed beside the bf16 product of
     the unpacked bits at the study's group and the two large shapes; the
     host popcount against the group launch with its copies over the
     summed work n^2 * Mg * L that compare's auto engine reads.
     Kernel and plain times from CUDA events, each kernel's bound from its
     bytes and operations at the card's rates;
  4. end to end: `instrain_tpu_torch profile -g` through the CLI on a
     small synthetic BAM with the genes of synth_genes, --engine dense,
     hybrid and batch, each on --device cuda and --device cpu (each pair's
     TSVs, gene_info too, byte-identical, and so are the outputs of
     parse_annotations over each, with an annotation CSV the smoke
     writes); then the
     main paths through --engine auto, each with every launch count reset
     just before it and read just after: the synthetic metagenome (128 x
     40 kb at 30x), which runs the batch engine, a one-scaffold isolate
     (2.5 Mb at 60x) and a deep input (250 kb at 3000x, whose linkage
     crosses the device bound), which run hybrid, checking the output
     tables, each kernel's launch count against the planned chunks and
     the scaffolds past the linkage bound, one copy to the card and one
     back for each device linkage call, and the absence of scaffold
     failures; then the metagenome with -g (synth_genes' prodigal file)
     and the plots through --engine auto (batch): a gene_info row for
     every gene of the profiled scaffolds, each kernel launched as often
     as without -g and plots, no scaffold or gene failure, its wall and
     genes phase beside the run without -g, and the nine figures where
     matplotlib imports (where it does not, `Plotting failed` logged and
     the run's checks as before); the metagenome with -g through
     --engine hybrid (TSVs and gene_info byte-identical to the batch
     run), both engines' device copies under torch.profiler (batch with
     -g and the plots too: the same copies as without), the deep input
     on --device cpu
     with the device linkage engine forced (TSVs byte-identical), and the
     metagenome and the isolate through --engine dense (launch counts
     reset and read around each run: site_stats and clonR once per 1 Mb
     position chunk, the other kernels never; the reference's
     cross-engine tolerances against the batch and hybrid tables, the
     metagenome's with -g and gene_info, the rarefied columns of the
     isolate apart); `profile_genes` with synth_genes' GenBank file over
     the metagenome's profile (covT a pickle where h5py is missing): a
     gene_info row for every gene, no failure; then compare: 8 samples of
     the metagenome (4 genomes, 10-40x, each BAM with its .bai: a ranged
     decode of half its scaffolds holds the full decode's records)
     profiled on the card with genome-wide aggregation, and compared
     (with -s, --bams,
     --store_mismatch_locations and --store_coverage_overlap) on the card
     through the overlap kernel (launch counts reset just before and read
     just after: once per comparison group), with the host engine, on
     --device cpu and with --engine auto (a launch per group from its
     bound on), every TSV byte for byte, a comparison row per (scaffold,
     pair, mm level), no scaffold failure, every pooling decode ranged
     (the pooling phase's seconds printed), and the device run drawing
     the dendrograms (where matplotlib imports; else the failure logged).
     The batch engine's profiled run also reports, per chunk, its H2D
     bytes and time beside its kernels' (from the trace);
  5. host commands: quick_profile (a coverm_raw.tsv row per scaffold),
     filter_reads (mapping_info.csv equal to the profile's) and other
     --run_statistics over the metagenome, and the rarefaction_curve
     script on the card over the small input at fractions 0.5 and 1.0
     (its site_stats launches counted; its 1.0 row against the small
     input's profile);
  6. timing: select_rows and masked_median at the inputs compact_from_full
     got in the three auto runs (the metagenome's largest chunk, the
     isolate, the deep input), at a 52 x 40 kb chunk and at one segment
     of M = 8, L = 2^20: the wrapper's time and its launches' device time
     alone, the plain version's, one PyTorch call's (torch.nonzero with
     the gathers; torch.sort), each after an L2 flush, and the bound.
The last three lines are the card's name and power limit, the kernels'
JSON record and the device record.
The kernels' record takes select_rows and masked_median at the
metagenome's chunk, the other kernels at the shapes their phases time;
ld's row has its device time beside its wrapper time at the deep input,
and its times and bound at 50,000 x 8 x 4,000,000.
Imports nothing of JAX. Needs no network; writes only under .smoke/.
"""

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]
# the main paths' inputs: (name, scaffolds, length, coverage), synth seed 7
MAIN_CASES = [("metagenome", 128, 40_000, 30), ("isolate", 1, 2_500_000, 60),
              ("deep", 1, 250_000, 3000)]


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


# The least time the card could take for a kernel's work: the larger of
# the bytes it must move (each input read once, each output written once)
# over the memory rate and its operations over their issue rate. Rates:
# HBM3 3.35 TB/s (H100 SXM data sheet); per SM and clock on cc 9.0, 64
# 32-bit integer adds, shifts or logic operations (CUDA C++ Programming
# Guide, arithmetic instruction throughput), times the SMs and the card's
# maximum SM clock from nvidia-smi.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_CLK_SM = 64
THREEFRY_OPS = 90     # 32-bit operations of one Threefry-2x32 draw


def card_rates(torch):
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    hz = float(res.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("env", f"{sms} SMs at up to {hz / 1e6:.0f} MHz: "
               f"{sms * INT32_PER_CLK_SM * hz:.4g} int32 op/s")
    return {"int32": sms * INT32_PER_CLK_SM * hz}


def nbytes(*objs):
    """Bytes of every tensor in (nested dicts, lists or tuples of) objs."""
    import torch
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, dict):
            n += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            n += nbytes(*o)
    return n


def bound(n_bytes, ops=0.0, rate=1.0):
    """(bound_ms, bound_by) of n_bytes moved and ops at `rate` per s."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


_FLUSH = []


def flush_l2(torch):
    """Write 128 MB, more than the card's 50 MB L2, so that the next
    launch finds its inputs in device memory."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(1 << 25, dtype=torch.int32, device="cuda"))
    _FLUSH[0].fill_(1)


def cold_ms(torch, fn, n, busy=False):
    """Mean ms of fn over n calls, each after an L2 flush, by CUDA events
    around each call alone: host waits inside fn included; or, with
    `busy`, the device time of the launches fn enqueues alone, the card
    kept busy (torch.cuda._sleep) while the host enqueues them (fn must
    not wait for the device)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        flush_l2(torch)
        if busy:
            torch.cuda._sleep(1_000_000)    # about 0.5 ms at 1980 MHz
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / n


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
            seg = C.single_segment(L, _fold_keys(42, [M + L])[0], dev)
            Mp = max(-(-M // 8) * 8, 8)
            core_k = C.site_stats_core(c, r, nl, fl, 5, 50)
            core_p = C.site_stats_core_plain(c, r, nl, fl, 5, 50)
            torch.cuda.synchronize()
            e1 = compare(core_p, core_k, f"site_stats M={M} L={L}")
            args = (core_p["cum"], core_p["total"], core_p["clonR_set"],
                    seg, 50, Mp)
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
        counts = torch.from_numpy(g[f"{tag}/counts"]).to(dev)
        got = C.site_stats(counts, torch.from_numpy(g[f"{tag}/ref"]).to(dev),
                           *gl, C.single_segment(counts.shape[-1],
                                                 g[f"{tag}/key"], dev),
                           min_cov=5, min_covR=50, rarefied_draws=50,
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
        seg = C.single_segment(L, _fold_keys(42, [0])[0], dev)
        core = C.site_stats_core_plain(c, r, nl, fl, 5, 50)
        args = (core["cum"], core["total"], core["clonR_set"], seg, 50, 8)
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


def one_scaffold(out):
    """The K4 outputs of a chunk of one segment in the JAX package's
    one-scaffold form: the aggregates without their segment axis, rows
    and linkage without seg_start (checked: [0, n_rows] and [0, n_pos])."""
    rows, link = dict(out["rows"]), dict(out["linkage"])
    check(rows.pop("seg_start").tolist() == [0, rows["n_rows"]] and
          link.pop("seg_start").tolist() == [0, link["n_pos"]],
          "a one-segment chunk's seg_start is not [0, n]")
    return dict(rows=rows, agg={k: v[0] for k, v in out["agg"].items()},
                linkage=link, masks=out["masks"])


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
        """Site stats of one scaffold, and its one-segment table."""
        counts, ref = site_stats_inputs(M, L, seed=seed)
        Mp = max(-(-M // 8) * 8, 8)
        seg = C.single_segment(L, _fold_keys(42, [seed])[0], dev)
        return C.site_stats(torch.from_numpy(counts).to(dev),
                            torch.from_numpy(ref).to(dev), nl, fl, seg,
                            m_stride=Mp), seg

    errs = dict.fromkeys(("select_rows", "mm_aggregates", "masked_median"),
                         0.0)
    shapes = [(M, L) for M in (1, 8, 33) for L in (1237, 4096, 1 << 20)]
    for M, L in shapes + [(8, 2_502_656)]:
        full, seg = full_for(M, L, M * 13 + L % 89)
        rows, link = CC.select_rows(full, seg)
        agg, cf, rf = CC.mm_aggregates(full, seg)
        med = CC.masked_median(full["total"], cf, rf, agg["counted"],
                               agg["rarefied"], seg)
        torch.cuda.synchronize()
        prows, plink = S.select_rows_seg(full, seg)
        pagg, pcf, prf = S.mm_aggregates_seg(full, seg)
        pmed = S.masked_medians_seg(full["total"], pcf, prf, pagg["counted"],
                                    pagg["rarefied"], seg)
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
        seg = C.single_segment(counts.shape[-1], g[f"{tag}/key"], dev)
        full = C.site_stats(counts, torch.from_numpy(g[f"{tag}/ref"]).to(
            dev), torch.as_tensor(g["null_lut"], device=dev),
            torch.as_tensor(g["freq_lut"], device=dev), seg,
            min_cov=5, min_covR=50, rarefied_draws=50,
            m_stride=int(g[f"{tag}/m_stride"]))
        got = one_scaffold(CC.compact_from_full(full, seg))
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

    # select_rows and masked_median are timed in compact_timing
    for M, L in ((8, 40000), (8, 1 << 20)):
        full, seg = full_for(M, L, 7)
        t = timed_pair(torch, lambda: CC.mm_aggregates(full, seg),
                       lambda: S.mm_aggregates_seg(full, seg), 20, 5)
        log("compact", f"time M={M} L={L} on {card}: mm_aggregates kernel "
                       f"{t[0]:.4f} ms vs plain {t[1]:.4f} ms")
    return errs


def segment_inputs(M, lengths, seed):
    """Site-stats inputs of a chunk: scaffolds of `lengths` laid end to
    end ([M, 4, sum(lengths)] counts, ref codes)."""
    import numpy as np
    from instrain_tpu_torch.synth import site_stats_inputs
    cs, rs = [], []
    for i, L in enumerate(lengths):
        if L >= 40:
            c, r = site_stats_inputs(M, L, seed + i)
        else:
            rng = np.random.default_rng(seed + i)
            c = rng.integers(0, 90, (M, 4, L)).astype(np.int32)
            r = rng.integers(0, 5, L).astype(np.uint8)
        cs.append(c)
        rs.append(r)
    return np.concatenate(cs, axis=2), np.concatenate(rs)


def phase_batch(torch, card):
    """The batch engine's kernels (K5): clonR and the three K4 kernels
    with a segment table, against their plain versions and, through the
    engine's chunk path, against the JAX package's batch golden file."""
    import numpy as np
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.kernels import sitestats as S
    from instrain_tpu_torch.kernels.nullmodel import \
        analytic_null_thresholds
    from instrain_tpu_torch.profile import compact as PC
    from instrain_tpu_torch.profile.pileup import ScaffoldPileup

    dev = torch.device("cuda")
    nl = torch.as_tensor(analytic_null_thresholds(max_coverage=10000),
                         device=dev)
    fl = torch.as_tensor(S.freq_min_count_lut(0.05, max_coverage=10000),
                         device=dev)

    def chunk(M, lengths, seed):
        counts, ref = segment_inputs(M, lengths, seed)
        c, r = torch.from_numpy(counts).to(dev), torch.from_numpy(ref).to(dev)
        seg = S.Segments(lengths, PC._fold_keys(42, range(seed, seed + len(
            lengths))), dev)
        Mp = max(-(-M // 8) * 8, 8)
        full = C.site_stats(c, r, nl, fl, seg, m_stride=Mp)
        return c, r, full, seg, Mp

    errs = dict.fromkeys(("site_stats", "clonR", "select_rows",
                          "mm_aggregates", "masked_median"), 0.0)
    for M, lengths in ((8, [1, 1237, 40000, 1_048_577, 300, 4096]),
                       (33, [160, 1, 5000, 40000]), (1, [7, 3000])):
        c, r, full, seg, Mp = chunk(M, lengths, M)
        core_p = C.site_stats_core_plain(c, r, nl, fl, 5, 50)
        torch.cuda.synchronize()
        errs["site_stats"] = max(errs["site_stats"], compare(
            core_p, full, f"site_stats chunk M={M}"))
        errs["clonR"] = max(errs["clonR"], compare_exact(
            {"clonR": S.clonR_values_seg(full["cum"], full["total"],
                                         full["clonR_set"], seg, 50, Mp)},
            {"clonR": full["clonR"]}, f"clonR chunk M={M}"))
        rows, link = CC.select_rows(full, seg)
        agg, cf, rf = CC.mm_aggregates(full, seg)
        med = CC.masked_median(full["total"], cf, rf, agg["counted"],
                               agg["rarefied"], seg)
        torch.cuda.synchronize()
        prows, plink = S.select_rows_seg(full, seg)
        pagg, pcf, prf = S.mm_aggregates_seg(full, seg)
        pmed = S.masked_medians_seg(full["total"], pcf, prf,
                                    pagg["counted"], pagg["rarefied"], seg)
        tag = f"chunk M={M} L={lengths}"
        errs["select_rows"] = max(errs["select_rows"], compare_exact(
            {"rows": prows, "linkage": plink},
            {"rows": rows, "linkage": link}, f"select_rows {tag}"))
        errs["mm_aggregates"] = max(errs["mm_aggregates"], compare_exact(
            {"agg": pagg, "clon_f": pcf, "clonR_f": prf},
            {"agg": agg, "clon_f": cf, "clonR_f": rf},
            f"mm_aggregates {tag}"))
        errs["masked_median"] = max(errs["masked_median"], compare_exact(
            pmed, med, f"masked_median {tag}"))
        log("batch", f"{tag}: site_stats, clonR, select_rows, "
                     f"mm_aggregates, masked_median == plain bit for bit "
                     f"({rows['n_rows']} SNP rows, {link['n_pos']} SNV "
                     f"positions, {int(full['clonR_set'].sum())} drawn "
                     f"cells)")
        del full, core_p

    golden = os.path.join(ROOT, "tests", "data", "torch_batch_golden.npz")
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    for name in sorted({k.split("/")[0] for k in g if "/" in k}):
        Mp = int(g[f"{name}/m_stride"])
        n = len({k.split("/")[1] for k in g
                 if k.startswith(name + "/") and k.split("/")[1].isdigit()})
        items, Ms = [], []
        for s in range(n):
            counts = g[f"{name}/{s}/counts"]
            M, _, L = counts.shape
            cp = np.zeros((Mp, 4, L), np.int32)
            cp[:M] = counts
            items.append((s, ScaffoldPileup(name=f"s{s}", rid=s, length=L,
                                            mm_values=np.arange(Mp),
                                            counts=cp),
                          g[f"{name}/{s}/ref"]))
            Ms.append(M)
        keys = np.stack([g[f"{name}/{s}/key"] for s in range(n)])
        fold, PC._fold_keys = PC._fold_keys, lambda seed, rids: keys
        try:
            res = PC._finish_chunk(PC._dispatch_chunk(
                items, torch.as_tensor(g["null_lut"], device=dev),
                torch.as_tensor(g["freq_lut"], device=dev), 5, 50, 0, False,
                dev))
        finally:
            PC._fold_keys = fold
        for s, st in res:
            M = Ms[s]
            want, got = {}, {}
            for grp in ("rows", "agg", "linkage", "masks"):
                d = getattr(st, grp)
                for k, v in g.items():
                    parts = k.split("/")
                    if parts[:3] != [name, str(s), grp]:
                        continue
                    key = f"{grp}/{parts[3]}"
                    want[key] = (int(v) if v.ndim == 0
                                 else torch.from_numpy(v))
                    b = d[parts[3]]
                    if grp == "agg" or parts[3] in ("cum", "present"):
                        b = b[:M]
                    got[key] = (int(b) if parts[3] in ("n_rows", "n_pos")
                                else torch.from_numpy(np.ascontiguousarray(
                                    b)))
            compare_exact(want, got, f"batch golden {name}/{s}")
        log("batch", f"golden {name}: {n} scaffolds of one chunk (M "
                     f"{Ms}) equal the JAX package's batch engine bit for "
                     f"bit")

    # times at the metagenome's chunk shape: as many 40 kb scaffolds at
    # M = 8 as one chunk holds (select_rows and masked_median: in
    # compact_timing)
    S_chunk = PC.CHUNK_CELLS // (8 * 40000)
    c, r, full, seg, Mp = chunk(8, [40000] * S_chunk, 7)
    agg, cf, rf = CC.mm_aggregates(full, seg)
    args = (full["cum"], full["total"], full["clonR_set"], seg, 50, Mp)
    times = {
        "site_stats": timed_pair(
            torch, lambda: C.site_stats_core(c, r, nl, fl, 5, 50),
            lambda: C.site_stats_core_plain(c, r, nl, fl, 5, 50), 20, 1),
        "clonR": timed_pair(torch, lambda: C.clonR(*args),
                            lambda: C.clonR_plain(*args), 20, 1),
        "mm_aggregates": timed_pair(
            torch, lambda: CC.mm_aggregates(full, seg),
            lambda: S.mm_aggregates_seg(full, seg), 20, 1)}
    log("batch", f"time, one chunk of {S_chunk} x 40 kb at M=8 on {card}: "
                 + "; ".join(f"{k} kernel {v[0]:.4f} ms vs plain "
                             f"{v[1]:.4f} ms" for k, v in times.items()))
    # bounds at the same shape: bytes in and out; clonR's Threefry draws
    # (50 per drawn cell)
    rates = card_rates(torch)
    core = C.site_stats_core(c, r, nl, fl, 5, 50)
    keys_agg = ("total", "clon", "clonR", "row", "morphia", "cls", "present")
    drawn = int(full["clonR_set"].sum())
    bounds = {
        "site_stats": bound(nbytes(c, r, nl, fl, core)),
        "clonR": bound(nbytes(args[:3], full["clonR"]),
                       drawn * 50 * THREEFRY_OPS, rates["int32"]),
        "mm_aggregates": bound(nbytes([full[k] for k in keys_agg],
                                      agg, cf, rf))}
    log("batch", "bounds at that shape: " + "; ".join(
        f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items()))
    return errs, times, bounds


# ------------------------------------------------ select_rows, masked_median

# the site_stats outputs the compaction kernels read
COMPACT_KEYS = ("row", "any_snp", "cum", "total", "con", "var", "morphia",
                "cls", "cryptic", "present", "clon", "clonR")


class CompactCapture:
    """While open, clones the inputs of cuda_compact.compact_from_full:
    for each run (its name set in .run) those of its largest chunk, as
    .inputs[name] = (full, seg)."""

    def __init__(self):
        from instrain_tpu_torch.kernels import cuda_compact
        self.mod, self.run = cuda_compact, None
        self.inputs, self.cells = {}, {}

    def __enter__(self):
        self.saved = self.mod.compact_from_full

        def keep(full, seg):
            cells = full["total"].numel()
            if cells > self.cells.get(self.run, 0):
                self.cells[self.run] = cells
                self.inputs[self.run] = (
                    {k: full[k].clone() for k in COMPACT_KEYS}, seg)
            return self.saved(full, seg)

        self.mod.compact_from_full = keep
        return self

    def __exit__(self, *exc):
        self.mod.compact_from_full = self.saved
        return False


def site_stats_chunk(torch, M, lengths, seed):
    """(full, seg): the site stats, on the card, of a chunk of scaffolds of
    `lengths` at M mm levels laid end to end."""
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.kernels import sitestats as S
    from instrain_tpu_torch.kernels.nullmodel import \
        analytic_null_thresholds
    from instrain_tpu_torch.profile.compact import _fold_keys
    dev = torch.device("cuda")
    nl = torch.as_tensor(analytic_null_thresholds(max_coverage=10000),
                         device=dev)
    fl = torch.as_tensor(S.freq_min_count_lut(0.05, max_coverage=10000),
                         device=dev)
    counts, ref = segment_inputs(M, lengths, seed)
    seg = S.Segments(lengths, _fold_keys(42, range(seed, seed + len(
        lengths))), dev)
    full = C.site_stats(torch.from_numpy(counts).to(dev),
                        torch.from_numpy(ref).to(dev), nl, fl, seg,
                        m_stride=max(-(-M // 8) * 8, 8))
    return {k: full[k] for k in COMPACT_KEYS}, seg


def check_select_median(torch, full, seg, what):
    """select_rows and masked_median (after mm_aggregates) bit for bit
    against their plain versions. Returns (select err, median err)."""
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import sitestats as S
    rows, link = CC.select_rows(full, seg)
    agg, cf, rf = CC.mm_aggregates(full, seg)
    med = CC.masked_median(full["total"], cf, rf, agg["counted"],
                           agg["rarefied"], seg)
    torch.cuda.synchronize()
    prows, plink = S.select_rows_seg(full, seg)
    pmed = S.masked_medians_seg(full["total"], cf, rf, agg["counted"],
                                agg["rarefied"], seg)
    e1 = compare_exact({"rows": prows, "linkage": plink},
                       {"rows": rows, "linkage": link},
                       f"select_rows {what}")
    e2 = compare_exact(pmed, med, f"masked_median {what}")
    return e1, e2, rows["n_rows"], link["n_pos"]


def median_edge_inputs(torch, kind, M, lengths, seed):
    """(total, clon_f, clonR_f, counted, rarefied, seg) on the card for
    masked_median's edge cases:
      equal   every coverage 30 and every clonality 1.0;
      sparse  counted / rarefied of 0, 1, 2 or 3 per row, the counted
              values at random positions and +inf elsewhere;
      digits  coverages and clonalities at the boundaries of the select's
              digits (2^k - 1, 2^k, 2^k + 1, neighbouring f32 patterns,
              +inf), with counts 0, 1, 2, n - 1, n or at random."""
    import numpy as np
    from instrain_tpu_torch.kernels import sitestats as S
    from instrain_tpu_torch.profile.compact import _fold_keys
    rng = np.random.default_rng(seed)
    Lt, n_seg = sum(lengths), len(lengths)
    dev = torch.device("cuda")
    if kind == "equal":
        total = np.full((M, Lt), 30, np.int64)
        cf = np.ones((M, Lt), np.float32)
        rf = cf.copy()
        counted = np.tile(np.asarray(lengths, np.int64)[:, None], (1, M))
        rarefied = counted.copy()
    elif kind == "sparse":
        total = rng.integers(0, 60, (M, Lt)).astype(np.int64)
        vals = np.float32([0.25, 0.5, 0.75, 1.0])
        cf = np.full((M, Lt), np.inf, np.float32)
        rf = cf.copy()
        counted = np.zeros((n_seg, M), np.int64)
        rarefied = np.zeros((n_seg, M), np.int64)
        a = 0
        for s, n in enumerate(lengths):
            for m in range(M):
                for arr, cnt, c in ((cf, counted, (s + m) % 4),
                                    (rf, rarefied, (s + 2 * m + 1) % 4)):
                    c = min(c, n)
                    at = a + rng.choice(n, c, replace=False)
                    arr[m, at] = rng.choice(vals, c)
                    cnt[s, m] = c
            a += n
    else:
        cov = np.array([0, 1, 2, 3, 2047, 2048, 2049, 65535, 65536, 65537,
                        (1 << 24) - 1, 1 << 24, (1 << 24) + 1, (1 << 24) + 3,
                        1 << 31], np.int64)
        bits = np.array([0x3E000000, 0x3EFFFFFF, 0x3F000000, 0x3F000001,
                         0x3F7FFBFF, 0x3F7FFC00, 0x3F7FFFFF, 0x3F800000,
                         0x3F800001, 0x3F800400, 0x7F800000], np.uint32)
        total = rng.choice(cov, (M, Lt))
        cf = rng.choice(bits, (M, Lt)).view(np.float32)
        rf = rng.choice(bits[:4], (M, Lt)).view(np.float32)
        picks = []
        for n in lengths:
            picks.append([min(c, n) for c in (0, 1, 2, max(n - 1, 0), n)] +
                         list(rng.integers(0, n + 1, M)))
        counted = np.array([[p[m % len(p)] for m in range(M)]
                            for p in picks], np.int64)
        rarefied = np.array([[p[(m + 3) % len(p)] for m in range(M)]
                             for p in picks], np.int64)
    seg = S.Segments(lengths, _fold_keys(3, range(n_seg)), dev)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (total, cf, rf, counted, rarefied)) + (seg,)


def phase_compact_edges(torch, short_keys):
    """select_rows and masked_median bit for bit against their plain
    versions at edge shapes: M = 33 over 40 kb segments, M = 80, a
    segment of one position alone and in a chunk, segments of
    `short_keys` (masked_median's short-row bound) and one past; and
    masked_median over all-equal values, over rows counting 0-3 values
    among +inf, and over values on its digits' boundaries."""
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import sitestats as S
    errs = {"select_rows": 0.0, "masked_median": 0.0}
    for M, lengths in ((33, [40000] * 4), (1, [1]), (80, [300, 1, 2000]),
                       (3, [1, short_keys, short_keys + 1, 2, 40000]),
                       (2, [short_keys + 1]), (5, [short_keys])):
        full, seg = site_stats_chunk(torch, M, lengths, M + len(lengths))
        e1, e2, n_rows, n_pos = check_select_median(
            torch, full, seg, f"M={M} L={lengths}")
        errs["select_rows"] = max(errs["select_rows"], e1)
        errs["masked_median"] = max(errs["masked_median"], e2)
        log("edges", f"M={M} segments {lengths}: select_rows and "
                     f"masked_median == plain bit for bit ({n_rows} SNP "
                     f"rows, {n_pos} SNV positions)")
        del full
    for kind in ("equal", "sparse", "digits"):
        for M, lengths in ((5, [1, 2, 3, 1000, short_keys]),
                           (3, [short_keys + 1, 7]), (2, [200_000])):
            args = median_edge_inputs(torch, kind, M, lengths, M)
            got = CC.masked_median(*args)
            torch.cuda.synchronize()
            errs["masked_median"] = max(errs["masked_median"], compare_exact(
                S.masked_medians_seg(*args), got,
                f"masked_median {kind} M={M} L={lengths}"))
        log("edges", f"masked_median, {kind} values, segments of 1 to "
                     f"200,000 positions: == plain bit for bit")
    return errs


def library_select(torch, full):
    """select_rows by PyTorch's own calls, on the chunk axis (positions
    not counted per segment): torch.nonzero of row.T, the 12 record
    gathers and the linkage gathers."""
    row, cum = full["row"], full["cum"]

    def run():
        idx = torch.nonzero(row.T)
        p, m = idx[:, 0], idx[:, 1]
        rec = [p, m] + [cum[m, b, p] for b in range(4)] + [
            full[k][m, p] for k in ("total", "con", "var", "morphia",
                                    "cls")] + [full["cryptic"][p]]
        pidx = torch.nonzero(full["any_snp"]).flatten()
        return rec, cum[:, :, pidx], full["present"][:, pidx]
    return run


def library_median(torch, total, clon_f, clonR_f, seg):
    """masked_median's yardstick: one torch.sort over the rows of the three
    value sets, each row one (set, mm level, segment); the gathers of the
    order statistics are not counted. None when the segments' lengths
    differ (no one call sorts them)."""
    import numpy as np
    lengths = np.diff(seg.off)
    if (lengths != lengths[0]).any():
        return None
    M = total.shape[0]
    keys = torch.stack([total.to(torch.float32), clon_f, clonR_f]).reshape(
        3 * M * seg.S, int(lengths[0]))
    return lambda: torch.sort(keys, dim=1)


def select_rows_bound(full, rows, link):
    """select_rows' bound from the bytes it must move: row and any_snp
    read whole; the values it gathers read once (per record its four
    cumulative counts, total and four codes; cryptic once per position
    that has a record; per SNV position its [M, 4] counts and [M]
    present); every output written once. Position, mm level and the
    linkage positions come from the tile and are not read."""
    M = full["total"].shape[0]
    cum, total = full["cum"].element_size(), full["total"].element_size()
    per_record, per_snv = 4 * cum + total + 4, M * (4 * cum + 1)
    record_positions = int(full["row"].any(0).sum())
    return bound(nbytes(full["row"], full["any_snp"], rows, link) +
                 rows["n_rows"] * per_record + record_positions +
                 link["n_pos"] * per_snv)


def synthetic_shapes(torch):
    """The timing shapes kept from earlier runs: one batch chunk of 40 kb
    scaffolds at M = 8 (as many as CHUNK_CELLS holds) and one segment of
    M = 8, L = 2^20."""
    from instrain_tpu_torch.profile.compact import CHUNK_CELLS
    n = CHUNK_CELLS // (8 * 40000)
    return [(f"synthetic chunk {n} x 40 kb", *site_stats_chunk(
                torch, 8, [40000] * n, 7)),
            ("one segment 2^20", *site_stats_chunk(torch, 8, [1 << 20], 7))]


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def compact_timing(torch, card, shapes):
    """select_rows and masked_median at each (name, full, seg): the
    wrapper's time, the device time of its launches alone (cold_ms busy;
    select_rows' two launches each, its host read between them left out),
    the plain version's, the library yardstick's, every one after an L2
    flush and taken in turns (plain, library, kernel, kernel, library,
    plain), and the bound."""
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import sitestats as S
    out = {}
    for name, full, seg in shapes:
        M, L = full["total"].shape
        agg, cf, rf = CC.mm_aggregates(full, seg)
        med_args = (full["total"], cf, rf, agg["counted"], agg["rarefied"],
                    seg)
        rows, link = CC.select_rows(full, seg)
        med = CC.masked_median(*med_args)
        res = out[name] = {}
        job = CC._rows_count(full, seg)
        torch.cuda.synchronize()
        count_ms = cold_ms(torch, lambda: CC._rows_count(full, seg), 10,
                           busy=True)
        gather_ms = cold_ms(torch, lambda: CC._rows_gather(
            job, rows["n_rows"], link["n_pos"]), 10, busy=True)
        for kname, kern, plain, lib, dev, bnd in (
                ("select_rows", lambda: CC.select_rows(full, seg),
                 lambda: S.select_rows_seg(full, seg),
                 library_select(torch, full), count_ms + gather_ms,
                 select_rows_bound(full, rows, link)),
                ("masked_median", lambda: CC.masked_median(*med_args),
                 lambda: S.masked_medians_seg(*med_args),
                 library_median(torch, full["total"], cf, rf, seg),
                 cold_ms(torch, lambda: CC.masked_median(*med_args), 10,
                         busy=True),
                 bound(nbytes(med_args[:5], med)))):
            n = 10
            p1 = cold_ms(torch, plain, 2)
            l1 = cold_ms(torch, lib, n) if lib else None
            k1 = cold_ms(torch, kern, n)
            k2 = cold_ms(torch, kern, n)
            l2 = cold_ms(torch, lib, n) if lib else None
            p2 = cold_ms(torch, plain, 2)
            res[kname] = dict(
                ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                library_ms=(l1 + l2) / 2 if lib else None,
                device_ms=dev, bound_ms=bnd[0], bound_by=bnd[1])
        log("timing", f"{name} (M={M}, {seg.S} segment(s), {L} positions) "
                      f"on {card}, cold L2: " + "; ".join(
                          f"{k} wrapper {v['ms']:.4f} ms, device "
                          f"{v['device_ms']:.4f} ms, plain "
                          f"{v['plain_ms']:.4f} ms, library "
                          f"{ms_text(v['library_ms'])}, bound "
                          f"{v['bound_ms']:.4f} ms "
                          f"({v['bound_by']})" for k, v in res.items()) +
                      f" ({rows['n_rows']} SNP rows, {link['n_pos']} SNV "
                      f"positions; select_rows' device time: count and scan "
                      f"{count_ms:.4f} ms, gather {gather_ms:.4f} ms)")
        del agg, cf, rf, med_args, rows, link, med, job
    return out


def compare_nan_equal(want, got, what):
    """Bit for bit with every NaN equal to every NaN (the card and XLA
    write different NaN payloads). Returns the largest absolute float
    difference."""
    import torch
    check(set(want) == set(got), f"{what}: keys {set(want) ^ set(got)}")
    err = 0.0
    for k, a in want.items():
        b = got[k]
        a = torch.as_tensor(a).to(b.device)
        check(a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape),
              f"{what}/{k}: {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            check(torch.equal(torch.isnan(a), torch.isnan(b)),
                  f"{what}/{k}: NaN masks differ")
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
            if a.numel():
                err = max(err, float((a - b).abs().max()))
        check(torch.equal(_bits(a), _bits(b)),
              f"{what}/{k}: not bit-identical (max abs err {err})")
    return err


# the linkage kernel's synthetic shapes (E edges, M mm levels, N pairs):
# one cell; (b) and (c); (d), a 2.5 Mb isolate at depth with about 1 % SNV
# sites
LD_SHAPES = ((1, 1, 30), (5000, 12, 150_000), (64, 33, 9000),
             (50_000, 8, 4_000_000))


def ld_boundary_shapes(torch):
    """Two shapes of 8 mm levels and 80 pairs an edge on either side of
    the largest ld grid in which each block's cells make one tile of 256
    on this card: 32 edges a block, and one edge more (a block of two
    tiles)."""
    from instrain_tpu_torch.kernels import cuda_linkage as CL
    plan = CL.ld_plan(1, 8, 0, 20, *CL._occupancy(torch.device("cuda")))
    E = plan.grid * CL.LD_THREADS // 8
    return ((E, 8, 80 * E), (E + 1, 8, 80 * (E + 1)))


def ld_case(torch, E, M, N):
    """ld's arguments on the card for synth.ld_inputs(E, M, N, E + M)."""
    from instrain_tpu_torch.profile.compact import _fold_keys
    from instrain_tpu_torch.synth import ld_inputs
    args = [torch.from_numpy(a).to("cuda") for a in ld_inputs(E, M, N, E + M)]
    return (*args, _fold_keys(2, [E])[0], 20, -(-M // 8) * 8)


def ld_bound(args, out, rates):
    """ld's bound: its inputs read and outputs written once, and min_snp
    Threefry draws a cell (E * M cells)."""
    E, M, _ = args[3].shape
    return bound(nbytes(args[:7], out), E * M * args[8] * THREEFRY_OPS,
                 rates["int32"])


def phase_linkage(torch, card, rates):
    """The linkage kernel (K6) against its plain version and the JAX
    package's golden file, every column bit for bit, one launch a call;
    then at shape (d) its wrapper's (ld_packed's) and its device time, L2
    flushed, and its bound. Returns (max abs err, shape (d)'s times)."""
    import numpy as np
    from instrain_tpu_torch.kernels import cuda_linkage as CL

    dev = torch.device("cuda")
    inputs = ("e_idx", "mm_idx", "combo", "c1", "c2", "present1",
              "present2")
    golden = os.path.join(ROOT, "tests", "data", "torch_linkage_golden.npz")
    with np.load(golden) as z:
        g = {k: z[k] for k in z.files}
    err = 0.0
    for tag in sorted({k.split("/")[0] for k in g}):
        args = [torch.from_numpy(g[f"{tag}/{k}"]).to(dev) for k in inputs]
        rest = (g[f"{tag}/key"], int(g[f"{tag}/min_snp"]),
                int(g[f"{tag}/m_stride"]))
        got = CL.ld(*args, *rest)
        torch.cuda.synchronize()
        want = {k.split("/")[-1]: torch.from_numpy(v) for k, v in g.items()
                if k.startswith(f"{tag}/out/")}
        err = max(err, compare_nan_equal(want, got, f"ld golden {tag}"))
        err = max(err, compare_nan_equal(CL.ld_plain(*args, *rest), got,
                                         f"ld plain {tag}"))
        log("linkage", f"golden {tag}: all {len(want)} columns equal the JAX "
                       f"package and the plain version bit for bit "
                       f"({int(got['valid'].sum())} valid cells)")
    at_d = None
    for E, M, N in LD_SHAPES + ld_boundary_shapes(torch):
        args = ld_case(torch, E, M, N)
        plan = CL.ld_plan(E, M, args[0].numel(), args[8], *CL._occupancy(dev))
        CL.reset_launch_counts()
        got = CL.ld(*args)
        torch.cuda.synchronize()
        check(CL.launch_counts() == {"ld": 1},
              f"ld E={E} M={M}: {CL.launch_counts()} launches, not 1")
        err = max(err, compare_nan_equal(CL.ld_plain(*args), got,
                                         f"ld E={E} M={M} N={N}"))
        log("linkage", f"E={E} M={M} N={N} ({plan.grid} blocks of "
                       f"{plan.edges_per_block} edges): ld == plain bit for bit "
                       f"({int(got['valid'].sum())} valid cells)")
        if (E, M, N) == LD_SHAPES[3]:
            bnd = ld_bound(args, got, rates)
            at_d = {"E": E, "M": M, "N": N,
                    "ms": cold_ms(torch, lambda: CL.ld_packed(*args), 20),
                    "device_ms": cold_ms(torch, lambda: CL.ld_packed(*args),
                                         20, busy=True),
                    "bound_ms": bnd[0], "bound_by": bnd[1]}
            log("linkage", f"time at E={E} M={M} N={N} on {card}, cold "
                           f"L2: device {at_d['device_ms']:.4f} ms, ld_packed "
                           f"{at_d['ms']:.4f} ms; bound "
                           f"{at_d['bound_ms']:.4f} ms ({at_d['bound_by']})")
        del args, got
    return err, at_d


# ---------------------------------------------------------------- phase 4


def read_table(out, name):
    import pandas as pd
    path = os.path.join(out, "output", f"{os.path.basename(out)}_{name}.tsv")
    check(os.path.exists(path), f"{path} was not written")
    return pd.read_csv(path, sep="\t", header=1 if name == "mapping_info"
                       else 0)


def run_profile(bam, fasta, out, engine, device="cuda", genes=None,
                plots=False):
    from instrain_tpu_torch.cli import main
    from instrain_tpu_torch.profile import pipeline
    pipeline.PHASES = {}
    flags = FLAGS if not plots else [f for f in FLAGS
                                     if f != "--skip_plot_generation"]
    t0 = time.perf_counter()
    rc = main(["profile", bam, fasta, "-o", out, "--device", device,
               "--engine", engine] + flags + (["-g", genes] if genes else []))
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
    """Counts what the engines bring back to the host: for the hybrid and
    batch engines, per chunk the 8-byte read of the row and position
    counts and the one packed copy of its outputs (a hybrid scaffold is a
    chunk of one); for the dense engine, the host arrays its stats hold
    (every one came over from the device)."""

    def __init__(self):
        from instrain_tpu_torch.profile import compact, pipeline
        self.mods = (compact, pipeline)
        self.bytes = []

    def __enter__(self):
        compact, pipeline = self.mods
        self.saved = (compact._finish_chunk, pipeline.run_site_stats)

        def finish(chunk):
            self.bytes.append(8 + chunk.host.numel())
            return self.saved[0](chunk)

        def dense(*a, **k):
            st = self.saved[1](*a, **k)
            self.bytes.append(sum(v.nbytes for v in st.arrays.values()))
            return st

        compact._finish_chunk, pipeline.run_site_stats = finish, dense
        return self

    def __exit__(self, *exc):
        compact, pipeline = self.mods
        compact._finish_chunk, pipeline.run_site_stats = self.saved
        return False


class LinkageCopies:
    """Traces each call of the device linkage engine under torch.profiler
    (device_copies): the calls and, for each, its host-to-device and
    device-to-host copies as the card ran them (None where the profiler
    recorded no device activity), and the seconds the profiler added to
    the run around the calls."""

    def __init__(self, torch):
        from instrain_tpu_torch.profile import linkage
        self.mod, self.torch = linkage, torch
        self.copies = []
        self.overhead_s = 0.0

    def __enter__(self):
        self.saved = self.mod._calculate_linkage_device

        def call(*a):
            out = []

            def run():
                t = time.perf_counter()
                out.append(self.saved(*a))
                out.append(time.perf_counter() - t)

            t0 = time.perf_counter()
            got = device_copies(self.torch, run)
            self.overhead_s += time.perf_counter() - t0 - out[1]
            self.copies.append(got and (got["HtoD"][0], got["DtoH"][0]))
            return out[0]

        self.mod._calculate_linkage_device = call
        return self

    def __exit__(self, *exc):
        self.mod._calculate_linkage_device = self.saved
        return False


TABLES = ("SNVs", "scaffold_info", "linkage", "mapping_info")
GENE_TABLES = TABLES + ("gene_info",)


def compare_tables(a_dir, b_dir, skip=(), tables=TABLES):
    """The reference's cross-engine tolerances (tests/test_compact.py:
    45-49): strings and integers exact, nucl_diversity* within 1e-6, other
    floats within 1e-9. Returns the largest absolute difference of each
    column in `skip`, which is not held to them."""
    import numpy as np
    diffs = {}
    for t in tables:
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
                # strings and integers; the gene columns of SNVs are empty
                # (NaN) outside genes
                check(a[col].equals(b[col]), f"{t}/{col}: engines differ")
    return diffs


def tsvs(out, tables=TABLES):
    texts = {}
    for t in tables:
        with open(os.path.join(out, "output",
                               f"{os.path.basename(out)}_{t}.tsv")) as f:
            texts[t] = f.read()
    return texts


def outputs(out):
    """{file name: text} of every file under <out>/output."""
    loc = os.path.join(out, "output")
    texts = {}
    for name in sorted(os.listdir(loc)):
        with open(os.path.join(loc, name)) as f:
            texts[name] = f.read()
    return texts


class FailureLog:
    """Collects the lines holding `needle` logged while it is entered (by
    default FAILURE: a scaffold's or a gene's failure), whatever file the
    run logs to. FAILURE lines are DEBUG records: profile lets them
    through the root logger while it runs, and the CLI's logger setup
    (basicConfig at DEBUG, at the smoke's first call) for the other
    subcommands."""

    def __init__(self, needle="FAILURE"):
        import logging
        self.lines = []
        self.handler = logging.Handler(logging.DEBUG)
        self.handler.emit = lambda r: (
            self.lines.append(r.getMessage())
            if needle in r.getMessage() else None)

    def __enter__(self):
        import logging
        logging.getLogger("").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging
        logging.getLogger("").removeHandler(self.handler)
        return False


def have_matplotlib():
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def check_profile_plots(out, phases):
    """The nine figures of a profile run with -g, each over 1,000 bytes,
    where matplotlib imports; where it does not, the run's log holds
    `Plotting failed`. Returns what to print."""
    if not have_matplotlib():
        with open(os.path.join(out, "log", "log.log")) as f:
            check("Plotting failed" in f.read(),
                  f"{out}: matplotlib is missing and the log holds no "
                  f"'Plotting failed'")
        return "plots: not drawn (no matplotlib); 'Plotting failed' logged"
    figs = os.path.join(out, "figures")
    sizes = {f: os.path.getsize(os.path.join(figs, f))
             for f in os.listdir(figs)}
    check(len(sizes) == 9 and min(sizes.values()) > 1000,
          f"{out}: figures {sizes}, expected nine over 1,000 bytes")
    return (f"plots: {len(sizes)} figures, {min(sizes.values())}-"
            f"{max(sizes.values())} bytes, plots phase "
            f"{phases.get('plots', 0.0):.3f} s")


def check_gene_info(out, genes_file):
    """gene_info has a row for every gene of the profiled scaffolds (all
    covered at these depths) with finite coverage and breadth; returns
    the SNVs' mutation-type counts."""
    import numpy as np
    from instrain_tpu_torch.profile.genes import parse_genes
    from instrain_tpu_torch.store.profile_dir import ProfileDir
    profiled = set(ProfileDir(out).get("scaffold_list"))
    want = sorted(g for s, df in parse_genes(genes_file).scaff2genes.items()
                  if s in profiled for g in df["gene"])
    info = read_table(out, "gene_info")
    check(sorted(info["gene"]) == want,
          f"{out}: {len(info)} gene_info rows for {len(want)} genes of "
          f"the profiled scaffolds")
    for col in ("coverage", "breadth"):
        check(np.isfinite(info[col]).all() and (info[col] > 0).all(),
              f"{out}: gene_info {col} not finite and positive")
    snv = read_table(out, "SNVs")
    return snv["mutation_type"].value_counts().to_dict()


def device_copies(torch, fn, trace=None):
    """Run fn under torch.profiler: {"DtoH"|"HtoD": (copies, ms),
    "kernels": (launches, ms)} of device time, or None when the profiler
    records no device activity. With `trace`, the chrome trace is written
    there too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    out = {"DtoH": [0, 0.0], "HtoD": [0, 0.0], "kernels": [0, 0.0]}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        key = ("DtoH" if "DtoH" in e.key else "HtoD" if "HtoD" in e.key
               else None if "Memcpy" in e.key or "Memset" in e.key
               else "kernels")
        if key:
            out[key][0] += e.count
            out[key][1] += us / 1000.0
    return out if out["kernels"][0] else None


def chunk_copies(trace):
    """The device work of a traced run, per stream in time order, cut into
    groups that each start at a host-to-device copy after other work: a
    chunk of the batch engine is its H2D copies and then its kernels on
    one stream. [(H2D bytes, H2D ms, kernels, kernel ms, D2H ms)]."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    streams = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            streams.setdefault(e.get("args", {}).get("stream"), []).append(e)
    groups = []
    for evs in streams.values():
        cur = None
        for e in sorted(evs, key=lambda e: e["ts"]):
            h2d = e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
            if h2d and (cur is None or cur[2] or cur[4]):
                cur = [0, 0.0, 0, 0.0, 0.0]
                groups.append(cur)
            if cur is None:
                continue
            ms = e.get("dur", 0.0) / 1e3
            if h2d:
                cur[0] += int(e.get("args", {}).get("bytes", 0))
                cur[1] += ms
            elif e["cat"] == "gpu_memcpy":
                cur[4] += ms
            else:
                cur[2] += 1
                cur[3] += ms
    return [tuple(g) for g in groups]


def phase_end_to_end(torch):
    from instrain_tpu_torch.cli import main
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import cuda_linkage as CL
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.profile import compact as PC
    from instrain_tpu_torch.profile import linkage as PL
    from instrain_tpu_torch.store.profile_dir import ProfileDir
    from instrain_tpu_torch.synth import synth, synth_genes

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    # a small input with genes (-g, synth_genes' prodigal file), each
    # engine on the card against the CPU, byte for byte, and
    # parse_annotations over both profiles
    small = os.path.join(WORK, "small")
    os.makedirs(small)
    fasta, bam, _ = synth(small, S=4, L=5000, COV=60, seed=3)
    small_input = (fasta, bam)
    small_genes, _ = synth_genes(fasta, seed=0)
    anno = os.path.join(small, "anno.csv")
    for engine in ("dense", "hybrid", "batch"):
        outs = {}
        with FailureLog() as failed:
            for device in ("cuda", "cpu"):
                outs[device] = os.path.join(small, f"{engine}_{device}.IS")
                check(main(["profile", bam, fasta, "-o", outs[device],
                            "--device", device, "--engine", engine,
                            "-g", small_genes] + FLAGS) == 0,
                      f"small {engine} {device} run failed")
        check(not failed.lines, f"small input: failures logged: "
                                f"{failed.lines[:3]}")
        check(tsvs(outs["cuda"], GENE_TABLES) ==
              tsvs(outs["cpu"], GENE_TABLES),
              f"small input, --engine {engine}: TSVs differ GPU vs CPU")
        types = check_gene_info(outs["cuda"], small_genes)
        if not os.path.exists(anno):
            genes = read_table(outs["cuda"], "gene_info")["gene"]
            with open(anno, "w") as f:
                f.write("gene,anno\n" + "".join(
                    f"{g},K{i % 5:05d}\n" for i, g in enumerate(genes[::2])))
        annotated = {}
        for device, out in outs.items():
            annotated[device] = os.path.join(small, f"pa_{engine}_{device}")
            check(main(["parse_annotations", "-i", out, "-a", anno, "-o",
                        annotated[device], "-b", "0"]) == 0,
                  f"small {engine} {device}: parse_annotations failed")
        pa = outputs(annotated["cuda"])
        check(pa == outputs(annotated["cpu"]) and
              "SampleAnnotationTotals.csv" in pa,
              f"small input, --engine {engine}: parse_annotations outputs "
              f"differ GPU vs CPU")
        log("e2e", f"small input (4 x 5 kb, 60x) with -g, --engine "
                   f"{engine}: GPU TSVs (gene_info too) byte-identical to "
                   f"the --device cpu run; SNV mutation types {types}; "
                   f"parse_annotations' {len(pa)} files byte-identical")

    cases = MAIN_CASES
    data = {}
    for name, S, L, cov in cases:
        d = os.path.join(WORK, name)
        os.makedirs(d)
        t0 = time.perf_counter()
        data[name] = synth(d, S=S, L=L, COV=cov, seed=7)
        log("e2e", f"synth {name} ({S} x {L} bp, {cov}x, "
                   f"{data[name][2]} pairs): "
                   f"{time.perf_counter() - t0:.2f} s")

    timings = {}

    def run(name, engine, device="cuda", genes=None, plots=False):
        S, L, cov = next(c[1:] for c in cases if c[0] == name)
        fasta, bam, n_pairs = data[name]
        out = os.path.join(WORK, name, f"{name}_{engine}_{device}"
                                       f"{'_g' if genes else ''}.IS")
        with D2HBytes() as d2h:
            wall, phases = run_profile(bam, fasta, out, engine, device,
                                       genes, plots)
        timings[out] = (wall, phases)
        rows, snvs = check_outputs(out, S, cov)
        mi = read_table(out, "mapping_info")
        filtered = int(mi["filtered_pairs"].iloc[0])
        check(filtered > 0.9 * n_pairs, f"{name}: {filtered} of "
                                        f"{n_pairs} pairs pass filtering")
        log("e2e", f"{name} --engine {engine} --device {device}"
                   f"{' -g' if genes else ''}: wall {wall:.2f} s, {filtered} "
                   f"filtered pairs -> {filtered / wall:.0f} filtered "
                   f"pairs/s; rows {rows}; {snvs} SNV sites")
        log("e2e", f"{name} --engine {engine} phases (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))
        if d2h.bytes:
            log("e2e", f"{name} --engine {engine} D2H: {sum(d2h.bytes)} "
                       f"bytes over {len(d2h.bytes)} engine calls, "
                       f"{sum(d2h.bytes) / len(d2h.bytes):.0f} per call")
        return out

    # the main paths, each through --engine auto with every launch count
    # reset just before it and read just after: the metagenome (the batch
    # engine), the isolate (hybrid) and the deep input (hybrid, its
    # linkage past the device engine's bound)
    linkage_choice = []
    resolve = PL.resolve_linkage_engine

    def record(engine, device, n_pairs):
        choice = resolve(engine, device, n_pairs)
        linkage_choice.append((n_pairs, choice))
        return choice

    ld_args = []
    device_ld_args = PL._device_ld_args

    def keep_ld_args(*a):
        ld_args.append(device_ld_args(*a))
        return ld_args[-1]

    five = ("site_stats", "clonR", "select_rows", "mm_aggregates",
            "masked_median")
    outs, launches = {}, dict.fromkeys(five + ("ld",), 0)
    case_launches = {}
    PL.resolve_linkage_engine = record
    PL._device_ld_args = keep_ld_args
    capture = CompactCapture()
    try:
        for name, S, _, _ in cases:
            capture.run = name
            linkage_choice.clear()
            C.reset_launch_counts()
            CC.reset_launch_counts()
            CL.reset_launch_counts()
            with capture, LinkageCopies(torch) as copies:
                outs[name] = run(name, "auto")
            got = {**C.launch_counts(), **CC.launch_counts(),
                   **CL.launch_counts()}
            case_launches[name] = got
            if name == "metagenome":
                # the batch engine's planned chunks, from the profiled
                # scaffolds (in run order) and their mm levels
                pdir = ProfileDir(outs[name])
                cov_t = pdir.get("covT")
                shapes = [(len(cov_t[n]), 40_000)
                          for n in pdir.get("scaffold_list")]
                check(len(shapes) == S,
                      f"{len(shapes)} metagenome scaffolds profiled")
                want = len(PC.plan_chunks(shapes))
                check(want < S, f"{want} chunks for {S} scaffolds")
                plan = (f"{want} planned chunks (mm levels "
                        f"{sorted(set(m for m, _ in shapes))})")
            else:
                want, plan = 1, "one scaffold"
            past = [n for n, choice in linkage_choice if choice == "device"]
            log("e2e", f"{name} launches: {got}; {S} scaffold(s) in {plan}; "
                       f"captured pairs per scaffold up to "
                       f"{max(n for n, _ in linkage_choice)}, "
                       f"{len(past)} past the {PL.DEVICE_MIN_PAIRS} bound "
                       f"of the device linkage engine")
            for k in five:
                check(got[k] == want, f"{name}: kernel {k} launched "
                                      f"{got[k]} times, planned {want}")
            check(got["ld"] == len(past),
                  f"{name}: ld launched {got['ld']} times for {len(past)} "
                  f"scaffolds past the bound")
            check(len(copies.copies) == len(past) and
                  all(c == (1, 1) for c in copies.copies),
                  f"{name}: {len(copies.copies)} device linkage calls made "
                  f"(H2D, D2H) copies {copies.copies} on the card (None: "
                  f"none traced), expected one each per call")
            if past:
                log("e2e", f"{name}: {len(copies.copies)} device linkage "
                           f"call(s), (H2D, D2H) copies traced on the card "
                           f"by torch.profiler: {copies.copies}; the "
                           f"profiler added {copies.overhead_s:.3f} s to "
                           f"the run's tables phase and wall")
            launches = {k: launches[k] + got[k] for k in launches}
    finally:
        PL.resolve_linkage_engine = resolve
        PL._device_ld_args = device_ld_args
    torch.cuda.synchronize()
    captured = capture.inputs
    check(sorted(captured) == sorted(c[0] for c in cases),
          f"compact_from_full's inputs captured for {sorted(captured)}")
    check(linkage_choice and linkage_choice[-1][1] == "device",
          f"the deep input's linkage ran on the host engine "
          f"({linkage_choice[-1:]})")
    log("e2e", f"launches in the main paths, summed: {launches}")

    # the metagenome through --engine auto (batch) with -g and the plots:
    # the genes of a chunk are profiled on the host while the next chunk
    # runs, and the figures are drawn from the stored profile, so every
    # kernel launches as often as without either
    meta_genes, meta_gb = synth_genes(data["metagenome"][0], seed=0)
    C.reset_launch_counts()
    CC.reset_launch_counts()
    CL.reset_launch_counts()
    with_genes = run("metagenome", "auto", genes=meta_genes, plots=True)
    got = {**C.launch_counts(), **CC.launch_counts(), **CL.launch_counts()}
    check(got == case_launches["metagenome"],
          f"metagenome -g with plots: launches {got}, without either "
          f"{case_launches['metagenome']}")
    types = check_gene_info(with_genes, meta_genes)
    wall0 = timings[outs["metagenome"]][0]
    wall1, phases1 = timings[with_genes]
    n_genes = len(read_table(with_genes, "gene_info"))
    card = nvidia_smi_line()
    log("e2e", f"metagenome --engine auto -g with plots on {card}: wall "
               f"{wall1:.3f} s against {wall0:.3f} s without -g and plots "
               f"({wall1 - wall0:+.3f} s); genes phase (the gene file's "
               f"parse and the gene calls) {phases1.get('genes', 0.0):.3f} s "
               f"for {n_genes} genes; launches {got}, as without either; "
               f"SNV mutation types {types}")
    log("e2e", f"metagenome --engine auto -g on {card}: "
               f"{check_profile_plots(with_genes, phases1)}")

    # the metagenome through the hybrid engine with -g: the same bytes
    hybrid = run("metagenome", "hybrid", genes=meta_genes)
    check(tsvs(hybrid, GENE_TABLES) == tsvs(with_genes, GENE_TABLES),
          "metagenome -g: --engine hybrid TSVs differ from --engine batch")
    log("e2e", "metagenome -g: --engine hybrid TSVs (gene_info too) "
               "byte-identical to the batch engine's")
    # device copies and busy time of both engines on the metagenome, and
    # of the batch engine with -g: the same copies as without
    traced = {}
    for engine, genes in (("batch", None), ("batch", meta_genes),
                          ("hybrid", None)):
        fasta, bam, _ = data["metagenome"]
        tag = f"{engine}{' -g' if genes else ''}"
        prof_out = os.path.join(WORK, "metagenome",
                                f"prof_{engine}{'_g' if genes else ''}.IS")
        trace = os.path.join(WORK, f"trace_{engine}.json")
        t0 = time.perf_counter()
        # the run with -g draws the plots too
        got = device_copies(torch, lambda: run_profile(
            bam, fasta, prof_out, engine, "cuda", genes, genes is not None),
            trace if tag == "batch" else None)
        wall = time.perf_counter() - t0
        traced[tag] = got
        if got is None:
            log("e2e", f"metagenome --engine {tag} under torch.profiler: "
                       f"no device activity recorded (not measured)")
            continue
        log("e2e", f"metagenome --engine {tag} under torch.profiler "
                   f"(wall {wall:.2f} s): D2H {got['DtoH'][0]} copies "
                   f"{got['DtoH'][1]:.3f} ms, H2D {got['HtoD'][0]} copies "
                   f"{got['HtoD'][1]:.3f} ms, kernels {got['kernels'][0]} "
                   f"launches {got['kernels'][1]:.3f} ms; device busy "
                   f"{got['DtoH'][1] + got['HtoD'][1] + got['kernels'][1]:.3f}"
                   f" ms")
        if tag == "batch":
            # the measurement that decides whether the sparse count wire
            # (K8) is worth porting: H2D against kernel time per chunk
            for i, (b, h_ms, n_k, k_ms, d_ms) in enumerate(
                    chunk_copies(trace)):
                log("e2e", f"metagenome --engine batch, stream group {i}: "
                           f"H2D {b} bytes in {h_ms:.4f} ms "
                           f"({b / max(h_ms, 1e-9) / 1e6:.1f} GB/s), "
                           f"{n_k} kernels {k_ms:.4f} ms, D2H {d_ms:.4f} "
                           f"ms")

    if traced["batch"] and traced["batch -g"]:
        copies = {k: [traced[t][k][0] for t in ("batch", "batch -g")]
                  for k in ("HtoD", "DtoH")}
        check(all(a == b for a, b in copies.values()),
              f"metagenome --engine batch: device copies (without -g and "
              f"plots, with both) {copies}")
        log("e2e", f"metagenome --engine batch: the same device copies "
                   f"with -g and plots as without under torch.profiler "
                   f"{copies}")

    # the deep input on the CPU with the device linkage engine forced
    PL.resolve_linkage_engine = lambda engine, device, n_pairs: "device"
    try:
        cpu = run("deep", "hybrid", "cpu")
    finally:
        PL.resolve_linkage_engine = resolve
    check(tsvs(cpu) == tsvs(outs["deep"]),
          "deep input: the --device cpu run (device linkage forced) "
          "differs from the GPU run")
    n_link = len(read_table(outs["deep"], "linkage"))
    log("e2e", f"deep input: --device cpu with the device linkage engine "
               f"forced: TSVs byte-identical to the GPU run ({n_link} "
               f"linkage rows)")

    # the dense engine with its 1 Mb position chunks, every launch count
    # reset just before each run and read just after: the metagenome (a
    # chunk per scaffold) against the batch engine, and the isolate (three
    # chunks) against the hybrid engine
    dense = {}
    for name, S, L, _ in cases[:2]:
        C.reset_launch_counts()
        CC.reset_launch_counts()
        CL.reset_launch_counts()
        dense[name] = run(name, "dense", genes=(
            meta_genes if name == "metagenome" else None))
        got = {**C.launch_counts(), **CC.launch_counts(),
               **CL.launch_counts()}
        chunks = S * -(-L // (1 << 20))
        log("e2e", f"{name} --engine dense launches: {got} ({chunks} "
                   f"scaffold chunks)")
        for k, n in got.items():
            want = chunks if k in ("site_stats", "clonR") else 0
            check(n == want, f"{name} --engine dense: kernel {k} launched "
                             f"{n} times, expected {want}")
    compare_tables(with_genes, dense["metagenome"], tables=GENE_TABLES)
    rare = ("nucl_diversity_rarefied", "nucl_diversity_rarefied_median")
    diffs = compare_tables(outs["isolate"], dense["isolate"], skip=rare)
    log("e2e", "metagenome -g: dense and batch tables (gene_info too) "
               "agree within the "
               "reference's cross-engine tolerances; isolate: dense and "
               "hybrid the same, except the rarefied columns, drawn per 1 Mb "
               "chunk by the dense engine and once per scaffold by the "
               "hybrid engine (max abs difference " + ", ".join(
                   f"{k} {v:.3g}" for k, v in diffs.items()) + ")")

    # profile_genes with the GenBank file over the card's profile of the
    # metagenome, whose covT is stored as a pickle where h5py is missing
    covt = ProfileDir(outs["metagenome"])._get_attributes().loc[
        "covT", "value"]
    t0 = time.perf_counter()
    with FailureLog() as failed:
        check(main(["profile_genes", "-i", outs["metagenome"], "-g",
                    meta_gb]) == 0, "profile_genes failed")
    pg_s = time.perf_counter() - t0
    check(not failed.lines, f"profile_genes: failures logged: "
                            f"{failed.lines[:3]}")
    types = check_gene_info(outs["metagenome"], meta_gb)
    log("e2e", f"profile_genes -g {os.path.basename(meta_gb)} over the "
               f"metagenome's profile (covT stored as "
               f"{os.path.splitext(covt)[1]}): {pg_s:.3f} s, gene_info for "
               f"every gene; SNV mutation types {types}")
    paths = {"metagenome": data["metagenome"][:2],
             "metagenome_profile": outs["metagenome"],
             "small": small_input, "small_profile": os.path.join(
                 small, "hybrid_cuda.IS")}
    return launches, ld_args[-1], captured, paths


# ---------------------------------------------------------------- host


def phase_check_deps(torch):
    """check_deps after the build: it names the card and the CUDA build,
    and finds every library built for this checkout's sources."""
    import contextlib
    import io
    from instrain_tpu_torch.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(main(["check_deps"]) == 0, "check_deps failed")
    report = buf.getvalue()
    for line in report.splitlines():
        log("deps", line)
    check(f"CUDA device 0: {torch.cuda.get_device_name(0)}" in report and
          f"CUDA build {torch.version.cuda}" in report,
          "check_deps does not name the card and the CUDA build")
    for name in ("CUDA kernels (instrain_kernels)",
                 "native decoder (instrain_io)"):
        check(f"{name}: built for the current sources" in report,
              f"check_deps: {name} is not reported built")


def phase_host_commands(torch, paths):
    """The host-only subcommands over the metagenome (quick_profile,
    filter_reads, other --run_statistics), and rarefaction_curve on the
    card over the small input (its site_stats launches counted, its 1.0
    row against the small input's profile on the card)."""
    import contextlib
    import io
    import pandas as pd
    from instrain_tpu_torch.auxiliary_scripts import rarefaction_curve
    from instrain_tpu_torch.cli import main
    from instrain_tpu_torch.kernels import cuda_compact as CC
    from instrain_tpu_torch.kernels import cuda_linkage as CL
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.store import generate as gen
    from instrain_tpu_torch.store.profile_dir import ProfileDir

    card = nvidia_smi_line()
    fasta, bam = paths["metagenome"]
    prof = paths["metagenome_profile"]
    qp = os.path.join(WORK, "quick_profile")
    t0 = time.perf_counter()
    check(main(["quick_profile", bam, fasta, "-o", qp]) == 0,
          "quick_profile failed")
    qp_s = time.perf_counter() - t0
    cov = pd.read_csv(os.path.join(qp, "coverm_raw.tsv"), sep="\t")
    genome = pd.read_csv(os.path.join(qp, "genomeCoverage.csv"))
    check(len(cov) == 128 and (cov["Read Count"] > 0).all(),
          f"quick_profile: {len(cov)} covered scaffolds, expected 128")
    log("host", f"quick_profile over the metagenome on {card}'s host: "
                f"{qp_s:.3f} s; {len(cov)} rows in coverm_raw.tsv, genome "
                f"coverage {genome['coverage'].iloc[0]:.3f}, breadth "
                f"{genome['breadth'].iloc[0]:.4f}")

    fr = os.path.join(WORK, "filter_reads")
    t0 = time.perf_counter()
    check(main(["filter_reads", bam, fasta, "-o", fr]) == 0,
          "filter_reads failed")
    fr_s = time.perf_counter() - t0
    got = pd.read_csv(os.path.join(fr, "mapping_info.csv"), sep="\t",
                      header=1)
    want = read_table(prof, "mapping_info")
    got = got[list(want.columns)].sort_values("scaffold")
    want = want.sort_values("scaffold")
    check(len(want) == 129 and
          got.reset_index(drop=True).equals(want.reset_index(drop=True)),
          f"filter_reads: mapping_info.csv ({len(got)} rows) differs from "
          f"the metagenome profile's ({len(want)} rows)")
    log("host", f"filter_reads over the metagenome: {fr_s:.3f} s; "
                f"mapping_info.csv holds the profile's {len(want)} rows")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(main(["other", "--run_statistics", prof]) == 0,
              "other --run_statistics failed")
    report = buf.getvalue()
    check("Run report" in report and "main_profile" in report,
          "other --run_statistics printed no report of main_profile")
    log("host", f"other --run_statistics over the metagenome's log: "
                f"{len(report.splitlines())} lines, sections " + ", ".join(
                    l.strip(".: ") for l in report.splitlines()
                    if l.startswith(".:: ")))

    # rarefaction_curve through the kernels on the card
    small_fasta, small_bam = paths["small"]
    out = os.path.join(WORK, "rarefaction")
    for mod in (C, CC, CL):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        check(rarefaction_curve.main([small_bam, small_fasta, "-o", out,
                                      "-s", "0.5", "1.0"]) == 0,
              "rarefaction_curve failed")
    torch.cuda.synchronize()
    rc_s = time.perf_counter() - t0
    got = {**C.launch_counts(), **CC.launch_counts(), **CL.launch_counts()}
    check(got["site_stats"] >= 2, f"rarefaction_curve: launches {got}, "
                                  f"expected site_stats at each fraction")
    rows = pd.read_csv(os.path.join(out, "rarefaction_curve.tsv"), sep="\t")
    db = gen.nonredundant_scaffold_table(ProfileDir(paths["small_profile"]))
    want = [1.0, float(db["coverage"].mean()), float(db["breadth"].mean()),
            int(db["divergent_site_count"].sum())]
    last = rows.iloc[-1].tolist()
    # the means within the rounding of a sum in another row order
    check(list(rows["fraction"]) == [0.5, 1.0] and last[3] == want[3] and
          all(abs(a - b) <= 1e-12 * abs(b) for a, b in zip(last[1:3],
                                                          want[1:3])),
          f"rarefaction_curve: rows {rows.values.tolist()}, the 1.0 row "
          f"against the small input's profile {want}")
    log("host", f"rarefaction_curve --device cuda -s 0.5 1.0 over the small "
                f"input on {card}: {rc_s:.3f} s, launches {got}; the 1.0 "
                f"row equals the small input's profile: {want}")


# ---------------------------------------------------------------- compare


def random_words(rng, N, Mg, L):
    """Packed masks uint64 [N, Mg, ceil(L / 64)] of random bits at a
    density of 1/4, 1/2 or 3/4 per sample, zero past L."""
    import numpy as np
    W = -(-L // 64)
    words = rng.integers(0, 2 ** 64, (N, Mg, W), dtype=np.uint64)
    for n in range(N):
        other = rng.integers(0, 2 ** 64, (Mg, W), dtype=np.uint64)
        if n % 3 == 0:
            words[n] &= other
        elif n % 3 == 2:
            words[n] |= other
    if L % 64:
        words[:, :, -1] &= np.uint64((1 << (L % 64)) - 1)
    return words


def group_words(rng, shapes):
    """Packed masks of a group of scaffolds of (N, Mg, L)."""
    return [random_words(rng, *d) for d in shapes]


def group_on_card(torch, words):
    """(plan, host buffer, device buffer) of a group of packed masks."""
    from instrain_tpu_torch.kernels import compare as K
    from instrain_tpu_torch.kernels.cuda_compact import _sms
    dev = torch.device("cuda")
    plan = K.group_plan([w.shape for w in words], _sms(dev))
    buf = torch.from_numpy(K.group_buffer(words, plan))
    return plan, buf, buf.to(dev)


# K7's exactness shapes: groups of (samples, mm levels, positions)
K7_GROUPS = [
    [(2, 1, 1)], [(3, 2, 4099)], [(8, 5, 40_000)], [(16, 4, 1 << 23)],
    [(64, 3, 100_000)],
    [(1, 1, 1), (2, 5, 63), (8, 3, 64), (17, 1, 4099), (64, 2, 40_000),
     (8, 4, 1), (17, 5, 63), (2, 2, 40_000), (1, 3, 4099), (64, 1, 64)],
    [(2, 1, 63), (8, 5, 4099), (16, 4, 1 << 23), (17, 2, 1), (64, 3, 64),
     (1, 5, 40_000)],
]
STUDY_GROUP = [(8, 5, 40_000)] * 128     # the study's one group


def overlap_bound(words, plan):
    """K7's bound: the group's words read once and its counts written
    once. Its operations run on the tensor cores' binary product, whose
    rate no data sheet in use here gives; k7_peak.cu measures it far above
    what the bytes feed it."""
    return bound(sum(w.nbytes for w in words) + 8 * plan.n_out)


def phase_compare_kernel(torch, card):
    """The group overlap kernel (K7) against its plain version and the host
    popcount, exact, one launch per group: single scaffolds up to
    (16, 4, 2^23) and (64, 3, 100,000), groups of mixed N (1-64), Mg (1-5)
    and L (1, 63, 64, 4099, 40,000, one of 2^23 among short ones), and the
    study's group of 128 x (8, 5, 40 kb); then timed in turns with the
    plain version and the bf16 product of the unpacked bits (the JAX
    package's method, the yardstick) at the study's group and at
    (16, 4, 2^23) and (64, 3, 100,000)."""
    import numpy as np
    from instrain_tpu_torch.kernels import compare as K
    from instrain_tpu_torch.kernels import cuda_compare as CC

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    times = {}
    for shapes in K7_GROUPS + [STUDY_GROUP]:
        words = group_words(rng, shapes)
        plan, buf, dbuf = group_on_card(torch, words)
        CC.reset_launch_counts()
        got = CC.overlap_counts_group(dbuf, plan)
        check(CC.launch_counts()["overlap_counts"] == 1,
              "overlap_counts_group: not one launch")
        plain = K.overlap_counts_group_plain(dbuf, plan)
        torch.cuda.synchronize()
        what = (f"overlap_counts, group of {len(shapes)} (N, Mg, L) "
                f"{shapes[:6]}{' ...' if len(shapes) > 6 else ''}")
        check(torch.equal(got, plain), f"{what}: differs from the plain "
                                       f"group version")
        counts = K.split_counts(got.cpu().numpy(), plan)
        for w, (b, sg) in zip(words, counts):
            hb, hs = K.pairwise_overlap_counts_host(w)
            check(np.array_equal(b, hb) and np.array_equal(sg, hs),
                  f"{what}: differs from the host popcount")
        log("compare", f"{what}: one launch of {plan.n_blocks} blocks == "
                       f"plain group version and == host popcount per "
                       f"scaffold, exact (diagonal sum "
                       f"{int(sum(sg.sum() for _, sg in counts))})")
        if shapes not in ([(16, 4, 1 << 23)], [(64, 3, 100_000)],
                          STUDY_GROUP):
            continue
        # the yardstick: bits unpacked to bf16 [sum Mg, N, L] once,
        # outside the timing, then one batched product with f32 results
        # (the scaffolds of a timed group share N and L: no padding)
        N, _, L = shapes[0]
        bits = torch.from_numpy(np.concatenate(
            [K.unpack_words(w, L) for w in words], axis=1)).to(dev)
        x = bits.to(torch.bfloat16).permute(1, 0, 2).contiguous()
        del bits
        xt = x.transpose(1, 2)

        def library():
            return torch.bmm(x, xt, out_dtype=torch.float32)

        lib_out = library()
        want_both = torch.cat([torch.as_tensor(b).reshape(-1, N, N)
                               for b, _ in counts]).to(dev)
        check(torch.equal(lib_out.to(torch.int64), want_both),
              f"bf16 product of {what} is not exact")
        k_ms, p_ms = timed_pair(torch, lambda: CC.overlap_counts_group(
            dbuf, plan), lambda: K.overlap_counts_group_plain(dbuf, plan),
            20, 1 if len(shapes) > 1 else 3)
        l1 = cuda_ms(torch, library, 10)
        dev_ms = cold_ms(torch, lambda: CC.overlap_counts_group(dbuf, plan),
                         20, busy=True)
        l2 = cuda_ms(torch, library, 10)
        b_ms, b_by = overlap_bound(words, plan)
        key = "study" if shapes is STUDY_GROUP else shapes[0]
        times[key] = dict(ms=k_ms, plain_ms=p_ms, device_ms=dev_ms,
                          library_ms=(l1 + l2) / 2, bound_ms=b_ms,
                          bound_by=b_by)
        log("compare", f"time, group of {len(shapes)} x {shapes[0]} on "
                       f"{card}: kernel {k_ms:.4f} ms warm, {dev_ms:.4f} ms "
                       f"device after an L2 flush; plain {p_ms:.4f} ms, "
                       f"bf16 bmm (unpacked, f32 out) {(l1 + l2) / 2:.4f} "
                       f"ms; bound {b_ms:.4f} ms ({b_by})")
        del x, xt, lib_out
    return times


def phase_compare_crossover(torch, card):
    """A group's overlap counts by the kernel with its copies (one H2D of
    the group's buffer, the launch, one D2H of the counts, as
    compare/pipeline.py:group_overlap_counts runs them) against the host
    popcount over the same group, across the summed work n^2 * Mg * L that
    the auto engine's bound reads."""
    import numpy as np
    from instrain_tpu_torch.compare import pipeline as CP

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    rows = []
    for N, G in ((8, 1), (8, 16), (32, 4)):
        for L in (1 << k for k in range(6, 19, 2)):
            words = group_words(rng, [(N, 4, L)] * G)
            lengths = [L] * G
            runs = {
                "host": lambda: [CP.host_overlap_counts(w) for w in words],
                "device": lambda: CP.group_overlap_counts(words, lengths,
                                                          "device", dev)}
            ms = {}
            for eng in ("host", "device", "device", "host"):
                runs[eng]()                                  # warm
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    runs[eng]()
                    torch.cuda.synchronize()
                    best = min(best, time.perf_counter() - t0)
                ms.setdefault(eng, []).append(best * 1e3)
            host, device = min(ms["host"]), min(ms["device"])
            work = G * N * N * 4 * L
            rows.append((work, host, device))
            log("compare", f"crossover, group of {G} x (N={N}, Mg=4, L={L})"
                           f" (sum n^2*Mg*L = {work:.4g}) on {card}: host "
                           f"{host:.4f} ms, one launch with its copies "
                           f"{device:.4f} ms")
    # the least swept work from which on the launch wins everywhere
    from_on = None
    for w, h, d in sorted(rows, reverse=True):
        if d >= h:
            break
        from_on = w
    log("compare", f"the group launch with its copies is faster than the "
                   f"host popcount at every swept work from {from_on} on; "
                   f"the auto bound is {CP.DEVICE_MIN_WORK}")
    return rows


def check_ranged_decode(bam):
    """A decode of every other scaffold through the BAM's .bai holds the
    full decode's records of those scaffolds."""
    import numpy as np
    from instrain_tpu_torch.io.bai import find_bai
    from instrain_tpu_torch.io.bam import decode_bam
    check(find_bai(bam) is not None, f"{bam} has no .bai beside it")
    t0 = time.perf_counter()
    full = decode_bam(bam)
    t1 = time.perf_counter()
    names = full.ref_names[::2]
    sub = decode_bam(bam, scaffolds=names)
    t2 = time.perf_counter()
    every = decode_bam(bam, scaffolds=full.ref_names)    # as pooling asks
    t3 = time.perf_counter()
    check(sub.ranged and every.ranged and not full.ranged,
          "the decode was not ranged")
    check(every.n_records == full.n_records,
          f"a ranged decode of every scaffold holds {every.n_records} "
          f"records, the full decode {full.n_records}")
    for name in names:
        a = np.flatnonzero(full.ref_id == full.name_to_ref_id[name])
        b = np.flatnonzero(sub.ref_id == sub.name_to_ref_id[name])
        check(len(a) == len(b) > 0 and all(
            np.array_equal(getattr(full, f)[a], getattr(sub, f)[b])
            for f in ("pos", "nm", "mapq", "flag", "ref_end")) and
            [full.qnames[i] for i in full.qname_id[a]] ==
            [sub.qnames[i] for i in sub.qname_id[b]],
            f"{name}: the ranged decode's records differ from the full "
            f"decode's")
    log("e2e", f"{os.path.basename(bam)}: a ranged decode of {len(names)} "
               f"scaffolds through its .bai ({t2 - t1:.3f} s) holds the "
               f"full decode's records ({t1 - t0:.3f} s, "
               f"{full.n_records} records); a ranged decode of all "
               f"{len(full.ref_names)} scaffolds {t3 - t2:.3f} s")


def phase_compare_e2e(torch):
    """compare end to end: 8 samples of the benchmark metagenome (128 x
    40 kb, 4 genomes of 32 scaffolds, 10-40x) profiled through the CLI on
    the card with genome-wide aggregation (a process each, at once), then
    compared on the card with the overlap_counts kernel (every launch
    count reset just before and read just after), with the host engine,
    on the CPU (the plain version) and with --engine auto (without
    pooling and the stores); the TSVs byte for byte."""
    import numpy as np
    import pandas as pd
    from instrain_tpu_torch.cli import main
    from instrain_tpu_torch.compare import pipeline as CP
    from instrain_tpu_torch.compare import pooling as CPO
    from instrain_tpu_torch.kernels import cuda_compact as CCP
    from instrain_tpu_torch.kernels import cuda_compare as CC
    from instrain_tpu_torch.kernels import cuda_linkage as CL
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    from instrain_tpu_torch.store.profile_dir import ProfileDir
    from instrain_tpu_torch.synth import synth_samples

    d = os.path.join(WORK, "compare")
    os.makedirs(d)
    covs = [10 + 30 * i / 7 for i in range(8)]
    t0 = time.perf_counter()
    fasta, bams, stb = synth_samples(d, 8, 128, 40_000, covs, seed=11,
                                     n_genomes=4)
    log("e2e", f"synth_samples: 8 samples of 128 x 40 kb, 4 genomes, "
               f"{covs[0]:.0f}-{covs[-1]:.0f}x: "
               f"{time.perf_counter() - t0:.2f} s")
    check_ranged_decode(bams[0])
    # the 8 profiles are set-up, not the path under test: one CLI process
    # each, all at once on the card
    profiles = [os.path.join(d, f"s{i}.IS") for i in range(8)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    t0 = time.perf_counter()
    try:
        for bam, out in zip(bams, profiles):
            with open(out + ".log", "w") as logf:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "instrain_tpu_torch.cli",
                     "profile", bam, fasta, "-o", out, "--device", "cuda",
                     "-s", stb, "--skip_plot_generation", "-p", "1"],
                    cwd=ROOT, env=env, stdout=logf,
                    stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out) in enumerate(zip(rcs, profiles)):
        check(rc == 0, f"profile of sample {i} exited {rc} (see "
                       f"{out}.log)")
        info = read_table(out, "genome_info")
        check(list(info["genome"]) == [f"genome_{g}" for g in range(4)] and
              np.isfinite(info["coverage"]).all(),
              f"sample {i}: genome_info is not 4 finite genomes")
    log("e2e", f"8 profiles on the card with genome-wide aggregation, one "
               f"process each, at once: {time.perf_counter() - t0:.2f} s")

    # every (scaffold, pair, mm level) the comparison must report
    want = 0
    levels = [{s: set(m) for s, m in ProfileDir(p).get("covT").items()}
              for p in profiles]
    scaffolds = set.intersection(*(set(lv) for lv in levels))
    check(len(scaffolds) == 128, f"{len(scaffolds)} scaffolds in common")
    study_work = 0      # the auto rule's n^2 * Mg * L over the group
    for s in scaffolds:
        for i in range(8):
            for j in range(i + 1, 8):
                want += len(levels[i][s] | levels[j][s])
        study_work += 64 * len(set().union(*(lv[s] for lv in levels))) * \
            40_000
    del levels
    n_groups = -(-128 * 40_000 // 10_000_000)     # --group_length default
    auto_launches = n_groups if study_work >= CP.DEVICE_MIN_WORK else 0

    lean = ["-s", stb, "--skip_plot_generation"]
    flags = lean + ["--bams"] + bams + ["--store_mismatch_locations",
                                        "--store_coverage_overlap"]
    failures = []
    real_log_failure = CP.log_failure
    CP.log_failure = lambda kind, unit, detail="": failures.append(
        (kind, unit, detail))
    # pooling's decode of each sample: ranged through the sample's .bai
    ranged = []
    real_decode = CPO.decode_bam

    def decode(*a, **k):
        bam = real_decode(*a, **k)
        ranged.append(bam.ranged)
        return bam

    CPO.decode_bam = decode
    runs = {}
    try:
        # auto shows the engine rule (a launch per group from its bound
        # on), without pooling and the stores, which no engine changes
        for tag, engine, device in (("device", "device", "cuda"),
                                    ("host", "host", "cuda"),
                                    ("cpu", "device", "cpu"),
                                    ("auto", "auto", "cuda")):
            out = os.path.join(d, f"{tag}.RC")
            for mod in (C, CCP, CL, CC):
                mod.reset_launch_counts()
            CP.PHASES = {}
            run_flags = lean if tag == "auto" else flags
            if tag == "device":     # this run draws the dendrograms too
                run_flags = [f for f in run_flags
                             if f != "--skip_plot_generation"]
            t0 = time.perf_counter()
            with FailureLog("plotting failed") as plot_log:
                check(main(["compare", "-i"] + profiles + ["-o", out,
                            "--device", device, "--engine", engine] +
                           run_flags) == 0, f"compare {tag} failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {**C.launch_counts(), **CCP.launch_counts(),
                   **CL.launch_counts(), **CC.launch_counts()}
            phases = dict(CP.PHASES)
            CP.PHASES = None
            runs[tag] = (out, got)
            if tag == "device":
                device_phases, device_plot_log = phases, plot_log.lines
            log("e2e", f"compare --engine {engine} --device {device}: wall "
                       f"{wall:.2f} s, overlap stage "
                       f"{phases.get('overlap', 0.0):.3f} s; phases (s): "
                       + ", ".join(f"{k} {v:.3f}" for k, v in
                                   phases.items()) + f"; launches {got}")
    finally:
        CP.log_failure = real_log_failure
        CPO.decode_bam = real_decode
    check(not failures, f"compare logged failures: {failures[:3]}")
    check(ranged and all(ranged), f"pooling's decodes ranged: {ranged}")
    card = nvidia_smi_line()
    log("e2e", f"compare --engine device on {card}: pooling phase "
               f"{device_phases['pooling']:.3f} s with the ranged decode "
               f"of each sample (commit a1862b1, full decode, NVIDIA H100 "
               f"80GB HBM3 at 700 W: 18.602 s)")
    fig = os.path.join(runs["device"][0], "figures",
                       "device.RC_inStrainCompare_dendrograms.pdf")
    if have_matplotlib():
        check(os.path.exists(fig) and os.path.getsize(fig) > 1000,
              f"{fig} was not drawn")
        log("e2e", f"compare --engine device: plots: the dendrograms, "
                   f"{os.path.getsize(fig)} bytes, plots phase "
                   f"{device_phases.get('plots', 0.0):.3f} s")
    else:
        check(device_plot_log, "compare --engine device: matplotlib is "
                               "missing and no plotting failure was logged")
        log("e2e", "compare --engine device: plots: not drawn (no "
                   "matplotlib); 'compare plotting failed' logged")

    out, got = runs["device"]
    check(got["overlap_counts"] == n_groups and
          sum(got.values()) == got["overlap_counts"],
          f"compare --engine device: launches {got}, expected "
          f"overlap_counts once for each of the {n_groups} comparison "
          f"group(s)")
    for tag in ("host", "cpu"):
        check(sum(runs[tag][1].values()) == 0,
              f"compare {tag}: launches {runs[tag][1]}, expected none")
    auto = runs["auto"][1]
    check(auto["overlap_counts"] == auto_launches and
          sum(auto.values()) == auto_launches,
          f"compare auto: launches {auto}, expected {auto_launches} "
          f"(the group's work {study_work}, the bound "
          f"{CP.DEVICE_MIN_WORK})")
    tables = ["comparisonsTable", "genomeWide_compare", "strain_clusters",
              "pairwise_SNP_locations", "pooled_SNV_info", "pooled_SNV_data",
              "pooled_SNV_data_keys"]
    texts = {}
    for tag, (rc, _) in runs.items():
        texts[tag] = {}
        for t in tables[:3] if tag == "auto" else tables:
            path = os.path.join(rc, "output", f"{tag}.RC_{t}.tsv")
            check(os.path.exists(path), f"{path} was not written")
            with open(path) as f:
                texts[tag][t] = f.read()
            check(texts[tag][t].count("\n") > 1, f"{path} has no rows")
    for tag in ("host", "cpu", "auto"):
        check(all(texts[tag][t] == texts["device"][t] for t in texts[tag]),
              f"compare {tag}: TSVs differ from the --engine device run")
    rc = ProfileDir(out)
    cdb = rc.get("comparisonsTable")
    keys = cdb[["scaffold", "name1", "name2", "mm"]].drop_duplicates()
    check(len(cdb) == want and len(keys) == want,
          f"comparisonsTable has {len(cdb)} rows ({len(keys)} distinct), "
          f"expected one per (scaffold, pair, mm level): {want}")
    check(np.isfinite(cdb["coverage_overlap"]).all() and
          (cdb["compared_bases_count"] > 0).all(),
          "comparisonsTable: empty or non-finite overlaps")
    one = rc.get("scaff2pair2mm2cov", scaffolds=["scaf_0"])
    check(len(one.get("scaf_0", {})) == 28,
          "scaff2pair2mm2cov lacks scaf_0's 28 pairs")
    clusters = pd.read_csv(os.path.join(out, "output",
                                        "device.RC_strain_clusters.tsv"),
                           sep="\t")
    per_genome = clusters.groupby("genome")["cluster"].nunique().tolist()
    log("e2e", f"compare: {want} (scaffold, pair, mm) rows, "
               f"{got['overlap_counts']} launch(es) of overlap_counts, one "
               f"per comparison group; the host engine's and --device "
               f"cpu's TSVs, and auto's ({auto_launches} launch(es): the "
               f"group's n^2*Mg*L {study_work} against the bound "
               f"{CP.DEVICE_MIN_WORK}) comparison, genome and cluster TSVs "
               f"byte-identical to it; strain clusters per genome "
               f"{per_genome}")
    return got["overlap_counts"]


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
    phase_check_deps(torch)
    from instrain_tpu_torch.kernels import cuda_compact as CC
    short_keys = CC.MEDIAN_SHORT_KEYS
    errs, _ = phase_kernels(torch, card)
    errs.update(phase_compact(torch, card))
    berrs, times, bounds = phase_batch(torch, card)
    errs = {k: max(v, berrs.get(k, 0.0)) for k, v in errs.items()}
    for k, v in phase_compact_edges(torch, short_keys).items():
        errs[k] = max(errs[k], v)
    rates = card_rates(torch)
    errs["ld"], ld_at_d = phase_linkage(torch, card, rates)
    k7 = phase_compare_kernel(torch, card)
    phase_compare_crossover(torch, card)
    launches, ld_args, captured, paths = phase_end_to_end(torch)
    launches["overlap_counts"] = phase_compare_e2e(torch)
    phase_host_commands(torch, paths)
    check("jax" not in sys.modules and "instrain_tpu" not in sys.modules,
          "jax or instrain_tpu was imported")

    # select_rows and masked_median at the inputs the main paths gave them,
    # then at the synthetic shapes
    timing = compact_timing(torch, card, [
        (f"{n} (captured)", *captured[n])
        for n in ("metagenome", "isolate", "deep")] + synthetic_shapes(
            torch))
    del captured

    # the ld kernel at the deep input's shapes, as its run gave them: warm
    # time of the main path's wrapper (ld_packed, one buffer) and of ld
    # (the dict of its columns), and the launch's device time, L2 flushed
    from instrain_tpu_torch.kernels import cuda_linkage as CL
    errs["ld"] = max(errs["ld"], compare_nan_equal(
        CL.ld_plain(*ld_args), CL.ld(*ld_args), "ld, deep input"))
    times["ld"] = timed_pair(torch, lambda: CL.ld_packed(*ld_args),
                             lambda: CL.ld_plain(*ld_args), 20, 3)
    ld_dict_ms = cuda_ms(torch, lambda: CL.ld(*ld_args), 20)
    ld_device_ms = cold_ms(torch, lambda: CL.ld_packed(*ld_args), 20,
                           busy=True)
    E, M, _ = ld_args[3].shape
    bounds["ld"] = ld_bound(ld_args, CL.ld(*ld_args), rates)
    log("linkage", f"time at the deep input's shape (E={E} edges, M={M}, "
                   f"{ld_args[0].numel()} pairs) on {card}: ld_packed "
                   f"{times['ld'][0]:.4f} ms, ld (dict) {ld_dict_ms:.4f} ms, "
                   f"device {ld_device_ms:.4f} ms vs plain "
                   f"{times['ld'][1]:.4f} ms; bound "
                   f"{bounds['ld'][0]:.4f} ms ({bounds['ld'][1]})")

    main_shape = timing["metagenome (captured)"]
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
        for name, line in (("mm_aggregates", 346),)
    ] + [
        {"name": "ld", "route": "cuda",
         "source": "instrain_tpu_torch/csrc/linkage.cu",
         "replaces": "instrain_tpu/kernels/linkage.py:29",
         "launches": launches["ld"], "max_abs_err": errs["ld"],
         "ms": times["ld"][0], "plain_ms": times["ld"][1],
         "device_ms": ld_device_ms, "dict_ms": ld_dict_ms,
         "shape_d": ld_at_d}
    ]
    # no single PyTorch call computes K1-K3, mm_aggregates or K6:
    # library_ms is null for them
    for k in kernels:
        k.update(bound_ms=bounds[k["name"]][0],
                 bound_by=bounds[k["name"]][1], library_ms=None)
    # select_rows and masked_median at the metagenome's largest chunk, as
    # its batch run gave it
    for name, line in (("select_rows", 325), ("masked_median", 379)):
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "instrain_tpu_torch/csrc/compact.cu",
             "replaces": f"instrain_tpu/kernels/sitestats.py:{line}",
             "launches": launches[name], "max_abs_err": errs[name],
             **{k: main_shape[name][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    main_shape = k7["study"]     # the compare run's group: 8 samples
    kernels.append(
        {"name": "overlap_counts", "route": "cuda",
         "source": "instrain_tpu_torch/csrc/compare.cu",
         "replaces": "instrain_tpu/kernels/compare.py:39",
         "launches": launches["overlap_counts"], "max_abs_err": 0.0,
         **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
