#!/usr/bin/env python3
"""
The compaction kernels select_rows and mm_aggregates, compare's overlap
kernel (K7) and device linkage's ld kernel (K6) of this checkout against
an earlier design of the same kernels, in one process on one NVIDIA GPU,
each design called through its own wrappers.

    mkdir -p .scratch/base
    git archive a1862b1 instrain_tpu_torch | tar -x -C .scratch/base
    python3 compact_ab.py .scratch/base/instrain_tpu_torch ld

DIR is the earlier commit's package: it is loaded beside this checkout's
as the package `instrain_earlier` (its modules import one another
relatively) and builds its own kernels into its own _build/. PARTs (all
by default): peak, overlap, compact, ld. The overlap part needs an
earlier package with the per-scaffold K7 entry (60a2909's, the design
the group launch replaced); ld takes a1862b1's (the design before the
one-launch ld). Keep DIR out of .smoke/ where chip_smoke.py runs after
it: the smoke clears .smoke/.

compact: the compaction kernels at the shapes chip_smoke.py times them at:
the inputs compact_from_full gets in the three --engine auto runs of its
main paths (the metagenome's largest chunk, the isolate, the deep input),
a 52 x 40 kb chunk and one segment of M = 8, L = 2^20 (against 60a2909's
design: select_rows' and mm_aggregates' input checks format their
messages on every call, mm_aggregates zero-fills its three outputs and
launches one thread per position). overlap: K7 at (a) the 8-sample
study's comparison group, 128 scaffolds of (8 samples, 5 mm levels, 40
kb): one group launch against 60a2909's 128 per-scaffold calls, on words
already on the card and with the copies each pipeline makes (one of the
group's buffer and one of its counts; two per scaffold), beside one bf16
torch.bmm of the group's unpacked bits [128 * 5, 8, 40000] with f32 out;
(b) (16, 4, 2^23) and (64, 3, 100,000); peak first runs k7_peak.cu (the
b1 tensor-core product's and the CUDA cores' popcount peak rates). ld:
at (a) the deep input's captured arguments (E = 83 edges, M = 5, 132,840
pairs), at chip_smoke.LD_SHAPES' (b) 5,000 x 12 x 150,000, (c) 64 x 33 x
9,000 and (d) 50,000 x 8 x 4,000,000, and at chip_smoke.ld_boundary_shapes
(the grid's one-tile and two-tile blocks), against a1862b1's design
(three launches: a memset, the scatter, the cells; five allocations),
and this design with and without its draws made ahead; then the whole device linkage call at the deep input, _device_ld_args to
the table, of both packages, by the host's clock to synchronize, with
the copies between host and device each makes counted under
torch.profiler.

At each shape the designs' outputs are first held equal bit for bit;
then, in turns (earlier, this, this, earlier), every call after an L2
flush and timed by CUDA events: the device time of the launches alone
(the card kept busy while the host enqueues them; select_rows' count and
gather launches timed apart, the host read of its totals between them
left out), and the wrapper's time (for ld: `ld`, which returns the dict
of columns, and `ld_packed`, the one buffer the main path copies back).
The bound is chip_smoke.py's. Prints a line per shape, then the card's
name and power limit, then every time as one JSON object on the last
line. Imports nothing of JAX; writes only under .smoke/ab/.
"""

import importlib.util
import json
import os
import shutil
import sys
import time

import chip_smoke as smoke

WORK = os.path.join(smoke.WORK, "ab")
N = 10                                  # calls per timing


def load_earlier(pkg_dir):
    """The earlier package at pkg_dir, imported as `instrain_earlier`."""
    smoke.check(os.path.exists(os.path.join(pkg_dir, "__init__.py")),
                f"no package at {pkg_dir}")
    spec = importlib.util.spec_from_file_location(
        "instrain_earlier", os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["instrain_earlier"] = mod
    spec.loader.exec_module(mod)
    import instrain_earlier.kernels.cuda_compact as ecc
    import instrain_earlier.kernels.cuda_compare as ecmp
    import instrain_earlier.kernels.cuda_linkage as ecl
    import instrain_earlier.kernels.cuda_sitestats as ecs
    ecs.load_kernels()
    return ecc, ecmp, ecl


def captured_shapes(cases=smoke.MAIN_CASES):
    """([(name, full, seg)] of the largest chunk of each main path's
    --engine auto run, on inputs made as chip_smoke.py makes them; the
    arguments of the last device linkage call and of its ld launch)."""
    from instrain_tpu_torch.profile import linkage as PL
    from instrain_tpu_torch.synth import synth
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    calls, saved = [], (PL._calculate_linkage_device, PL._device_ld_args)

    def keep_call(*a):
        calls.append(a)
        return saved[0](*a)

    def keep_args(*a):
        calls.append(saved[1](*a))
        return calls[-1]

    PL._calculate_linkage_device, PL._device_ld_args = keep_call, keep_args
    try:
        with smoke.CompactCapture() as capture:
            for name, S, L, cov in cases:
                d = os.path.join(WORK, name)
                os.makedirs(d)
                fasta, bam, _ = synth(d, S=S, L=L, COV=cov, seed=7)
                capture.run = name
                smoke.run_profile(bam, fasta, os.path.join(d, "auto.IS"),
                                  "auto")
    finally:
        PL._calculate_linkage_device, PL._device_ld_args = saved
    smoke.check(len(calls) >= 2, "no device linkage call in the main paths")
    return ([(f"{n} (captured)", *capture.inputs[n]) for n, *_ in cases],
            calls[-2], calls[-1])


def in_turns(torch, designs, busy):
    """{design: mean ms} of each design's calls, taken earlier, this,
    this, earlier; designs[d] is a list of functions each timed alone."""
    t = {}
    for d in ("earlier", "this", "this", "earlier"):
        t.setdefault(d, []).append(sum(
            smoke.cold_ms(torch, f, N, busy=busy) for f in designs[d]))
    return {d: sum(v) / len(v) for d, v in t.items()}


def report(kname, dev, wrap, bnd):
    r = {"this_device_ms": dev["this"], "earlier_device_ms": dev["earlier"],
         "this_ms": wrap["this"], "earlier_ms": wrap["earlier"],
         "bound_ms": bnd[0], "bound_by": bnd[1]}
    text = (f"{kname} device {r['this_device_ms']:.4f} ms (earlier "
            f"{r['earlier_device_ms']:.4f}, "
            f"{r['earlier_device_ms'] / r['this_device_ms']:.2f}x), wrapper "
            f"{r['this_ms']:.4f} ms (earlier {r['earlier_ms']:.4f}, "
            f"{r['earlier_ms'] / r['this_ms']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return r, text


def ab_compact(torch, ecc, name, full, seg, card):
    """select_rows and mm_aggregates of both designs at one shape: checked
    equal, then timed in turns."""
    from instrain_tpu_torch.kernels import cuda_compact as CC
    M, L = full["total"].shape
    rows, link = CC.select_rows(full, seg)
    agg, cf, rf = CC.mm_aggregates(full, seg)
    old_rows, old_link = ecc.select_rows(full, seg)
    old_agg, old_cf, old_rf = ecc.mm_aggregates(full, seg)
    torch.cuda.synchronize()
    smoke.compare_exact({"rows": rows, "linkage": link},
                        {"rows": old_rows, "linkage": old_link},
                        f"select_rows, {name}: this design vs the earlier")
    smoke.compare_exact({"agg": agg, "clon_f": cf, "clonR_f": rf},
                        {"agg": old_agg, "clon_f": old_cf,
                         "clonR_f": old_rf},
                        f"mm_aggregates, {name}: this design vs the earlier")
    n_rows, n_pos = rows["n_rows"], link["n_pos"]
    job, old_job = CC._rows_count(full, seg), ecc._rows_count(full, seg)
    torch.cuda.synchronize()
    keys = ("total", "clon", "clonR", "row", "morphia", "cls", "present")
    res, texts = {}, []
    for kname, launches, wrappers, bnd in (
            ("select_rows",
             {"earlier": [lambda: ecc._rows_count(full, seg),
                          lambda: ecc._rows_gather(old_job, n_rows, n_pos)],
              "this": [lambda: CC._rows_count(full, seg),
                       lambda: CC._rows_gather(job, n_rows, n_pos)]},
             {"earlier": [lambda: ecc.select_rows(full, seg)],
              "this": [lambda: CC.select_rows(full, seg)]},
             smoke.select_rows_bound(full, rows, link)),
            ("mm_aggregates",
             {"earlier": [lambda: ecc.mm_aggregates(full, seg)],
              "this": [lambda: CC.mm_aggregates(full, seg)]},
             {"earlier": [lambda: ecc.mm_aggregates(full, seg)],
              "this": [lambda: CC.mm_aggregates(full, seg)]},
             smoke.bound(smoke.nbytes([full[k] for k in keys], agg, cf,
                                      rf)))):
        res[kname], text = report(kname, in_turns(torch, launches, True),
                                  in_turns(torch, wrappers, False), bnd)
        texts.append(text)
    smoke.log("ab", f"{name} (M={M}, {seg.S} segment(s), {L} positions, "
                    f"{n_rows} SNP rows, {n_pos} SNV positions) on {card}, "
                    f"cold L2, outputs equal bit for bit: " +
                    "; ".join(texts))
    return res


def ab_overlap(torch, ecmp, card):
    """K7 of both designs: the study's group, (16, 4, 2^23) and
    (64, 3, 100,000)."""
    import numpy as np
    from instrain_tpu_torch.compare import pipeline as CP
    from instrain_tpu_torch.kernels import compare as K
    from instrain_tpu_torch.kernels import cuda_compare as CC
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    res = {}
    for shapes in (smoke.STUDY_GROUP, [(16, 4, 1 << 23)],
                   [(64, 3, 100_000)]):
        words = smoke.group_words(rng, shapes)
        plan, buf, dbuf = smoke.group_on_card(torch, words)
        per = [torch.from_numpy(w.view(np.int64)).to(dev) for w in words]
        got = K.split_counts(CC.overlap_counts_group(dbuf, plan).cpu()
                             .numpy(), plan)
        for (b, s), t in zip(got, per):
            ob, os_ = ecmp.overlap_counts(t)
            smoke.check(np.array_equal(b, ob.cpu().numpy()) and
                        np.array_equal(s, os_.cpu().numpy()),
                        f"overlap_counts {shapes[0]}: the designs differ")
        lengths = [L for _, _, L in shapes]
        launches = {"earlier": [lambda: [ecmp.overlap_counts(t)
                                         for t in per]],
                    "this": [lambda: CC.overlap_counts_group(dbuf, plan)]}
        dev_ms = in_turns(torch, launches, True)
        wrap_ms = in_turns(torch, launches, False)

        def earlier_copies():
            # the earlier pipeline: per scaffold the words to the card, the
            # launch, the counts back
            for w in words:
                t = torch.from_numpy(w.view(np.int64)).to(dev)
                b, s = ecmp.overlap_counts(t)
                b.cpu(), s.cpu()

        copies_ms = in_turns(torch, {
            "earlier": [earlier_copies],
            "this": [lambda: CP.group_overlap_counts(words, lengths,
                                                     "device", dev)]},
            False)
        bnd = smoke.overlap_bound(words, plan)
        key = "study group" if shapes is smoke.STUDY_GROUP else \
            str(shapes[0])
        r, text = report("overlap_counts", dev_ms, wrap_ms, bnd)
        r.update(this_copies_ms=copies_ms["this"],
                 earlier_copies_ms=copies_ms["earlier"])
        text += (f"; with the copies {copies_ms['this']:.4f} ms (earlier "
                 f"{copies_ms['earlier']:.4f}, "
                 f"{copies_ms['earlier'] / copies_ms['this']:.2f}x)")
        if shapes is smoke.STUDY_GROUP:
            N_, _, L = shapes[0]
            bits = torch.from_numpy(np.concatenate(
                [K.unpack_words(w, L) for w in words], axis=1)).to(dev)
            x = bits.to(torch.bfloat16).permute(1, 0, 2).contiguous()
            del bits
            xt = x.transpose(1, 2)
            lib = smoke.cold_ms(torch, lambda: torch.bmm(
                x, xt, out_dtype=torch.float32), N)
            lib2 = smoke.cold_ms(torch, lambda: torch.bmm(
                x, xt, out_dtype=torch.float32), N)
            r["library_ms"] = (lib + lib2) / 2
            text += f"; bf16 bmm of the group {r['library_ms']:.4f} ms"
            del x, xt
        res[key] = r
        smoke.log("ab", f"K7 at {key} ({len(shapes)} x {shapes[0]}, "
                        f"{plan.n_blocks} blocks) on {card}, cold L2, "
                        f"counts equal: {text}")
    return res


def host_ms(torch, fn, n):
    """Mean ms of fn over n calls by the host's clock, each call ended by
    torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def without_draws_ahead(CL):
    """CL.ld_packed with ld_plan's pre_cells set to 0: every thread adds
    pairs and the cells make all their draws."""
    def call(*args):
        plan = CL.ld_plan
        CL.ld_plan = lambda *a: plan(*a)._replace(pre_cells=0)
        try:
            return CL.ld_packed(*args)
        finally:
            CL.ld_plan = plan
    return call


def ab_linkage(torch, ecl, card, deep_call, deep_args):
    """ld of both designs at the deep input's captured arguments (a), at
    (b)-(d) of chip_smoke.LD_SHAPES and at chip_smoke.ld_boundary_shapes:
    each held bit for bit to the plain version, then timed in turns; and
    this design's device time with and without its draws made ahead
    (pre_cells 0). Then the whole device linkage call at the deep input
    (_device_ld_args to the table) of both packages, by the host's clock,
    with its host-device copies counted under torch.profiler."""
    import pandas as pd
    import instrain_earlier.profile.linkage as EPL
    from instrain_tpu_torch.kernels import cuda_linkage as CL
    from instrain_tpu_torch.profile import linkage as PL
    rates = smoke.card_rates(torch)
    dev = torch.device("cuda")
    shapes = [("(a) deep input (captured)", deep_args)] + [
        (f"{tag} E={E} M={M} N={N}", smoke.ld_case(torch, E, M, N))
        for tag, (E, M, N) in zip(
            ("(b)", "(c)", "(d)", "one tile a block", "two tiles a block"),
            smoke.LD_SHAPES[1:] + smoke.ld_boundary_shapes(torch))]
    res = {}
    no_pre = without_draws_ahead(CL)
    for name, args in shapes:
        want = CL.ld_plain(*args)
        smoke.compare_nan_equal(want, CL.ld(*args), f"ld {name}, this")
        smoke.compare_nan_equal(want, ecl.ld(*args), f"ld {name}, earlier")
        E, M, _ = args[3].shape
        plan = CL.ld_plan(E, M, args[0].numel(), args[8], *CL._occupancy(dev))
        calls = {"earlier": [lambda: ecl.ld(*args)],
                 "this": [lambda: CL.ld(*args)]}
        r, text = report("ld", in_turns(torch, calls, True),
                         in_turns(torch, calls, False),
                         smoke.ld_bound(args, want, rates))
        packed = in_turns(torch, {"earlier": calls["earlier"],
                                  "this": [lambda: CL.ld_packed(*args)]},
                          False)["this"]
        r.update(this_packed_ms=packed, grid=plan.grid,
                 edges_per_block=plan.edges_per_block)
        text += (f"; ld_packed {packed:.4f} ms "
                 f"({r['earlier_ms'] / packed:.2f}x the earlier ld)")
        smoke.compare_nan_equal(want, CL.unpack_ld(no_pre(*args), E, M),
                                f"ld {name}, no draws ahead")
        ahead = in_turns(torch, {"earlier": [lambda: no_pre(*args)],
                                 "this": [lambda: CL.ld_packed(*args)]}, True)
        r.update(ahead_device_ms=ahead["this"],
                 none_ahead_device_ms=ahead["earlier"])
        text += (f"; device with {plan.pre_cells} cells drawn ahead a block "
                 f"{ahead['this']:.4f} ms, none {ahead['earlier']:.4f} ms "
                 f"({ahead['earlier'] / ahead['this']:.2f}x)")
        res[name] = r
        smoke.log("ab", f"ld at {name} ({plan.grid} blocks of "
                        f"{plan.edges_per_block} edges) on {card}, cold L2, "
                        f"outputs equal bit for bit: {text}")
        del args, want, calls
    # the whole call at the deep input
    old_df = EPL._calculate_linkage_device(*deep_call)
    new_df = PL._calculate_linkage_device(*deep_call)
    smoke.check(old_df.equals(new_df) and len(new_df) > 0,
                "the deep input's linkage tables differ between designs")
    fns = {"earlier": lambda: EPL._calculate_linkage_device(*deep_call),
           "this": lambda: PL._calculate_linkage_device(*deep_call)}
    t = {}
    for d in ("earlier", "this", "this", "earlier"):
        t.setdefault(d, []).append(host_ms(torch, fns[d], N))
    whole = {d: sum(v) / len(v) for d, v in t.items()}
    copies = {d: smoke.device_copies(torch, fns[d]) for d in fns}
    res["whole call"] = {"this_ms": whole["this"],
                         "earlier_ms": whole["earlier"],
                         "rows": len(new_df), "copies": copies}

    def text(c):
        if c is None:
            return "not measured (no device activity traced)"
        return (f"{c['HtoD'][0]} H2D ({c['HtoD'][1]:.4f} ms), "
                f"{c['DtoH'][0]} D2H ({c['DtoH'][1]:.4f} ms), "
                f"{c['kernels'][0]} kernels ({c['kernels'][1]:.4f} ms)")

    smoke.log("ab", f"device linkage call at the deep input on {card} "
                    f"({len(new_df)} rows, tables equal): host clock "
                    f"{whole['this']:.4f} ms (earlier "
                    f"{whole['earlier']:.4f}, "
                    f"{whole['earlier'] / whole['this']:.2f}x); traced "
                    f"copies: this {text(copies['this'])}; earlier "
                    f"{text(copies['earlier'])}")
    return res


def peak_rates():
    """k7_peak.cu's lines: the b1 tensor-core product's and the CUDA cores'
    AND + popcount peak rates, and its fragment layout check."""
    import subprocess
    from instrain_tpu_torch import build
    os.makedirs(WORK, exist_ok=True)
    exe = os.path.join(WORK, "k7_peak")
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", exe, os.path.join(smoke.ROOT, "k7_peak.cu")],
                   check=True)
    res = subprocess.run([exe], capture_output=True, text=True, timeout=120)
    smoke.check(res.returncode == 0 and "0 of 128 wrong" in res.stdout,
                f"k7_peak failed: {res.stdout} {res.stderr}")
    for line in res.stdout.splitlines():
        smoke.log("peak", line)
    return res.stdout


PARTS = ("peak", "overlap", "compact", "ld")


def main():
    parts = sys.argv[2:] or PARTS
    if len(sys.argv) < 2 or not set(parts) <= set(PARTS):
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this comparison "
              "needs an NVIDIA GPU", flush=True)
        return 1
    card = smoke.nvidia_smi_line()
    t0 = time.perf_counter()
    smoke.phase_build()
    ecc, ecmp, ecl = load_earlier(os.path.abspath(sys.argv[1]))
    smoke.log("ab", f"both designs built: {time.perf_counter() - t0:.2f} s")
    results = {}
    try:
        if "peak" in parts:
            results["peak"] = peak_rates()
        if "overlap" in parts:
            results["overlap_counts"] = ab_overlap(torch, ecmp, card)
        if "compact" in parts or "ld" in parts:
            # the deep input alone when only ld is asked for
            captured, deep_call, deep_args = captured_shapes(
                smoke.MAIN_CASES if "compact" in parts else
                smoke.MAIN_CASES[2:])
        if "compact" in parts:
            for name, full, seg in captured + smoke.synthetic_shapes(torch):
                results[name] = ab_compact(torch, ecc, name, full, seg, card)
        if "ld" in parts:
            results["ld"] = ab_linkage(torch, ecl, card, deep_call,
                                       deep_args)
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
