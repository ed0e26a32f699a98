#!/usr/bin/env python3
"""
The benchmark of instrain_tpu_torch's `profile`, one cell per call:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU. A cell
(BENCHMARK.json's `workloads`) names a configuration (the database and the
read model, benchmark/configs/) and a traffic mix (the CLI arguments and
the loop, benchmark/traffic/). The mix may name more input files
(benchmark/inputs/, written in set-up; a traffic argument "{<input>}" is
the file's path) and more checks (benchmark/checks/, more numbers compared
after the window).

Set-up: the imports, the program's libraries (built into the checkout on
its first run), the sample's inputs generated from the seed
(benchmark/gen/) into a directory under TMPDIR, and one warm-up sample.
The window: samples profiled one after another (a closed loop, one at a
time, as a user's job profiles its samples), each a call of
instrain_tpu_torch.profile.pipeline.profile with the configuration the
`instrain_tpu_torch profile` command builds, into a directory of its own;
a sample starts while the window is open, and the last one runs to its
end. Before each sample the previous one's output tables are digested and
its directory removed. After the window the program's state is freed, the
last sample is compared in full with the plain reference (benchmark/ref/),
and every other sample's output tables with its, byte for byte.

Prints a set-up breakdown on standard error, the numbers compared beside
their limits as its last lines, and the result as the last line of
standard output. With --trace 1 the result holds the per-layer metrics
(the program's phase timers, its launch counters and a torch.profiler
trace of the window) in place of the end-to-end ones.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "cuda"))

# the top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "instrain_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that are forbidden (whole names:
    instrain_tpu_torch is not instrain_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (/proc/self/stat, clock ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def cpu_s() -> float:
    """CPU seconds this process has used, user and system, all threads:
    beside a sample's wall, it tells a slower host (CPU seconds grow with
    the wall) from waiting (they do not)."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_cfg(cli, pipeline, traffic, inputs, out):
    """The ProfileConfig `instrain_tpu_torch profile` builds for these
    arguments (cli.main without process start and setup_logger)."""
    argv = (["profile", inputs["bam"], inputs["fasta"], "-o", out] +
            list(traffic["args"]) +
            (["-s", inputs["stb"]] if inputs["stb"] else []))
    args = cli.build_parser().parse_args(argv)
    cfg = cli.profile_config_from_args(args)
    pipeline.check_supported(cfg)
    cli.select_local_cards(args.device, args.mesh_devices)
    cfg.output = out
    return cfg


def run_cell(man: dict, cell: dict, seed: int, seconds: float,
             traced: bool, device: str = "cuda"):
    """One run of a cell; returns its result. `device`
    "cpu" runs the program's plain kernels (the CPU tests drive the
    harness so); the benchmark's runs are on "cuda"."""
    from benchmark.harness import registry
    cfg_params = registry.config(man, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    if traffic.get("loop") != "closed" or traffic.get("concurrency") != 1:
        raise ValueError("the harness drives a closed loop of one client")
    if device != "cuda":
        traffic = dict(traffic, args=list(traffic["args"]) +
                       ["--device", device])
    on_gpu = device == "cuda"
    from benchmark.harness import judge
    ext = registry.extensions(traffic, judge.LIMITS)

    setup = {}
    import torch
    from instrain_tpu_torch import build, cli
    from instrain_tpu_torch.kernels import (cuda_compact, cuda_compare,
                                            cuda_linkage, cuda_sitestats)
    from instrain_tpu_torch.profile import pipeline
    setup["imports_s"] = time.perf_counter() - T0
    t = time.perf_counter()
    build.native_io_library()
    if on_gpu:
        build.cuda_kernels_library()
        torch.cuda.init()
    setup["libraries_s"] = time.perf_counter() - t

    from benchmark.gen import reads as gen
    from benchmark.harness import memory, outputs, phases, trace
    counters = (cuda_sitestats, cuda_compact, cuda_linkage, cuda_compare)
    rundir = tempfile.mkdtemp(prefix="instrain-bench-")
    peak = memory.PeakRSS()
    try:
        t = time.perf_counter()
        inputs = gen.write_inputs(cfg_params, seed,
                                  os.path.join(rundir, "input"),
                                  threads=min(os.cpu_count() or 1, 8))
        paths = {n: write(cfg_params, seed, inputs["layout"],
                          os.path.join(rundir, "input"))
                 for n, write in ext.writers.items()}
        traffic = dict(traffic, args=registry.resolve_args(traffic["args"],
                                                           paths))
        setup["inputs_s"] = time.perf_counter() - t

        def sample(k: int, record: bool):
            out = os.path.join(rundir, "samples", str(k), "profile.IS")
            cfg = make_cfg(cli, pipeline, traffic, inputs, out)
            if record:
                pipeline.PHASES = {}
                for c in counters:
                    c.reset_launch_counts()
            t0 = time.perf_counter()
            pipeline.profile(inputs["bam"], inputs["fasta"], cfg)
            wall = time.perf_counter() - t0
            if not record:
                return wall, None, None
            ph, pipeline.PHASES = pipeline.PHASES, None
            return wall, ph, sum(sum(c.launch_counts().values())
                                 for c in counters)

        t = time.perf_counter()
        for k in range(int(traffic.get("warmup_samples", 1))):
            sample(-1 - k, False)
        shutil.rmtree(os.path.join(rundir, "samples"), ignore_errors=True)
        if on_gpu:
            torch.cuda.synchronize()
        setup["warmup_s"] = time.perf_counter() - t
        log("setup " + " ".join(f"{k}={v:.3f}" for k, v in setup.items()))

        run = phases.Run()
        attempted = failed = 0
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU] +
                           ([ProfilerActivity.CUDA] if on_gpu else []))
        # set-up's writes (the inputs) reach the disk before the window
        # opens, not inside it
        os.sync()
        gc.collect()
        if prof is not None:
            prof.__enter__()
        setup_s = process_age()
        log(f"resident at window open {memory.resident() / 2 ** 30:.3f} GiB")
        peak.start()
        cpu_open = cpu_s()
        t_open = time.perf_counter()
        t_end = t_open
        digests, prev, sample_cpu = [], None, []
        try:
            while attempted == 0 or time.perf_counter() < t_open + seconds:
                k = attempted
                attempted += 1
                if prev is not None:
                    # the previous sample's tables are digested, then its
                    # directory removed before the next sample starts
                    digests.append(outputs.digest(prev))
                    shutil.rmtree(os.path.dirname(prev))
                    prev = None
                cpu_k = cpu_s()
                try:
                    if prof is not None:
                        with torch.profiler.record_function(trace.SAMPLE):
                            wall, ph, launches = sample(k, True)
                    else:
                        wall, ph, launches = sample(k, False)
                except Exception:
                    failed += 1
                    log(f"sample {k} failed:\n{traceback.format_exc()}")
                    shutil.rmtree(os.path.join(rundir, "samples", str(k)),
                                  ignore_errors=True)
                    continue
                t_end = time.perf_counter()
                sample_cpu.append(cpu_s() - cpu_k)
                prev = os.path.join(rundir, "samples", str(k), "profile.IS")
                run.samples.append(phases.Sample(inputs["pairs"], wall, ph,
                                                 launches))
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        window_s = t_end - t_open
        window_cpu = cpu_s() - cpu_open
        peak_bytes = peak.stop()
        run.window_s = window_s
        dev_peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        if prof is not None:
            run.trace = trace.export(prof, os.path.join(rundir, "trace.json"))
            prof = None
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()

        # the comparison: the last sample in full, every other one by the
        # digest of its tables
        numbers = {}
        if prev is not None and failed == 0:
            from benchmark.ref.profile import reference
            log(f"sample output {outputs.size(prev) / 2 ** 20:.1f} MiB")
            base = reference(cfg_params, seed)
            numbers = judge.judge(outputs.read_profile(prev), base)
            want = outputs.digest(prev)
            numbers["samples_differing"] = sum(d != want for d in digests)
            for name, check in ext.checks.items():
                # a check that raises reads every number of its own as
                # one-sided, so that its limits fail
                try:
                    numbers.update(registry.check_numbers(
                        check, check.read(prev),
                        check.reference(cfg_params, seed, inputs["layout"],
                                        paths, base, "reference")))
                except Exception:
                    log(f"check {name} failed:\n{traceback.format_exc()}")
                    numbers.update(dict.fromkeys(check.LIMITS,
                                                 judge.ONE_SIDED))
        correct = (bool(numbers) and failed == 0 and
                   judge.verdict(numbers, ext.limits))
    finally:
        peak.close()
        shutil.rmtree(rundir, ignore_errors=True)

    if traced:
        metrics = registry.read_metrics(
            registry.cell_metrics(man, cell["name"], "per_layer"), run)
    else:
        e2e = {"profile_pairs_per_s": (run.pairs / window_s if window_s > 0
                                       else 0.0),
               "peak_host_gib": peak_bytes / 2 ** 30,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in registry.cell_metrics(man, cell["name"],
                                                  "end_to_end")}
    device_info = {"platform": "gpu" if on_gpu else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_gpu
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(dev_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced and run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = window_s
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    log(f"window {window_s:.3f} s, {len(run.samples)} samples of "
        f"{', '.join(f'{s.wall_s:.3f}' for s in run.samples)} s, peak host "
        f"memory by {peak.mode}")
    log(f"process CPU seconds: window {window_cpu:.3f}, samples " +
        ", ".join(f"{c:.3f}" for c in sample_cpu))
    result["compared"] = {k: {"value": v, "limit": ext.limits[k]}
                          for k, v in numbers.items()}
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from benchmark.harness import registry
    man = registry.manifest()
    cell = registry.workload(man, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        log(f"need {cell['chips']} CUDA device(s); found {have}")
        return 2
    result = run_cell(man, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for k, v in result["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}")
    if not result["compared"]:
        log("compared nothing: no sample completed without failure")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
