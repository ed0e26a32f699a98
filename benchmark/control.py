#!/usr/bin/env python3
"""
The control of the comparison that decides `correct`: the plain reference
computed one step below the precision the configuration states (clonality
in bfloat16 in place of float32, aggregates in float32 in place of
float64), put in the program's place and judged against the reference as
a run judges the program. It has to come out not correct; its readings set
the upper end of each float limit (PERF.md, "How `correct` is decided").
A cell's checks (benchmark/checks/) are judged alike, each check's
reference at the control's precision against its reference, over the
cell's input files (benchmark/inputs/; written to a temporary directory,
with no BAM).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with every number and whether it passes.
It needs no GPU: neither side runs the program.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_numbers(cfg: dict, seed: int, ext=None) -> dict:
    """Every number of the control; with `ext` (registry.extensions of the
    cell) its checks' numbers too."""
    from benchmark.harness import judge, registry
    from benchmark.ref.profile import reference
    low, ref = reference(cfg, seed, precision="control"), reference(cfg, seed)
    numbers = judge.judge(low, ref)
    if ext is None or not ext.checks:
        return numbers
    from benchmark.gen import reads as gen
    lay = gen.layout(cfg, seed)
    with tempfile.TemporaryDirectory(prefix="instrain-control-") as d:
        paths = {n: write(cfg, seed, lay, d)
                 for n, write in ext.writers.items()}
        for check in ext.checks.values():
            numbers.update(registry.check_numbers(
                check,
                check.reference(cfg, seed, lay, paths, low, "control"),
                check.reference(cfg, seed, lay, paths, ref, "reference")))
    return numbers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    from benchmark.harness import judge, registry
    man = registry.manifest()
    cell = registry.workload(man, args.workload)
    cfg = registry.config(man, cell["config"])
    ext = registry.extensions(registry.traffic(cell["traffic"]),
                              judge.LIMITS)
    for seed in args.seeds:
        t = time.perf_counter()
        nums = control_numbers(cfg, seed, ext)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "correct": judge.verdict(nums, ext.limits),
                          "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
