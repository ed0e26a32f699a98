#!/usr/bin/env python3
"""
The control of the comparison that decides `correct`: the plain reference
computed one step below the precision the configuration states (clonality
in bfloat16 in place of float32, aggregates in float32 in place of
float64), put in the program's place and judged against the reference as
a run judges the program. It has to come out not correct; its readings set
the upper end of each float limit (PERF.md, "How `correct` is decided").

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with every number and whether it passes.
It needs no GPU: neither side runs the program.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_numbers(cfg: dict, seed: int) -> dict:
    from benchmark.harness import judge
    from benchmark.ref.profile import reference
    return judge.judge(reference(cfg, seed, precision="control"),
                       reference(cfg, seed))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    from benchmark.harness import judge, registry
    man = registry.manifest()
    cfg = registry.config(man, registry.workload(man, args.workload)["config"])
    for seed in args.seeds:
        t = time.perf_counter()
        nums = control_numbers(cfg, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "correct": judge.verdict(nums), "numbers": nums}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
