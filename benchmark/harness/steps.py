"""
The per-layer metrics of the program's child spans and steps (profile/
pipeline.py:PHASES names such as "genome.irep" or "store.wait"): like
phases.us_per_pair, but None where no timed sample recorded any of the
names, as a program without those spans records none.
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness.phases import Run, us_per_pair


def step_us_per_pair(run: Run, *names: str) -> Optional[float]:
    """The named phases' seconds summed over the samples, per read pair,
    in us; None where no timed sample has any of them."""
    if not any(n in s.phases for s in run.samples if s.phases is not None
               for n in names):
        return None
    return sum(us_per_pair(run, n) for n in names)
