"""
What one measured window leaves for the per-layer metric readers
(benchmark/metrics/*.py): each sample's read pairs, wall seconds, the
program's phase seconds (instrain_tpu_torch/profile/pipeline.py:PHASES)
and kernel launches, and the reduced device trace, in a traced run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# the main thread's phases of a profile run, which add up to its wall
# (pipeline.py:PHASES); "genes" lies inside "tables", and "store_reads"
# and "special_stream" are the store threads' seconds
MAIN_PHASES = ("decode", "filter", "pileup", "kernels", "tables", "gather",
               "store", "genome", "plots")


@dataclass
class Sample:
    pairs: int
    wall_s: float
    phases: Optional[Dict[str, float]] = None
    launches: Optional[int] = None


@dataclass
class Run:
    samples: List[Sample] = field(default_factory=list)
    window_s: float = 0.0
    trace: Optional[Dict] = None

    @property
    def pairs(self) -> int:
        return sum(s.pairs for s in self.samples)


def us_per_pair(run: Run, phase: str) -> Optional[float]:
    """A phase's seconds summed over the samples, per read pair, in us."""
    timed = [s for s in run.samples if s.phases is not None]
    if not timed:
        return None
    return (sum(s.phases.get(phase, 0.0) for s in timed) * 1e6 /
            sum(s.pairs for s in timed))


def unphased_us_per_pair(run: Run) -> Optional[float]:
    """The samples' walls less their main-thread phases, per pair, in us."""
    timed = [s for s in run.samples if s.phases is not None]
    if not timed:
        return None
    rest = sum(s.wall_s - sum(s.phases.get(p, 0.0) for p in MAIN_PHASES)
               for s in timed)
    return rest * 1e6 / sum(s.pairs for s in timed)
