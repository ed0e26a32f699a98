"""genome_coverage_us_per_pair: host seconds of the per-genome coverage
arrays and their median, SEM and std per mm level (profile/genome.py, span
"genome.coverage", inside "genome"), per read pair, over the traced
window's samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genome.coverage")
