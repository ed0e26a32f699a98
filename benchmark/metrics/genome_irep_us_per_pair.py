"""genome_irep_us_per_pair: host seconds of the GC windows and the iRep fits
(profile/genome.py, span "genome.irep", inside "genome"), per read pair,
over the traced window's samples; none where the program records no such
span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genome.irep")
