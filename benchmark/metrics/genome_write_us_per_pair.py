"""genome_write_us_per_pair: host seconds of genome-wide's stores and its
genome_info and SNVs tables (profile/genome.py, span "genome.write",
inside "genome"), per read pair, over the traced window's samples; none
where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genome.write")
