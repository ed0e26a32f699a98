"""genome_load_us_per_pair: host seconds of genome-wide reading back the
stored tables, covT, the .stb and the FASTA (profile/genome.py, span
"genome.load", inside "genome"), per read pair, over the traced window's
samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genome.load")
