"""genome_us_per_pair: host seconds of genome-wide aggregation
(profile/genome.py), the profile run's PHASES["genome"], per read pair,
over the traced window's samples."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "genome")
