"""filter_us_per_pair: host seconds of the read-pair filter
(profile/filter_reads.py), the profile run's PHASES["filter"], per read
pair, over the traced window's samples."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "filter")
