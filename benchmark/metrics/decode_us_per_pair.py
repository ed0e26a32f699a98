"""decode_us_per_pair: host seconds of the BAM decode (io/bam.py over
native/bam.cc), the profile run's PHASES["decode"], per read pair, over
the traced window's samples."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "decode")
