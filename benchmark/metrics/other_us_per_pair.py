"""other_us_per_pair: host seconds of a profile run outside every phase of
its main thread (the FASTA registry, the LUTs, the run's log set-up): each
sample's wall less the sum of its main-thread phases, per read pair, over
the traced window's samples."""

from benchmark.harness.phases import unphased_us_per_pair


def read(run):
    return unphased_us_per_pair(run)
