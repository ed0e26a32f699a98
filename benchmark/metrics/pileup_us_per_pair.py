"""pileup_us_per_pair: host seconds of the pileup build (profile/pileup.py),
the profile run's PHASES["pileup"], per read pair, over the traced
window's samples."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "pileup")
