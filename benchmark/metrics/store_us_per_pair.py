"""store_us_per_pair: host seconds of the profile directory's stores and
output tables on the main thread (store/profile_dir.py,
store/generate.py), the profile run's PHASES["store"], per read pair, over
the traced window's samples. The store threads' own seconds are not in
it."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "store")
