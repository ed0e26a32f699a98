"""engine_us_per_pair: host seconds of the engines' device loop
(profile/compact.py, with its copies and waits; the dense path's kernel
calls), the profile run's PHASES["kernels"], per read pair, over the
traced window's samples."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "kernels")
