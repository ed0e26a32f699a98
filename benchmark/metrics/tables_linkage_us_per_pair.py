"""tables_linkage_us_per_pair: host seconds of linkage, host numpy or the
device `ld` kernel (profile/linkage.py:calculate_linkage, span
"tables.linkage", inside "tables"), per read pair, over the traced
window's samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "tables.linkage")
