"""tables_us_per_pair: host seconds of the SNV, scaffold and linkage tables
and host linkage (profile/tables.py, profile/linkage.py), the profile
run's PHASES["tables"], per read pair, over the traced window's samples."""

from benchmark.harness.phases import us_per_pair


def read(run):
    return us_per_pair(run, "tables")
