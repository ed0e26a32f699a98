"""tables_views_us_per_pair: host seconds of a scaffold's covT, clonT and
clonTR views and its reads-to-SNVs (profile/pipeline.py:_finalize_result,
span "tables.views", inside "tables"), per read pair, over the traced
window's samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "tables.views")
