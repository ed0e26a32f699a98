"""genes_us_per_pair: host seconds of gene profiling with -g
(profile/genes.py, span "genes": the genes file's parse, at the top level,
and each scaffold's genes, inside "tables"), per read pair, over the traced
window's samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genes")
