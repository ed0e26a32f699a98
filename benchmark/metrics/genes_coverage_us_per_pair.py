"""genes_coverage_us_per_pair: host seconds of the genes' coverage, breadth
and clonality (profile/genes.py:calc_gene_coverage and calc_gene_clonality,
span "genes.coverage", inside "genes"), per read pair, over the traced
window's samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genes.coverage")
