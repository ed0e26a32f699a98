"""genes_counts_us_per_pair: host seconds of the genes' SNV counts, sites,
dN/dS and pN/pS (profile/genes.py:calc_gene_snp_counts, span
"genes.counts", inside "genes"), per read pair, over the traced window's
samples; none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genes.counts")
