"""store_genes_us_per_pair: host seconds of storing the gene tables
(profile/genes.py:store_gene_tables, span "store.genes", inside "store"),
per read pair, over the traced window's samples; none where the program
records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "store.genes")
