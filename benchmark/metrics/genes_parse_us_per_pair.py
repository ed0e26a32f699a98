"""genes_parse_us_per_pair: host seconds of the genes file's parse
(profile/genes.py:parse_genes, span "genes.parse", inside "genes"), per
read pair, over the traced window's samples; none where the program records
no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genes.parse")
