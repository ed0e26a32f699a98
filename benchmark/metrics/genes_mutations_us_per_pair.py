"""genes_mutations_us_per_pair: host seconds of the SNVs' mutation types
(profile/genes.py:characterize_snps_wrapper, span "genes.mutations", inside
"genes"), per read pair, over the traced window's samples; none where the
program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "genes.mutations")
