"""registry_us_per_pair: host seconds of a profile run's set-up on its main
thread: the FASTA registry, the reference sequences, the LUTs and the
run's log handler (profile/pipeline.py, span "registry"), per read pair,
over the traced window's samples; none where the program records no such
span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "registry")
