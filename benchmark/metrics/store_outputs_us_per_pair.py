"""store_outputs_us_per_pair: host seconds of the five output tables
(store/generate.py, span "store.outputs", inside "store"), per read pair,
over the traced window's samples; none where the program records no such
span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "store.outputs")
