"""store_wait_us_per_pair: host seconds the main thread waits for the batch
engine's two store threads (profile/pipeline.py, span "store.wait", inside
"store"), per read pair, over the traced window's samples; none where the
program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "store.wait")
