"""engine_wait_us_per_pair: host seconds the engine loop waits for a chunk's
copy to land (profile/compact.py:_finish_chunk, span "kernels.wait",
inside "kernels"), per read pair, over the traced window's samples; none
where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "kernels.wait")
