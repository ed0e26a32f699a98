"""store_threads_us_per_pair: seconds of the batch engine's two store
threads, the read results and the covT/clonT/clonTR writes
(profile/pipeline.py, spans "store_reads" and "special_stream"), which
overlap the main thread, per read pair, over the traced window's samples;
none where the program records no such span."""

from benchmark.harness.steps import step_us_per_pair


def read(run):
    return step_us_per_pair(run, "store_reads", "special_stream")
