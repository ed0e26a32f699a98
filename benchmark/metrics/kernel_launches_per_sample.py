"""kernel_launches_per_sample: launches of the hand-written kernels in one
profile run, the sum of the launch counters of kernels/cuda_sitestats.py,
cuda_compact.py, cuda_linkage.py and cuda_compare.py, reset before each
sample; the mean over the traced window's samples."""


def read(run):
    counted = [s.launches for s in run.samples if s.launches is not None]
    if not counted:
        return None
    return sum(counted) / len(counted)
