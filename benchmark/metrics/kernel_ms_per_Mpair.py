"""kernel_ms_per_Mpair: device time of kernels (copies and memsets left
out) in the traced window, from torch.profiler's CUDA activity, per
million read pairs of the window's samples."""


def read(run):
    if run.trace is None or not run.pairs:
        return None
    return run.trace["kernel_s"] * 1e3 / (run.pairs / 1e6)
