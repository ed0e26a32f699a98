"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the device: 100 * (1 - busy / window), busy the
union of the device intervals of torch.profiler's CUDA activity."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
