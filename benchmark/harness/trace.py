"""
Reduction of a torch.profiler trace of the measured window (CPU and CUDA
activities) to what the per-layer metrics and the result's `breakdown`
read: the device's busy time (the union of kernel, copy and memset
intervals), kernel time, the device operations that took most time, and
the longest idle gaps of the device, each labelled by the host-side
profiler event that began last before it. The window is the span of the
`bench.sample` ranges run.py opens around each sample.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SAMPLE = "bench.sample"


def reduce_trace(path: str, top: int = 10) -> Dict:
    """Reads the chrome trace at `path` (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host, samples = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""), cat))
        elif e.get("name") == SAMPLE:
            samples.append((ts, ts + dur))
        elif cat in HOST_CATS:
            host.append((ts, e.get("name", "")))
    if not samples:
        raise ValueError("no bench.sample range in the trace")
    w0 = min(s for s, _ in samples)
    w1 = max(e for _, e in samples)
    dev = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in dev
           if b > w0 and a < w1]
    dev.sort()
    merged: List[List[float]] = []
    for a, b, _, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    kernel_us = sum(b - a for a, b, _, c in dev if c == "kernel")
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n, _ in dev:
        by_name[n] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    host_ts = [t for t, _ in host]

    def label(t0: float) -> str:
        i = bisect.bisect_right(host_ts, t0) - 1
        return "after " + host[i][1] if i >= 0 else "before any host op"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return dict(
        busy_s=busy_us * 1e-6,
        kernel_s=kernel_us * 1e-6,
        device_ops=[[n, us * 1e-6] for n, us in ops],
        idle_gaps=[[label(a), (b - a) * 1e-6] for a, b in longest])


def export(prof, path: str) -> Dict:
    prof.export_chrome_trace(path)
    try:
        return reduce_trace(path)
    finally:
        os.remove(path)
