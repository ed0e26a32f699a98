"""
Multi-process execution of `profile` over torch.distributed: the
counterpart of instrain_tpu/parallel/distributed.py.

Each process owns a subset of the scaffolds (a greedy balance by filtered
pairs, or by the .bai's byte extents before any decode:
profile/pipeline.py:_plan_sharded_decode), decodes and profiles only
those, and the per-scaffold payloads meet in one gather before the tables
are assembled. Every payload that crosses processes is host data (pickled
tables and numpy arrays): no device tensor crosses, so the process group
is gloo, on the CPU, also on GPU hosts, and it is created with a timeout,
so that a dead peer fails the run instead of hanging it.

Processes find each other through the environment that torchrun sets:
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT.
"""

from __future__ import annotations

import datetime
import os
import pickle
import zlib
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective waits for its peers before it fails the run; the
# result gather waits out the slowest process's profiling
DEFAULT_TIMEOUT_S = 3600.0


def init_distributed(timeout_s: float = None) -> bool:
    """Join the process group that RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT describe (gloo, with a timeout of timeout_s seconds, by
    default INSTRAIN_DIST_TIMEOUT or DEFAULT_TIMEOUT_S). A run of one
    process (WORLD_SIZE unset or 1) joins nothing. Returns whether a group
    of several processes is up."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if not dist.is_initialized():
        if timeout_s is None:
            timeout_s = float(os.environ.get("INSTRAIN_DIST_TIMEOUT",
                                             DEFAULT_TIMEOUT_S))
        dist.init_process_group(
            "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    return process_count() > 1


def shutdown_distributed() -> None:
    """Leave the process group, where there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def assign_scaffolds_to_hosts(scaffold_pairs: Dict[str, int],
                              n_hosts: int) -> List[List[str]]:
    """Greedy balanced assignment of scaffolds to hosts by weight
    (filtered pairs, or .bai bytes): largest first, each into the
    lightest bin (the first of equal ones), a bin's load growing by the
    weight plus one."""
    order = sorted(scaffold_pairs, key=scaffold_pairs.get, reverse=True)
    loads = [0] * n_hosts
    bins: List[List[str]] = [[] for _ in range(n_hosts)]
    for s in order:
        i = int(np.argmin(loads))
        bins[i].append(s)
        loads[i] += scaffold_pairs[s] + 1
    return bins


def my_scaffolds(scaffold_pairs: Dict[str, int]) -> List[str]:
    """The scaffolds this process owns under the canonical assignment."""
    return assign_scaffolds_to_hosts(scaffold_pairs,
                                     process_count())[process_index()]


def allgather_tables(local_tables: list) -> list:
    """Every process's list of tables, concatenated in process order, on
    every process; a run of one process returns its input. Each list
    crosses as one zlib-compressed (level 1) pickle, in two gathers: the
    sizes, then the payloads padded to the largest; the local list is
    reused as it is."""
    n = process_count()
    if n == 1:
        return local_tables
    blob = zlib.compress(pickle.dumps(local_tables, protocol=5), 1)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([len(blob)], dtype=torch.int64))
    sizes = [int(t) for t in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8)
    if blob:
        padded[:len(blob)] = torch.frombuffer(bytearray(blob),
                                              dtype=torch.uint8)
    bufs = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(bufs, padded)
    me = process_index()
    out = []
    for i, (buf, size) in enumerate(zip(bufs, sizes)):
        if i == me:
            out.extend(local_tables)
        else:
            out.extend(pickle.loads(zlib.decompress(
                buf[:size].numpy().tobytes())))
    return out
