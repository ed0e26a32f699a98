"""
Multi-GPU placement of the profile kernels: the counterpart of
instrain_tpu/parallel/mesh.py over torch devices.

A mesh is an ordered list of devices, and it is an execution placement,
not a separate code path: the shards run the same kernels as one device
(kernels/cuda_sitestats.py, kernels/cuda_compact.py) and the merged
results are bit-identical to the one-device run. Two plans:

- position split (the hybrid engine, one scaffold at a time): contiguous
  shards of a scaffold's position axis, one per device, each with its
  base position. Every site statistic is position-local; the rarefied
  draws are keyed by the scaffold's own position (the shard's base plus
  the position in the shard, csrc/clonr.cu), as the JAX package keys
  them by global position. The caller merges the shards
  (profile/compact.py:_dispatch_sharded).
- scaffold split (the batch engine): the engine's chunks go to the
  devices in turn, chunk k to device k mod n, and their results come
  back in dispatch order.

On the CPU a mesh is n shards on the one CPU device (the counterpart of
the JAX tests' virtual CPU devices), so the CPU tests reach the same
code. A mesh may repeat a device (two shards on one card); the CLI never
builds such a mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def resolve_device(name: str) -> torch.device:
    """--device -> torch.device. "cuda" is the current CUDA device and
    needs a GPU: there is no CPU fallback."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device {name!r} (cuda or cpu)")


def default_device(device=None) -> torch.device:
    """The device of an engine call: `device` as given, or the current
    CUDA device when it is None (raises without a GPU)."""
    return resolve_device("cuda") if device is None else torch.device(device)


class Mesh:
    """A 1-D device mesh: an ordered tuple of torch devices."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def position_split(self, L: int) -> List[Tuple[torch.device, int, int]]:
        """(device, first, end) of each non-empty shard of an axis of L
        positions: contiguous runs of ceil(L / size) positions, in device
        order."""
        step = -(-L // self.size)
        return [(d, a, min(a + step, L))
                for d, a in zip(self.devices, range(0, L, step))]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, devices=None,
              device_type: str = "cuda") -> Mesh:
    """A mesh of `devices` as given (a device may repeat), or of
    n_devices devices: on "cpu" n shards of the CPU, on "cuda" the
    n_devices cards from the current one on (cuda:k ... cuda:k+n-1, k the
    current device: 0 unless the process chose another). Raises when
    those cards do not exist: it never falls back to fewer."""
    if devices is not None:
        return Mesh(devices)
    if device_type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    first = torch.cuda.current_device() if have else 0
    n = have - first if n_devices is None else n_devices
    if n < 1 or first + n > have:
        raise ValueError(f"need {first + max(n, 1)} devices, have {have}")
    return Mesh([torch.device("cuda", first + i) for i in range(n)])
