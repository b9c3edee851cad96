"""Device meshes for sharded index partitions (port of
reindexer_tpu/parallel/mesh.py).

A `Mesh` is an array of torch devices with named axes. A device may repeat:
`["cpu"] * 8` is an 8-shard mesh on the CPU, `["cuda:0"] * 4` a 4-shard
mesh on one card, and every shard still owns its rows as tensors of its
own (shard_rows copies). Where the reference's collectives ride ICI inside
`shard_map`, each shard here runs its scan on its own device and the
per-shard candidates move to the merge device (the first local shard's)
for one stable top-k: O(k * n_shards) values, not the score rows.

A mesh may span processes (init_distributed, then make_mesh): each process
holds the shards of its own devices, ranks in order, and the merge
all-gathers the processes' candidates with torch.distributed (gloo on the
CPU, NCCL across cards).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device]


class Mesh:
    """devices: an array of torch devices, one axis per name. On a mesh that
    spans processes, the array holds this process's devices, and the shard
    axis counts `world` times as many shards, this process's at
    [rank * local, (rank + 1) * local)."""

    def __init__(self, devices, axis_names: Sequence[str] = ("shards",),
                 world: int = 1, rank: int = 0):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        shape = np.shape(np.asarray(devices, dtype=object))
        if len(shape) != len(axis_names):
            shape = (len(flat),) + (1,) * (len(axis_names) - 1)
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.world = world
        self.rank = rank

    @property
    def shape(self) -> dict:
        """Axis sizes by name; the first axis counts every process's rows."""
        sizes = list(self.devices.shape)
        sizes[0] *= self.world
        return dict(zip(self.axis_names, sizes))

    def axis_devices(self, axis: str) -> list:
        """This process's devices along `axis` (index 0 on the others)."""
        a = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[a]):
            idx[a] = i
            out.append(self.devices[tuple(idx)])
        return out


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join this process to a process-spanning mesh: torch.distributed over
    tcp://<coordinator_address>, gloo when there is no card, NCCL when
    there is. Arguments default from RX_DIST_COORDINATOR /
    RX_DIST_NUM_PROCESSES / RX_DIST_PROCESS_ID; a single-process
    configuration is a no-op (returns False). Afterwards make_mesh()
    builds meshes that span the processes."""
    coordinator_address = coordinator_address or os.environ.get(
        "RX_DIST_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("RX_DIST_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RX_DIST_PROCESS_ID", "0"))
    if num_processes <= 1 or not coordinator_address:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def default_devices() -> list:
    """The visible CUDA devices; raises when there is none (a mesh never
    drops to the CPU quietly: pass devices=["cpu"] * n for that)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible: pass the mesh's devices explicitly "
            "(e.g. devices=['cpu'] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("shards",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over `devices` (default: the visible CUDA devices), the
    first n_devices of them. After init_distributed the mesh spans every
    process, each contributing these devices."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else default_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(arr.reshape(tuple(shape)), axis_names, world, rank)


def _shard_devices(mesh: Mesh, axis: str) -> list:
    """One entry a shard over every process: the device of this process's
    shards, None for another process's."""
    local = mesh.axis_devices(axis)
    out: list = [None] * (len(local) * mesh.world)
    out[mesh.rank * len(local): (mesh.rank + 1) * len(local)] = local
    return out


def shard_rows(mesh: Mesh, x, axis: str = "shards") -> list:
    """Split an [N, ...] array or tensor into the mesh's row blocks along
    `axis`: shard s gets rows [s * N / S, (s + 1) * N / S) as a tensor of
    its own on its device (None for another process's shard)."""
    devs = _shard_devices(mesh, axis)
    t = torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    n = t.shape[0]
    if n % len(devs):
        raise ValueError(f"{n} rows do not split over {len(devs)} shards")
    per = n // len(devs)
    return [None if d is None else
            t[s * per:(s + 1) * per].to(d, copy=True)
            for s, d in enumerate(devs)]


def replicate(mesh: Mesh, x, axis: str = "shards") -> list:
    """A copy of x on every shard's device (None for another process's)."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    return [None if d is None else t.to(d, copy=True)
            for d in _shard_devices(mesh, axis)]


def global_put(mesh: Mesh, x: np.ndarray, spec: Optional[str]) -> list:
    """This process's part of a (possibly process-spanning) global array
    that every process holds identically: row-split over the axis `spec`
    names, or replicated for spec None. A single-process mesh gets every
    shard."""
    if spec is None:
        return replicate(mesh, x)
    return shard_rows(mesh, x, spec)


def pad_rows_to_multiple(x: np.ndarray, multiple: int,
                         fill=0) -> np.ndarray:
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad_shape = (target - n,) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)])
