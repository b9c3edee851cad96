"""Mesh context: the engine-integrated sharding plane (port of
reindexer_tpu/parallel/context.py).

`Reindexer(mesh=ctx)` hands the context to every namespace, which passes it
to the indexes it creates: the vector engines (BF, IVF, HNSW) and full text
then keep their device state row-sharded over the context's devices and
answer the same `select` / `select_batch` calls by scanning every shard and
merging the per-shard top-k (`merge`).

The context holds a list of torch devices, one a shard, and a device may
repeat: `MeshContext(["cpu"] * 8)` runs eight shards on the CPU,
`make_mesh_context(4)` four shards of the visible cards (cycled when there
are fewer cards than shards). Shards are dispatched back to back and only
the drain waits on the device, as with one device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..ops.distance import stable_topk
from .mesh import DeviceLike, Mesh, _shard_devices, default_devices
from .mesh import replicate as _replicate
from .mesh import shard_rows as _shard_rows


class MeshContext:
    """A device mesh and the axis the indexes shard their rows over.

    `mesh` is a `Mesh` or a plain list of devices (one shard each)."""

    def __init__(self, mesh: Union[Mesh, Sequence[DeviceLike]],
                 shard_axis: str = "shards"):
        if not isinstance(mesh, Mesh):
            mesh = Mesh(list(mesh), (shard_axis,))
        self.mesh = mesh
        self.shard_axis = shard_axis
        # one entry a shard: its device, or None for another process's
        self.devices = _shard_devices(mesh, shard_axis)
        self.local_shards = [s for s, d in enumerate(self.devices)
                             if d is not None]

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[self.local_shards[0]].type

    @property
    def merge_device(self) -> torch.device:
        """Where the per-shard candidates meet: the first local shard's
        device."""
        return self.devices[self.local_shards[0]]

    @property
    def spans_processes(self) -> bool:
        return self.mesh.world > 1

    def shard_rows(self, x) -> list:
        """Row-split x over the shards, each block a tensor of its own on
        its shard's device (None for another process's shard)."""
        return _shard_rows(self.mesh, x, self.shard_axis)

    def replicate(self, x) -> list:
        return _replicate(self.mesh, x, self.shard_axis)

    def merge(self, parts: list, k: int,
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The global top-k of the local shards' candidates: parts is one
        (scores f32[Q, kk], GLOBAL ids [Q, kk]) pair a local shard, in shard
        order, each sorted by (score desc, id asc). They move to the merge
        device and concatenate in shard order (across processes, one
        all_gather in rank order), so among equal scores the lower shard,
        then the lower local row, wins: the reference's all_gather +
        lax.top_k. Returns (scores f32[Q, k], ids i32[Q, k]), -inf / -1
        where fewer than k candidates are valid."""
        dev = self.merge_device
        all_s = torch.cat([s.to(dev) for s, _ in parts], dim=1)
        all_i = torch.cat([i.to(dev).to(torch.int32) for _, i in parts],
                          dim=1)
        if self.spans_processes:
            all_s, all_i = (self._gather_processes(all_s),
                            self._gather_processes(all_i))
        best_s, pos = stable_topk(all_s, min(k, all_s.shape[1]))
        best_i = torch.gather(all_i, 1, pos)
        best_i = torch.where(best_s > float("-inf"), best_i, -1)
        if best_s.shape[1] < k:
            pad = k - best_s.shape[1]
            best_s = torch.nn.functional.pad(best_s, (0, pad),
                                             value=float("-inf"))
            best_i = torch.nn.functional.pad(best_i, (0, pad), value=-1)
        return best_s, best_i.to(torch.int32)

    def _gather_processes(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's x [Q, C], concatenated along C in rank order."""
        out = [torch.empty_like(x) for _ in range(self.mesh.world)]
        dist.all_gather(out, x.contiguous())
        return torch.cat(out, dim=1)


def make_mesh_context(n_shards: Optional[int] = None,
                      devices: Optional[Sequence[DeviceLike]] = None,
                      shard_axis: str = "shards") -> MeshContext:
    """A context of n_shards shards over `devices` (default: the visible
    CUDA devices; raises when there is none), cycled: make_mesh_context(8)
    on one card puts eight shards on cuda:0, on eight cards one on each."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else default_devices()
    n = len(devs) if n_shards is None else n_shards
    return MeshContext([devs[s % len(devs)] for s in range(n)], shard_axis)
