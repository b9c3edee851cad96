"""Distributed HNSW: per-shard subgraphs + one top-k merge (port of
reindexer_tpu/parallel/sharded_hnsw.py).

Each shard holds the HNSW graph of its row partition (built per shard, as
the reference's per-shard namespaces are); a query beams through every
shard's graph on that shard's device and the per-shard top-ef candidates
merge once (MeshContext.merge). The beam is the one-device beam
(ops/hnsw_kernels.py): descent through the shard's upper layers, then
layer 0 with expand 2 and 2 * ef iterations at most, over the exact fp32
rows (the reference's mesh tables are fp32 also for an SQ8 index).

`shard_hnsw_state` packs independently built HnswIndex partitions into the
reference's row-block layout (shard s owns rows [s * cap, (s + 1) * cap)),
for callers that hold the tables rather than the indexes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.type_consts import VectorMetric
from ..ops.hnsw_kernels import (DataPack, beam_search_layer, beam_steps,
                                greedy_descend)


def shard_beam(q: torch.Tensor, data: torch.Tensor, sq: torch.Tensor,
               links0: torch.Tensor, upper, entry: int, ef: int,
               metric: VectorMetric,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's beam: (scores f32[Q, ef], LOCAL ids i32[Q, ef], iters),
    -inf / -1 where empty; all -inf / -1 for a shard without an entry.
    iters is the beam's count (int32, 0 without an entry), for the caller
    to add to `beam_steps` once it is on the host. upper is the shard's
    top-first [Lu, cap, M] table or None."""
    dev = data.device
    q = q.to(dev)
    n_q = q.shape[0]
    if entry < 0:
        return (torch.full((n_q, ef), float("-inf"), device=dev),
                torch.full((n_q, ef), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    pack = DataPack(data, sq)
    ents = torch.full((n_q,), entry, dtype=torch.int32, device=dev)
    if upper is not None and upper.shape[0] > 0:
        ents = greedy_descend(q, pack, upper, ents, metric)
    s, i, it = beam_search_layer(q, pack, links0, ents[:, None], ef=ef,
                                 expand=2, max_iters=2 * ef, metric=metric)
    return s, i.to(torch.int32), it


def build_sharded_hnsw(mesh, ef: int, expand: int, metric: VectorMetric,
                       n_upper: int, shard_axis: str = "shards"):
    """fn(queries, data, sq, links0, upper, entries) -> (scores f32[Q, ef],
    GLOBAL ids i32[Q, ef]) over per-shard lists as shard_hnsw_state packs
    them (global id = shard * cap + local). expand is 2, as in the
    reference's mesh program; n_upper is implied by the tables."""
    from .context import MeshContext
    ctx = mesh if isinstance(mesh, MeshContext) else \
        MeshContext(mesh, shard_axis)
    assert expand == 2

    def fn(queries, data, sq, links0, upper, entries):
        cap = data[ctx.local_shards[0]].shape[0]
        parts, its = [], []
        for s in ctx.local_shards:
            sc, li, it = shard_beam(queries, data[s], sq[s], links0[s],
                                    upper[s], int(entries[s]), ef, metric)
            parts.append((sc, torch.where(li >= 0, li + s * cap, -1)))
            its.append(it)
        out = ctx.merge(parts, ef)
        beam_steps.add(int(torch.stack([x.to(out[0].device)
                                        for x in its]).sum()))
        return out

    return fn


def shard_hnsw_state(mesh, indexes: Sequence, cap: int,
                     shard_axis: str = "shards"):
    """Pack per-shard HnswIndex partitions into per-shard tables of `cap`
    rows each on the shard's device: (data, sq, links0, upper, entries,
    n_upper), lists by shard. Every index must have capacity <= cap;
    upper stacks pad with empty tables at the top to the deepest shard's
    n_upper (aligned at the bottom, layer 1 last)."""
    from .context import MeshContext
    ctx = mesh if isinstance(mesh, MeshContext) else \
        MeshContext(mesh, shard_axis)
    assert len(indexes) == ctx.n_shards
    n_upper = max((len(ix._upper) for ix in indexes), default=0)
    out = ([], [], [], [], [])
    for s, ix in enumerate(indexes):
        ix._commit()
        kcap = ix.keeper.capacity
        assert kcap <= cap, "shard capacity exceeds pack cap"
        dev = ctx.devices[s]
        data = np.zeros((cap, ix.dims), dtype=np.float32)
        sq = np.zeros(cap, dtype=np.float32)
        links0 = np.full((cap, ix.m0), -1, dtype=np.int32)
        upper = np.full((max(n_upper, 1), cap, ix.m), -1, dtype=np.int32)
        data[:kcap] = ix.keeper.data.cpu().numpy()
        sq[:kcap] = ix.keeper.sq.cpu().numpy()
        links0[:kcap] = ix._links0
        off = n_upper - len(ix._upper)
        for li, u in enumerate(ix._upper):
            upper[off + li, :kcap] = u
        for lst, a in zip(out[:4], (data, sq, links0,
                                    upper if n_upper else upper[:0])):
            lst.append(torch.from_numpy(a).to(dev))
        out[4].append(ix._entry)
    return (*out, n_upper)
