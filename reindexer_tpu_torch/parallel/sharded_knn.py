"""Distributed KNN: row-sharded base partitions + one top-k merge (port of
reindexer_tpu/parallel/sharded_knn.py).

Each shard scans its own rows on its own device with the kernels of one
device, then the per-shard candidates merge (MeshContext.merge): O(k * S)
values move, not the score rows.

  fp32   K1 `bf_scan` + K2 `bf_select` (ops.select.knn_scan_fused) on the
         shard's rows; a shard whose k exceeds K2's 128 slots (or its rows)
         takes the plain chunked scan (ops.distance.knn_scan, stable ties);
         a shard whose K2 selection overflows reruns that plain scan.
  SQ8    approx / approx_rerank: K3 `sq8_scan` in S mode + K2
         (ops.select.knn_scan_fused_sq8), the reference's mesh formula
         fac * (q.lo + q_alpha.codes) - |b|^2 (the query is not quantized,
         so not K5); overflow or k > 128 take the plain quantized scan.
         approx_rerank re-scores each shard's local top-k exactly BEFORE
         the merge, as the reference's mesh program does.

The engines dispatch every shard back to back and merge on the device; the
drain reads the merged top-k and the shards' overflow flags in one copy
(`MeshScan`). `build_sharded_knn` / `build_sharded_knn_sq8` keep the
reference's builders for callers that hold their own shard lists.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.type_consts import VectorMetric
from ..ops.distance import knn_scan
from ..ops.hnsw_kernels import _score_gathered
from ..ops.scan import BLK, SQ_EFF_BIG
from ..ops.select import S_SLOTS, knn_scan_fused, knn_scan_fused_sq8


def kernel_geometry(rows: int, k: int) -> bool:
    """True when K1/K3 + K2 take a shard of `rows` rows at k (else the
    plain scan): rows a multiple of 64 and 1 <= min(k, rows) <= 128."""
    return rows % BLK == 0 and min(k, rows) <= S_SLOTS


def _global(ids: torch.Tensor, lo: int) -> torch.Tensor:
    return torch.where(ids >= 0, ids + lo, -1)


def shard_topk(q: torch.Tensor, data: torch.Tensor, sq_eff: torch.Tensor,
               lo: int, k: int, metric: VectorMetric, plain: bool = False,
               ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """A shard's exact top-min(k, rows) with global ids: (scores, ids,
    flag f32[Q] or None when the plain scan ran)."""
    q = q.to(data.device)
    kk = min(k, data.shape[0])
    if not plain and kernel_geometry(data.shape[0], k):
        s, i, flag = knn_scan_fused(q, data, sq_eff, kk, metric)
        return s, _global(i, lo), flag
    s, i = knn_scan(q, data, sq_eff < SQ_EFF_BIG / 2, sq_eff, kk, metric)
    return s, _global(i, lo), None


def shard_topk_sq8(q: torch.Tensor, codes: torch.Tensor, lo_v: torch.Tensor,
                   alpha: torch.Tensor, data: torch.Tensor,
                   sq_eff: torch.Tensor, lo: int, k: int,
                   metric: VectorMetric, rerank: bool, plain: bool = False,
                   ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """A shard's top-min(k, rows) of the quantized scores (global ids),
    re-scored exactly in place (not re-sorted) when `rerank`."""
    from ..index.vector.quantization import knn_scan_quantized
    q = q.to(codes.device)
    kk = min(k, codes.shape[0])
    flag = None
    if not plain and kernel_geometry(codes.shape[0], k):
        s, i, flag = knn_scan_fused_sq8(q, codes, lo_v, alpha, sq_eff, kk,
                                        metric)
    else:
        s, i = knn_scan_quantized(q, codes, lo_v, alpha,
                                  sq_eff < SQ_EFF_BIG / 2, sq_eff, kk, metric)
    if rerank:
        # exact fp32 scores of the local candidates, on the shard
        ok = (i >= 0) & (s > float("-inf"))
        safe = torch.where(ok, i, 0).long()
        ex = _score_gathered(q, data[safe], sq_eff[safe], metric)
        s = torch.where(ok, ex, float("-inf"))
    return s, _global(i, lo), flag


class MeshScan:
    """One dispatched mesh scan. run(s, plain) -> (scores, global ids,
    flag or None) scans local shard s; every shard is dispatched back to
    back and the merge is queued on the merge device, so nothing waits on
    the device before the drain. `flag` stacks the shards' K2 overflow
    flags (f32[shards, Q]) for the drain's one copy, None when no kernel
    selection ran; `rerun(host_flag)` rescans the flagged shards with the
    plain scan and merges again. On a mesh that spans processes the flags
    are reduced (max) over the processes first, so all of them rerun and
    merge together."""

    def __init__(self, ctx, k: int, shards: list,
                 run: Callable[[int, bool], tuple]):
        self.ctx, self.k, self.shards, self._run = ctx, k, shards, run
        outs = [run(s, False) for s in shards]
        self.parts = [(s, i) for s, i, _ in outs]
        flags = [f for _, _, f in outs if f is not None]
        dev = ctx.merge_device
        self.flag = (torch.stack([f.to(dev) for f in flags])
                     if flags else None)
        if self.flag is not None and ctx.spans_processes:
            # every process must agree on a rerun (its merge is a
            # collective): shard j reruns where any process's shard j
            # flagged
            dist.all_reduce(self.flag, op=dist.ReduceOp.MAX)
        self.scores, self.ids = ctx.merge(self.parts, k)

    def rerun(self, host_flag: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        fl = np.asarray(host_flag).reshape(len(self.shards), -1)
        for j, s in enumerate(self.shards):
            if (fl[j] > 0).any():
                s_, i_, _ = self._run(s, True)
                self.parts[j] = (s_, i_)
        s, i = self.ctx.merge(self.parts, self.k)
        return s.cpu().numpy(), i.cpu().numpy()


def _sq_eff(valid: torch.Tensor, sq: torch.Tensor,
            metric: VectorMetric) -> torch.Tensor:
    base = sq if metric == VectorMetric.L2 else torch.zeros_like(sq)
    return torch.where(valid, base, torch.full_like(sq, SQ_EFF_BIG))


def _drain(scan: MeshScan) -> tuple[torch.Tensor, torch.Tensor]:
    if scan.flag is not None:
        fl = scan.flag.cpu().numpy()
        if (fl > 0).any():
            s, i = scan.rerun(fl)
            return torch.from_numpy(s), torch.from_numpy(i)
    return scan.scores, scan.ids


def build_sharded_knn(mesh, k: int, metric: VectorMetric,
                      shard_axis: str = "shards",
                      batch_axis: Optional[str] = None):
    """fn(queries, base, valid, sq) -> (scores f32[Q, k], GLOBAL ids
    i32[Q, k]): base / valid / sq are per-shard lists (parallel.mesh
    shard_rows), queries a tensor (or a replicate list). With a batch axis
    the queries split into that axis's blocks, block b scanned on the
    devices of mesh row b and merged on its first."""
    ctxs = _batch_contexts(mesh, shard_axis, batch_axis)

    def fn(queries, base, valid, sq):
        q_all = queries[0] if isinstance(queries, (list, tuple)) \
            else queries
        sq_eff = [None if b is None else _sq_eff(v.to(b.device),
                                                 s.to(b.device), metric)
                  for b, v, s in zip(base, valid, sq)]
        per = base[next(i for i, b in enumerate(base) if b is not None)
                   ].shape[0]
        outs = []
        for ctx, rows in zip(ctxs, np.array_split(
                np.arange(q_all.shape[0]), len(ctxs))):
            q = q_all[torch.from_numpy(rows).to(q_all.device)]

            def run(s, plain, ctx=ctx, q=q):
                dev = ctx.devices[s]
                return shard_topk(q.to(dev), base[s].to(dev),
                                  sq_eff[s].to(dev), s * per, k, metric,
                                  plain)

            outs.append(_drain(MeshScan(ctx, k, ctx.local_shards, run)))
        dev = ctxs[0].merge_device
        return (torch.cat([o[0].to(dev) for o in outs]),
                torch.cat([o[1].to(dev) for o in outs]))

    return fn


def build_sharded_knn_sq8(mesh, k: int, metric: VectorMetric,
                          shard_axis: str = "shards", rerank: bool = False):
    """fn(q, codes, lo, alpha, base, valid, sq) -> (scores, GLOBAL ids):
    codes / base / valid / sq per-shard lists, lo / alpha f32[D]."""
    ctx = _batch_contexts(mesh, shard_axis, None)[0]

    def fn(q, codes, lo, alpha, base, valid, sq):
        per = codes[ctx.local_shards[0]].shape[0]

        def run(s, plain):
            dev = ctx.devices[s]
            return shard_topk_sq8(
                q.to(dev), codes[s].to(dev), lo.to(dev), alpha.to(dev),
                base[s].to(dev),
                _sq_eff(valid[s].to(dev), sq[s].to(dev), metric), s * per,
                k, metric, rerank, plain)

        return _drain(MeshScan(ctx, k, ctx.local_shards, run))

    return fn


def _batch_contexts(mesh, shard_axis: str, batch_axis: Optional[str]):
    """One MeshContext a block of the batch axis (one for no batch axis):
    the shard axis's devices at that batch index."""
    from .context import MeshContext
    from .mesh import Mesh
    if not isinstance(mesh, Mesh):
        return [mesh]                       # already a MeshContext
    if batch_axis is None:
        return [MeshContext(mesh, shard_axis)]
    a = mesh.axis_names.index(shard_axis)
    b = mesh.axis_names.index(batch_axis)
    devs = np.moveaxis(mesh.devices, (a, b), (0, 1))
    return [MeshContext(Mesh(devs[:, j].reshape(-1), (shard_axis,),
                             mesh.world, mesh.rank), shard_axis)
            for j in range(devs.shape[1])]
