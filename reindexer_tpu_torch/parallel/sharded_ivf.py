"""Distributed IVF: row-sharded lists + replicated centroids + one top-k
merge (port of reindexer_tpu/parallel/sharded_ivf.py).

Stage 1 (the centroid probe) runs once, on the merge device: the centroid
table is small and the same for every shard. Stage 2 scans each shard's
rows with the probe-mask formulation (a row counts when its list is
probed), and the per-shard top-k merge (MeshContext.merge).

The probe-mask stage 2, not K6's segment reorder, is the sharded
formulation on purpose, as in the reference: each shard's rows hold
fragments of every inverted list, so a per-shard list-contiguous reorder
would need a global shuffle on every rebuild; the masked scan needs none
and its cost is already split S ways. It is plain PyTorch, as the
reference's is plain XLA (no Pallas site lies on this path).
"""
from __future__ import annotations

import torch

from ..core.type_consts import VectorMetric
from ..ops.distance import _chunk_scores, chunked_topk
from ..ops.scan import SQ_EFF_BIG


def probe_mask(probes: torch.Tensor, nlist: int) -> torch.Tensor:
    """[B, P] probed centroid ids -> bool[B, nlist] membership table (port
    of ops/ivf_kernels.py::probe_mask)."""
    m = torch.zeros((probes.shape[0], nlist), dtype=torch.bool,
                    device=probes.device)
    return m.scatter_(1, probes.long(), True)


def scan_probed_full(q: torch.Tensor, data: torch.Tensor,
                     sq_eff: torch.Tensor, assign: torch.Tensor,
                     sel: torch.Tensor, k: int, metric: VectorMetric,
                     chunk: int = 262144,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 as a masked scan of rows data f32[N, D] (port of
    ops/ivf_kernels.py::scan_probed_full): row r counts for query b when
    it is valid (sq_eff below SQ_EFF_BIG / 2), assigned (assign[r] >= 0)
    and its list probed (sel[b, assign[r]]). Returns the top-min(k, N)
    (scores, local ids), -inf / -1 padded, ties to the lower row."""
    valid = (sq_eff < SQ_EFF_BIG / 2) & (assign >= 0)
    safe = assign.clamp_min(0).long()

    def scores_of(rows):
        s = _chunk_scores(q, data[rows], sq_eff[rows], metric)
        return s.masked_fill(~sel[:, safe[rows]], float("-inf"))

    return chunked_topk(data.shape[0], q, min(k, data.shape[0]), chunk,
                        scores_of, valid)


def shard_probed_topk(q: torch.Tensor, data: torch.Tensor,
                      sq_eff: torch.Tensor, assign: torch.Tensor,
                      sel: torch.Tensor, lo: int, k: int,
                      metric: VectorMetric,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's probe-masked top-k with global ids, on the shard's
    device."""
    dev = data.device
    s, i = scan_probed_full(q.to(dev), data, sq_eff, assign,
                            sel.to(dev), k, metric)
    return s, torch.where(i >= 0, i + lo, -1)


def build_sharded_ivf(mesh, k: int, metric: VectorMetric,
                      shard_axis: str = "shards"):
    """fn(queries, base, sq, valid, assign, sel) -> (scores f32[B, k],
    GLOBAL row ids i32[B, k], -1 padded): base / sq / valid / assign are
    per-shard lists, sel (bool[B, nlist], stage 1's probe membership) one
    tensor."""
    from .context import MeshContext
    from .sharded_knn import _sq_eff
    ctx = mesh if isinstance(mesh, MeshContext) else \
        MeshContext(mesh, shard_axis)

    def fn(queries, base, sq, valid, assign, sel):
        per = base[ctx.local_shards[0]].shape[0]
        parts = []
        for s in ctx.local_shards:
            dev = base[s].device
            parts.append(shard_probed_topk(
                queries, base[s], _sq_eff(valid[s].to(dev), sq[s].to(dev),
                                          metric),
                assign[s].to(dev), sel, s * per, k, metric))
        return ctx.merge(parts, k)

    return fn
