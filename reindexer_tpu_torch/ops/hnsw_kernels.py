"""Graph-search device helpers (port of reindexer_tpu/ops/hnsw_kernels.py).

Only `exact_rescore` is ported so far: the SQ8 brute-force index's
approx_rerank mode needs it. It is plain PyTorch (a gather, a batched dot and
a top-k), as the JAX version is plain XLA; there is no Pallas kernel here.
The HNSW beam search of the same JAX module is ported with the HNSW index
(see ROADMAP).
"""
from __future__ import annotations

import torch

from reindexer_tpu.core.type_consts import VectorMetric


def _score_gathered(q: torch.Tensor, vecs: torch.Tensor, vec_sq: torch.Tensor,
                    metric: VectorMetric) -> torch.Tensor:
    """q [Q, D], vecs [Q, K, D], vec_sq [Q, K] -> scores [Q, K]
    (higher-better)."""
    dots = torch.einsum("qkd,qd->qk", vecs, q)
    if metric == VectorMetric.L2:
        return 2.0 * dots - vec_sq - (q * q).sum(dim=1, keepdim=True)
    return dots


def exact_rescore(queries: torch.Tensor, data: torch.Tensor,
                  data_sq: torch.Tensor, ids: torch.Tensor,
                  scores_in: torch.Tensor, metric: VectorMetric,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank quantized results exactly: gather the K returned rows of the
    fp32 `data` [N, D] for each query, score them exactly, sort best first.

    queries f32[Q, D]; data_sq f32[N] (|b|^2, read for L2 only); ids i32[Q,
    K] (-1 pad); scores_in f32[Q, K] (their quantized scores, read only to
    mask padding). Returns (scores f32[Q, K], ids i32[Q, K]), -inf / -1
    padded."""
    q = queries.to(torch.float32)
    valid = (ids >= 0) & (scores_in > float("-inf"))
    safe = torch.where(valid, ids, 0).to(torch.int64)
    s = _score_gathered(q, data[safe], data_sq[safe], metric)
    s = torch.where(valid, s, float("-inf"))
    s2, pos = torch.topk(s, s.shape[1], dim=1)
    ids2 = torch.gather(ids, 1, pos)
    ids2 = torch.where(s2 > float("-inf"), ids2, -1).to(torch.int32)
    return s2, ids2
