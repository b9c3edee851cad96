"""Distance scans in PyTorch: the port of reindexer_tpu/ops/distance.py.

Scores are "higher is better": inner product / cosine use the similarity,
L2 the negated squared distance. `scores_to_ranks` turns a score back into
the reference's rank value.

`knn_scan` is the plain chunked scan (`torch.matmul` + `torch.topk`). The
engine runs it where the hand-written kernels do not apply (k > 128) and to
rerun a query whose kernel selection overflowed. The JAX package's
`onehot_take` / `exact_topk_blocks` are not ported: they work around slow
gathers on the TPU, and `torch.topk` does their job here.
"""
from __future__ import annotations

import numpy as np
import torch

from reindexer_tpu.core.type_consts import RankOrdering, VectorMetric


def metric_ordering(metric: VectorMetric) -> RankOrdering:
    """Rank ordering per metric: L2 ascending, IP/cosine descending."""
    return RankOrdering.ASC if metric == VectorMetric.L2 else RankOrdering.DESC


def scores_to_ranks(scores: np.ndarray, metric: VectorMetric) -> np.ndarray:
    """Convert higher-is-better scores to reference rank values."""
    if metric == VectorMetric.L2:
        return -scores   # score = -l2^2 -> rank = l2^2
    return scores


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Row-normalize for the cosine metric (zero rows stay zero)."""
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    norms = np.where(norms == 0.0, 1.0, norms)
    return x / norms


def _chunk_scores(q: torch.Tensor, base: torch.Tensor, base_sq: torch.Tensor,
                  metric: VectorMetric) -> torch.Tensor:
    """[Q, D] x [C, D] -> [Q, C] higher-is-better scores."""
    dots = q @ base.T
    if metric == VectorMetric.L2:
        return (2.0 * dots - base_sq[None, :]
                - (q * q).sum(dim=1, keepdim=True))
    return dots


def knn_scan(queries: torch.Tensor, base: torch.Tensor, valid: torch.Tensor,
             base_sq: torch.Tensor, k: int, metric: VectorMetric,
             chunk: int = 262144) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force KNN: (scores f32[Q, k], ids i32[Q, k]), best first,
    padded with -inf / -1. base f32[N, D]; valid bool[N]; base_sq f32[N]
    (|b|^2, read for L2 only). Each chunk of `chunk` base rows is scored by
    one matmul and its top-k merged into the running top-k, so the [Q, N]
    score matrix is never whole."""
    q = queries.to(torch.float32)
    return chunked_topk(
        base.shape[0], q, k, chunk,
        lambda rows: _chunk_scores(q, base[rows], base_sq[rows], metric),
        valid)


def chunked_topk(n: int, q: torch.Tensor, k: int, chunk: int, scores_of,
                 valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked top-k loop of knn_scan over n rows: scores_of(rows) ->
    f32[Q, len(rows)] scores a slice of rows, valid bool[n] masks them, and
    each chunk's top-k merges into the running top-k. Returns (scores
    f32[Q, k], ids i32[Q, k]), best first, -inf / -1 padded."""
    n_q = q.shape[0]
    best_s = torch.full((n_q, k), float("-inf"), dtype=torch.float32,
                        device=q.device)
    best_i = torch.full((n_q, k), -1, dtype=torch.int64, device=q.device)
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        s = scores_of(slice(start, end))
        s = s.masked_fill(~valid[None, start:end], float("-inf"))
        loc_s, loc_i = torch.topk(s, min(k, end - start), dim=1)
        merged_s = torch.cat([best_s, loc_s], dim=1)
        merged_i = torch.cat([best_i, loc_i + start], dim=1)
        best_s, sel = torch.topk(merged_s, k, dim=1)
        best_i = torch.gather(merged_i, 1, sel)
    best_i = torch.where(best_s > float("-inf"), best_i, -1)
    return best_s, best_i.to(torch.int32)


def pairwise_scores(queries: torch.Tensor, base: torch.Tensor,
                    valid: torch.Tensor, base_sq: torch.Tensor,
                    metric: VectorMetric) -> torch.Tensor:
    """Full [Q, N] higher-is-better score matrix, -inf for invalid rows
    (the radius-only path)."""
    s = _chunk_scores(queries.to(torch.float32), base, base_sq, metric)
    return s.masked_fill(~valid[None, :], float("-inf"))
