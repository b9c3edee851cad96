"""The control: the plain reference put in the program's place, computed in
the precision next below the configuration's fp32, which is TF32 (a
10-bit mantissa on the tensor cores' inputs). The comparison has to find
it not correct. Each product's inputs are rounded to TF32 and multiplied
in fp32 with TF32 off, which is what a TF32 matrix product computes, on
the card and on the CPU alike. For cosine, rows and queries are first
normalised in fp32 (a zero row stays zero), and the rank is the product.

It takes the rows the harness made from the seed, never the program's
tensors, and answers through the engine's interface
(`select_batch_async`), so the facade, the executor, dynbatch and result
assembly around it are the program's own.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def unit(x: torch.Tensor) -> torch.Tensor:
    """Each row of x (float32) over its norm; a zero row stays zero."""
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norm == 0.0, torch.ones_like(norm), norm)


@dataclass
class Answer:
    ids: np.ndarray
    ranks: np.ndarray
    ordering: object


class Tf32Reference:
    """Exact k-nearest neighbours with TF32 products, on `device`."""

    def __init__(self, rows: np.ndarray, metric: str, device, ordering):
        self.metric = metric
        self.ordering = ordering
        self.device = torch.device(device)
        self.base = tf32(self._scored(torch.from_numpy(rows)))
        self.base_sq = (self.base * self.base).sum(1)

    def _scored(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device)
        return unit(x) if self.metric == "cosine" else x

    def select_batch_async(self, queries, params):
        q = tf32(self._scored(torch.from_numpy(
            np.asarray(queries, dtype=np.float32))))
        prod = q @ self.base.T
        if self.metric == "l2":
            score = -(self.base_sq[None, :] - 2.0 * prod
                      + (q * q).sum(1)[:, None])
        else:
            score = prod
        s, i = torch.topk(score, params.k, dim=1)
        ranks = (-s if self.metric == "l2" else s).cpu().numpy()
        ids = i.cpu().numpy().astype(np.int64)

        def drain():
            return [Answer(ids[b], ranks[b], self.ordering)
                    for b in range(len(ids))]
        return drain
