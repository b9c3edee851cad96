"""The plain reference: exact k-nearest neighbours in float64 with NumPy.

It imports nothing of the program. It gets the rows and queries the
harness made from the seed, works out the exact top-k of each query again,
and rebuilds each stored document from its id. Ranks follow the
program's convention: the squared distance for L2 (lower is better), the
inner product for inner_product and the cosine similarity for cosine
(higher is better; a zero row or query scores 0).
"""
from __future__ import annotations

import numpy as np

BLOCK = 256            # queries scored at a time (256 x 100k float64)


def lower_is_better(metric: str) -> bool:
    return metric == "l2"


def unit(x64: np.ndarray) -> np.ndarray:
    """Each row (last axis) over its norm; a zero row stays zero."""
    norm = np.linalg.norm(x64, axis=-1, keepdims=True)
    return x64 / np.where(norm == 0.0, 1.0, norm)


def ranks64(rows64: np.ndarray, q64: np.ndarray, ids: np.ndarray,
            metric: str) -> np.ndarray:
    """Exact rank of rows `ids` (any shape) for the query q64 [D]."""
    r = rows64[ids]
    if metric == "l2":
        d = r - q64
        return np.einsum("...d,...d->...", d, d)
    if metric == "cosine":
        return unit(r) @ unit(q64)
    return r @ q64


def all_ranks64(rows64: np.ndarray, q64: np.ndarray, metric: str):
    """Exact ranks [Q, N] of every row for the queries q64 [Q, D]."""
    if metric == "l2":
        return ((rows64 * rows64).sum(1)[None, :] - 2.0 * (q64 @ rows64.T)
                + (q64 * q64).sum(1)[:, None])
    if metric == "cosine":
        return unit(q64) @ unit(rows64).T
    return q64 @ rows64.T


def exact_topk(rows: np.ndarray, queries: np.ndarray, k: int,
               metric: str) -> tuple[np.ndarray, np.ndarray]:
    """(ids [Q, k], ranks [Q, k]) best first, ties by the lower id."""
    rows64 = rows.astype(np.float64)
    q64 = queries.astype(np.float64)
    if metric == "cosine":
        # the inner product of the unit rows, normalised once
        rows64, q64, metric = unit(rows64), unit(q64), "inner_product"
    ids_out = np.empty((len(q64), k), dtype=np.int64)
    ranks_out = np.empty((len(q64), k), dtype=np.float64)
    for lo in range(0, len(q64), BLOCK):
        r = all_ranks64(rows64, q64[lo:lo + BLOCK], metric)
        key = r if lower_is_better(metric) else -r
        part = np.argpartition(key, k - 1, axis=1)[:, :k]
        kth = np.take_along_axis(key, part, 1).max(1, keepdims=True)
        for j in range(len(r)):
            # every row that ties the k-th, then a stable sort: lower ids
            # win among equal ranks
            cand = np.flatnonzero(key[j] <= kth[j])
            order = np.argsort(key[j][cand], kind="stable")[:k]
            ids_out[lo + j] = cand[order]
            ranks_out[lo + j] = r[j][cand[order]]
    return ids_out, ranks_out


def document(doc_id: int, groups: np.ndarray) -> dict:
    """The stored document of row `doc_id`, as a select returns it (the
    vector field left out)."""
    return {"id": int(doc_id), "grp": int(groups[doc_id])}
