"""SIFT-like rows: clustered, non-negative integer components clipped to
[0, 255], as SIFT descriptors are (ANN-benchmarks sift-128-euclidean).

SIFT's own vectors are not in the repository, so rows are made from the
seed: `n_centers` centres with exponential components of mean
`center_scale` (SIFT's histograms are mostly small counts with a long
tail), each row a centre plus gaussian noise of `sigma`, rounded and
clipped. Queries are drawn around the same centres from their own stream
and clipped, but not rounded: with integer queries every product and sum
of a distance is exact in TF32, bf16 or fp16 arithmetic too, and no
comparison could tell a lower precision from fp32.
"""
from __future__ import annotations

import numpy as np


def _draw(rng, n: int, dims: int, params: dict, centers):
    which = rng.integers(0, len(centers), size=n)
    return centers[which] + rng.normal(0.0, params["sigma"], size=(n, dims))


def make(rng: np.random.Generator, n: int, dims: int, params: dict):
    """(rows f32[n, dims], centers)."""
    centers = rng.exponential(params["center_scale"],
                              size=(params["n_centers"], dims))
    rows = np.clip(np.rint(_draw(rng, n, dims, params, centers)), 0, 255)
    return rows.astype(np.float32), centers


def make_queries(rng: np.random.Generator, n: int, dims: int, params: dict,
                 centers: np.ndarray) -> np.ndarray:
    return np.clip(_draw(rng, n, dims, params, centers), 0,
                   255).astype(np.float32)
