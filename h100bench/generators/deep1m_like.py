"""Deep1B-like rows (ANN-benchmarks deep-image-96-angular): unit vectors
clustered around `n_centers` gaussian centres at noise `sigma`.

Frozen copy of chip_smoke.py's `make_deep1m_like` (itself bench.py's
bench_deep1m), with the random stream taken from the run's seed instead
of a fixed one, and the rows and queries drawn by separate calls.
"""
from __future__ import annotations

import numpy as np


def _draw(rng, n: int, dims: int, params: dict, centers):
    which = rng.integers(0, len(centers), size=n)
    rows = (centers[which]
            + params["sigma"] * rng.normal(size=(n, dims))).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows


def make(rng: np.random.Generator, n: int, dims: int, params: dict):
    """(rows f32[n, dims] of unit norm, centers)."""
    centers = rng.normal(size=(params["n_centers"], dims)).astype(np.float32)
    return _draw(rng, n, dims, params, centers), centers


def make_queries(rng: np.random.Generator, n: int, dims: int, params: dict,
                 centers: np.ndarray) -> np.ndarray:
    return _draw(rng, n, dims, params, centers)
