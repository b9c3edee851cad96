"""KNN search parameters.

Mirrors the reference's `KnnSearchParams` variant
(cpp_src/core/query/knn_search_params.h:60-192): a base {k, radius} pair plus
per-index-type extensions — ef for HNSW, nprobe for IVF. At least one of
k/radius must be set (reference enforces the same).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ...core.errors import ParamsError


@dataclasses.dataclass
class KnnSearchParams:
    """Base KNN params: k nearest and/or metric radius cut-off."""

    k: Optional[int] = None
    radius: Optional[float] = None

    def __post_init__(self) -> None:
        if self.k is None and self.radius is None:
            raise ParamsError("KNN query requires k and/or radius")
        if self.k is not None and self.k <= 0:
            raise ParamsError("KNN k must be > 0")

    def to_dict(self) -> dict:
        d: dict = {}
        if self.k is not None:
            d["k"] = self.k
        if self.radius is not None:
            d["radius"] = self.radius
        return d

    @staticmethod
    def from_dict(d: dict) -> "KnnSearchParams":
        k = d.get("k")
        radius = d.get("radius")
        if "ef" in d:
            return HnswSearchParams(k=k, radius=radius, ef=int(d["ef"]))
        if "nprobe" in d:
            return IvfSearchParams(k=k, radius=radius, nprobe=int(d["nprobe"]))
        return KnnSearchParams(k=k, radius=radius)


@dataclasses.dataclass
class BruteForceSearchParams(KnnSearchParams):
    """Brute-force index params (no extra knobs)."""


@dataclasses.dataclass
class HnswSearchParams(KnnSearchParams):
    """HNSW params: ef beam width >= k (reference: knn_search_params.h
    HnswSearchParams). Uniquely, HNSW allows *neither* k nor radius — that
    selects streaming KNN mode (reference: nsselecter.cc:483-500, streaming
    supported for HNSW only)."""

    ef: int = 0

    def __post_init__(self) -> None:
        if self.k is not None and self.k <= 0:
            raise ParamsError("KNN k must be > 0")
        if self.ef == 0:
            self.ef = max(self.k or 0, 10)
        if self.k is not None and self.ef < self.k:
            raise ParamsError("HNSW ef must be >= k")

    @property
    def is_streaming(self) -> bool:
        return self.k is None and self.radius is None

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["ef"] = self.ef
        return d


@dataclasses.dataclass
class IvfSearchParams(KnnSearchParams):
    """IVF params: nprobe lists to scan (reference: knn_search_params.h IvfSearchParams)."""

    nprobe: int = 1

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.nprobe <= 0:
            raise ParamsError("IVF nprobe must be > 0")

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["nprobe"] = self.nprobe
        return d
