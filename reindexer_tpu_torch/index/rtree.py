"""Geometry point index (reference: cpp_src/core/index/rtree/).

The reference builds a Guttman R-tree over 2-D points to serve DWithin,
with four selectable split strategies (linear / quadratic / greene /
rstar; indexrtree.cc wires MaxEntries 32 or 16, MinEntries 4, selected by
IndexOpts.rtree_type). Two backends behind the same index:

- NATIVE (default when a compiler exists): a true array-pooled Guttman
  R-tree in C++ (csrc/rtree_native.cpp) implementing all four reference
  split strategies — incremental insert/delete with CondenseTree,
  circle-vs-MBR DWithin descent. This is the reference's own data
  structure and scaling (O(log n) descent), built native like the
  reference's.
- PYTHON fallback, two tiers (semantically identical results):
  * small bases: one vectorized distance computation over all rows — the
    branch-free batched analog of an R-tree range descent;
  * large bases (>= _GRID_MIN points): a uniform GRID index — points
    bucket into cells, sorted cell-major into a CSR, and DWithin visits
    only the cells intersecting the query circle's bounding box, then
    refines with the exact vectorized predicate.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from ..core.errors import QueryError
from ..core.payload import IndexDef
from ..core.type_consts import CondType
from .base import Index, SelectKeyResult

_GRID_MIN = 8192      # below this a single vectorized scan wins
_TARGET_PER_CELL = 64

# reference split-strategy wiring (indexrtree.cc:136-160): linear and
# quadratic use 32-entry nodes, greene and rstar 16-entry
_SPLIT_CODES = {"linear": (0, 32), "quadratic": (1, 32),
                "greene": (2, 16), "rstar": (3, 16)}

_native = None
_native_tried = False


def _native_module():
    global _native, _native_tried
    if not _native_tried:
        _native_tried = True
        if os.environ.get("RX_RTREE_NATIVE", "1") not in ("0", "false"):
            from .. import csrc
            _native = csrc.load("rtree_native", "rtree_native.cpp")
    return _native


class RTreeIndex(Index):
    def __init__(self, definition: IndexDef):
        super().__init__(definition)
        self._pts = np.zeros((64, 2), dtype=np.float64)
        self._valid = np.zeros(64, dtype=np.bool_)
        self._size = 0
        self._grid: Optional[dict] = None
        self._dirty = True
        self._tree = None
        nat = _native_module()
        if nat is not None:
            code, max_entries = _SPLIT_CODES.get(
                getattr(definition.opts, "rtree_type", "rstar"),
                _SPLIT_CODES["rstar"])
            self._tree = nat.rtree_new(code, max_entries)
            self._nat = nat

    def _grow(self, need: int) -> None:
        if need <= len(self._pts):
            return
        cap = max(need, len(self._pts) * 2)
        pts = np.zeros((cap, 2), dtype=np.float64)
        pts[: self._size] = self._pts[: self._size]
        valid = np.zeros(cap, dtype=np.bool_)
        valid[: self._size] = self._valid[: self._size]
        self._pts, self._valid = pts, valid

    def upsert(self, row_id: int, values: Any) -> None:
        self._grow(row_id + 1)
        self._size = max(self._size, row_id + 1)
        self._dirty = True
        if values is None:
            if self._tree is not None and self._valid[row_id]:
                old = self._pts[row_id]
                self._nat.rtree_remove(self._tree, int(row_id),
                                       float(old[0]), float(old[1]))
            self._valid[row_id] = False
            return
        pt = np.asarray(values, dtype=np.float64).reshape(-1)
        if pt.shape[0] != 2:
            raise QueryError("rtree point must have exactly 2 coordinates")
        if self._tree is not None:
            if self._valid[row_id]:
                old = self._pts[row_id]
                self._nat.rtree_remove(self._tree, int(row_id),
                                       float(old[0]), float(old[1]))
            self._nat.rtree_insert(self._tree, int(row_id),
                                   float(pt[0]), float(pt[1]))
        self._pts[row_id] = pt
        self._valid[row_id] = True

    def delete(self, row_id: int, values: Any) -> None:
        if row_id < self._size:
            if self._tree is not None and self._valid[row_id]:
                old = self._pts[row_id]
                self._nat.rtree_remove(self._tree, int(row_id),
                                       float(old[0]), float(old[1]))
            self._valid[row_id] = False
            self._dirty = True

    def supports(self, condition: CondType) -> bool:
        return condition in (CondType.DWITHIN, CondType.ANY, CondType.EMPTY)

    # ------------------------------------------------------------------
    def _rebuild_grid(self) -> None:
        """Uniform-grid CSR over valid points: cell side sized so an average
        cell holds ~_TARGET_PER_CELL points (the R-tree-node-fanout analog;
        indexrtree.cc uses MAX_ENTRIES-bounded nodes the same way)."""
        self._dirty = False
        rows = np.flatnonzero(self._valid[: self._size])
        if len(rows) < _GRID_MIN:
            self._grid = None
            return
        pts = self._pts[rows]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        span = np.maximum(hi - lo, 1e-12)
        n_cells = max(len(rows) // _TARGET_PER_CELL, 1)
        nx = max(int(np.sqrt(n_cells * span[0] / span[1])), 1)
        ny = max(n_cells // max(nx, 1), 1)
        cx = np.minimum(((pts[:, 0] - lo[0]) / span[0] * nx).astype(np.int64),
                        nx - 1)
        cy = np.minimum(((pts[:, 1] - lo[1]) / span[1] * ny).astype(np.int64),
                        ny - 1)
        cell = cx * ny + cy
        order = np.argsort(cell, kind="stable")
        self._grid = {
            "rows": rows[order],
            "pts": pts[order],
            "start": np.searchsorted(cell[order],
                                     np.arange(nx * ny + 1)),
            "lo": lo, "span": span, "nx": nx, "ny": ny,
        }

    def _dwithin_grid(self, center: np.ndarray, distance: float,
                      ) -> Optional[np.ndarray]:
        g = self._grid
        if g is None:
            return None
        lo, span, nx, ny = g["lo"], g["span"], g["nx"], g["ny"]
        x0 = int(np.clip((center[0] - distance - lo[0]) / span[0] * nx,
                         0, nx - 1))
        x1 = int(np.clip((center[0] + distance - lo[0]) / span[0] * nx,
                         0, nx - 1))
        y0 = int(np.clip((center[1] - distance - lo[1]) / span[1] * ny,
                         0, ny - 1))
        y1 = int(np.clip((center[1] + distance - lo[1]) / span[1] * ny,
                         0, ny - 1))
        start = g["start"]
        out = []
        d2max = float(distance) ** 2
        # visit each intersecting cell ROW as one contiguous CSR range
        # (cells with the same x are adjacent in y: one slice per (x, ystrip))
        for cxi in range(x0, x1 + 1):
            s = start[cxi * ny + y0]
            e = start[cxi * ny + y1 + 1]
            if e <= s:
                continue
            pts = g["pts"][s:e]
            d2 = np.sum((pts - center[None, :]) ** 2, axis=1)
            hit = d2 <= d2max
            if hit.any():
                out.append(g["rows"][s:e][hit])
        if not out:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(out)).astype(np.int64)

    def select_key(self, condition: CondType, values: tuple, **kw) -> SelectKeyResult:
        if condition == CondType.DWITHIN:
            (point, distance) = values
            center = np.asarray(point, dtype=np.float64).reshape(-1)
            if self._tree is not None:
                raw = self._nat.rtree_dwithin(
                    self._tree, float(center[0]), float(center[1]),
                    float(distance))
                ids = np.frombuffer(raw, dtype=np.int32).astype(np.int64)
                ids.sort()
                return SelectKeyResult(ids)
            if self._dirty:
                self._rebuild_grid()
            ids = self._dwithin_grid(center, float(distance))
            if ids is not None:
                return SelectKeyResult(ids)
            d2 = np.sum((self._pts[: self._size] - center[None, :]) ** 2, axis=1)
            mask = self._valid[: self._size] & (d2 <= float(distance) ** 2)
            return SelectKeyResult(np.flatnonzero(mask).astype(np.int64))
        if condition == CondType.ANY:
            return SelectKeyResult(
                np.flatnonzero(self._valid[: self._size]).astype(np.int64))
        if condition == CondType.EMPTY:
            return SelectKeyResult(
                np.flatnonzero(~self._valid[: self._size]).astype(np.int64))
        return SelectKeyResult.fallthrough()

    def clear(self) -> None:
        self._valid[:] = False
        self._size = 0
        self._grid = None
        self._dirty = True
        if self._tree is not None:
            code, max_entries = _SPLIT_CODES.get(
                getattr(self.definition.opts, "rtree_type", "rstar"),
                _SPLIT_CODES["rstar"])
            self._tree = self._nat.rtree_new(code, max_entries)

    def memstat(self) -> dict:
        out = {"name": self.name,
               "unique_keys_count": int(self._valid[: self._size].sum()),
               "data_size": int(self._size * 16)}
        if self._tree is not None:
            height, nodes, points = self._nat.rtree_stats(self._tree)
            out["rtree"] = {"height": height, "nodes": nodes,
                            "points": points}
        return out
