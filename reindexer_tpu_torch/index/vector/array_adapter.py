"""Array vector indexes: multiple vectors per document (port of
reindexer_tpu/index/vector/array_adapter.py, over the port's `Index` and
`FloatVectorIndexBase`).

Semantic equivalent of the reference's array float-vector support
(float_vector.md:624-630; dedup in FloatVectorIndex::removeDuplicateRowId,
core/index/float_vector/float_vector_index.h:140-160): an `is_array: true`
vector index holds 0..N vectors per document. KNN searches run over vector
*slots*; results deduplicate per document keeping only the best-matched
vector, so a k-NN query may return fewer than k items — exactly the
reference behavior.

Implementation: a slot allocator maps documents to engine node ids, and any
engine (brute-force / HNSW / IVF) runs unchanged underneath: the device
kernels never see documents, only slots. As in the reference, the adapter
has `select` and `select_batch` and no `*_async` split, so `knn_batch` on an
array field raises AttributeError in both packages.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ...core.errors import ParamsError
from ...core.payload import IndexDef
from ...core.type_consts import CondType
from ..base import Index, SelectKeyResult
from .base import FloatVectorIndexBase
from .params import KnnSearchParams


class ArrayVectorIndex(Index):
    def __init__(self, definition: IndexDef, inner: FloatVectorIndexBase):
        super().__init__(definition)
        self.inner = inner
        self._slots_of: dict[int, list[int]] = {}    # row -> slots
        self._slot_row = np.full(1024, -1, dtype=np.int64)
        self._free: list[int] = []
        self._next_slot = 0

    def attach_mesh(self, ctx) -> None:
        self.inner.attach_mesh(ctx)

    # --- slot allocator ---------------------------------------------------
    def _alloc(self, row: int) -> int:
        slot = self._free.pop() if self._free else self._next_slot
        if slot == self._next_slot:
            self._next_slot += 1
        if slot >= len(self._slot_row):
            grow = np.full(len(self._slot_row), -1, dtype=np.int64)
            self._slot_row = np.concatenate([self._slot_row, grow])
        self._slot_row[slot] = row
        return slot

    def _release_row(self, row: int) -> None:
        for slot in self._slots_of.pop(row, []):
            self.inner.delete(slot, None)
            self._slot_row[slot] = -1
            self._free.append(slot)

    # --- Index interface ----------------------------------------------------
    def upsert(self, row_id: int, values: Any) -> None:
        self._release_row(row_id)
        if values is None:
            return
        vecs = np.asarray(values, dtype=np.float32)
        if vecs.ndim == 1:
            if len(vecs) == 0:
                return
            vecs = vecs[None, :]
        if vecs.ndim != 2:
            raise ParamsError("array vector field expects a 2-D float array")
        slots = []
        for v in vecs:
            slot = self._alloc(row_id)
            self.inner.upsert(slot, v)
            slots.append(slot)
        self._slots_of[row_id] = slots

    def delete(self, row_id: int, values: Any) -> None:
        self._release_row(row_id)

    def supports(self, condition: CondType) -> bool:
        return self.inner.supports(condition)

    def select_key(self, condition: CondType, values: tuple,
                   **kw) -> SelectKeyResult:
        if condition in (CondType.ANY, CondType.EMPTY):
            rows_with = np.asarray(
                [r for r, s in self._slots_of.items() if s], dtype=np.int64)
            if condition == CondType.ANY:
                return SelectKeyResult(np.sort(rows_with))
            return SelectKeyResult.fallthrough()
        return self.inner.select_key(condition, values, **kw)

    def commit(self) -> None:
        self.inner.commit()

    # --- KNN with per-document dedup (removeDuplicateRowId analog) --------
    def select(self, query: np.ndarray, params: KnnSearchParams,
               ) -> SelectKeyResult:
        res = self.inner.select(query, params)
        if len(res.ids) == 0:
            return res
        rows = self._slot_row[res.ids]
        seen: set[int] = set()
        keep = np.zeros(len(rows), dtype=bool)
        for i, r in enumerate(rows):       # best-first order preserved
            ri = int(r)
            if ri >= 0 and ri not in seen:
                seen.add(ri)
                keep[i] = True
        return SelectKeyResult(rows[keep].astype(np.int64),
                               (res.ranks[keep] if res.ranks is not None
                                else None),
                               res.ordering)

    def select_batch(self, queries, params):
        return [self.select(q, params) for q in np.asarray(queries)]

    def clear(self) -> None:
        self.inner.clear()
        self._slots_of.clear()
        self._slot_row[:] = -1
        self._free.clear()
        self._next_slot = 0

    def memstat(self) -> dict:
        st = self.inner.memstat()
        st["name"] = self.name
        st["is_array"] = True
        return st

    def state_dict(self) -> dict:
        return {
            "inner": self.inner.state_dict(),
            "slots_of": {int(k): list(v) for k, v in self._slots_of.items()},
            "slot_row": self._slot_row.copy(),
            "free": list(self._free),
            "next_slot": self._next_slot,
        }

    def load_state_dict(self, state: dict) -> None:
        self.clear()
        self.inner.load_state_dict(state["inner"])
        self._slots_of = {int(k): list(v)
                          for k, v in state["slots_of"].items()}
        self._slot_row = np.asarray(state["slot_row"], dtype=np.int64)
        self._free = list(state["free"])
        self._next_slot = int(state["next_slot"])
