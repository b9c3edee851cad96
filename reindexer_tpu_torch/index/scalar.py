"""Scalar indexes: hash, tree (ordered), store, TTL, composite.

TPU-first re-design of the reference scalar index family
(cpp_src/core/index/indexunordered.cc hash, indexordered.cc btree,
indexstore.cc store, ttlindex.cc TTL): the per-key posting container is a
Python set during mutation (the analog of IdSet's btree-set mode,
cpp_src/core/idset/idset.h:23-27) that commits lazily into sorted numpy id
arrays for batch-friendly selection — mirroring the reference's background
sort-orders optimization (namespace/index_optimizer.cc) where reads get
array-shaped postings.

Ordered (tree) indexes keep a bisect-maintained sorted key list instead of a
btree; range scans concatenate per-key id arrays, which keeps the whole
select path vectorized (numpy) rather than per-row pointer chasing.
"""
from __future__ import annotations

import bisect
import time
from typing import Any, Iterable, Optional

import numpy as np

from ..core.errors import QueryError
from ..core.payload import IndexDef, coerce_scalar
from ..core.type_consts import CondType, FieldType
from .base import Index, SelectKeyResult

_EMPTY_IDS = np.empty(0, dtype=np.int64)


def _as_iter(values: Any) -> Iterable:
    if values is None:
        return ()
    if isinstance(values, (list, tuple, set, np.ndarray)):
        return values
    return (values,)


class _KeyPostings:
    """value -> id set with lazy sorted-array commit."""

    __slots__ = ("sets", "arrays", "dirty")

    def __init__(self) -> None:
        self.sets: dict[Any, set[int]] = {}
        self.arrays: dict[Any, np.ndarray] = {}
        self.dirty: set = set()

    def add(self, key: Any, row_id: int) -> None:
        s = self.sets.get(key)
        if s is None:
            s = set()
            self.sets[key] = s
        s.add(row_id)
        self.dirty.add(key)

    def remove(self, key: Any, row_id: int) -> bool:
        s = self.sets.get(key)
        if s is None:
            return False
        s.discard(row_id)
        self.dirty.add(key)
        if not s:
            del self.sets[key]
            self.arrays.pop(key, None)
            self.dirty.discard(key)
            return True
        return False

    def ids(self, key: Any) -> np.ndarray:
        if key in self.dirty:
            s = self.sets.get(key)
            if s:
                self.arrays[key] = np.fromiter(s, dtype=np.int64, count=len(s))
            else:
                self.arrays.pop(key, None)
            self.dirty.discard(key)
        return self.arrays.get(key, _EMPTY_IDS)

    def clear(self) -> None:
        self.sets.clear()
        self.arrays.clear()
        self.dirty.clear()

    def __len__(self) -> int:
        return len(self.sets)


class HashIndex(Index):
    """Unordered hash index (reference: cpp_src/core/index/indexunordered.cc).

    Serves EQ/SET/ANY/EMPTY/ALLSET; range conditions fall through to the
    column comparator like the reference's comparator fallback.
    """

    def __init__(self, definition: IndexDef):
        super().__init__(definition)
        self._post = _KeyPostings()
        self._rows_with_value: set[int] = set()

    def _keys_of(self, values: Any) -> list:
        ftype = self.definition.field_type
        return [coerce_scalar(v, ftype) for v in _as_iter(values)]

    def upsert(self, row_id: int, values: Any) -> None:
        for key in self._keys_of(values):
            self._post.add(key, row_id)
            self._rows_with_value.add(row_id)

    def delete(self, row_id: int, values: Any) -> None:
        for key in self._keys_of(values):
            self._post.remove(key, row_id)
        self._rows_with_value.discard(row_id)

    def supports(self, condition: CondType) -> bool:
        return condition in (CondType.EQ, CondType.SET, CondType.ANY,
                             CondType.ALLSET)

    def first_row(self, value: Any) -> Optional[int]:
        """Cheap single-key peek for PK lookups (the mutation-source sets
        are authoritative; skips SelectKeyResult construction). Routes
        through _keys_of so subclass key packing (UuidIndex 128-bit ints)
        stays in effect."""
        keys = self._keys_of((value,))
        s = self._post.sets.get(keys[0]) if keys else None
        if s:
            return next(iter(s))
        return None

    def estimate_matches(self, condition: CondType, values: Any):
        """Posting-size selectivity estimate (planner ordering)."""
        try:
            if condition in (CondType.EQ, CondType.SET):
                return sum(len(self._post.sets.get(k) or ())
                           for k in self._keys_of(values))
            if condition == CondType.ALLSET:
                sizes = [len(self._post.sets.get(k) or ())
                         for k in self._keys_of(values)]
                return min(sizes) if sizes else 0
            if condition == CondType.ANY:
                return len(self._rows_with_value)
        except Exception:
            return None
        return None

    def select_key(self, condition: CondType, values: tuple, **kw) -> SelectKeyResult:
        if condition in (CondType.EQ, CondType.SET):
            keys = self._keys_of(values)
            if len(keys) == 1:
                ids = self._post.ids(keys[0])
                # copy=False: read-only callers (the point-select fast path)
                # skip the defensive copy
                return SelectKeyResult(ids.copy() if kw.get("copy", True)
                                       else ids)
            parts = [self._post.ids(k) for k in keys]
            parts = [p for p in parts if len(p)]
            if not parts:
                return SelectKeyResult.empty()
            return SelectKeyResult(np.unique(np.concatenate(parts)),
                                   sorted_unique=True)
        if condition == CondType.ALLSET:
            keys = self._keys_of(values)
            if not keys:
                return SelectKeyResult.empty()
            sets = [self._post.sets.get(k) for k in keys]
            if any(s is None for s in sets):
                return SelectKeyResult.empty()
            inter = set.intersection(*sets)  # type: ignore[arg-type]
            return SelectKeyResult(np.fromiter(inter, dtype=np.int64, count=len(inter)))
        if condition == CondType.ANY:
            rows = self._rows_with_value
            return SelectKeyResult(np.fromiter(rows, dtype=np.int64, count=len(rows)))
        return SelectKeyResult.fallthrough()

    def clear(self) -> None:
        self._post.clear()
        self._rows_with_value.clear()

    def memstat(self) -> dict:
        return {"name": self.name, "unique_keys_count": len(self._post),
                "data_size": sum(len(s) for s in self._post.sets.values()) * 8}


class TreeIndex(HashIndex):
    """Ordered index (reference: cpp_src/core/index/indexordered.cc over
    cpp-btree). A bisect-maintained sorted distinct-key list on top of the
    hash postings adds LT/LE/GT/GE/RANGE support.
    """

    def __init__(self, definition: IndexDef):
        super().__init__(definition)
        self._sorted_keys: list = []

    def upsert(self, row_id: int, values: Any) -> None:
        for key in self._keys_of(values):
            if key not in self._post.sets:
                bisect.insort(self._sorted_keys, key)
            self._post.add(key, row_id)
            self._rows_with_value.add(row_id)

    def delete(self, row_id: int, values: Any) -> None:
        for key in self._keys_of(values):
            emptied = self._post.remove(key, row_id)
            if emptied:
                pos = bisect.bisect_left(self._sorted_keys, key)
                if pos < len(self._sorted_keys) and self._sorted_keys[pos] == key:
                    self._sorted_keys.pop(pos)
        self._rows_with_value.discard(row_id)

    def supports(self, condition: CondType) -> bool:
        return super().supports(condition) or condition in (
            CondType.LT, CondType.LE, CondType.GT, CondType.GE, CondType.RANGE)

    def estimate_matches(self, condition: CondType, values: Any):
        """Value-distribution selectivity for range conditions: distinct
        keys in the range (bisect over the sorted key list) x average
        posting size. The analog of the reference planner's ordered-index
        cost estimate (querypreprocessor.cc GetSelectKeyResult cost via
        index distribution), O(log keys) per query entry."""
        if condition in (CondType.EQ, CondType.SET, CondType.ANY,
                         CondType.ALLSET):
            return super().estimate_matches(condition, values)
        try:
            nkeys = len(self._sorted_keys)
            if nkeys == 0:
                return 0
            avg = max(1.0, len(self._rows_with_value) / nkeys)
            keys = self._keys_of(values)
            if condition == CondType.LT:
                span = bisect.bisect_left(self._sorted_keys, keys[0])
            elif condition == CondType.LE:
                span = bisect.bisect_right(self._sorted_keys, keys[0])
            elif condition == CondType.GT:
                span = nkeys - bisect.bisect_right(self._sorted_keys, keys[0])
            elif condition == CondType.GE:
                span = nkeys - bisect.bisect_left(self._sorted_keys, keys[0])
            elif condition == CondType.RANGE:
                lo, hi = sorted(keys[:2])
                span = (bisect.bisect_right(self._sorted_keys, hi)
                        - bisect.bisect_left(self._sorted_keys, lo))
            else:
                return None
            return int(span * avg)
        except Exception:
            return None

    def _range_ids(self, lo_pos: int, hi_pos: int) -> SelectKeyResult:
        keys = self._sorted_keys[lo_pos:hi_pos]
        if not keys:
            return SelectKeyResult.empty()
        parts = [self._post.ids(k) for k in keys]
        parts = [p for p in parts if len(p)]
        if not parts:
            return SelectKeyResult.empty()
        return SelectKeyResult(np.concatenate(parts))

    def select_key(self, condition: CondType, values: tuple, **kw) -> SelectKeyResult:
        if condition in (CondType.EQ, CondType.SET, CondType.ANY, CondType.ALLSET):
            return super().select_key(condition, values, **kw)
        keys = self._keys_of(values)
        n = len(self._sorted_keys)
        if condition == CondType.LT:
            return self._range_ids(0, bisect.bisect_left(self._sorted_keys, keys[0]))
        if condition == CondType.LE:
            return self._range_ids(0, bisect.bisect_right(self._sorted_keys, keys[0]))
        if condition == CondType.GT:
            return self._range_ids(bisect.bisect_right(self._sorted_keys, keys[0]), n)
        if condition == CondType.GE:
            return self._range_ids(bisect.bisect_left(self._sorted_keys, keys[0]), n)
        if condition == CondType.RANGE:
            lo, hi = sorted(keys[:2])
            return self._range_ids(bisect.bisect_left(self._sorted_keys, lo),
                                   bisect.bisect_right(self._sorted_keys, hi))
        return SelectKeyResult.fallthrough()

    def clear(self) -> None:
        super().clear()
        self._sorted_keys.clear()

    def sorted_row_order(self, desc: bool = False) -> np.ndarray:
        """All rows in key order — used by the sort optimizer (the analog of
        the reference's pre-built sort orders, namespace/index_optimizer.cc)."""
        keys = reversed(self._sorted_keys) if desc else self._sorted_keys
        parts = [np.sort(self._post.ids(k)) for k in keys]
        parts = [p for p in parts if len(p)]
        if not parts:
            return _EMPTY_IDS
        return np.concatenate(parts)


class StoreIndex(Index):
    """Store-only ('-') index (reference: cpp_src/core/index/indexstore.cc):
    no lookup structure; every condition falls through to the column
    comparator."""

    def upsert(self, row_id: int, values: Any) -> None:
        pass

    def delete(self, row_id: int, values: Any) -> None:
        pass

    def supports(self, condition: CondType) -> bool:
        return False

    def select_key(self, condition: CondType, values: tuple, **kw) -> SelectKeyResult:
        return SelectKeyResult.fallthrough()

    def clear(self) -> None:
        pass


class UuidIndex(HashIndex):
    """Dedicated UUID hash index (reference: core/index/uuid_index.{h,cc} —
    IndexUnordered specialized on 128-bit Uuid keys instead of strings,
    core/keyvalue/uuid.cc ParseUuid for accepted forms).

    Keys pack to one 128-bit int: vs the canonical 36-char dashed string
    that's ~3x less key memory and single-word-pair hash/compare. Accepts
    dashed or plain 32-hex input, case-insensitive; select results and the
    comparator fallback (which reads canonicalized column strings) are
    unchanged."""

    def _keys_of(self, values: Any) -> list:
        import uuid as _uuid
        return [_uuid.UUID(coerce_scalar(v, FieldType.UUID)).int
                for v in _as_iter(values)]

    def memstat(self) -> dict:
        return {"name": self.name, "unique_keys_count": len(self._post),
                # 16-byte packed keys + 8-byte row ids
                "data_size": (len(self._post) * 16
                              + sum(len(s)
                                    for s in self._post.sets.values()) * 8)}


class TtlIndex(TreeIndex):
    """TTL index over int64 unix timestamps (reference:
    cpp_src/core/index/ttlindex.cc): rows whose value + expire_after < now
    are expired; collection happens in Namespace background maintenance."""

    def expired_rows(self, now: Optional[float] = None) -> np.ndarray:
        now = time.time() if now is None else now
        cutoff = int(now) - self.definition.opts.expire_after
        res = self.select_key(CondType.LE, (cutoff,))
        return res.ids


class CompositeIndex(Index):
    """Composite index over multiple sub-fields (reference: composite
    indexes, payload/fieldsset.h; substitution in querypreprocessor.cc).

    Keys are tuples of the sub-field values; supports EQ/SET and (for the
    tree variant) ordered conditions via lexicographic tuple order.
    """

    def __init__(self, definition: IndexDef, ordered: bool = True):
        super().__init__(definition)
        self.sub_fields = tuple(definition.json_paths)
        impl_def = definition
        self._impl: HashIndex = (TreeIndex(impl_def) if ordered else HashIndex(impl_def))
        # composite keys are pre-coerced tuples; bypass per-type coercion
        self._impl._keys_of = lambda values: [  # type: ignore[assignment]
            tuple(v) if isinstance(v, (list, tuple)) else (v,) for v in _as_iter(values)]

    def upsert(self, row_id: int, values: Any) -> None:
        # a composite value is ONE key (a tuple of sub-field values)
        self._impl.upsert(row_id, [values])

    def delete(self, row_id: int, values: Any) -> None:
        self._impl.delete(row_id, [values])

    def supports(self, condition: CondType) -> bool:
        return self._impl.supports(condition)

    def select_key(self, condition: CondType, values: tuple, **kw) -> SelectKeyResult:
        return self._impl.select_key(condition, values, **kw)

    def clear(self) -> None:
        self._impl.clear()

    def memstat(self) -> dict:
        return self._impl.memstat()
