"""Vectorized comparators — the fallback filter path when an index can't
serve a condition (reference: cpp_src/core/nsselecter/comparator/*).

Where the reference evaluates conditions per row against payload fields, the
TPU build evaluates them as whole-column vector ops (numpy) producing boolean
row masks — the batched analog of comparator evaluation inside selectLoop
(nsselecter.cc:799).
"""
from __future__ import annotations

import fnmatch
import re
from typing import Any, Optional, Sequence

import numpy as np

from ..core.errors import QueryError
from ..core.payload import Column, coerce_scalar
from ..core.type_consts import CondType, FieldType


def _like_to_regex(pattern: str) -> "re.Pattern[str]":
    """Reference LIKE semantics: '_' = any single char, '%' = any substring
    (cpp_src/core/nsselecter/comparator/comparator_indexed.h LIKE)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _scalar_mask(values: np.ndarray, is_set: np.ndarray, cond: CondType,
                 cvals: Sequence[Any], ftype: FieldType) -> np.ndarray:
    cvals = [coerce_scalar(v, ftype) for v in cvals]
    n = len(values)
    if cond == CondType.ANY:
        return is_set.copy()
    if cond == CondType.EMPTY:
        return ~is_set
    if n == 0:
        return np.zeros(0, dtype=np.bool_)
    if cond == CondType.EQ:
        return is_set & (values == cvals[0])
    if cond == CondType.SET:
        if not cvals:
            return np.zeros(n, dtype=np.bool_)
        if values.dtype == object:
            cset = set(cvals)
            return is_set & np.fromiter((v in cset for v in values),
                                        dtype=np.bool_, count=n)
        return is_set & np.isin(values, np.asarray(cvals))
    if cond == CondType.ALLSET:
        # scalar column can match ALLSET only when all requested values equal
        uniq = set(cvals)
        if len(uniq) == 1:
            return is_set & (values == next(iter(uniq)))
        return np.zeros(n, dtype=np.bool_)
    if cond in (CondType.LT, CondType.LE, CondType.GT, CondType.GE):
        cmp = {CondType.LT: np.less, CondType.LE: np.less_equal,
               CondType.GT: np.greater, CondType.GE: np.greater_equal}[cond]
        if values.dtype == object:
            c0 = cvals[0]
            py = {CondType.LT: lambda v: v < c0, CondType.LE: lambda v: v <= c0,
                  CondType.GT: lambda v: v > c0, CondType.GE: lambda v: v >= c0}[cond]
            return is_set & np.fromiter(
                (v is not None and py(v) for v in values), dtype=np.bool_, count=n)
        return is_set & cmp(values, cvals[0])
    if cond == CondType.RANGE:
        lo, hi = sorted(cvals[:2])
        if values.dtype == object:
            return is_set & np.fromiter(
                (v is not None and lo <= v <= hi for v in values),
                dtype=np.bool_, count=n)
        return is_set & (values >= lo) & (values <= hi)
    if cond == CondType.LIKE:
        rx = _like_to_regex(str(cvals[0]))
        return is_set & np.fromiter(
            (isinstance(v, str) and rx.match(v) is not None for v in values),
            dtype=np.bool_, count=n)
    raise QueryError(f"unsupported comparator condition: {cond}")


def _array_mask(values: np.ndarray, is_set: np.ndarray, cond: CondType,
                cvals: Sequence[Any], ftype: FieldType) -> np.ndarray:
    cvals = [coerce_scalar(v, ftype) for v in cvals]
    n = len(values)
    out = np.zeros(n, dtype=np.bool_)
    if cond == CondType.ANY:
        for i in range(n):
            arr = values[i]
            out[i] = is_set[i] and arr is not None and len(arr) > 0
        return out
    if cond == CondType.EMPTY:
        for i in range(n):
            arr = values[i]
            out[i] = (not is_set[i]) or arr is None or len(arr) == 0
        return out
    cset = set(cvals)
    for i in range(n):
        if not is_set[i]:
            continue
        arr = values[i]
        if arr is None:
            continue
        if cond == CondType.EQ or cond == CondType.SET:
            out[i] = any(v in cset for v in arr)
        elif cond == CondType.ALLSET:
            out[i] = cset.issubset(set(arr))
        elif cond == CondType.LT:
            out[i] = any(v < cvals[0] for v in arr)
        elif cond == CondType.LE:
            out[i] = any(v <= cvals[0] for v in arr)
        elif cond == CondType.GT:
            out[i] = any(v > cvals[0] for v in arr)
        elif cond == CondType.GE:
            out[i] = any(v >= cvals[0] for v in arr)
        elif cond == CondType.RANGE:
            lo, hi = sorted(cvals[:2])
            out[i] = any(lo <= v <= hi for v in arr)
        elif cond == CondType.LIKE:
            rx = _like_to_regex(str(cvals[0]))
            out[i] = any(isinstance(v, str) and rx.match(v) for v in arr)
        else:
            raise QueryError(f"unsupported array comparator condition: {cond}")
    return out


def column_mask(col: Column, cond: CondType, cvals: Sequence[Any],
                capacity: int) -> np.ndarray:
    """Boolean mask [capacity] of rows matching the condition on a column."""
    values = col.values()
    is_set = col.set_mask()
    if col.is_array:
        m = _array_mask(values, is_set, cond, cvals, col.ftype)
    else:
        m = _scalar_mask(values, is_set, cond, cvals, col.ftype)
    if len(m) < capacity:
        # rows beyond column size: unset -> match only EMPTY
        pad_val = cond == CondType.EMPTY
        m = np.concatenate([m, np.full(capacity - len(m), pad_val, dtype=np.bool_)])
    return m[:capacity]


def column_mask_rows(col: Column, cond: CondType, cvals: Sequence[Any],
                     rows: np.ndarray) -> np.ndarray:
    """Boolean mask [len(rows)]: the condition evaluated at the given row
    ids only — the candidate-probing form of `column_mask` (reference
    analog: comparators see only the rows the leading SelectIterator
    drives, nsselecter.cc:799). Rows at/beyond the column size are unset,
    matching `column_mask`'s padding semantics (only EMPTY matches)."""
    values = col.values()
    is_set = col.set_mask()
    if len(values) == 0:
        iset = np.zeros(len(rows), dtype=np.bool_)
        if col.is_array:
            return _array_mask(np.empty(len(rows), dtype=object), iset,
                               cond, cvals, col.ftype)
        return _scalar_mask(np.zeros(len(rows), dtype=values.dtype), iset,
                            cond, cvals, col.ftype)
    in_range = rows < len(values)
    safe = np.where(in_range, rows, 0)
    vals = values[safe]
    iset = is_set[safe] & in_range
    if col.is_array:
        return _array_mask(vals, iset, cond, cvals, col.ftype)
    return _scalar_mask(vals, iset, cond, cvals, col.ftype)


def raw_values_mask(raw_values: list, cond: CondType, cvals: Sequence[Any]) -> np.ndarray:
    """Comparator over non-indexed document fields (per-row; the analog of
    the reference's non-index CJSON comparators)."""
    n = len(raw_values)
    out = np.zeros(n, dtype=np.bool_)
    if cond == CondType.DWITHIN:
        (point, distance) = cvals
        cx, cy = float(point[0]), float(point[1])
        d2 = float(distance) ** 2
        for i, v in enumerate(raw_values):
            if isinstance(v, (list, tuple)) and len(v) == 2:
                out[i] = (float(v[0]) - cx) ** 2 + (float(v[1]) - cy) ** 2 <= d2
        return out
    rx = _like_to_regex(str(cvals[0])) if cond == CondType.LIKE and cvals else None
    for i, v in enumerate(raw_values):
        if cond == CondType.EMPTY:
            out[i] = v is None or (isinstance(v, list) and not v)
            continue
        if v is None:
            continue
        vals = v if isinstance(v, list) else [v]
        if cond == CondType.ANY:
            out[i] = len(vals) > 0
        elif cond == CondType.EQ:
            out[i] = any(x == cvals[0] for x in vals)
        elif cond == CondType.SET:
            cset = set(cvals)
            out[i] = any(x in cset for x in vals)
        elif cond == CondType.ALLSET:
            out[i] = set(cvals).issubset(set(vals))
        elif cond == CondType.LT:
            out[i] = any(x < cvals[0] for x in vals)
        elif cond == CondType.LE:
            out[i] = any(x <= cvals[0] for x in vals)
        elif cond == CondType.GT:
            out[i] = any(x > cvals[0] for x in vals)
        elif cond == CondType.GE:
            out[i] = any(x >= cvals[0] for x in vals)
        elif cond == CondType.RANGE:
            lo, hi = sorted(cvals[:2])
            out[i] = any(lo <= x <= hi for x in vals)
        elif cond == CondType.LIKE:
            out[i] = any(isinstance(x, str) and rx.match(x) for x in vals)  # type: ignore[union-attr]
        else:
            raise QueryError(f"unsupported condition on non-indexed field: {cond}")
    return out
