"""Query results container.

Semantic equivalent of the reference `LocalQueryResults`/`QueryResults`
(cpp_src/core/queryresults/localqueryresults.h:39, queryresults.h:29):
ranked row refs + aggregation results + joined items + explain payload.
Iteration yields `ResultItem`s carrying the document, its rank, and any
joined documents (the analog of the Go iterator with joins, iterator.go).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class FacetResult:
    values: tuple
    count: int


@dataclasses.dataclass
class AggregationResult:
    agg_type: str
    fields: tuple[str, ...]
    value: Optional[float] = None
    facets: list[FacetResult] = dataclasses.field(default_factory=list)
    distincts: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"type": self.agg_type, "fields": list(self.fields)}
        if self.value is not None:
            d["value"] = self.value
        if self.facets:
            d["facets"] = [{"values": list(f.values), "count": f.count}
                           for f in self.facets]
        if self.distincts:
            d["distincts"] = list(self.distincts)
        return d


@dataclasses.dataclass
class ResultItem:
    doc: dict
    row_id: int
    rank: Optional[float] = None
    joined: dict[str, list[dict]] = dataclasses.field(default_factory=dict)
    ns_name: str = ""


class QueryResults:
    def __init__(self, ns_name: str = "",
                 items: Optional[list[ResultItem]] = None,
                 total_count: Optional[int] = None,
                 aggregations: Optional[list[AggregationResult]] = None,
                 explain: Optional[dict] = None):
        self.ns_name = ns_name
        self._items: list[ResultItem] = items or []
        self.total_count = total_count
        self.aggregations = aggregations or []
        self.explain = explain

    def __len__(self) -> int:
        return len(self._items)

    @property
    def count(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[ResultItem]:
        return iter(self._items)

    def __getitem__(self, i: int) -> ResultItem:
        return self._items[i]

    def docs(self) -> list[dict]:
        return [it.doc for it in self._items]

    def ranks(self) -> list[Optional[float]]:
        return [it.rank for it in self._items]

    def row_ids(self) -> np.ndarray:
        return np.asarray([it.row_id for it in self._items], dtype=np.int64)

    def agg_results(self) -> list[dict]:
        return [a.to_dict() for a in self.aggregations]

    def extend(self, other: "QueryResults") -> None:
        self._items.extend(other._items)
        if other.total_count is not None:
            self.total_count = (self.total_count or 0) + other.total_count

    def to_json_list(self) -> list[dict]:
        return self.docs()
