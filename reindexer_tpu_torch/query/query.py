"""Query AST and fluent builder.

The semantic equivalent of the reference `Query` object
(cpp_src/core/query/query.h:37) and the Go builder (query.go): an entries
tree of AND/OR/NOT conditions with brackets, KNN entries, joins, merge
queries, subqueries, aggregations, sort entries, and pagination.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import numpy as np

from ..core.errors import QueryError
from ..core.type_consts import AggType, CondType, COND_BY_NAME, OpType, StrictMode
from ..index.vector.params import KnnSearchParams


@dataclasses.dataclass
class QueryEntry:
    """One field condition (reference: QueryEntry in query/queryentry.h)."""

    field: str
    condition: CondType
    values: tuple = ()

    def __post_init__(self) -> None:
        if isinstance(self.condition, str):
            self.condition = COND_BY_NAME[self.condition.lower()]
        if not isinstance(self.values, tuple):
            vals = self.values if isinstance(self.values, (list, np.ndarray)) else [self.values]
            self.values = tuple(vals)
        if self.condition == CondType.RANGE and len(self.values) != 2:
            raise QueryError("range condition requires exactly 2 values")


@dataclasses.dataclass
class BetweenFieldsEntry:
    """Field-vs-field comparison (reference: BetweenFieldsQueryEntry)."""

    first_field: str
    condition: CondType
    second_field: str


@dataclasses.dataclass
class KnnQueryEntry:
    """KNN condition (reference: KnnQueryEntry; Go WhereKnn query.go:703).

    `value` may be a vector (np.ndarray) or a string to auto-embed via the
    index's configured embedder (reference: query auto-embedding,
    reindexerimpl.cc:1231).
    """

    field: str
    value: Any
    params: KnnSearchParams


@dataclasses.dataclass
class SubQueryEntry:
    """Subquery condition: field COND (subquery) or (subquery) COND values
    (reference: SubQueryEntry / SubQueryFieldEntry in query/queryentry.h)."""

    condition: CondType
    sub_query: "Query"
    field: Optional[str] = None   # field COND subquery-result
    values: tuple = ()            # subquery-aggregate COND values


@dataclasses.dataclass
class Bracket:
    """Parenthesized sub-tree of entries (reference: core/expressiontree.h brackets)."""

    entries: list = dataclasses.field(default_factory=list)  # list[(OpType, entry)]


@dataclasses.dataclass
class AlwaysTrue:
    """Matches all rows (used by empty filters)."""


@dataclasses.dataclass
class SortingEntry:
    """One sort directive; expression supports fields, arithmetic, rank(),
    hash(), abs() etc. (reference: sorting/sortexpression.cc)."""

    expression: str
    desc: bool = False
    forced_values: tuple = ()  # forced sort order (reference: forcedSortOrder)


@dataclasses.dataclass
class AggregateEntry:
    """Aggregation request (reference: AggregateEntry in query.h)."""

    agg_type: AggType
    fields: tuple[str, ...]
    limit: int = -1
    offset: int = 0
    sort: tuple[SortingEntry, ...] = ()


@dataclasses.dataclass
class UpdateEntry:
    """SET/DROP field operation for update queries
    (reference: UpdateEntry in query.h)."""

    field: str
    values: tuple = ()
    mode: str = "set"         # set | drop | set_expression | set_object
    is_array: bool = False


class JoinType:
    LEFT = "left"
    INNER = "inner"
    OR_INNER = "or_inner"
    MERGE = "merge"


@dataclasses.dataclass
class OnCondition:
    op: OpType
    left_field: str
    condition: CondType
    right_field: str


@dataclasses.dataclass
class JoinedQuery:
    """Joined sub-query (reference: JoinedQuery in query.h; Go query.go Join)."""

    join_type: str
    query: "Query"
    on: list[OnCondition] = dataclasses.field(default_factory=list)


class Query:
    """Fluent query builder over one namespace.

    Usage mirrors the Go builder (reference query.go):
        q = Query("items").where("year", ">", 2010).where("name", "=", "str")
        q = Query("items").where_knn("vec", qvec, HnswSearchParams(k=10, ef=50))
    """

    def __init__(self, namespace: str):
        self.namespace = namespace
        self.entries: list = []           # list[(OpType, entry)]
        self.sorts: list[SortingEntry] = []
        self.aggregations: list[AggregateEntry] = []
        self.limit_: Optional[int] = None
        self.offset_: int = 0
        self.select_filter: tuple[str, ...] = ()
        self.joins: list[JoinedQuery] = []
        self.merge_queries: list["Query"] = []
        self.update_entries: list[UpdateEntry] = []
        self.with_rank_: bool = False
        self.req_total: bool = False
        self.explain_: bool = False
        self.strict_mode: StrictMode = StrictMode.NAMES
        self.select_functions: list[str] = []
        self._next_op: OpType = OpType.AND
        self._bracket_stack: list[Bracket] = []
        self.debug_level: int = 0
        self.local_: bool = False
        # groups of array fields whose conditions must match at the SAME
        # array position (reference: equalPositions, query.h / dsl)
        self.equal_positions: list[tuple[str, ...]] = []

    # --- entry plumbing -------------------------------------------------
    def _append(self, entry: Any) -> "Query":
        op = self._next_op
        self._next_op = OpType.AND
        target = self._bracket_stack[-1].entries if self._bracket_stack else self.entries
        target.append((op, entry))
        return self

    # --- logical operators ---------------------------------------------
    def op_or(self) -> "Query":
        self._next_op = OpType.OR
        return self

    def op_not(self) -> "Query":
        self._next_op = OpType.NOT
        return self

    # Go-style aliases
    Or = op_or
    Not = op_not

    def open_bracket(self) -> "Query":
        br = Bracket()
        self._append(br)
        self._bracket_stack.append(br)
        return self

    def close_bracket(self) -> "Query":
        if not self._bracket_stack:
            raise QueryError("close_bracket without open_bracket")
        self._bracket_stack.pop()
        return self

    # --- conditions -----------------------------------------------------
    def where(self, field: str, condition: Union[CondType, str], values: Any = ()) -> "Query":
        return self._append(QueryEntry(field, condition, values))

    def where_between_fields(self, first: str, condition: Union[CondType, str],
                             second: str) -> "Query":
        if isinstance(condition, str):
            condition = COND_BY_NAME[condition.lower()]
        return self._append(BetweenFieldsEntry(first, condition, second))

    def where_knn(self, field: str, value: Any, params: KnnSearchParams) -> "Query":
        self.with_rank_ = True
        return self._append(KnnQueryEntry(field, value, params))

    def where_query(self, sub_query: "Query", condition: Union[CondType, str],
                    values: Any = ()) -> "Query":
        if isinstance(condition, str):
            condition = COND_BY_NAME[condition.lower()]
        vals = values if isinstance(values, (list, tuple)) else [values]
        return self._append(SubQueryEntry(condition, sub_query, values=tuple(vals)))

    def where_field_query(self, field: str, condition: Union[CondType, str],
                          sub_query: "Query") -> "Query":
        if isinstance(condition, str):
            condition = COND_BY_NAME[condition.lower()]
        return self._append(SubQueryEntry(condition, sub_query, field=field))

    def match(self, field: str, dsl: str) -> "Query":
        """Full-text match (reference: Go Query.Match query.go:728)."""
        self.with_rank_ = True
        return self._append(QueryEntry(field, CondType.EQ, (dsl,)))

    def equal_position(self, *fields: str) -> "Query":
        """Require the listed array-field conditions to match at the same
        array index (reference: Query::AddEqualPosition)."""
        if len(fields) < 2:
            raise QueryError("equal_position requires at least 2 fields")
        self.equal_positions.append(tuple(fields))
        return self

    def dwithin(self, field: str, point: Sequence[float], distance: float) -> "Query":
        return self._append(QueryEntry(field, CondType.DWITHIN,
                                       (tuple(point), float(distance))))

    # --- modifiers ------------------------------------------------------
    def sort(self, expression: str, desc: bool = False,
             forced_values: Sequence[Any] = ()) -> "Query":
        self.sorts.append(SortingEntry(expression, desc, tuple(forced_values)))
        return self

    def limit(self, n: int) -> "Query":
        self.limit_ = n
        return self

    def offset(self, n: int) -> "Query":
        self.offset_ = n
        return self

    def select(self, *fields: str) -> "Query":
        self.select_filter = tuple(fields)
        return self

    def with_rank(self) -> "Query":
        self.with_rank_ = True
        return self

    def req_total_count(self) -> "Query":
        self.req_total = True
        return self

    def explain(self) -> "Query":
        self.explain_ = True
        return self

    def strict(self, mode: Union[StrictMode, str]) -> "Query":
        self.strict_mode = StrictMode(mode)
        return self

    def local(self) -> "Query":
        """Restrict a sharded query to the local shard (reference: Go Query.Local)."""
        self.local_ = True
        return self

    def functions(self, *funcs: str) -> "Query":
        """Select functions like highlight()/snippet() (reference: query.go Functions)."""
        self.select_functions.extend(funcs)
        return self

    # --- aggregations ---------------------------------------------------
    def aggregate(self, agg_type: Union[AggType, str], *fields: str,
                  limit: int = -1, offset: int = 0,
                  sort: Sequence[SortingEntry] = ()) -> "Query":
        self.aggregations.append(AggregateEntry(AggType(agg_type), tuple(fields),
                                                limit, offset, tuple(sort)))
        return self

    def aggregate_sum(self, field: str) -> "Query":
        return self.aggregate(AggType.SUM, field)

    def aggregate_avg(self, field: str) -> "Query":
        return self.aggregate(AggType.AVG, field)

    def aggregate_min(self, field: str) -> "Query":
        return self.aggregate(AggType.MIN, field)

    def aggregate_max(self, field: str) -> "Query":
        return self.aggregate(AggType.MAX, field)

    def aggregate_facet(self, *fields: str, limit: int = -1, offset: int = 0,
                        sort: Sequence[SortingEntry] = ()) -> "Query":
        return self.aggregate(AggType.FACET, *fields, limit=limit, offset=offset,
                              sort=sort)

    def distinct(self, *fields: str) -> "Query":
        return self.aggregate(AggType.DISTINCT, *fields)

    # --- joins / merge --------------------------------------------------
    def _join(self, other: "Query", join_type: str) -> "JoinBuilder":
        jq = JoinedQuery(join_type, other)
        self.joins.append(jq)
        if join_type == JoinType.OR_INNER:
            # OR-inner join participates in the entries tree as an OR condition
            self._next_op = OpType.OR
        if join_type != JoinType.LEFT:
            self._append(jq)
        return JoinBuilder(self, jq)

    def join(self, other: "Query", join_type: str = JoinType.LEFT) -> "JoinBuilder":
        return self._join(other, join_type)

    def inner_join(self, other: "Query") -> "JoinBuilder":
        return self._join(other, JoinType.INNER)

    def left_join(self, other: "Query") -> "JoinBuilder":
        return self._join(other, JoinType.LEFT)

    def or_inner_join(self, other: "Query") -> "JoinBuilder":
        return self._join(other, JoinType.OR_INNER)

    def merge(self, other: "Query") -> "Query":
        self.merge_queries.append(other)
        return self

    # --- update entries -------------------------------------------------
    def set(self, field: str, value: Any) -> "Query":
        vals = value if isinstance(value, (list, tuple)) else (value,)
        self.update_entries.append(UpdateEntry(field, tuple(vals),
                                               is_array=isinstance(value, (list, tuple))))
        return self

    def set_expression(self, field: str, expr: str) -> "Query":
        self.update_entries.append(UpdateEntry(field, (expr,), mode="set_expression"))
        return self

    def drop(self, field: str) -> "Query":
        self.update_entries.append(UpdateEntry(field, (), mode="drop"))
        return self


class JoinBuilder:
    """Builds ON conditions for a join (reference: Go query.go On())."""

    def __init__(self, parent: Query, joined: JoinedQuery):
        self._parent = parent
        self._joined = joined
        self._next_op = OpType.AND

    def on(self, left_field: str, condition: Union[CondType, str],
           right_field: str) -> "JoinBuilder":
        if isinstance(condition, str):
            condition = COND_BY_NAME[condition.lower()]
        self._joined.on.append(OnCondition(self._next_op, left_field,
                                           condition, right_field))
        self._next_op = OpType.AND
        return self

    def op_or(self) -> "JoinBuilder":
        self._next_op = OpType.OR
        return self

    @property
    def query(self) -> Query:
        return self._parent

    # allow continuing to build the outer query
    def __getattr__(self, item):
        return getattr(self._parent, item)
