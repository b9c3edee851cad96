"""JSON DSL query parser + encoder.

Semantic equivalent of the reference JSON-DSL layer
(cpp_src/core/query/dsl/dslparser.cc ~1300 LoC; Go connector dsl/ package;
REST body of POST /api/v1/db/:db/query). Accepts the reference's field
names; `parse_dsl` produces a Query, `to_dsl` round-trips one back to JSON.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..core.errors import QueryError
from ..core.type_consts import AggType, COND_BY_NAME, COND_NAMES, CondType, OpType
from ..index.vector.params import (HnswSearchParams, IvfSearchParams,
                                   KnnSearchParams)
from .query import (BetweenFieldsEntry, Bracket, JoinedQuery, JoinType,
                    KnnQueryEntry, OnCondition, Query, QueryEntry,
                    SortingEntry, SubQueryEntry)

_OPS = {"and": OpType.AND, "or": OpType.OR, "not": OpType.NOT}
_JOIN_TYPES = {"inner": JoinType.INNER, "left": JoinType.LEFT,
               "orinner": JoinType.OR_INNER}


def _cond(c: str) -> CondType:
    c = c.lower()
    if c in COND_BY_NAME:
        return COND_BY_NAME[c]
    raise QueryError(f"unknown DSL condition '{c}'")


def _knn_params(d: dict) -> KnnSearchParams:
    k = d.get("k")
    radius = d.get("radius")
    if "ef" in d:
        return HnswSearchParams(k=k, radius=radius, ef=int(d["ef"]))
    if "nprobe" in d:
        return IvfSearchParams(k=k, radius=radius, nprobe=int(d["nprobe"]))
    if k is None and radius is None:
        return HnswSearchParams()
    return KnnSearchParams(k=k, radius=radius)


def parse_dsl(d: dict) -> Query:
    ns = d.get("namespace")
    if not ns:
        raise QueryError("DSL query requires 'namespace'")
    q = Query(ns)
    _parse_filters(q, d.get("filters", []))
    sort = d.get("sort")
    if sort:
        for s in (sort if isinstance(sort, list) else [sort]):
            q.sort(s.get("field", ""), bool(s.get("desc", False)),
                   tuple(s.get("values", ())))
    if "limit" in d and d["limit"] is not None and int(d["limit"]) >= 0:
        q.limit(int(d["limit"]))
    if d.get("offset"):
        q.offset(int(d["offset"]))
    for f in d.get("select_filter", []):
        q.select_filter = q.select_filter + (f,)
    for fn in d.get("select_functions", []):
        q.functions(fn)
    rt = d.get("req_total", "disabled")
    if rt in ("enabled", "cached", True):
        q.req_total_count()
    if d.get("explain"):
        q.explain()
    if d.get("strict_mode"):
        q.strict(d["strict_mode"])
    for a in d.get("aggregations", []):
        q.aggregate(AggType(a["type"].lower()), *a.get("fields", []),
                    limit=int(a.get("limit", -1)),
                    offset=int(a.get("offset", 0)),
                    sort=tuple(SortingEntry(s.get("field", ""),
                                            bool(s.get("desc", False)))
                               for s in a.get("sort", [])))
    for m in d.get("merge_queries", []):
        q.merge(parse_dsl(m))
    for uf in d.get("update_fields", []):
        mode = uf.get("type", "value")
        vals = uf.get("values", [])
        if mode == "expression":
            q.set_expression(uf["name"], str(vals[0]))
        else:
            if uf.get("is_array") or len(vals) > 1:
                q.set(uf["name"], list(vals))
            elif vals:
                q.set(uf["name"], vals[0])
    if d.get("drop_fields"):
        for f in d["drop_fields"]:
            q.drop(f)
    for ep in d.get("equal_positions", []):
        pos = ep.get("positions", ep) if isinstance(ep, dict) else ep
        q.equal_position(*pos)
    return q


def _parse_filters(q: Query, filters: list) -> None:
    for f in filters:
        op = _OPS.get(str(f.get("op", "and")).lower(), OpType.AND)
        if op == OpType.OR:
            q.op_or()
        elif op == OpType.NOT:
            q.op_not()
        if "filters" in f:
            q.open_bracket()
            _parse_filters(q, f["filters"])
            q.close_bracket()
            continue
        if "join_query" in f:
            jd = f["join_query"]
            jtype = _JOIN_TYPES.get(str(jd.get("type", "inner")).lower(),
                                    JoinType.INNER)
            sub = parse_dsl({"namespace": jd["namespace"],
                             "filters": jd.get("filters", []),
                             "sort": jd.get("sort"),
                             "limit": jd.get("limit"),
                             "offset": jd.get("offset", 0)})
            jb = q.join(sub, jtype)
            for oc in jd.get("on", []):
                if str(oc.get("op", "and")).lower() == "or":
                    jb.op_or()
                jb.on(oc["left_field"], _cond(oc.get("cond", "eq")),
                      oc["right_field"])
            continue
        if "sub_query" in f:
            sub = parse_dsl(f["sub_query"])
            if "field" in f:
                q.where_field_query(f["field"], _cond(f["cond"]), sub)
            else:
                vals = f.get("value", [])
                q.where_query(sub, _cond(f["cond"]),
                              vals if isinstance(vals, list) else [vals])
            continue
        cond = _cond(f.get("cond", "eq"))
        if cond == CondType.KNN:
            params = _knn_params(f.get("params", {}))
            value = f.get("value")
            if isinstance(value, list):
                value = np.asarray(value, dtype=np.float32)
            q.where_knn(f["field"], value, params)
            continue
        if "first_field" in f:
            q.where_between_fields(f["first_field"], cond, f["second_field"])
            continue
        value = f.get("value", ())
        q.where(f["field"], cond, value)


# ---------------------------------------------------------------------------
# encoder (reference: Query::GetJSON / dsl encoder)
# ---------------------------------------------------------------------------
def to_dsl(q: Query) -> dict:
    d: dict[str, Any] = {"namespace": q.namespace,
                         "filters": _encode_entries(q.entries)}
    if q.sorts:
        d["sort"] = [{"field": s.expression, "desc": s.desc,
                      **({"values": list(s.forced_values)}
                         if s.forced_values else {})} for s in q.sorts]
    if q.limit_ is not None:
        d["limit"] = q.limit_
    if q.offset_:
        d["offset"] = q.offset_
    if q.select_filter:
        d["select_filter"] = list(q.select_filter)
    if q.select_functions:
        d["select_functions"] = list(q.select_functions)
    if q.req_total:
        d["req_total"] = "enabled"
    if q.explain_:
        d["explain"] = True
    if q.aggregations:
        d["aggregations"] = [
            {"type": a.agg_type.value, "fields": list(a.fields)}
            for a in q.aggregations]
    if q.merge_queries:
        d["merge_queries"] = [to_dsl(m) for m in q.merge_queries]
    if q.equal_positions:
        d["equal_positions"] = [{"positions": list(g)}
                                for g in q.equal_positions]
    return d


def _encode_entries(entries: list) -> list:
    out = []
    op_names = {OpType.AND: "AND", OpType.OR: "OR", OpType.NOT: "NOT"}
    for op, e in entries:
        base = {"op": op_names[op]}
        if isinstance(e, Bracket):
            base["filters"] = _encode_entries(e.entries)
        elif isinstance(e, QueryEntry):
            base.update({"field": e.field, "cond": COND_NAMES[e.condition],
                         "value": list(e.values) if len(e.values) != 1
                         else e.values[0]})
        elif isinstance(e, KnnQueryEntry):
            v = e.value
            base.update({"field": e.field, "cond": "knn",
                         "value": (v.tolist() if isinstance(v, np.ndarray)
                                   else v),
                         "params": e.params.to_dict()})
        elif isinstance(e, BetweenFieldsEntry):
            base.update({"first_field": e.first_field,
                         "cond": COND_NAMES[e.condition],
                         "second_field": e.second_field})
        elif isinstance(e, SubQueryEntry):
            base.update({"cond": COND_NAMES[e.condition],
                         "sub_query": to_dsl(e.sub_query)})
            if e.field:
                base["field"] = e.field
            if e.values:
                base["value"] = list(e.values)
        elif isinstance(e, JoinedQuery):
            base["join_query"] = {
                "type": e.join_type, "namespace": e.query.namespace,
                "filters": _encode_entries(e.query.entries),
                "on": [{"left_field": c.left_field,
                        "cond": COND_NAMES[c.condition],
                        "right_field": c.right_field,
                        "op": op_names[c.op]} for c in e.on]}
        out.append(base)
    return out
