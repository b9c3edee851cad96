"""Port of reindexer_tpu/sharding.py: a copy of the reference's module over
the port's databases (host only). The shards are port `Reindexer`s the
caller builds, each on its own torch device (one card may hold them all);
the scatter runs the shards' selects from a thread pool, so on the card
several threads launch the kernels at once. The device row-sharding plane
is reindexer_tpu_torch/parallel/ (`Reindexer(mesh=...)`).

It differs in one place: a reshard moves each row with its float vectors.
The reference reads the rows to move with a plain select, which leaves
the vector fields out (they are shown only under `vectors()`), so a moved
row reaches its new shard without them and no KNN finds it again
(ROADMAP C).

The reference's notes follow.

Sharding: key-routed writes + scatter-gather distributed selects.

Semantic equivalent of the reference sharding stack
(cpp_src/core/shardingproxy.cc + cluster/sharding/sharding.cc LocatorService
+ core/parallelexecutor.cc; semantics sharding.md:17-60): a sharding config
maps a namespace's shard key (by explicit key values or ranges) to shard
ids; writes route to the owning shard; selects either pin to one shard (when
the query filters the shard key by equality) or fan out to all shards in
parallel and merge — ranked streams merge by rank, sorted streams re-merge
by the sort key, aggregations combine (sum/min/max/count; facets/distinct
union) like the reference's limited distributed aggregations.

This is the *host* scatter-gather plane across engine instances; the
*device* row-sharding plane over a chip mesh lives in parallel/sharded_knn
(SURVEY.md §2.4 P8 maps the reference's shard-by-rows to both levels).
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence, Union

import numpy as np

from .core.database import Reindexer
from .core.errors import ParamsError, QueryError
from .core.payload import get_json_path
from .core.type_consts import AggType, CondType, OpType
from .query.query import Bracket, KnnQueryEntry, Query, QueryEntry
from .query.results import AggregationResult, FacetResult, QueryResults


@dataclasses.dataclass
class ShardKeyRange:
    left: Any
    right: Any        # inclusive bounds (reference: range-based sharding keys)


@dataclasses.dataclass
class ShardSpec:
    shard_id: int
    values: tuple = ()                       # explicit key values
    ranges: tuple[ShardKeyRange, ...] = ()


@dataclasses.dataclass
class NamespaceShardingConfig:
    namespace: str
    index: str                               # shard key field
    shards: tuple[ShardSpec, ...] = ()
    default_shard: int = 0


class Locator:
    """Key -> shard resolution (reference: cluster/sharding LocatorService)."""

    def __init__(self, cfg: NamespaceShardingConfig):
        self.cfg = cfg
        self._by_value: dict[Any, int] = {}
        for spec in cfg.shards:
            for v in spec.values:
                self._by_value[v] = spec.shard_id

    def shard_of(self, key: Any) -> int:
        sid = self._by_value.get(key)
        if sid is not None:
            return sid
        for spec in self.cfg.shards:
            for r in spec.ranges:
                try:
                    if r.left <= key <= r.right:
                        return spec.shard_id
                except TypeError:
                    continue
        return self.cfg.default_shard


class ShardedReindexer:
    """API-compatible facade over N shard engines
    (reference: ShardingProxy wraps every Reindexer verb)."""

    def __init__(self, shards: Sequence[Reindexer],
                 configs: Sequence[NamespaceShardingConfig],
                 this_shard: int = 0):
        if not shards:
            raise ParamsError("sharding requires at least one shard")
        self.shards = list(shards)
        self.this_shard = this_shard
        self._locators = {c.namespace: Locator(c) for c in configs}
        self._reshard_lock = threading.Lock()   # blocks routed writes
        self._pool = ThreadPoolExecutor(
            max_workers=max(len(shards), 1),
            thread_name_prefix="shard-exec")

    # --- namespace ops broadcast to every shard -------------------------
    def open_namespace(self, name: str, indexes=()) -> None:
        for sh in self.shards:
            sh.open_namespace(name, indexes)

    def drop_namespace(self, name: str) -> None:
        for sh in self.shards:
            sh.drop_namespace(name)

    def truncate_namespace(self, name: str) -> None:
        for sh in self.shards:
            sh.truncate_namespace(name)

    def add_index(self, ns: str, idef) -> None:
        for sh in self.shards:
            sh.add_index(ns, idef)

    # --- routed writes ---------------------------------------------------
    def _route_doc(self, ns: str, doc: dict) -> Reindexer:
        # a reshard in progress would route against a swapping config
        with self._reshard_lock:
            return self._route_doc_locked(ns, doc)

    def _route_doc_locked(self, ns: str, doc: dict) -> Reindexer:
        loc = self._locators.get(ns)
        if loc is None:
            return self.shards[self.this_shard]
        key = get_json_path(doc, loc.cfg.index)
        if key is None:
            raise QueryError(
                f"sharded upsert requires the shard key '{loc.cfg.index}'")
        return self.shards[loc.shard_of(key)]

    def upsert(self, ns: str, doc: dict) -> int:
        return self._route_doc(ns, doc).upsert(ns, doc)

    def insert(self, ns: str, doc: dict) -> int:
        return self._route_doc(ns, doc).insert(ns, doc)

    def update(self, ns: str, doc: dict) -> int:
        return self._route_doc(ns, doc).update(ns, doc)

    def delete(self, ns: str, doc: dict) -> bool:
        return self._route_doc(ns, doc).delete(ns, doc)

    # --- selects ---------------------------------------------------------
    def _pinned_shard(self, q: Query) -> Optional[int]:
        """A query pins to one shard when it filters the shard key with EQ
        (or single-value SET) at the top level (reference:
        sharding.md single-shard queries)."""
        loc = self._locators.get(q.namespace)
        if loc is None:
            return self.this_shard
        for op, entry in q.entries:
            if op != OpType.AND or not isinstance(entry, QueryEntry):
                continue
            if entry.field != loc.cfg.index:
                continue
            if entry.condition == CondType.EQ and len(entry.values) == 1:
                return loc.shard_of(entry.values[0])
            if entry.condition == CondType.SET:
                sids = {loc.shard_of(v) for v in entry.values}
                if len(sids) == 1:
                    return sids.pop()
        return None

    def select(self, q: Union[Query, str]) -> QueryResults:
        if isinstance(q, str):
            from .query.sql import parse_sql
            q = parse_sql(q)
        if q.local_:
            return self.shards[self.this_shard].select(q)
        pinned = self._pinned_shard(q)
        if pinned is not None:
            return self.shards[pinned].select(q)
        return self._distributed_select(q)

    def _distributed_select(self, q: Query) -> QueryResults:
        """Scatter-gather with post-merge (reference: ParallelExecutor +
        proxied qr merge, core/parallelexecutor.cc)."""
        # each shard must over-fetch offset+limit to merge correctly
        sub = _clone_for_shard(q)
        futures = [self._pool.submit(sh.select, sub) for sh in self.shards]
        parts = [f.result() for f in futures]

        merged = QueryResults(ns_name=q.namespace)
        for p in parts:
            merged.extend(p)
        items = merged._items

        # merge ordering: rank streams by rank in metric order, field sorts
        # re-applied on the merged stream
        rank_desc = self._rank_descending(q)
        if q.sorts:
            se = q.sorts[0]
            expr = se.expression.strip()

            def key_of(it):
                if expr.lower().startswith(("rank", "rrf")):
                    return it.rank if it.rank is not None else -np.inf
                v = get_json_path(it.doc, expr)
                return (v is None, v)
            items.sort(key=key_of, reverse=se.desc)
        elif q.with_rank_:
            worst = -np.inf if rank_desc else np.inf
            items.sort(key=lambda it: (it.rank if it.rank is not None
                                       else worst), reverse=rank_desc)

        total = (sum(p.total_count for p in parts
                     if p.total_count is not None)
                 if any(p.total_count is not None for p in parts) else None)

        # a distributed KNN keeps k nearest overall, not k per shard
        knn = [e for op, e in q.entries if isinstance(e, KnnQueryEntry)]
        if len(knn) == 1 and knn[0].params.k is not None and not q.sorts:
            items[:] = items[: knn[0].params.k]

        lo = q.offset_
        hi = len(items) if q.limit_ is None else lo + q.limit_
        out = QueryResults(ns_name=q.namespace, items=items[lo:hi],
                           total_count=total,
                           aggregations=_merge_aggregations(q, parts))
        return out

    def _rank_descending(self, q: Query) -> bool:
        """Merged-rank direction: a single L2 KNN stream ranks ascending
        (distance), everything else (IP/cos/BM25/fused RRF) descending —
        mirrors the per-metric rank semantics (reference: hnsw_index.cc
        select() ordering)."""
        from .core.type_consts import VectorMetric
        knn = [e for op, e in q.entries if isinstance(e, KnnQueryEntry)]
        ranked_other = len(q.entries) - len([1 for op, e in q.entries
                                             if isinstance(e, KnnQueryEntry)])
        if len(knn) == 1:
            # hybrid (FT present) fuses with RRF -> descending
            ns0 = self.shards[0].get_namespace(q.namespace)
            for op, e in q.entries:
                if isinstance(e, QueryEntry):
                    idef = ns0.index_def(e.field)
                    if idef is not None and idef.is_fulltext:
                        return True
            idef = ns0.index_def(knn[0].field)
            if idef is not None and idef.vector_opts is not None:
                return idef.vector_opts.metric != VectorMetric.L2
        return True

    # --- runtime resharding ----------------------------------------------
    def sharding_config(self) -> list[NamespaceShardingConfig]:
        return [loc.cfg for loc in self._locators.values()]

    def apply_sharding_config(
            self, configs: Sequence[NamespaceShardingConfig]) -> dict:
        """Runtime resharding (reference: the `apply_sharding_config`
        control request, sharding.md:17-60 + shardingproxy.cc
        handleNewShardingConfig): validate the new config, block writes,
        migrate every row whose key now routes to a different shard
        (upsert at the new owner, delete at the old — the reference moves
        rows the same way via internal proxied writes), then swap the
        locators. Returns per-namespace moved-row counts."""
        new_locators: dict[str, Locator] = {}
        for cfg in configs:
            if not cfg.shards:
                raise ParamsError(
                    f"sharding config for '{cfg.namespace}' has no shards")
            seen_vals: set = set()
            for spec in cfg.shards:
                if not (0 <= spec.shard_id < len(self.shards)):
                    raise ParamsError(
                        f"shard id {spec.shard_id} out of range "
                        f"(have {len(self.shards)} shards)")
                for v in spec.values:
                    if v in seen_vals:
                        raise ParamsError(
                            f"shard key value {v!r} mapped to multiple "
                            f"shards in '{cfg.namespace}'")
                    seen_vals.add(v)
            if not (0 <= cfg.default_shard < len(self.shards)):
                raise ParamsError("default shard out of range")
            new_locators[cfg.namespace] = Locator(cfg)

        moved: dict[str, int] = {}
        with self._reshard_lock:
            for ns, loc in new_locators.items():
                count = 0
                for sid, sh in enumerate(self.shards):
                    try:
                        # with the float vectors, which a plain select
                        # leaves out
                        res = sh.select(Query(ns).select("vectors()"))
                    except Exception:
                        continue            # ns absent on this shard
                    to_move = []
                    for doc in res.docs():
                        key = get_json_path(doc, loc.cfg.index)
                        if key is None:
                            continue
                        target = loc.shard_of(key)
                        if target != sid:
                            to_move.append((target, doc))
                    for target, doc in to_move:
                        self.shards[target].upsert(ns, doc)
                        sh.delete(ns, doc)
                        count += 1
                moved[ns] = count
                self._locators[ns] = loc
        return moved

    def delete_query(self, q: Query) -> int:
        return sum(sh.delete_query(_clone_for_shard(q))
                   for sh in self.shards)

    def update_query(self, q: Query) -> QueryResults:
        out = QueryResults(ns_name=q.namespace)
        for sh in self.shards:
            out.extend(sh.update_query(q))
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for sh in self.shards:
            sh.close()


def _clone_for_shard(q: Query) -> Query:
    """Per-shard subquery: same filters/sorts, pagination widened to
    offset+limit so the merge can re-paginate."""
    import copy
    sub = copy.copy(q)
    sub.entries = q.entries
    sub.offset_ = 0
    sub.limit_ = (None if q.limit_ is None else q.offset_ + q.limit_)
    sub.req_total = q.req_total
    return sub


def _merge_aggregations(q: Query, parts: list[QueryResults],
                        ) -> list[AggregationResult]:
    """Distributed aggregation merge (reference supports a limited set,
    sharding.md:17-60)."""
    if not q.aggregations or not parts:
        return []
    out: list[AggregationResult] = []
    for ai, agg in enumerate(q.aggregations):
        per = [p.aggregations[ai] for p in parts if len(p.aggregations) > ai]
        res = AggregationResult(agg.agg_type.value, agg.fields)
        vals = [a.value for a in per if a.value is not None]
        if agg.agg_type in (AggType.SUM, AggType.COUNT, AggType.COUNT_CACHED):
            res.value = float(sum(vals)) if vals else 0.0
        elif agg.agg_type == AggType.MIN:
            res.value = min(vals) if vals else None
        elif agg.agg_type == AggType.MAX:
            res.value = max(vals) if vals else None
        elif agg.agg_type == AggType.AVG:
            # avg-of-avgs is not exact; reference restricts distributed
            # avg similarly — document as approximate
            res.value = float(np.mean(vals)) if vals else 0.0
        elif agg.agg_type == AggType.FACET:
            counts: dict[tuple, int] = {}
            for a in per:
                for f in a.facets:
                    counts[f.values] = counts.get(f.values, 0) + f.count
            res.facets = [FacetResult(k, c) for k, c in
                          sorted(counts.items(), key=lambda kv: -kv[1])]
        elif agg.agg_type == AggType.DISTINCT:
            seen: list = []
            have = set()
            for a in per:
                for v in a.distincts:
                    if v not in have:
                        have.add(v)
                        seen.append(v)
            res.distincts = seen
        out.append(res)
    return out
