"""Port of reindexer_tpu/client.py: a copy of the reference's module (host
only; the same wire format).

The reference's notes follow.

Network client: the application-level connector for server mode.

Semantic equivalent of the reference's language bindings over the network
(Go cproto connector, bindings/cproto/cproto.go + query builder query.go;
C++ client cpp_src/client/): the same Query builder objects execute against
a remote ReindexerServer — queries serialize to the JSON DSL
(query/dsl.py), results deserialize into QueryResults. The wire is the HTTP
API (the TPU build's serving edge; SURVEY.md §2.4 keeps the reference's
protocol surface only at the edge).
"""
from __future__ import annotations

import json
import urllib.parse
import urllib.request
from typing import Any, Optional, Sequence, Union

from .core.errors import (ConflictError, NotFoundError, ParamsError,
                          QueryError, ReindexerError)
from .core.payload import IndexDef
from .query.dsl import to_dsl
from .query.query import Query
from .query.results import (AggregationResult, FacetResult, QueryResults,
                            ResultItem)

_ERR_BY_CODE = {400: QueryError, 404: NotFoundError, 409: ConflictError}


class RemoteTransaction:
    """Client-side tx with BATCHED item shipping (the Go connector's async
    tx batching analog, bindings/cproto tx pipelining): consecutive steps
    of the same mode buffer locally and flush as ONE bulk items request
    (the server's tx items route accepts JSON lists), so an N-item tx
    costs ~N/batch_size round trips instead of N."""

    def __init__(self, client: "RemoteReindexer", tx_id: str,
                 batch_size: int = 500):
        self._c = client
        self._id = tx_id
        self._batch = int(batch_size)
        self._mode: Optional[str] = None
        self._buf: list[dict] = []

    def _flush(self) -> None:
        if self._buf:
            self._c._call(self._mode, f"/transactions/{self._id}/items",
                          self._buf)
            self._buf = []

    def _step(self, mode: str, doc: dict) -> "RemoteTransaction":
        if mode != self._mode:
            self._flush()
            self._mode = mode
        self._buf.append(doc)
        if len(self._buf) >= self._batch:
            self._flush()
        return self

    def upsert(self, doc: dict) -> "RemoteTransaction":
        return self._step("PUT", doc)

    def insert(self, doc: dict) -> "RemoteTransaction":
        return self._step("POST", doc)

    def update(self, doc: dict) -> "RemoteTransaction":
        return self._step("PATCH", doc)

    def delete(self, doc: dict) -> "RemoteTransaction":
        return self._step("DELETE", doc)

    def commit(self) -> None:
        self._flush()
        self._c._call("POST", f"/transactions/{self._id}/commit")
        self._c._cache_invalidate(getattr(self, "_ns", ""))

    def rollback(self) -> None:
        self._buf = []
        self._c._call("POST", f"/transactions/{self._id}/rollback")


class RemoteReindexer:
    """Client facade mirroring the embedded `Reindexer` API.

    `cache_queries` > 0 enables a client-side LRU of decoded results
    keyed by the query (the Go connector's deep-copy object cache
    analog, readme.md "object cache"): repeated selects skip the
    network; ANY write to a namespace through this client invalidates
    that namespace's cached queries. Writes from OTHER clients are not
    observed (same staleness contract as the Go cache)."""

    def __init__(self, url: str, db: str, create: bool = True,
                 cache_queries: int = 0):
        self.base = url.rstrip("/")
        self.db = db
        self._qcache_size = int(cache_queries)
        self._qcache: "dict[tuple, QueryResults]" = {}
        if create:
            self._request("POST", "/api/v1/db", {"name": db},
                          ignore_codes=(409,))

    # --- client-side query cache -----------------------------------
    def _cache_invalidate(self, ns: str) -> None:
        if self._qcache:
            for key in [k for k in self._qcache if k[0] == ns]:
                del self._qcache[key]

    # --- transport ------------------------------------------------------
    def _request(self, method: str, path: str, body: Any = None,
                 ignore_codes: tuple = ()) -> dict:
        data = None
        if body is not None:
            data = (body if isinstance(body, bytes)
                    else json.dumps(body, default=str).encode())
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            if e.code in ignore_codes:
                return {}
            try:
                desc = json.loads(e.read().decode()).get("description", "")
            except Exception:
                desc = str(e)
            raise _ERR_BY_CODE.get(e.code, ReindexerError)(desc)

    def _call(self, method: str, path: str, body: Any = None) -> dict:
        return self._request(method, f"/api/v1/db/{self.db}{path}", body)

    # --- namespaces -----------------------------------------------------
    def open_namespace(self, name: str,
                       indexes: Sequence[IndexDef] = ()) -> None:
        self._call("POST", "/namespaces",
                   {"name": name,
                    "indexes": [d.to_dict() for d in indexes]})

    def drop_namespace(self, name: str) -> None:
        self._call("DELETE", f"/namespaces/{name}")

    def truncate_namespace(self, name: str) -> None:
        self._call("DELETE", f"/namespaces/{name}/truncate")

    def namespace_names(self) -> list[str]:
        resp = self._call("GET", "/namespaces")
        return [d["name"] for d in resp.get("items", [])]

    def add_index(self, ns: str, idef: IndexDef) -> None:
        self._call("POST", f"/namespaces/{ns}/indexes", idef.to_dict())

    def update_index(self, ns: str, idef: IndexDef) -> None:
        self._call("PUT", f"/namespaces/{ns}/indexes", idef.to_dict())

    def drop_index(self, ns: str, name: str) -> None:
        self._call("DELETE", f"/namespaces/{ns}/indexes/{name}")

    def index_defs(self, ns: str) -> list[IndexDef]:
        resp = self._call("GET", f"/namespaces/{ns}/indexes")
        return [IndexDef.from_dict(d) for d in resp.get("items", [])]

    # --- items ----------------------------------------------------------
    @staticmethod
    def _items_path(ns: str, precepts) -> str:
        path = f"/namespaces/{ns}/items"
        if precepts:
            import urllib.parse
            path += "?" + "&".join(
                "precepts=" + urllib.parse.quote(p) for p in precepts)
        return path

    def _modify(self, method: str, ns: str, doc: dict, precepts) -> None:
        resp = self._call(method, self._items_path(ns, precepts), doc)
        if precepts and isinstance(resp, dict) and resp.get("items"):
            # server returns precept-computed items (serial()/now())
            doc.clear()
            doc.update(resp["items"][0])
        self._cache_invalidate(ns)

    def upsert(self, ns: str, doc: dict, precepts=None) -> None:
        self._modify("PUT", ns, doc, precepts)

    def insert(self, ns: str, doc: dict, precepts=None) -> None:
        self._modify("POST", ns, doc, precepts)

    def update(self, ns: str, doc: dict, precepts=None) -> None:
        self._modify("PATCH", ns, doc, precepts)

    def delete(self, ns: str, doc: dict) -> None:
        self._call("DELETE", f"/namespaces/{ns}/items", doc)
        self._cache_invalidate(ns)

    # --- queries --------------------------------------------------------
    def select(self, q: Union[Query, str]) -> QueryResults:
        ns = q.namespace if isinstance(q, Query) else ""
        key = None
        if self._qcache_size > 0:
            key = (ns, q if isinstance(q, str)
                   else json.dumps(to_dsl(q), sort_keys=True, default=str))
            hit = self._qcache.get(key)
            if hit is not None:
                return hit
        if isinstance(q, str):
            resp = self._call(
                "GET", "/query?q=" + urllib.parse.quote(q))
        else:
            resp = self._call("POST", "/query", to_dsl(q))
        res = self._decode_results(resp, ns)
        if key is not None:
            self._qcache[key] = res
            while len(self._qcache) > self._qcache_size:
                self._qcache.pop(next(iter(self._qcache)))
        return res

    def update_query(self, q: Query) -> QueryResults:
        resp = self._call("PUT", "/query", to_dsl(q))
        self._cache_invalidate(q.namespace)
        return self._decode_results(resp, q.namespace)

    def delete_query(self, q: Query) -> int:
        resp = self._call("DELETE", "/query", to_dsl(q))
        self._cache_invalidate(q.namespace)
        return int(resp.get("updated", 0))

    def _decode_results(self, resp: dict, ns: str) -> QueryResults:
        items = [ResultItem(doc=d, row_id=i, ns_name=ns)
                 for i, d in enumerate(resp.get("items", []))]
        aggs = []
        for a in resp.get("aggregations", []):
            ar = AggregationResult(a.get("type", ""),
                                   tuple(a.get("fields", ())))
            ar.value = a.get("value")
            ar.distincts = a.get("distincts", [])
            ar.facets = [FacetResult(tuple(f["values"]), f["count"])
                         for f in a.get("facets", [])]
            aggs.append(ar)
        return QueryResults(ns_name=ns, items=items,
                            total_count=resp.get("total_items"),
                            aggregations=aggs,
                            explain=resp.get("explain"))

    # --- meta / tx ------------------------------------------------------
    def put_meta(self, ns: str, key: str, value: str) -> None:
        self._call("PUT", f"/namespaces/{ns}/metabykey",
                   {"key": key, "value": value})

    def get_meta(self, ns: str, key: str) -> Optional[str]:
        try:
            return self._call("GET",
                              f"/namespaces/{ns}/metabykey/{key}")["value"]
        except NotFoundError:
            return None

    def new_transaction(self, ns: str) -> RemoteTransaction:
        resp = self._call("POST", f"/namespaces/{ns}/transactions/begin")
        tx = RemoteTransaction(self, resp["tx_id"])
        tx._ns = ns
        return tx
