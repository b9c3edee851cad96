"""Port of reindexer_tpu/server/http.py: the reference's server over the
port's databases: `DBManager` and `ReindexerServer` take the torch `device`
(default `cuda`) every `Reindexer` they open lives on, and a database
directory holding a sqlite store reopens as `sqlite://` (the reference
reopens every directory as a FileStorage).

The reference's notes follow.

HTTP REST server.

Semantic equivalent of the reference HTTP server
(cpp_src/server/httpserver.cc:1098-1164 route table; OpenAPI spec
server/contrib/server.yml): multi-database root (dbmanager analog,
server/dbmanager.cc), namespaces/items/indexes/meta CRUD, SQL + JSON-DSL
queries, transactions, health check, Prometheus metrics. Response formats:
JSON (default), msgpack, csv-file, and protobuf (?format=..., with
GET /api/v1/db/:db/protobuf_schema serving the proto3 schema — reference:
httpserver.cc:936,1116 + core/cjson/protobufbuilder.cc).

Built on the stdlib ThreadingHTTPServer — the accept loop replaces the
reference's bespoke ev reactor + coroutines (net/ev/ev.cc, P6 in SURVEY.md
§2.4: host-side concurrency is not device-relevant).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from ..core.database import Reindexer, resolve_device
from ..core.errors import (ConflictError, NotFoundError, ParamsError,
                           QueryCanceledError,
                           QueryError, ReindexerError)
from ..core.payload import IndexDef
from ..core.transaction import Transaction
from ..query.dsl import parse_dsl
from ..query.query import Query
from ..query.results import QueryResults


class _Forbidden(Exception):
    """Role check failure raised after routing (maps to HTTP 403)."""


_SQL_WRITE_NEED = {"UPDATE": "data_write", "DELETE": "data_write",
                   "TRUNCATE": "db_admin", "DROP": "db_admin"}


def _sql_need(sql: str) -> str:
    """Role required to run a SQL statement, by statement type (reference:
    httpserver.cc:128-150 execQueryByType — select: data_read,
    update/delete: data_write, truncate: db_admin)."""
    head = sql.lstrip().split(None, 1)
    kw = head[0].upper() if head else ""
    return _SQL_WRITE_NEED.get(kw, "data_read")


def _required_role(method: str, parts: list[str], qs: dict) -> str:
    """Per-route minimum role, mirroring the reference's route table
    (httpserver.cc getDB<kRole...> per handler; dbmanager.cc:89,152:
    database create/drop require owner)."""
    if parts[:3] != ["api", "v1", "db"]:
        return "data_read" if method == "GET" else "data_write"
    rest = parts[3:]
    if not rest:                          # /api/v1/db (list | create db)
        return "owner" if method == "POST" else "data_read"
    sub = rest[1:]
    if not sub:                           # /api/v1/db/<db> (drop db)
        return "owner" if method == "DELETE" else "data_read"
    head = sub[0]
    if head == "query":
        if method == "GET":               # ?q= SQL gated by statement type
            return _sql_need(qs.get("q", [""])[0])
        # POST = DSL select; PUT = update query; DELETE = delete query
        return "data_read" if method == "POST" else "data_write"
    if head == "sqlquery":
        return "data_read"                # escalated in-handler via _require
    if head in ("dslquery", "suggest", "replication", "events"):
        return "data_read"
    if head == "transactions":
        return "data_write"
    if head == "namespaces":
        nsub = sub[1:]                    # [ns?, op?, ...]
        if len(nsub) <= 1:                # list/create | get/drop namespace
            return "data_read" if method == "GET" else "db_admin"
        op = nsub[1]
        if op in ("truncate", "rename"):
            return "db_admin"
        if op in ("indexes", "schema"):
            return "data_read" if method == "GET" else "db_admin"
        if op in ("knn_batch", "ft_batch"):
            return "data_read"            # batched searches are reads
        # items / metabykey / transactions(begin) / ...
        return "data_read" if method == "GET" else "data_write"
    return "data_read" if method == "GET" else "data_write"


class DBManager:
    """Multi-database root (reference: server/dbmanager.cc)."""

    def __init__(self, storage_root: str = "",
                 device="cuda"):
        self.storage_root = storage_root
        self.device = resolve_device(device)
        self.dbs: dict[str, Reindexer] = {}
        self.auth = None
        self.started_at = time.time()
        self._lock = threading.Lock()
        # rediscover persisted databases (reference: dbmanager scans the
        # storage root on startup)
        if storage_root and os.path.isdir(storage_root):
            for entry in sorted(os.listdir(storage_root)):
                if os.path.isdir(os.path.join(storage_root, entry)):
                    try:
                        self.create(entry)
                    except Exception:
                        pass

    def get(self, name: str) -> Reindexer:
        with self._lock:
            db = self.dbs.get(name)
            if db is None:
                raise NotFoundError(f"database '{name}' not found")
            return db

    def create(self, name: str) -> Reindexer:
        with self._lock:
            if name in self.dbs:
                return self.dbs[name]
            if not re.fullmatch(r"[A-Za-z0-9_\-]+", name):
                raise ParamsError(f"invalid database name '{name}'")
            dsn = _dsn_of(os.path.join(self.storage_root, name)) \
                if self.storage_root else ""
            db = Reindexer(dsn, device=self.device)
            self.dbs[name] = db
            return db

    def drop(self, name: str) -> None:
        with self._lock:
            db = self.dbs.pop(name, None)
            if db is None:
                raise NotFoundError(f"database '{name}' not found")
            db.close()

    def names(self) -> list[str]:
        return sorted(self.dbs.keys())


def _dsn_of(path: str) -> str:
    """The DSN of a database directory: `sqlite://` where it holds a sqlite
    store (storage.db), else the plain path (the JSONL engine)."""
    if os.path.isfile(os.path.join(path, "storage.db")):
        return "sqlite://" + path
    return path


def _items_payload(res: QueryResults, with_columns: bool = False) -> dict:
    out: dict[str, Any] = {"items": res.docs()}
    if res.total_count is not None:
        out["total_items"] = res.total_count
    out["query_total_items"] = res.total_count if res.total_count is not None \
        else len(res)
    if res.aggregations:
        out["aggregations"] = res.agg_results()
    if res.explain:
        out["explain"] = res.explain
    return out


try:
    import msgpack as _msgpack
except Exception:                     # pragma: no cover
    _msgpack = None


def _to_csv(items: list[dict]) -> str:
    """CSV rendering of result items (reference: csvbuilder.cc / queryresults
    CSV encoder): columns = ordered union of document keys; nested values are
    JSON-encoded in their cell."""
    import csv as _csv
    import io
    cols: list[str] = []
    seen = set()
    for doc in items:
        for k in doc:
            if k not in seen:
                seen.add(k)
                cols.append(k)
    buf = io.StringIO()
    w = _csv.writer(buf)
    w.writerow(cols)
    for doc in items:
        row = []
        for c in cols:
            v = doc.get(c)
            if isinstance(v, (dict, list)):
                v = json.dumps(v, ensure_ascii=False, default=str)
            row.append(v)
        w.writerow(row)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    server_version = "reindexer_tpu"
    protocol_version = "HTTP/1.1"
    mgr: DBManager = None            # set by make_server
    txs: dict[str, Transaction] = {}
    _fmt = "json"                    # per-request response format

    # silence request logging
    def log_message(self, fmt, *args):
        pass

    # --- plumbing -------------------------------------------------------
    def _send(self, code: int, payload: Any) -> None:
        """Serialize by negotiated format (reference: httpserver format=
        json|msgpack|csv-file per-request encoders, httpserver.cc queries/
        items routes)."""
        if self._fmt == "msgpack" and _msgpack is not None:
            body = _msgpack.packb(payload, default=str)
            ctype = "application/x-msgpack"
        elif self._fmt == "csv-file" and isinstance(payload, dict) \
                and isinstance(payload.get("items"), list):
            body = _to_csv(payload["items"]).encode("utf-8")
            ctype = "text/csv; charset=utf-8"
        elif self._fmt == "protobuf" and isinstance(payload, dict) \
                and isinstance(payload.get("items"), list) \
                and getattr(self, "_pb_ns", None) is not None:
            from ..core.protobuf import encode_query_results
            body = encode_query_results(self._pb_ns, payload)
            ctype = "application/protobuf"
        else:
            body = json.dumps(payload, ensure_ascii=False,
                              default=str).encode("utf-8")
            ctype = "application/json; charset=utf-8"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, ctype: str = "text/plain") -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


    def _send_qres(self, db, res) -> None:
        """Send query results honoring format=protobuf (needs the result
        namespace's schema for the item messages)."""
        if self._fmt == "protobuf":
            try:
                self._pb_ns = db.get_namespace(res.ns_name)
            except Exception:
                self._pb_ns = None
        self._send(200, _items_payload(res))

    def _err(self, code: int, msg: str) -> None:
        self._send(code, {"success": False, "response_code": code,
                          "description": msg})

    def _body(self) -> Any:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length == 0:
            return None
        raw = self.rfile.read(length)
        if not raw:
            return None
        ctype = self.headers.get("Content-Type") or ""
        if "msgpack" in ctype and _msgpack is not None:
            return _msgpack.unpackb(raw)
        return json.loads(raw.decode("utf-8"))

    def _check_auth(self, method: str, parts: list[str],
                    qs: dict) -> Optional[str]:
        """Authenticate and enforce the per-route role, mirroring the
        reference's per-handler role templates (httpserver.cc getDB<kRole...>
        + dbmanager.cc:89,152 owner gates for database create/drop). Returns
        an error string or None."""
        auth = getattr(self.mgr, "auth", None)
        self._auth_user = None
        if auth is None or not auth.enabled:
            return None
        user = auth.authenticate(self.headers.get("Authorization"))
        if user is None:
            return "unauthorized"
        self._auth_user = user
        db_name = parts[3] if len(parts) > 3 and parts[:3] == ["api", "v1", "db"] \
            else "*"
        self._auth_db = db_name
        need = _required_role(method, parts, qs)
        if not auth.allows(user, db_name, need):
            return f"forbidden: role '{auth.role_for(user, db_name)}' " \
                   f"lacks '{need}'"
        return None

    def _require(self, need: str, db_name: Optional[str] = None) -> None:
        """Late role escalation for routes whose required role depends on the
        request body (POST /sqlquery with UPDATE/DELETE/TRUNCATE SQL)."""
        auth = getattr(self.mgr, "auth", None)
        if auth is None or not auth.enabled:
            return
        db_name = db_name or getattr(self, "_auth_db", "*")
        user = getattr(self, "_auth_user", None)
        if not auth.allows(user, db_name, need):
            raise _Forbidden(f"forbidden: role "
                             f"'{auth.role_for(user, db_name)}' lacks '{need}'")

    def _route(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        parts = [urllib.parse.unquote(p) for p in parsed.path.split("/")
                 if p != ""]
        qs = urllib.parse.parse_qs(parsed.query)
        fmt = qs.get("format", [None])[0]
        if fmt is None and "msgpack" in (self.headers.get("Accept") or ""):
            fmt = "msgpack"
        self._fmt = fmt or "json"
        self._pb_ns = None     # per-request (keep-alive reuses the handler)
        try:
            err = self._check_auth(method, parts, qs)
            if err == "unauthorized":
                return self._err(401, "unauthorized")
            if err is not None:
                return self._err(403, err)
            from .. import tracing
            if tracing.enabled():
                with tracing.span(f"HTTP {method}",
                                  http_path=parsed.path,
                                  http_method=method):
                    self._dispatch(method, parts, qs)
            else:
                self._dispatch(method, parts, qs)
        except _Forbidden as e:
            self._err(403, str(e))
        except QueryCanceledError as e:
            # reference: errTimeout/errCanceled -> HTTP 408 (httpserver.cc)
            self._err(408, str(e))
        except NotFoundError as e:
            self._err(404, str(e))
        except (ParamsError, QueryError, json.JSONDecodeError) as e:
            self._err(400, str(e))
        except ConflictError as e:
            self._err(409, str(e))
        except ReindexerError as e:
            self._err(500, str(e))
        except Exception as e:          # pragma: no cover
            self._err(500, f"internal error: {e}")

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_PATCH(self):
        self._route("PATCH")

    def do_DELETE(self):
        self._route("DELETE")

    @staticmethod
    def _qctx(qs: dict):
        """Per-request deadline from ?timeout_ms= (reference: the HTTP
        server threads an execution deadline into RdxContext)."""
        import contextlib
        t = qs.get("timeout_ms", [None])[0]
        if not t:
            return contextlib.nullcontext()
        from ..core import rdxcontext
        return rdxcontext.context(timeout_ms=float(t), tag="http")

    # --- routing table (reference: httpserver.cc:1098-1164) -------------
    def _dispatch(self, method: str, p: list[str], qs: dict) -> None:
        if method == "GET" and (not p or p[0] in ("face", "facestaging")):
            # bundled admin UI (reference: DocHandler /face routes,
            # httpserver.cc:1060,1101-1104)
            if not p:
                self.send_response(302)
                self.send_header("Location", "/face/")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            from .face import FACE_HTML
            return self._send_text(200, FACE_HTML,
                                   "text/html; charset=utf-8")
        if p[:3] == ["api", "v1", "check"] and method == "GET":
            return self._send(200, {"status": "OK",
                                    "version": "reindexer_tpu"})
        if p == ["metrics"] and method == "GET":
            return self._metrics()
        if p[:2] == ["debug", "pprof"] and method == "GET":
            return self._pprof(p[2:], qs)
        if p[:3] == ["api", "v1", "db"]:
            rest = p[3:]
            if not rest:
                if method == "GET":
                    return self._send(200, {"items": self.mgr.names(),
                                            "total_items": len(self.mgr.names())})
                if method == "POST":
                    body = self._body() or {}
                    self.mgr.create(body.get("name", ""))
                    return self._send(200, {"success": True})
            else:
                return self._db_routes(method, rest, qs)
        if p[:4] == ["api", "v1", "query", "convert"]:
            return self._convert(method, p[4], qs)
        if p[:3] == ["api", "v1", "allocator"] and method == "GET":
            # allocator/info analog (reference: GetMemInfo route)
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF)
            return self._send(200, {
                "rss_kb": ru.ru_maxrss,
                "user_cpu_s": ru.ru_utime,
                "system_cpu_s": ru.ru_stime,
            })
        raise NotFoundError(f"no route for {method} {'/'.join(p)}")

    def _db_routes(self, method: str, p: list[str], qs: dict) -> None:
        db_name = p[0]
        rest = p[1:]
        if not rest and method == "DELETE":
            self.mgr.drop(db_name)
            return self._send(200, {"success": True})
        db = self.mgr.get(db_name)
        if not rest:
            raise NotFoundError("no route")
        head = rest[0]

        if head == "query":
            if method == "GET":
                sql = qs.get("q", [""])[0]
                with self._qctx(qs):
                    return self._send_qres(db, db.select(sql))
            if method == "POST":
                q = parse_dsl(self._body() or {})
                with self._qctx(qs):
                    return self._send_qres(db, db.select(q))
            if method == "PUT":
                q = parse_dsl(self._body() or {})
                return self._send(200, _items_payload(db.update_query(q)))
            if method == "DELETE":
                q = parse_dsl(self._body() or {})
                n = db.delete_query(q)
                return self._send(200, {"items": [], "updated": n})
        if head == "sqlquery" and method == "POST":
            length = int(self.headers.get("Content-Length", 0) or 0)
            sql = self.rfile.read(length).decode("utf-8")
            self._require(_sql_need(sql), db_name)
            with self._qctx(qs):
                return self._send_qres(db, db.select(sql))
        if head == "dslquery" and method == "POST":
            q = parse_dsl(self._body() or {})
            with self._qctx(qs):
                return self._send_qres(db, db.select(q))
        if head == "protobuf_schema" and method == "GET":
            # reference: httpserver.cc:936 GetProtobufSchema (?ns=&ns[]=)
            from ..core.protobuf import schema_text
            nses = qs.get("ns", []) + qs.get("ns[]", [])
            if not nses:
                nses = db.namespace_names()
            return self._send_text(200, schema_text(db, nses))
        if head == "namespaces":
            return self._ns_routes(db, method, rest[1:], qs)
        if head == "transactions":
            return self._tx_routes(db, method, rest[1:], qs)
        if head == "events":
            return self._event_routes(db, method, rest[1:], qs)
        if head == "suggest" and method == "GET":
            from ..query.suggest import suggest
            sql = qs.get("q", [""])[0]
            pos = int(qs.get("pos", [str(len(sql))])[0])
            return self._send(200, {"suggests": suggest(db, sql, pos)})
        if head == "replication":
            # leader-side replication verbs (reference: RPC snapshot/updates
            # verbs, server/rpcserver.cc:1382-1384)
            state = getattr(db, "_replication_state", None)
            if state is None:
                from ..replication import ReplicationState
                state = ReplicationState(db)
            if len(rest) > 1 and rest[1] == "updates" and method == "GET":
                from_lsn = int(qs.get("from_lsn", ["0"])[0])
                return self._send(200, state.updates(from_lsn))
            if len(rest) > 1 and rest[1] == "snapshot" and method == "GET":
                return self._send(200, state.snapshot())
            if len(rest) > 1 and rest[1] == "snapshot_meta" \
                    and method == "GET":
                return self._send(200, state.snapshot_meta())
            if len(rest) > 1 and rest[1] == "snapshot_chunk" \
                    and method == "GET":
                return self._send(200, state.snapshot_chunk(
                    qs.get("ns", [""])[0],
                    int(qs.get("offset", ["0"])[0]),
                    int(qs.get("limit", ["1000"])[0])))
        raise NotFoundError(f"no route for {method} /{'/'.join(p)}")

    # --- namespaces -----------------------------------------------------
    def _ns_routes(self, db: Reindexer, method: str, p: list[str],
                   qs: dict) -> None:
        if not p:
            if method == "GET":
                items = [{"name": n} for n in db.namespace_names()]
                return self._send(200, {"items": items,
                                        "total_items": len(items)})
            if method == "POST":
                body = self._body() or {}
                idefs = [IndexDef.from_dict(i)
                         for i in body.get("indexes", [])]
                db.open_namespace(body["name"], idefs)
                return self._send(200, {"success": True})
        ns_name = p[0]
        sub = p[1:]
        if not sub:
            if method == "GET":
                ns = db.get_namespace(ns_name)
                return self._send(200, {
                    "name": ns.name,
                    "indexes": [d.to_dict() for d in ns.index_defs()]})
            if method == "DELETE":
                db.drop_namespace(ns_name)
                return self._send(200, {"success": True})
        head = sub[0] if sub else ""
        if head == "truncate" and method == "DELETE":
            db.truncate_namespace(ns_name)
            return self._send(200, {"success": True})
        if head == "rename" and method == "GET" and len(sub) == 2:
            db.rename_namespace(ns_name, sub[1])
            return self._send(200, {"success": True})
        if head == "items":
            return self._item_routes(db, ns_name, method, qs)
        if head == "indexes":
            return self._index_routes(db, ns_name, method, sub[1:])
        if head == "schema":
            if method == "PUT":
                db.set_schema(ns_name, self._body() or {})
                return self._send(200, {"success": True})
            if method == "GET":
                return self._send(200,
                                  db.get_namespace(ns_name).schema or {})
        if head == "knn_batch" and method == "POST":
            # batched KNN serving (TPU extension: N query vectors answered
            # by one device program)
            body = self._body() or {}
            from ..index.vector.params import KnnSearchParams
            params = KnnSearchParams.from_dict(body.get("params", {}))
            results = db.knn_batch(ns_name, body["field"],
                                   body["queries"], params)
            return self._send(200, {"results": [
                {"items": r.docs(),
                 "ranks": [it.rank for it in r]} for r in results]})
        if head == "ft_batch" and method == "POST":
            body = self._body() or {}
            results = db.ft_batch(ns_name, body["field"], body["queries"])
            return self._send(200, {"results": [
                {"items": r.docs(),
                 "ranks": [it.rank for it in r]} for r in results]})
        if head == "metalist" and method == "GET":
            keys = db.enum_meta(ns_name)
            return self._send(200, {"meta": [{"key": k} for k in keys],
                                    "total_items": len(keys)})
        if head == "metabykey":
            if method == "GET" and len(sub) == 2:
                v = db.get_meta(ns_name, sub[1])
                if v is None:
                    raise NotFoundError(f"meta key '{sub[1]}' not found")
                return self._send(200, {"key": sub[1], "value": v})
            if method == "PUT":
                body = self._body() or {}
                db.put_meta(ns_name, body["key"], str(body["value"]))
                return self._send(200, {"success": True})
            if method == "DELETE" and len(sub) == 2:
                db.delete_meta(ns_name, sub[1])
                return self._send(200, {"success": True})
        raise NotFoundError(f"no namespace route '{head}'")

    def _item_routes(self, db: Reindexer, ns: str, method: str,
                     qs: dict) -> None:
        if method == "GET":
            q = Query(ns)
            flt = qs.get("filter", [None])[0]
            if flt:
                from ..query.sql import _Parser
                p = _Parser(flt)
                p.conditions(q)
            if qs.get("sort_field"):
                q.sort(qs["sort_field"][0],
                       qs.get("sort_order", ["asc"])[0] == "desc")
            q.limit(int(qs.get("limit", [1000])[0]))
            q.offset(int(qs.get("offset", [0])[0]))
            q.req_total_count()
            return self._send_qres(db, db.select(q))
        body = self._body()
        docs = body if isinstance(body, list) else [body]
        # atomic on-update functions, repeated query param (reference:
        # httpserver.cc:1225 modifyItemsJSON precepts)
        precepts = qs.get("precepts") or None
        n = 0
        for doc in docs:
            if doc is None:
                continue
            if method == "POST":
                db.insert(ns, doc, precepts=precepts)
            elif method == "PUT":
                db.upsert(ns, doc, precepts=precepts)
            elif method == "PATCH":
                db.update(ns, doc, precepts=precepts)
            elif method == "DELETE":
                db.delete(ns, doc)
            n += 1
        resp: dict[str, Any] = {"success": True, "updated": n}
        if precepts:
            # reference returns the precept-computed items back
            resp["items"] = [d for d in docs if d is not None]
        return self._send(200, resp)

    def _index_routes(self, db: Reindexer, ns: str, method: str,
                      p: list[str]) -> None:
        if method == "GET":
            defs = [d.to_dict() for d in db.get_namespace(ns).index_defs()]
            return self._send(200, {"items": defs, "total_items": len(defs)})
        if method == "POST":
            db.add_index(ns, IndexDef.from_dict(self._body()))
            return self._send(200, {"success": True})
        if method == "PUT":
            db.update_index(ns, IndexDef.from_dict(self._body()))
            return self._send(200, {"success": True})
        if method == "DELETE" and p:
            db.drop_index(ns, p[0])
            return self._send(200, {"success": True})
        raise NotFoundError("no index route")

    # --- transactions (reference: BeginTx/CommitTx/RollbackTx routes) ----
    def _tx_routes(self, db: Reindexer, method: str, p: list[str],
                   qs: dict) -> None:
        if not p:
            raise NotFoundError("no tx route")
        tx_id = p[0]
        action = p[1] if len(p) > 1 else ""
        if action == "commit" and method == "POST":
            tx = self.txs.pop(tx_id, None)
            if tx is None:
                raise NotFoundError(f"transaction '{tx_id}' not found")
            tx.commit()
            return self._send(200, {"success": True})
        if action == "rollback" and method == "POST":
            tx = self.txs.pop(tx_id, None)
            if tx is None:
                raise NotFoundError(f"transaction '{tx_id}' not found")
            tx.rollback()
            return self._send(200, {"success": True})
        if action == "items":
            tx = self.txs.get(tx_id)
            if tx is None:
                raise NotFoundError(f"transaction '{tx_id}' not found")
            body = self._body()
            docs = body if isinstance(body, list) else [body]
            for doc in docs:
                if method in ("POST",):
                    tx.insert(doc)
                elif method == "PUT":
                    tx.upsert(doc)
                elif method == "PATCH":
                    tx.update(doc)
                elif method == "DELETE":
                    tx.delete(doc)
            return self._send(200, {"success": True})
        raise NotFoundError("no tx route")

    # --- events (long-poll edge of the reference's event subscriptions,
    # cpp_src/events/ + Go events/eventshandler.go) ----------------------
    subs: dict = {}

    def _event_routes(self, db, method: str, p: list[str], qs: dict) -> None:
        from ..events import EventsObserver, EventSubscriberConfig
        obs = getattr(db, "_events_observer", None)
        if obs is None:
            obs = EventsObserver()
            obs.attach_db(db)
        if not p and method == "POST":
            body = self._body() or {}
            cfg = EventSubscriberConfig(
                namespaces=tuple(body.get("namespaces", ())),
                event_types=tuple(body.get("event_types", ())))
            sub = obs.subscribe(cfg)
            sub_id = uuid.uuid4().hex[:16]
            self.subs[sub_id] = (obs, sub)
            return self._send(200, {"subscription_id": sub_id})
        if p and method == "GET":
            entry = self.subs.get(p[0])
            if entry is None:
                raise NotFoundError(f"subscription '{p[0]}' not found")
            timeout = min(float(qs.get("timeout_ms", ["1000"])[0]), 30000) / 1e3
            events = entry[1].poll(timeout=timeout)
            return self._send(200, {"events": [e.to_dict() for e in events],
                                    "dropped": entry[1].dropped})
        if p and method == "DELETE":
            entry = self.subs.pop(p[0], None)
            if entry is None:
                raise NotFoundError(f"subscription '{p[0]}' not found")
            entry[0].unsubscribe(entry[1])
            return self._send(200, {"success": True})
        raise NotFoundError("no events route")

    # --- misc -----------------------------------------------------------
    def _convert(self, method: str, kind: str, qs: dict) -> None:
        from ..query.dsl import to_dsl
        from ..query.sql import parse_sql
        if kind == "sql" and method == "POST":
            length = int(self.headers.get("Content-Length", 0) or 0)
            sql = self.rfile.read(length).decode("utf-8")
            return self._send(200, to_dsl(parse_sql(sql)))
        raise NotFoundError("no convert route")

    def _metrics(self) -> None:
        """Prometheus exposition (reference:
        server/statscollect/prometheus.cc — reindexer_qps_total,
        reindexer_avg_latency, reindexer_memstats_* families)."""
        lines = [
            "# TYPE reindexer_items_count gauge",
            "# TYPE reindexer_memstats_data_size_bytes gauge",
            "# TYPE reindexer_queries_total counter",
            "# TYPE reindexer_avg_latency_seconds gauge",
        ]
        for db_name in self.mgr.names():
            db = self.mgr.dbs[db_name]
            for ns_name in db.namespace_names():
                ns = db.get_namespace(ns_name)
                labels = f'{{db="{db_name}",ns="{ns_name}"}}'
                lines.append(
                    f"reindexer_items_count{labels} {ns.item_count()}")
                data_size = sum(int(m.get("data_size", 0))
                                for m in (ix.memstat()
                                          for ix in ns.indexes))
                lines.append(
                    f"reindexer_memstats_data_size_bytes{labels} {data_size}")
                for op, st in ns.perf.stats().items():
                    op_labels = (f'{{db="{db_name}",ns="{ns_name}",'
                                 f'op="{op}"}}')
                    lines.append(
                        f"reindexer_queries_total{op_labels} "
                        f"{st['total_queries_count']}")
                    lines.append(
                        f"reindexer_avg_latency_seconds{op_labels} "
                        f"{st['total_avg_latency_us'] / 1e6:.6g}")
        lines.append("# TYPE reindexer_uptime_seconds gauge")
        lines.append(f"reindexer_uptime_seconds "
                     f"{time.time() - self.mgr.started_at:.1f}")
        self._send_text(200, "\n".join(lines) + "\n",
                        "text/plain; version=0.0.4")

    def _pprof(self, p: list[str], qs: dict) -> None:
        """pprof-analog debug surface (reference: optional gperftools
        /debug/pprof routes, server/pprof/pprof.cc): `threads` dumps every
        thread's stack (goroutine-profile analog); `profile?seconds=N`
        samples all thread stacks at ~10ms and returns collapsed
        flamegraph-format stacks."""
        import sys
        import traceback

        if p == ["threads"]:
            frames = sys._current_frames()
            out = []
            for t in threading.enumerate():
                f = frames.get(t.ident)
                out.append(f"--- thread {t.name} ({t.ident}) ---")
                if f is not None:
                    out.extend(s.rstrip()
                               for s in traceback.format_stack(f))
            return self._send_text(200, "\n".join(out) + "\n")
        if p == ["profile"]:
            seconds = min(float(qs.get("seconds", ["2"])[0]), 30.0)
            me = threading.get_ident()
            counts: dict[str, int] = {}
            deadline = time.time() + seconds
            while time.time() < deadline:
                for tid, f in sys._current_frames().items():
                    if tid == me:
                        continue
                    stack = []
                    while f is not None:
                        stack.append(f"{f.f_code.co_name} "
                                     f"({f.f_code.co_filename.rsplit('/', 1)[-1]}"
                                     f":{f.f_lineno})")
                        f = f.f_back
                    key = ";".join(reversed(stack))
                    counts[key] = counts.get(key, 0) + 1
                time.sleep(0.01)
            body = "\n".join(f"{k} {v}" for k, v in
                             sorted(counts.items(), key=lambda kv: -kv[1]))
            return self._send_text(200, body + "\n")
        raise NotFoundError("no pprof route")


# tx begin lives under the namespace path in the reference route table
_TX_BEGIN_RE = re.compile(
    r"^/api/v1/db/([^/]+)/namespaces/([^/]+)/transactions/begin$")

_orig_dispatch = _Handler._dispatch


def _dispatch_with_tx_begin(self, method, p, qs):
    path = "/" + "/".join(p)
    m = _TX_BEGIN_RE.match(path)
    if m and method == "POST":
        db = self.mgr.get(m.group(1))
        tx = db.new_transaction(m.group(2))
        tx_id = uuid.uuid4().hex[:16]
        self.txs[tx_id] = tx
        return self._send(200, {"tx_id": tx_id})
    return _orig_dispatch(self, method, p, qs)


_Handler._dispatch = _dispatch_with_tx_begin


class ReindexerServer:
    """Standalone server facade (reference: cpp_src/cmd/reindexer_server)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9088,
                 storage_root: str = "", auth=None,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 device="cuda"):
        self.mgr = DBManager(storage_root, device)
        self.mgr.auth = auth   # AuthManager or None (reference: dbmanager)
        # TCP_NODELAY: without it, HTTP/1.1 keep-alive request/response
        # pairs hit the 40ms Nagle+delayed-ACK stall (measured: 21 qps vs
        # 400+ single-stream on loopback)
        handler = type("BoundHandler", (_Handler,),
                       {"mgr": self.mgr, "txs": {},
                        "disable_nagle_algorithm": True})
        # stdlib default accept backlog is 5: concurrent clients beyond it
        # get connection RESETS under load (reference server's ev loop
        # listens with a deep backlog; cpp_src/net/listener.cc). 128 covers
        # any sane connection count; the kernel caps it at somaxconn.
        srv_cls = type("BoundServer", (ThreadingHTTPServer,),
                       {"request_queue_size": 128, "daemon_threads": True})
        self.httpd = srv_cls((host, port), handler)
        if certfile:
            # TLS termination (reference: server/ ENABLE_OPENSSL https
            # listener; stdlib ssl replaces the vendored openssl build)
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        for db in self.mgr.dbs.values():
            db.close()
