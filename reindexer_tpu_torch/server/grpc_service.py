"""Port of reindexer_tpu/server/grpc_service.py: the reference's service
over the port's `DBManager` (the same contract, reindexer_grpc.proto, and
the same wire codec). `grpcio` is imported only when a server is made, so
importing this module never needs it.

The reference's notes follow.

gRPC service — full mirror of the reference's optional ENABLE_GRPC
plane (cpp_src/server/proto/reindexer.proto, 439 lines, +
server/grpc/reindexerservice.cc): same package/service, complete rpc set
(DDL, ModifyItem, ExecSql/Select/Update/Delete streams, metadata,
transactions, schema), same message names and field numbers, so reference
gRPC clients work unchanged. Contract: reindexer_grpc.proto next to this
file.

Implementation is codegen-free: a small proto3 wire codec (specs below
mirror the .proto, including nested messages and zigzag sint64) +
grpcio generic handlers, so the server has no protoc build step. Clients
compile reindexer_grpc.proto with stock protoc/grpcio tooling — tests do
exactly that to prove wire compatibility.

Query results stream one QueryResultsResponse per item (options only on
the first response, like the reference's ExecSql loop in
reindexerservice.cc), encoded per OutputFlags.encodingType: JSON,
CJSON (core/cjson.py document codec), MSGPACK, or the per-namespace
protobuf item encoding served by GetProtobufSchema. withRank adds a
"rank()" key and withItemID a "#rowid" key to dict-shaped encodings
(the reference injects the same values as cjson pseudo-tags).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from concurrent import futures
from typing import Any, Optional

from ..core.errors import (ConflictError, LogicError, NotFoundError,
                           ParamsError, QueryCanceledError, QueryError,
                           QueryTimeoutError, ReindexerError, StorageError)
from ..core.payload import IndexDef
from ..core.protobuf import encode_varint as _write_varint

SERVICE = "reindexer.grpc.Reindexer"

# ---------------------------------------------------------------------------
# minimal proto3 wire codec: spec = {field_num: (name, kind)} where kind is
#   "string" | "bytes" | "int" (plain varint) | "sint" (zigzag varint) |
#   "bool"; a "*" suffix marks repeated scalars; a dict kind is a nested
#   message spec; [dict] is a repeated nested message.
# ---------------------------------------------------------------------------


def _read_varint(b: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        x = b[i]
        i += 1
        out |= (x & 0x7F) << shift
        if not x & 0x80:
            return out, i
        shift += 7


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def decode(b: bytes, spec: dict) -> dict:
    out: dict[str, Any] = {}
    for name, kind in spec.values():
        out[name] = ([] if isinstance(kind, list)
                     or (isinstance(kind, str) and kind.endswith("*"))
                     else None)
    i = 0
    while i < len(b):
        tag, i = _read_varint(b, i)
        num, wt = tag >> 3, tag & 7
        ent = spec.get(num)
        if wt == 0:
            v, i = _read_varint(b, i)
            if ent:
                name, kind = ent
                if kind in ("sint", "sint*"):
                    _store(out, ent, _unzigzag(v))
                elif kind in ("bool", "bool*"):
                    _store(out, ent, bool(v))
                elif kind in ("int", "int*"):
                    _store(out, ent, v)
        elif wt == 2:
            ln, i = _read_varint(b, i)
            raw = b[i: i + ln]
            i += ln
            if ent:
                name, kind = ent
                if isinstance(kind, dict):
                    out[name] = decode(raw, kind)
                elif isinstance(kind, list):
                    out[name].append(decode(raw, kind[0]))
                elif kind.startswith("string"):
                    _store(out, ent, raw.decode("utf-8"))
                elif kind.startswith("bytes"):
                    _store(out, ent, raw)
        elif wt == 5:
            i += 4
        elif wt == 1:
            i += 8
        else:
            raise ValueError(f"bad wire type {wt}")
    return out


def _store(out: dict, ent: tuple, v: Any) -> None:
    name, kind = ent
    if isinstance(kind, str) and kind.endswith("*"):
        out[name].append(v)
    else:
        out[name] = v


def encode(msg: dict, spec: dict) -> bytes:
    out = bytearray()
    for num, (name, kind) in spec.items():
        v = msg.get(name)
        if v is None:
            continue
        if isinstance(kind, dict):
            data = encode(v, kind)
            _write_varint((num << 3) | 2, out)
            _write_varint(len(data), out)
            out += data
            continue
        if isinstance(kind, list):
            for item in v:
                data = encode(item, kind[0])
                _write_varint((num << 3) | 2, out)
                _write_varint(len(data), out)
                out += data
            continue
        vals = v if kind.endswith("*") else [v]
        base = kind.rstrip("*")
        for x in vals:
            if base == "int":
                if x == 0:
                    continue
                _write_varint(num << 3, out)
                _write_varint(int(x), out)
            elif base == "sint":
                if x == 0:
                    continue
                _write_varint(num << 3, out)
                _write_varint(_zigzag(int(x)), out)
            elif base == "bool":
                if not x:
                    continue
                _write_varint(num << 3, out)
                _write_varint(1, out)
            else:
                data = x.encode("utf-8") if isinstance(x, str) else bytes(x)
                if not data:
                    continue
                _write_varint((num << 3) | 2, out)
                _write_varint(len(data), out)
                out += data
    return bytes(out)


# message specs (names + field numbers mirror reindexer_grpc.proto, which
# mirrors the reference proto)
ERROR = {1: ("code", "int"), 2: ("what", "string")}
DB_REQ = {1: ("dbName", "string")}
NS_REQ = {1: ("dbName", "string"), 2: ("nsName", "string")}
INDEX_OPTS = {1: ("isPk", "bool"), 2: ("isArray", "bool"),
              3: ("isDense", "bool"), 4: ("isSparse", "bool"),
              5: ("rtreeType", "int"), 6: ("collateMode", "int"),
              7: ("sortOrdersTable", "string"), 8: ("config", "string")}
INDEX = {1: ("name", "string"), 2: ("jsonPaths", "string*"),
         3: ("indexType", "string"), 4: ("fieldType", "string"),
         5: ("options", INDEX_OPTS), 6: ("expireAfter", "sint")}
ADD_INDEX = {1: ("dbName", "string"), 2: ("nsName", "string"),
             3: ("definition", INDEX)}
SCHEMA_DEF = {1: ("nsName", "string"), 2: ("jsonData", "string")}
SET_SCHEMA = {1: ("dbName", "string"),
              2: ("schemaDefinitionRequest", SCHEMA_DEF)}
STORAGE_OPTS = {1: ("nsName", "string"), 2: ("enabled", "bool"),
                3: ("dropOnFileFormatError", "bool"),
                4: ("createIfMissing", "bool"),
                5: ("verifyChecksums", "bool"), 6: ("fillCache", "bool"),
                7: ("sync", "bool")}
OPEN_NS = {1: ("dbName", "string"), 2: ("storageOptions", STORAGE_OPTS)}
NAMESPACE = {1: ("dbName", "string"), 2: ("name", "string"),
             3: ("storageOptions", STORAGE_OPTS),
             4: ("indexesDefinitions", [INDEX])}
ADD_NS = {1: ("dbName", "string"), 2: ("namespace", NAMESPACE)}
ENUM_NS_OPTS = {1: ("filter", "string"), 2: ("withClosed", "bool"),
                3: ("onlyNames", "bool"), 4: ("hideSystems", "bool")}
ENUM_NS_REQ = {1: ("dbName", "string"), 2: ("options", ENUM_NS_OPTS)}
ENUM_NS_RESP = {1: ("namespacesDefinitions", [NAMESPACE]),
                2: ("errorResponse", ERROR)}
NAMES_RESP = {1: ("names", "string*"), 2: ("errorResponse", ERROR)}
MODIFY = {1: ("dbName", "string"), 2: ("nsName", "string"),
          3: ("mode", "int"), 4: ("encodingType", "int"),
          5: ("data", "bytes")}
QUERY = {1: ("encodingType", "int"), 2: ("data", "bytes")}
OUTPUT_FLAGS = {1: ("encodingType", "int"), 2: ("withItemID", "bool"),
                3: ("withNsID", "bool"), 4: ("withRank", "bool"),
                5: ("withJoinedItems", "bool")}
SQL_REQ = {1: ("dbName", "string"), 2: ("sql", "string"),
           3: ("flags", OUTPUT_FLAGS)}
QUERY_REQ = {1: ("dbName", "string"), 2: ("query", QUERY),
             3: ("flags", OUTPUT_FLAGS)}
QR_OPTS = {1: ("totalItems", "sint"), 2: ("queryTotalItems", "sint"),
           3: ("cacheEnabled", "bool"), 4: ("explain", "string")}
QR_RESP = {1: ("data", "bytes"), 2: ("options", QR_OPTS),
           3: ("errorResponse", ERROR)}
CONNECT_OPTS = {1: ("expectedClusterID", "sint"),
                2: ("openNamespaces", "bool"),
                3: ("allowNamespaceErrors", "bool"),
                5: ("disableReplication", "bool"),
                6: ("storageType", "int")}
CONNECT_REQ = {1: ("url", "string"), 2: ("dbName", "string"),
               3: ("login", "string"), 4: ("password", "string"),
               5: ("connectOpts", CONNECT_OPTS)}
METADATA = {1: ("nsName", "string"), 2: ("key", "string"),
            3: ("value", "string")}
META_REQ = {1: ("dbName", "string"), 2: ("metadata", METADATA)}
META_RESP = {1: ("metadata", "string"), 2: ("errorResponse", ERROR)}
ENUM_META_REQ = {1: ("dbName", "string"), 2: ("nsName", "string")}
META_KEYS_RESP = {1: ("keys", "string*"), 2: ("errorResponse", ERROR)}
TX_ID = {1: ("id", "sint")}
TX_ID_RESP = {1: ("status", ERROR), 2: ("id", "sint")}
ADD_TX_ITEM = {1: ("id", "sint"), 2: ("mode", "int"),
               3: ("encodingType", "int"), 4: ("data", "bytes")}
BEGIN_TX = {1: ("dbName", "string"), 2: ("nsName", "string")}
PB_SCHEMA_REQ = {1: ("dbName", "string"), 2: ("namespaces", "string*")}
PB_SCHEMA_RESP = {1: ("proto", "string"), 2: ("errorResponse", ERROR)}

_MODE_UPSERT, _MODE_INSERT, _MODE_UPDATE, _MODE_DELETE = 0, 1, 2, 3
_ENC_JSON, _ENC_CJSON, _ENC_MSGPACK, _ENC_PROTOBUF = 0, 1, 2, 3

_RTREE = {0: "linear", 1: "quadratic", 2: "greene", 3: "rstar"}
_COLLATE = {0: "none", 1: "ascii", 2: "utf8", 3: "numeric", 4: "custom"}

class TxDoesNotExistError(NotFoundError):
    """Unknown transaction id (reference: errTxDoesNotExist)."""


# reference ErrorResponse.ErrorCode values for our exception types
_ERR_CODES: list[tuple[type, int]] = [
    (TxDoesNotExistError, 31),    # errCodeTxDoesNotExist
    (QueryTimeoutError, 19),      # errCodeTimeout
    (QueryCanceledError, 20),     # errCodeCanceled
    (ParamsError, 3),             # errCodeParams
    (NotFoundError, 13),          # errCodeNotFound
    (ConflictError, 7),           # errCodeConflict
    (LogicError, 4),              # errCodeLogic
    (StorageError, 37),           # errCodeSystem
    (QueryError, 2),              # errCodeQueryExec
    (json.JSONDecodeError, 5),    # errCodeParseJson
    (ReindexerError, 4),
]


def _err_code(e: Exception) -> int:
    for typ, code in _ERR_CODES:
        if isinstance(e, typ):
            return code
    return 37                      # errCodeSystem


def _ok() -> bytes:
    return encode({"code": 0}, ERROR)


def _err(e: Exception) -> bytes:
    return encode({"code": _err_code(e), "what": str(e)}, ERROR)


def _err_dict(e: Exception) -> dict:
    return {"code": _err_code(e), "what": str(e)}


def _index_from_msg(d: Optional[dict]) -> IndexDef:
    """grpc Index message -> IndexDef (reference maps the same fields in
    reindexerservice.cc indexFromMsg)."""
    if not d or not d.get("name"):
        raise ParamsError("index definition required")
    opts = d.get("options") or {}
    cfg = {}
    if opts.get("config"):
        cfg = json.loads(opts["config"])
    idef = IndexDef.from_dict({
        "name": d["name"],
        "json_paths": d["jsonPaths"] or [d["name"]],
        "index_type": d.get("indexType") or "hash",
        "field_type": d.get("fieldType") or "string",
        "is_pk": opts.get("isPk") or False,
        "is_array": opts.get("isArray") or False,
        "is_dense": opts.get("isDense") or False,
        "is_sparse": opts.get("isSparse") or False,
        "collate_mode": _COLLATE.get(opts.get("collateMode") or 0, "none"),
        "expire_after": d.get("expireAfter") or 0,
        "config": cfg,
    })
    idef.opts.rtree_type = _RTREE.get(opts.get("rtreeType") or 0, "rstar")
    return idef


class GrpcReindexerServer:
    """Codegen-free gRPC front over a DBManager (server/http.py DBManager —
    the same multi-database root the HTTP plane uses)."""

    def __init__(self, mgr, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 4):
        import grpc
        self._grpc = grpc
        self.mgr = mgr
        self._txs: dict[int, Any] = {}
        self._tx_ids = itertools.count(1)
        self._tx_lock = threading.Lock()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)

    # ------------------------------------------------------------------
    def _handler(self):
        grpc = self._grpc
        svc = self
        ident = lambda b: b

        unary = {
            "Connect": (CONNECT_REQ, svc._connect),
            "CreateDatabase": (DB_REQ, svc._create_db),
            "OpenNamespace": (OPEN_NS, svc._open_ns),
            "AddNamespace": (ADD_NS, svc._add_ns),
            "CloseNamespace": (NS_REQ, svc._close_ns),
            "DropNamespace": (NS_REQ, svc._drop_ns),
            "TruncateNamespace": (NS_REQ, svc._truncate_ns),
            "AddIndex": (ADD_INDEX, svc._add_index),
            "UpdateIndex": (ADD_INDEX, svc._update_index),
            "DropIndex": (ADD_INDEX, svc._drop_index),
            "SetSchema": (SET_SCHEMA, svc._set_schema),
            "EnumNamespaces": (ENUM_NS_REQ, svc._enum_ns),
            "EnumDatabases": ({}, svc._enum_dbs),
            "GetMeta": (META_REQ, svc._get_meta),
            "PutMeta": (META_REQ, svc._put_meta),
            "EnumMeta": (ENUM_META_REQ, svc._enum_meta),
            "DeleteMeta": (META_REQ, svc._delete_meta),
            "GetProtobufSchema": (PB_SCHEMA_REQ, svc._pb_schema),
            "BeginTransaction": (BEGIN_TX, svc._begin_tx),
            "CommitTransaction": (TX_ID, svc._commit_tx),
            "RollbackTransaction": (TX_ID, svc._rollback_tx),
        }
        query_streams = {
            "ExecSql": (SQL_REQ, svc._exec_sql),
            "Select": (QUERY_REQ, svc._select),
            "Update": (QUERY_REQ, svc._update),
            "Delete": (QUERY_REQ, svc._delete),
        }

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                prefix = f"/{SERVICE}/"
                if not details.method.startswith(prefix):
                    return None
                name = details.method[len(prefix):]
                if name in unary:
                    spec, fn = unary[name]

                    def run(req, ctx, spec=spec, fn=fn):
                        try:
                            return fn(decode(req, spec))
                        except Exception as e:   # -> ErrorResponse
                            return _err(e)

                    return grpc.unary_unary_rpc_method_handler(
                        run, request_deserializer=ident,
                        response_serializer=ident)
                if name in query_streams:
                    spec, fn = query_streams[name]

                    def run_q(req, ctx, spec=spec, fn=fn):
                        yield from fn(decode(req, spec))
                    return grpc.unary_stream_rpc_method_handler(
                        run_q, request_deserializer=ident,
                        response_serializer=ident)
                if name == "ModifyItem":
                    def run_modify(req_iter, ctx):
                        for raw in req_iter:
                            try:
                                svc._modify(decode(raw, MODIFY))
                                yield _ok()
                            except Exception as e:
                                yield _err(e)
                    return grpc.stream_stream_rpc_method_handler(
                        run_modify, request_deserializer=ident,
                        response_serializer=ident)
                if name == "AddTxItem":
                    def run_tx_item(req_iter, ctx):
                        for raw in req_iter:
                            try:
                                svc._add_tx_item(decode(raw, ADD_TX_ITEM))
                                yield _ok()
                            except Exception as e:
                                yield _err(e)
                    return grpc.stream_stream_rpc_method_handler(
                        run_tx_item, request_deserializer=ident,
                        response_serializer=ident)
                return None

        return Handler()

    # --- helpers --------------------------------------------------------
    def _db(self, req):
        return self.mgr.get(req["dbName"])

    def _decode_item(self, db, ns_name: str, enc: int, data: bytes) -> dict:
        if enc == _ENC_CJSON:
            from ..core.cjson import decode_doc
            doc = decode_doc(bytes(data))
        elif enc == _ENC_MSGPACK:
            try:
                import msgpack
            except ImportError as e:
                raise ParamsError("msgpack not available") from e
            doc = msgpack.unpackb(bytes(data))
        elif enc == _ENC_PROTOBUF:
            from ..core.protobuf import decode_item
            doc = decode_item(db.get_namespace(ns_name), bytes(data))
        else:
            doc = json.loads(bytes(data).decode("utf-8"))
        if not isinstance(doc, dict):
            raise ParamsError("item must decode to an object")
        return doc

    def _encode_result_item(self, db, ns_name: str, item, flags: dict,
                            fields=None) -> bytes:
        enc = (flags or {}).get("encodingType") or _ENC_JSON
        doc = item.doc
        extra = {}
        if (flags or {}).get("withRank") and item.rank is not None:
            extra["rank()"] = float(item.rank)
        if (flags or {}).get("withItemID"):
            extra["#rowid"] = int(item.row_id)
        if extra:
            doc = {**doc, **extra}
        if enc == _ENC_PROTOBUF:
            from ..core.protobuf import encode_item
            return encode_item(db.get_namespace(ns_name), doc,
                               fields=fields)
        if enc == _ENC_CJSON:
            from ..core.cjson import encode_doc
            return encode_doc(doc)
        if enc == _ENC_MSGPACK:
            try:
                import msgpack
            except ImportError as e:
                raise ParamsError("msgpack not available") from e
            return msgpack.packb(doc, default=str)
        return json.dumps(doc, ensure_ascii=False,
                          default=str).encode("utf-8")

    def _stream_results(self, db, res, flags: dict):
        """One QueryResultsResponse per item; options only on the first
        (reference: reindexerservice.cc packCJSONItem loop)."""
        opts = {"queryTotalItems": len(res)}
        if res.total_count is not None:
            opts["totalItems"] = res.total_count
        if res.explain is not None:
            opts["explain"] = json.dumps(res.explain, default=str)
        fields = None
        enc = (flags or {}).get("encodingType") or _ENC_JSON
        if enc == _ENC_PROTOBUF and res.ns_name:
            from ..core.protobuf import _ns_fields
            fields = _ns_fields(db.get_namespace(res.ns_name))
        first = True
        sent = False
        for item in res:
            msg = {"data": self._encode_result_item(
                db, res.ns_name, item, flags, fields=fields)}
            if first:
                msg["options"] = opts
                first = False
            sent = True
            yield encode(msg, QR_RESP)
        if not sent:
            yield encode({"options": opts}, QR_RESP)

    def _run_query_stream(self, req, runner):
        try:
            db = self._db(req)
            res = runner(db)
            yield from self._stream_results(db, res, req.get("flags"))
        except Exception as e:
            yield encode({"errorResponse": _err_dict(e)}, QR_RESP)

    def _parse_query(self, msg: Optional[dict]):
        from ..query.dsl import parse_dsl
        if not msg or not msg.get("data"):
            raise ParamsError("query required")
        enc = msg.get("encodingType") or _ENC_JSON
        if enc != _ENC_JSON:
            raise ParamsError("only JSON-encoded queries are supported")
        return parse_dsl(json.loads(bytes(msg["data"]).decode("utf-8")))

    # --- method impls --------------------------------------------------
    def _connect(self, req) -> bytes:
        name = req["dbName"] or (req["url"] or "").rsplit("/", 1)[-1]
        if not name:
            raise ParamsError("dbName required")
        self.mgr.create(name)
        return _ok()

    def _create_db(self, req) -> bytes:
        self.mgr.create(req["dbName"])
        return _ok()

    def _open_ns(self, req) -> bytes:
        so = req.get("storageOptions") or {}
        ns = so.get("nsName")
        if not ns:
            raise ParamsError("storageOptions.nsName required")
        self._db(req).open_namespace(ns, [])
        return _ok()

    def _add_ns(self, req) -> bytes:
        ns = req.get("namespace") or {}
        if not ns.get("name"):
            raise ParamsError("namespace.name required")
        defs = [_index_from_msg(d) for d in ns.get("indexesDefinitions")]
        self._db(req).open_namespace(ns["name"], defs)
        return _ok()

    def _close_ns(self, req) -> bytes:
        self._db(req).close_namespace(req["nsName"])
        return _ok()

    def _drop_ns(self, req) -> bytes:
        self._db(req).drop_namespace(req["nsName"])
        return _ok()

    def _truncate_ns(self, req) -> bytes:
        self._db(req).truncate_namespace(req["nsName"])
        return _ok()

    def _add_index(self, req) -> bytes:
        self._db(req).add_index(req["nsName"],
                                _index_from_msg(req.get("definition")))
        return _ok()

    def _update_index(self, req) -> bytes:
        self._db(req).update_index(req["nsName"],
                                   _index_from_msg(req.get("definition")))
        return _ok()

    def _drop_index(self, req) -> bytes:
        d = req.get("definition") or {}
        if not d.get("name"):
            raise ParamsError("definition.name required")
        self._db(req).drop_index(req["nsName"], d["name"])
        return _ok()

    def _set_schema(self, req) -> bytes:
        sd = req.get("schemaDefinitionRequest") or {}
        if not sd.get("nsName"):
            raise ParamsError("schemaDefinition.nsName required")
        self._db(req).set_schema(sd["nsName"],
                                 json.loads(sd.get("jsonData") or "{}"))
        return _ok()

    def _enum_ns(self, req) -> bytes:
        db = self._db(req)
        opts = req.get("options") or {}
        names = db.namespace_names()
        if opts.get("hideSystems"):
            names = [n for n in names if not n.startswith("#")]
        if opts.get("filter"):
            names = [n for n in names if n == opts["filter"]]
        defs = []
        for n in names:
            entry: dict[str, Any] = {"dbName": req["dbName"], "name": n}
            if not opts.get("onlyNames"):
                ns = db.get_namespace(n)
                entry["indexesDefinitions"] = [
                    _index_to_msg(idef) for idef in ns.index_defs()]
            defs.append(entry)
        return encode({"namespacesDefinitions": defs}, ENUM_NS_RESP)

    def _enum_dbs(self, req) -> bytes:
        return encode({"names": self.mgr.names()}, NAMES_RESP)

    def _modify(self, req) -> None:
        db = self._db(req)
        doc = self._decode_item(db, req["nsName"],
                                req["encodingType"] or 0, req["data"] or b"")
        mode = req["mode"] or 0
        if mode == _MODE_INSERT:
            db.insert(req["nsName"], doc)
        elif mode == _MODE_UPDATE:
            db.update(req["nsName"], doc)
        elif mode == _MODE_DELETE:
            db.delete(req["nsName"], doc)
        else:
            db.upsert(req["nsName"], doc)

    def _exec_sql(self, req):
        yield from self._run_query_stream(
            req, lambda db: db.select(req["sql"]))

    def _select(self, req):
        yield from self._run_query_stream(
            req, lambda db: db.select(self._parse_query(req.get("query"))))

    def _update(self, req):
        yield from self._run_query_stream(
            req,
            lambda db: db.update_query(self._parse_query(req.get("query"))))

    def _delete(self, req):
        def run(db):
            from ..query.results import QueryResults
            q = self._parse_query(req.get("query"))
            n = db.delete_query(q)
            return QueryResults(ns_name=q.namespace, total_count=n)
        yield from self._run_query_stream(req, run)

    # --- transactions ---------------------------------------------------
    def _begin_tx(self, req) -> bytes:
        try:
            tx = self._db(req).new_transaction(req["nsName"])
        except Exception as e:
            return encode({"status": _err_dict(e)}, TX_ID_RESP)
        with self._tx_lock:
            tx_id = next(self._tx_ids)
            self._txs[tx_id] = (tx, req["dbName"], req["nsName"])
        return encode({"id": tx_id}, TX_ID_RESP)

    def _tx(self, tx_id: Optional[int]):
        with self._tx_lock:
            ent = self._txs.get(tx_id or 0)
        if ent is None:
            raise TxDoesNotExistError(
                f"transaction {tx_id} does not exist")
        return ent

    def _add_tx_item(self, req) -> None:
        tx, db_name, ns_name = self._tx(req["id"])
        db = self.mgr.get(db_name)
        doc = self._decode_item(db, ns_name, req["encodingType"] or 0,
                                req["data"] or b"")
        mode = req["mode"] or 0
        if mode == _MODE_INSERT:
            tx.insert(doc)
        elif mode == _MODE_UPDATE:
            tx.update(doc)
        elif mode == _MODE_DELETE:
            tx.delete(doc)
        else:
            tx.upsert(doc)

    def _commit_tx(self, req) -> bytes:
        tx, _, _ = self._tx(req["id"])
        try:
            tx.commit()
        finally:
            with self._tx_lock:
                self._txs.pop(req["id"], None)
        return _ok()

    def _rollback_tx(self, req) -> bytes:
        tx, _, _ = self._tx(req["id"])
        tx.rollback()
        with self._tx_lock:
            self._txs.pop(req["id"], None)
        return _ok()

    # --- metadata --------------------------------------------------------
    def _meta(self, req) -> dict:
        md = req.get("metadata") or {}
        if not md.get("nsName"):
            raise ParamsError("metadata.nsName required")
        return md

    def _get_meta(self, req) -> bytes:
        md = self._meta(req)
        v = self._db(req).get_meta(md["nsName"], md["key"] or "")
        return encode({"metadata": v or ""}, META_RESP)

    def _put_meta(self, req) -> bytes:
        md = self._meta(req)
        self._db(req).put_meta(md["nsName"], md["key"] or "",
                               md["value"] or "")
        return _ok()

    def _enum_meta(self, req) -> bytes:
        return encode({"keys": self._db(req).enum_meta(req["nsName"])},
                      META_KEYS_RESP)

    def _delete_meta(self, req) -> bytes:
        md = self._meta(req)
        self._db(req).delete_meta(md["nsName"], md["key"] or "")
        return _ok()

    def _pb_schema(self, req) -> bytes:
        from ..core.protobuf import schema_text
        db = self._db(req)
        nses = req["namespaces"] or db.namespace_names()
        return encode({"proto": schema_text(db, nses)}, PB_SCHEMA_RESP)


def _index_to_msg(idef: IndexDef) -> dict:
    """IndexDef -> grpc Index message dict (EnumNamespaces response)."""
    rt = {v: k for k, v in _RTREE.items()}
    cm = {v: k for k, v in _COLLATE.items()}
    d = idef.to_dict() if hasattr(idef, "to_dict") else {}
    cfg = d.get("config") or {}
    return {
        "name": idef.name,
        "jsonPaths": list(idef.json_paths),
        "indexType": str(getattr(idef.index_type, "value",
                                 idef.index_type)),
        "fieldType": str(getattr(idef.field_type, "value",
                                 idef.field_type)),
        "options": {
            "isPk": idef.opts.is_pk,
            "isArray": idef.opts.is_array,
            "isDense": idef.opts.is_dense,
            "isSparse": idef.opts.is_sparse,
            "rtreeType": rt.get(getattr(idef.opts, "rtree_type", "rstar"),
                                3),
            "collateMode": cm.get(idef.opts.collate, 0),
            "config": json.dumps(cfg) if cfg else "",
        },
        "expireAfter": idef.opts.expire_after,
    }


def proto_path() -> str:
    """Path of the .proto contract shipped with the package."""
    return os.path.join(os.path.dirname(__file__), "reindexer_grpc.proto")
