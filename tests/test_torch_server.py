"""The server plane of reindexer_tpu_torch vs reindexer_tpu's, on the CPU.

The port's HTTP server (`server/http.py`), binary RPC server and client
(`net/`), HTTP client (`client.py`), events, SQL suggestions, CLI
(`tools/cli.py`), daemon (`server/__main__.py`) and wire codecs
(`core/cjson.py`, `core/protobuf.py`) run against the reference's on the
same scripted requests:

  - HTTP: one server of each package, in memory, the port's on the CPU; a
    script of requests (DDL, upsert, SQL, DSL, DSL KNN, `match`, hybrid,
    knn_batch / ft_batch, a transaction, meta, an events subscription,
    suggest, the protobuf schema, errors) runs on both, and each response's
    JSON must be the same, floats within rtol 1e-5 (ranks: fp32 rounding)
    and atol 1e-6; the random ids of a transaction or a subscription and
    event time stamps are not compared;
  - RPC: the same calls through each package's RpcReindexer against each
    package's RpcServer give the same documents, ranks (rtol 1e-5), totals
    and errors; 8 client threads x 32 vec_bf selects equal the serial
    answers;
  - the cjson and protobuf encodings are equal byte for byte;
  - the CLI's dump and repair print what the reference's print;
  - the replication routes and verbs, the CLI's `\\dump wal` and the
    daemon's `--grpc-port` answer as the reference's do;
  - the server, the manager, the RPC server and the CLI open their
    databases on `cuda` by default, which raises without a card.
Every socket binds port 0; every thread is joined with a timeout.
"""
import importlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import reindexer_tpu_torch as port
from reindexer_tpu_torch.client import RemoteReindexer
from reindexer_tpu_torch.core import cjson, protobuf
from reindexer_tpu_torch.net.rpc_client import RpcReindexer
from reindexer_tpu_torch.net.rpc_server import RpcServer
from reindexer_tpu_torch.query.suggest import suggest
from reindexer_tpu_torch.server.http import DBManager, ReindexerServer
from reindexer_tpu_torch.tools import cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
JOIN_S = 30
IGNORED = {"tx_id", "subscription_id", "timestamp"}
D = 4


def _ref():
    import reindexer_tpu
    return reindexer_tpu


def _mod(pkg_name, path):
    top = "reindexer_tpu_torch" if pkg_name == "port" else "reindexer_tpu"
    return importlib.import_module(f"{top}.{path}")


def same_json(a, b, path="$"):
    """a == b, floats within RTOL / ATOL, IGNORED keys skipped."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            if k not in IGNORED:
                same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert abs(a - b) <= ATOL + RTOL * abs(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


def call(port_no, method, path, body=None, raw=False):
    data = None
    if body is not None:
        data = (body if isinstance(body, str) else json.dumps(body)).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port_no}{path}",
                                 data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=JOIN_S) as resp:
            out = resp.read()
            return resp.status, (out if raw else json.loads(out.decode()))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


# --- 1. HTTP: a scripted session on both servers -------------------------

def _rows(n=40):
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(n, D)).round(3)
    words = ["red fox", "lazy dog", "red dog", "blue fox", "quick red fox"]
    return [{"id": i, "grp": i % 4, "txt": words[i % 5],
             "vec": [float(x) for x in vecs[i]]} for i in range(n)]


QV = [0.5, -0.25, 0.125, 1.0]
NS = "/api/v1/db/sdb/namespaces"
KNN_DSL = {"namespace": "items", "filters": [
    {"op": "AND", "field": "vec", "cond": "knn", "value": QV,
     "params": {"k": 5}}]}
HYBRID_DSL = {"namespace": "items", "filters": [
    {"op": "AND", "field": "txt", "cond": "eq", "value": "red"},
    {"op": "AND", "field": "vec", "cond": "knn", "value": QV,
     "params": {"k": 10}}],
    "sort": [{"field": "RRF()", "desc": True}], "limit": 5}


def _sql(q):
    return "/api/v1/db/sdb/query?q=" + urllib.parse.quote(q)


# (name, method, path, body); "{tx}" / "{sub}" are this server's ids
SCRIPT = [
    ("check", "GET", "/api/v1/check", None),
    ("create_db", "POST", "/api/v1/db", {"name": "sdb"}),
    ("list_dbs", "GET", "/api/v1/db", None),
    ("create_ns", "POST", NS, {"name": "items", "indexes": [
        {"name": "id", "index_type": "hash", "field_type": "int",
         "is_pk": True},
        {"name": "grp", "index_type": "tree", "field_type": "int"},
        {"name": "txt", "index_type": "text", "field_type": "string"},
        {"name": "vec", "index_type": "vec_bf",
         "config": {"dimension": D, "metric": "l2"}}]}),
    ("subscribe", "POST", "/api/v1/db/sdb/events",
     {"namespaces": ["items"], "event_types": ["upsert"]}),
    ("upsert", "PUT", f"{NS}/items/items", _rows()),
    ("get_items", "GET", f"{NS}/items/items?limit=5", None),
    ("events", "GET", "/api/v1/db/sdb/events/{sub}?timeout_ms=2000", None),
    ("unsubscribe", "DELETE", "/api/v1/db/sdb/events/{sub}", None),
    ("list_ns", "GET", NS, None),
    ("indexes", "GET", f"{NS}/items/indexes", None),
    ("sql_where", "GET", _sql("SELECT * FROM items WHERE grp = 2 ORDER BY id"),
     None),
    ("sql_total", "GET", _sql("SELECT COUNT(*) FROM items WHERE grp > 1"),
     None),
    ("sql_agg", "GET", _sql("SELECT SUM(grp), MAX(id) FROM items"), None),
    ("dsl_where", "POST", "/api/v1/db/sdb/query", {
        "namespace": "items", "sort": [{"field": "id", "desc": True}],
        "limit": 4, "filters": [{"field": "grp", "cond": "lt",
                                 "value": 2}]}),
    ("dsl_knn", "POST", "/api/v1/db/sdb/query", KNN_DSL),
    ("sql_knn_rank", "GET", _sql(
        f"SELECT *, rank() FROM items WHERE KNN(vec, {QV}, k=5)"), None),
    ("match_rank", "GET", _sql(
        "SELECT *, rank() FROM items WHERE txt = 'red fox'"), None),
    ("hybrid", "POST", "/api/v1/db/sdb/query", HYBRID_DSL),
    ("sqlquery", "POST", "/api/v1/db/sdb/sqlquery",
     "SELECT * FROM items WHERE id < 3 ORDER BY id"),
    ("dslquery", "POST", "/api/v1/db/sdb/dslquery", KNN_DSL),
    ("knn_batch", "POST", f"{NS}/items/knn_batch",
     {"field": "vec", "queries": [QV, [0.0, 0.0, 0.0, 0.0]],
      "params": {"k": 3}}),
    ("ft_batch", "POST", f"{NS}/items/ft_batch",
     {"field": "txt", "queries": ["red", "dog"]}),
    ("tx_begin", "POST", f"{NS}/items/transactions/begin", None),
    ("tx_items", "PUT", "/api/v1/db/sdb/transactions/{tx}/items",
     [{"id": 100, "grp": 9, "txt": "new fox", "vec": QV}]),
    ("tx_commit", "POST", "/api/v1/db/sdb/transactions/{tx}/commit", None),
    ("after_tx", "POST", "/api/v1/db/sdb/query", KNN_DSL),
    ("meta_put", "PUT", f"{NS}/items/metabykey", {"key": "k1", "value": "v1"}),
    ("meta_get", "GET", f"{NS}/items/metabykey/k1", None),
    ("metalist", "GET", f"{NS}/items/metalist", None),
    ("suggest", "GET", "/api/v1/db/sdb/suggest?q=" + urllib.parse.quote(
        "SELECT * FROM it"), None),
    ("suggest_field", "GET", "/api/v1/db/sdb/suggest?q=" + urllib.parse.quote(
        "SELECT * FROM items WHERE g"), None),
    ("delete_query", "DELETE", _sql("DELETE FROM items WHERE grp = 3"), None),
    ("after_delete", "GET", _sql("SELECT COUNT(*) FROM items"), None),
    ("err_no_ns", "GET", "/api/v1/db/sdb/query?q=" + urllib.parse.quote(
        "SELECT * FROM nothere"), None),
    ("err_bad_sql", "GET", _sql("SELEKT nothing"), None),
    ("err_no_db", "GET", "/api/v1/db/nodb/namespaces", None),
    ("err_knn_dims", "POST", "/api/v1/db/sdb/query", {
        "namespace": "items", "filters": [{"field": "vec", "cond": "knn",
                                           "value": [1.0], "params":
                                           {"k": 2}}]}),
    ("dsl_limit", "POST", "/api/v1/db/sdb/query",
     {"namespace": "items", "limit": 2, "req_total": True}),
]


def _run_script(port_no):
    out, ids = {}, {}
    for name, method, path, body in SCRIPT:
        code, resp = call(port_no, method, path.format(**ids), body)
        if name == "tx_begin":
            ids["tx"] = resp["tx_id"]
        if name == "subscribe":
            ids["sub"] = resp["subscription_id"]
        out[name] = (code, resp)
    return out


@pytest.fixture(scope="module")
def http_pair():
    from reindexer_tpu.server.http import ReindexerServer as RefServer
    servers = {"ref": RefServer(port=0),
               "port": ReindexerServer(port=0, device="cpu")}
    for s in servers.values():
        s.start()
    try:
        yield {name: _run_script(s.port) for name, s in servers.items()}
    finally:
        for s in servers.values():
            s.stop()
            s._thread.join(timeout=JOIN_S)


@pytest.mark.parametrize("step", [s[0] for s in SCRIPT])
def test_http_script_matches_reference(http_pair, step):
    code_r, want = http_pair["ref"][step]
    code_p, got = http_pair["port"][step]
    assert code_p == code_r, (step, got, want)
    same_json(got, want, step)


def test_http_script_reaches_every_engine(http_pair):
    """The script's answers are not empty where they must hold rows."""
    got = {k: v[1] for k, v in http_pair["port"].items()}
    assert [d["id"] for d in got["dsl_knn"]["items"]]
    assert got["match_rank"]["items"] and got["hybrid"]["items"]
    assert any(e["type"] == "upsert" for e in got["events"]["events"])
    assert "items" in got["suggest"]["suggests"]
    assert got["tx_commit"]["success"] and \
        100 in [d["id"] for d in got["after_tx"]["items"]]
    assert http_pair["port"]["err_no_ns"][0] == 404


REPL = "/api/v1/db/r/replication"


def test_http_replication_routes_raise_naming_a13b():
    """The replication routes (a seam that raised before replication was
    ported; the name is kept) answer as the reference's: the updates of a
    lazily made replication state (a force sync, then WAL records), the
    snapshot, its meta and a chunk."""
    from reindexer_tpu.server.http import ReindexerServer as RefServer
    got = {}
    for name, srv in (("ref", RefServer(port=0)),
                      ("port", ReindexerServer(port=0, device="cpu"))):
        srv.start()
        try:
            call(srv.port, "POST", "/api/v1/db", {"name": "r"})
            call(srv.port, "POST", "/api/v1/db/r/namespaces",
                 SCRIPT[3][3] | {"name": "items"})
            call(srv.port, "PUT", "/api/v1/db/r/namespaces/items/items",
                 _rows(8))
            got[name] = [call(srv.port, "GET", f"{REPL}/{path}") for path in (
                "updates?from_lsn=0", "snapshot", "snapshot_meta",
                "snapshot_chunk?ns=items&offset=2&limit=3")]
            call(srv.port, "PUT", "/api/v1/db/r/namespaces/items/items",
                 _rows(10)[8:])
            call(srv.port, "DELETE", "/api/v1/db/r/namespaces/items/items",
                 [{"id": 1}])
            got[name].append(call(srv.port, "GET",
                                  f"{REPL}/updates?from_lsn=1"))
        finally:
            srv.stop()
            srv._thread.join(timeout=JOIN_S)
    same_json(got["port"], got["ref"])
    assert got["port"][0] == (200, {"force_sync": True, "last_lsn": 1})
    assert [r["op"] for r in got["port"][4][1]["updates"]] == [
        "upsert", "upsert", "delete"]


def test_http_protobuf_response_matches_reference(http_pair):
    """format=protobuf bodies and the protobuf schema route are byte for
    byte the reference's."""
    from reindexer_tpu.server.http import ReindexerServer as RefServer
    bodies = {}
    for name, srv in (("ref", RefServer(port=0)),
                      ("port", ReindexerServer(port=0, device="cpu"))):
        srv.start()
        try:
            call(srv.port, "POST", "/api/v1/db", {"name": "pb"})
            call(srv.port, "POST", "/api/v1/db/pb/namespaces",
                 SCRIPT[3][3] | {"name": "items"})
            call(srv.port, "PUT", "/api/v1/db/pb/namespaces/items/items",
                 _rows(6))
            q = urllib.parse.quote("SELECT * FROM items ORDER BY id")
            bodies[name] = (
                call(srv.port, "GET", f"/api/v1/db/pb/query?format=protobuf"
                     f"&q={q}", raw=True)[1],
                call(srv.port, "GET", "/api/v1/db/pb/protobuf_schema?ns=items",
                     raw=True)[1])
        finally:
            srv.stop()
            srv._thread.join(timeout=JOIN_S)
    assert bodies["port"] == bodies["ref"] and len(bodies["port"][0]) > 10


# --- 2. RPC ---------------------------------------------------------------

def _rpc_session(pkg_name, srv_port):
    """The same calls on one package's RpcReindexer: returns what each gave
    (documents, ranks, totals, or the error's type name)."""
    pkg = port if pkg_name == "port" else _ref()
    client_cls = _mod(pkg_name, "net.rpc_client").RpcReindexer
    c = client_cls("127.0.0.1", srv_port, "rdb")
    out = {}

    def rec(name, fn):
        try:
            res = fn()
        except Exception as e:       # errors are compared by type
            out[name] = ("error", type(e).__name__)
            return
        if hasattr(res, "docs"):
            out[name] = (res.docs(), [r for r in res.ranks()],
                         res.total_count,
                         [a.to_dict() for a in res.aggregations])
        else:
            out[name] = res
    try:
        rec("ping", c.ping)
        rec("open", lambda: c.open_namespace("items", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("grp", "tree", "int"),
            pkg.IndexDef("txt", "text", "string"),
            pkg.IndexDef("vec", "vec_bf", vector_opts=pkg.FloatVectorOpts(
                dims=D, metric=pkg.VectorMetric.L2))]))
        for doc in _rows():
            c.upsert("items", doc)
        Q = pkg.Query
        rec("names", c.namespace_names)
        rec("where", lambda: c.select(Q("items").where("grp", "=", 1)
                                      .sort("id").req_total_count()))
        rec("sql", lambda: c.select("SELECT * FROM items WHERE id < 4"))
        rec("knn", lambda: c.select(Q("items").where_knn(
            "vec", np.asarray(QV, np.float32), pkg.KnnSearchParams(k=6))))
        rec("match", lambda: c.select(Q("items").match("txt", "red dog")))
        rec("hybrid", lambda: c.select(
            Q("items").match("txt", "red").where_knn(
                "vec", np.asarray(QV, np.float32), pkg.KnnSearchParams(k=10))
            .sort("RRF()", desc=True).limit(5)))
        rec("agg", lambda: c.select(Q("items").aggregate_sum("grp")))
        tx = c.new_transaction("items")
        tx.upsert({"id": 200, "grp": 0, "txt": "tx fox", "vec": QV})
        rec("tx_commit", tx.commit)
        rec("after_tx", lambda: c.select(Q("items").where("id", "=", 200)))
        c.put_meta("items", "k", "v")
        rec("meta", lambda: c.get_meta("items", "k"))
        c.delete("items", {"id": 3})
        rec("after_delete", lambda: c.select(Q("items").where("id", "<", 6)
                                             .sort("id")))
        rec("err_sql", lambda: c.select("NOT SQL AT ALL"))
        rec("err_drop", lambda: c.drop_namespace("missing"))
        rec("err_dims", lambda: c.select(Q("items").where_knn(
            "vec", np.ones(3, np.float32), pkg.KnnSearchParams(k=2))))
    finally:
        c.close()
    return out


@pytest.fixture(scope="module")
def rpc_pair():
    servers = {"ref": _mod("ref", "net.rpc_server").RpcServer(port=0),
               "port": RpcServer(port=0, device="cpu")}
    for s in servers.values():
        s.start()
    try:
        yield servers, {n: _rpc_session(n, s.port)
                        for n, s in servers.items()}
    finally:
        for s in servers.values():
            s.stop()


RPC_STEPS = ("ping", "open", "names", "where", "sql", "knn", "match",
             "hybrid", "agg", "tx_commit", "after_tx", "meta", "after_delete",
             "err_sql", "err_drop", "err_dims")


@pytest.mark.parametrize("step", RPC_STEPS)
def test_rpc_session_matches_reference(rpc_pair, step):
    _, answers = rpc_pair
    same_json(json.loads(json.dumps(answers["port"][step], default=str)),
              json.loads(json.dumps(answers["ref"][step], default=str)),
              step)


def test_rpc_answers_equal_embedded(rpc_pair):
    """Over the wire the port answers what its embedded database answers."""
    servers, _ = rpc_pair
    db = servers["port"].mgr.get("rdb")
    q = port.Query("items").where_knn("vec", np.asarray(QV, np.float32),
                                      port.KnnSearchParams(k=6))
    c = RpcReindexer("127.0.0.1", servers["port"].port, "rdb")
    try:
        over = c.select(q)
    finally:
        c.close()
    local = db.select(q)
    assert [d["id"] for d in over.docs()] == [d["id"] for d in local.docs()]
    # the wire carries 0.0 for "no rank", so the client (the reference's)
    # reads a distance of exactly 0 (row 200 sits on QV) as None
    want = [None if r == 0 else r for r in local.ranks()]
    assert [r is None for r in over.ranks()] == [r is None for r in want]
    assert want[0] is None
    np.testing.assert_allclose([r for r in over.ranks() if r is not None],
                               [r for r in want if r is not None], rtol=RTOL)


def test_rpc_concurrent_vec_bf_selects_equal_serial(rpc_pair):
    """8 client threads x 32 vec_bf selects on the port's server (its worker
    pool calls the database from several threads at once) give the serial
    answers."""
    servers, _ = rpc_pair
    srv = servers["port"]
    qs = np.random.default_rng(11).normal(size=(32, D)).astype(np.float32)
    db = srv.mgr.get("rdb")

    def query(i):
        return port.Query("items").where_knn("vec", qs[i],
                                             port.KnnSearchParams(k=5))

    serial = [[d["id"] for d in db.select(query(i)).docs()]
              for i in range(len(qs))]
    got, errors = {}, []

    def worker(t):
        c = RpcReindexer("127.0.0.1", srv.port, "rdb", conns=1)
        try:
            for i in range(len(qs)):
                got[(t, i)] = [d["id"] for d in c.select(query(i)).docs()]
        except Exception as e:       # surfaced in the main thread
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)      # more thread switches inside the pool
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert all(got[(t, i)] == serial[i] for t in range(8)
               for i in range(len(qs)))


def test_rpc_replication_verbs_raise_naming_a13b(rpc_pair):
    """The replication verbs (a seam that raised before replication was
    ported; the name is kept) answer as the reference's, on a database of
    their own on each server: GET_UPDATES (a force sync, then records),
    GET_SNAPSHOT, GET_SNAPSHOT_META and GET_SNAPSHOT_CHUNK."""
    from reindexer_tpu_torch.net.protocol import Cmd
    servers, _ = rpc_pair
    got = {}
    for name, srv in servers.items():
        pkg = port if name == "port" else _ref()
        c = _mod(name, "net.rpc_client").RpcReindexer("127.0.0.1", srv.port,
                                                       "repl")
        try:
            c.open_namespace("t", [pkg.IndexDef(
                "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
            for doc in _rows(6):
                c.upsert("t", doc)
            verbs = [(Cmd.GET_UPDATES, [0]), (Cmd.GET_SNAPSHOT, []),
                     (Cmd.GET_SNAPSHOT_META, []),
                     (Cmd.GET_SNAPSHOT_CHUNK, ["t", 1, 2])]
            got[name] = [json.loads(c._call(cmd, args)[0])
                         for cmd, args in verbs]
            c.upsert("t", _rows(7)[6])
            c.put_meta("t", "k", "v")
            got[name].append(json.loads(c._call(Cmd.GET_UPDATES, [1])[0]))
        finally:
            c.close()
    same_json(got["port"], got["ref"])
    assert got["port"][0] == {"force_sync": True, "last_lsn": 1}
    assert [r["op"] for r in got["port"][4]["updates"]] == [
        "upsert", "put_meta"]


def test_rpc_event_subscription_streams_upserts(rpc_pair):
    servers, _ = rpc_pair
    c = RpcReindexer("127.0.0.1", servers["port"].port, "rdb")
    sub = c.subscribe_updates(namespaces=("items",), event_types=("upsert",))
    try:
        c.upsert("items", {"id": 300, "grp": 1, "txt": "ev", "vec": QV})
        events = sub.poll(timeout=5.0)
    finally:
        sub.close()
        c.close()
    assert [(e["namespace"], e["type"]) for e in events] == [
        ("items", "upsert")]


# --- 3. the HTTP client ----------------------------------------------------

def test_remote_client_matches_embedded():
    srv = ReindexerServer(port=0, device="cpu")
    srv.start()
    try:
        c = RemoteReindexer(f"http://127.0.0.1:{srv.port}", "cdb")
        c.open_namespace("items", [
            port.IndexDef("id", "hash", "int", opts=port.IndexOpts(is_pk=True)),
            port.IndexDef("txt", "text", "string"),
            port.IndexDef("vec", "vec_bf", vector_opts=port.FloatVectorOpts(
                dims=D, metric=port.VectorMetric.L2))])
        tx = c.new_transaction("items")
        for doc in _rows():
            tx.upsert({k: doc[k] for k in ("id", "txt", "vec")})
        tx.commit()
        db = srv.mgr.get("cdb")
        for q in (port.Query("items").where_knn(
                      "vec", np.asarray(QV, np.float32),
                      port.KnnSearchParams(k=7)),
                  port.Query("items").match("txt", "lazy"),
                  "SELECT * FROM items WHERE id > 30 ORDER BY id"):
            assert c.select(q).docs() == db.select(q).docs()
    finally:
        srv.stop()
        srv._thread.join(timeout=JOIN_S)


# --- 4. storage under the server -----------------------------------------

def _persisted_root(root):
    """A FileStorage database `fdb` and a sqlite database `sdb` under root."""
    for name, dsn in (("fdb", str(root / "fdb")),
                      ("sdb", f"sqlite://{root / 'sdb'}")):
        db = port.Reindexer(dsn, device="cpu")
        db.open_namespace("n", [port.IndexDef(
            "id", "hash", "int", opts=port.IndexOpts(is_pk=True))])
        db.upsert("n", {"id": 7 if name == "fdb" else 8})
        db.close()


def test_server_rediscovers_file_and_sqlite_databases(tmp_path):
    _persisted_root(tmp_path)
    srv = ReindexerServer(port=0, storage_root=str(tmp_path), device="cpu")
    srv.start()
    try:
        assert call(srv.port, "GET", "/api/v1/db")[1]["items"] == ["fdb",
                                                                   "sdb"]
        for name, want in (("fdb", 7), ("sdb", 8)):
            code, body = call(srv.port, "GET",
                              f"/api/v1/db/{name}/query?q=SELECT%20*%20FROM%20n")
            assert code == 200 and body["items"] == [{"id": want}]
        assert type(srv.mgr.get("sdb").storage).__name__ == "SqliteStorage"
    finally:
        srv.stop()
        srv._thread.join(timeout=JOIN_S)


@pytest.mark.reference_divergence
def test_reference_manager_reopens_sqlite_database_empty(tmp_path):
    """The reference's DBManager opens every database directory as a
    FileStorage (reindexer_tpu/server/http.py DBManager.create), so a sqlite
    database under the root comes back without its namespaces; the port
    reopens it as sqlite:// (test_server_rediscovers_file_and_sqlite_...)."""
    from reindexer_tpu.server.http import DBManager as RefManager
    _persisted_root(tmp_path)
    mgr = RefManager(str(tmp_path))
    assert mgr.get("fdb").namespace_names() == ["n"]
    assert mgr.get("sdb").namespace_names() == []


# --- 5. codecs, events, suggest ------------------------------------------

def _docs_for_codecs():
    rng = np.random.default_rng(2)
    return [{"id": i, "s": f"héllo {i}", "f": float(rng.normal()),
             "b": bool(i % 2), "n": None, "arr": [1, 2.5, "x", [True]],
             "o": {"k": [i, {"z": -i}]}} for i in range(20)]


@pytest.mark.parametrize("fn", ["encode_doc", "encode_docs",
                                "encode_docs_stateful"])
def test_cjson_bytes_match_reference(fn):
    ref_cjson = _mod("ref", "core.cjson")
    docs = _docs_for_codecs()
    if fn == "encode_doc":
        want = [ref_cjson.encode_doc(d) for d in docs]
        got = [cjson.encode_doc(d) for d in docs]
    elif fn == "encode_docs":
        want, got = ref_cjson.encode_docs(docs), cjson.encode_docs(docs)
    else:
        st_r, st_p = ref_cjson.TagState(), cjson.TagState()
        want = [ref_cjson.encode_docs_stateful(docs[i:i + 5], st_r)
                for i in range(0, 20, 5)]
        got = [cjson.encode_docs_stateful(docs[i:i + 5], st_p)
               for i in range(0, 20, 5)]
    assert got == want
    if fn == "encode_docs":
        assert cjson.decode_docs(want) == docs


def _codec_db(pkg):
    db = pkg.Reindexer(device="cpu") if pkg is port else pkg.Reindexer()
    db.open_namespace("events", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("score", "tree", "double"),
        pkg.IndexDef("name", "hash", "string"),
        pkg.IndexDef("flag", "-", "bool"),
        pkg.IndexDef("tags", "hash", "string", opts=pkg.IndexOpts(
            is_array=True)),
        pkg.IndexDef("vec", "vec_bf", vector_opts=pkg.FloatVectorOpts(
            dims=4, metric=pkg.VectorMetric.L2))])
    db.upsert("events", {"id": 1, "score": 2.5, "name": "alpha",
                         "flag": True, "tags": ["a", "b"],
                         "vec": [0.1, 0.2, 0.3, 0.4], "note": "extra"})
    db.upsert("events", {"id": -2, "score": -1.25, "name": "beta",
                         "flag": False, "tags": [],
                         "vec": [1.0, 0.0, 0.0, 0.0]})
    return db


def test_protobuf_bytes_match_reference():
    ref_pb = _mod("ref", "core.protobuf")
    out = {}
    for name, pkg, mod in (("ref", _ref(), ref_pb), ("port", port, protobuf)):
        db = _codec_db(pkg)
        res = db.select(pkg.Query("events").sort("id", True)
                        .req_total_count().select("vectors()"))
        payload = {"items": res.docs(), "total_items": res.total_count,
                   "query_total_items": res.total_count}
        ns = db.get_namespace("events")
        out[name] = (mod.schema_text(db, ["events"]),
                     mod.encode_query_results(ns, payload),
                     [mod.encode_item(ns, d) for d in res.docs()])
    assert out["port"] == out["ref"]
    ns = _codec_db(port).get_namespace("events")
    assert protobuf.decode_item(ns, out["port"][2][0])["name"] == "alpha"


def test_events_observer_matches_reference():
    got = {}
    for name in ("ref", "port"):
        pkg = port if name == "port" else _ref()
        ev = _mod(name, "events")
        db = pkg.Reindexer(device="cpu") if name == "port" else \
            pkg.Reindexer()
        obs = ev.EventsObserver()
        obs.attach_db(db)
        sub = obs.subscribe(ev.EventSubscriberConfig(namespaces=("e",)))
        db.open_namespace("e", [pkg.IndexDef(
            "id", "hash", "int", opts=pkg.IndexOpts(is_pk=True))])
        db.upsert("e", {"id": 1})
        db.put_meta("e", "m", "x")
        db.delete("e", {"id": 1})
        got[name] = [{k: v for k, v in e.to_dict().items()
                      if k != "timestamp"} for e in sub.poll(timeout=1.0)]
    assert got["port"] == got["ref"] and len(got["port"]) >= 3


@pytest.mark.parametrize("sql", ["SEL", "SELECT * FROM ", "SELECT * FROM it",
                                 "SELECT * FROM items WHERE ",
                                 "SELECT * FROM items WHERE g",
                                 "SELECT * FROM items ORDER BY "])
def test_suggest_matches_reference(sql):
    ref_suggest = _mod("ref", "query.suggest").suggest
    dbs = {}
    for name in ("ref", "port"):
        pkg = port if name == "port" else _ref()
        db = pkg.Reindexer(device="cpu") if name == "port" else \
            pkg.Reindexer()
        db.open_namespace("items", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("grp", "tree", "int")])
        dbs[name] = db
    assert suggest(dbs["port"], sql) == ref_suggest(dbs["ref"], sql)


def test_serializer_bytes_match_reference():
    ref_ser = _mod("ref", "net.serializer")
    from reindexer_tpu_torch.net.serializer import decode_args, encode_args
    vals = [0, 1, -1, 2 ** 40, -(2 ** 40), 3.5, -0.25, "строка", b"\x00\xff",
            True, False, None, [1, "a", [2.5, None]], []]
    assert encode_args(vals) == ref_ser.encode_args(vals)
    assert decode_args(encode_args(vals)) == vals


# --- 6. the HTTP embedder --------------------------------------------------

def test_http_embedder_knn_by_text_matches_reference():
    """A KNN by string through an embedding config with an endpoint: both
    packages call the same local embedder service for the query's vector
    and answer the same."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def embed(text):
        return [float(len(text)), float(text.count("a")), 1.0, 0.0]

    class Embed(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            vecs = [embed(t) for t in body["data"]]
            out = json.dumps({"embeddings": vecs}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    svc = ThreadingHTTPServer(("127.0.0.1", 0), Embed)
    th = threading.Thread(target=svc.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{svc.server_address[1]}/embed"
        got = {}
        for name in ("ref", "port"):
            pkg = port if name == "port" else _ref()
            db = pkg.Reindexer(device="cpu") if name == "port" else \
                pkg.Reindexer()
            db.open_namespace("e", [
                pkg.IndexDef("id", "hash", "int",
                             opts=pkg.IndexOpts(is_pk=True)),
                pkg.IndexDef("vec", "vec_bf", vector_opts=pkg.FloatVectorOpts(
                    dims=4, metric=pkg.VectorMetric.L2,
                    embedding=pkg.EmbeddingConfig(endpoint=url,
                                                  fields=("t",))))])
            for i, t in enumerate(["a", "banana", "cab", "xyzzy", "aaaa"]):
                db.upsert("e", {"id": i, "t": t, "vec": embed(t)})
            res = db.select(pkg.Query("e").where_knn(
                "vec", "data", pkg.KnnSearchParams(k=3)))
            got[name] = ([d["id"] for d in res.docs()], res.ranks())
    finally:
        svc.shutdown()
        svc.server_close()
        th.join(timeout=JOIN_S)
    assert got["port"][0] == got["ref"][0] and got["port"][0]
    np.testing.assert_allclose(got["port"][1], got["ref"][1], rtol=RTOL)


# --- 7. the CLI -------------------------------------------------------------

def _cli_db(pkg, dsn=""):
    db = pkg.Reindexer(dsn, device="cpu") if pkg is port else \
        pkg.Reindexer(dsn)
    db.open_namespace("d", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("name", "hash", "string")])
    for i in range(10):
        db.upsert("d", {"id": i, "name": f"n{i}"})
    db.put_meta("d", "k", "v")
    return db


def test_cli_dump_matches_reference_and_restores():
    ref_cli = _mod("ref", "tools.cli")
    want, got = io.StringIO(), io.StringIO()
    assert ref_cli.dump(_cli_db(_ref()), None, want) == 10
    assert cli.dump(_cli_db(port), None, got) == 10
    assert got.getvalue() == want.getvalue()
    db2, out = port.Reindexer(device="cpu"), io.StringIO()
    for line in got.getvalue().splitlines():
        cli.execute_line(db2, line, out)
    assert len(db2.select(port.Query("d"))) == 10
    assert db2.get_meta("d", "k") == "v"


def test_cli_commands_and_wal_dump_seam():
    """The CLI's commands, and `\\dump wal` (a seam that raised before
    replication was ported), print what the reference's print: the first
    dump makes the replication state over an existing namespace (its ring
    starts past LSN 1, so a dump from 0 prints nothing, as a follower there
    would force-sync), the later ones the records after LSN 1 and 2."""
    outs = {}
    for pkg, mod in ((port, cli), (_ref(), _mod("ref", "tools.cli"))):
        db = pkg.Reindexer(device="cpu") if pkg is port else pkg.Reindexer()
        out = io.StringIO()
        for line in ('\\namespaces add {"name": "c", "indexes": '
                     '[{"name": "id", "index_type": "hash", "field_type": '
                     '"int", "is_pk": true}]}', "\\dump wal",
                     '\\upsert c {"id": 1, "x": "y"}',
                     '\\upsert c {"id": 2, "x": "z"}', "SELECT * FROM c",
                     "\\dump wal", "\\dump wal 1", "\\dump wal 2",
                     "\\dump c"):
            mod.execute_line(db, line, out)
        outs[pkg is port] = out.getvalue()
    assert outs[True] == outs[False]
    lines = [json.loads(s) for s in outs[True].splitlines()
             if s.startswith("{")]
    assert lines[0] == {"id": 1, "x": "y"}
    assert [(r["lsn"], r["op"], r["doc"]["id"]) for r in lines[2:5]] == [
        (2, "upsert", 1), (3, "upsert", 2), (3, "upsert", 2)]


@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_cli_repair_matches_reference(tmp_path, pkg_name, capsys):
    """--repair on the same broken storage (written by either package)
    prints the reference's report and exits with its code."""
    pkg = port if pkg_name == "port" else _ref()
    src = tmp_path / "src"
    db = _cli_db(pkg, str(src))
    db.flush()
    db.upsert("d", {"id": 11, "name": "wal"})
    db.storage.close()
    with open(src / "d" / "wal.jsonl", "a", encoding="utf-8") as f:
        f.write('{"op": "upsert", "doc": {"id": 12')
    outs = {}
    for name, mod in (("ref", _mod("ref", "tools.cli")), ("port", cli)):
        copy = tmp_path / name
        shutil.copytree(src, copy)
        rc = mod.main(["--dsn", f"builtin://{copy}", "--repair"])
        outs[name] = (rc, capsys.readouterr().out)
    assert outs["port"] == outs["ref"] and outs["port"][0] == 1
    db2 = port.Reindexer(str(tmp_path / "port"), device="cpu")
    assert sorted(d["id"] for d in db2.select(port.Query("d")).docs()) == \
        list(range(10)) + [11]


def test_cli_main_runs_commands_on_a_local_dsn(tmp_path, capsys):
    _cli_db(port, str(tmp_path / "db")).close()
    rc = cli.main(["--dsn", f"builtin://{tmp_path / 'db'}", "--device", "cpu",
                   "-c", "SELECT * FROM d WHERE id = 3"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {
        "id": 3, "name": "n3"}


# --- 8. the default device and the daemon ----------------------------------

@pytest.mark.parametrize("make", [
    "manager", "server", "rpc_server", "cli_connect", "cli_main",
    "daemon_main"])
def test_server_plane_defaults_to_cuda(tmp_path, make):
    """Every entry point of the server plane opens its databases on `cuda`
    unless told otherwise, and so raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda opens")
    from reindexer_tpu_torch.server import __main__ as daemon
    fns = {
        "manager": lambda: DBManager(),
        "server": lambda: ReindexerServer(port=0),
        "rpc_server": lambda: RpcServer(port=0),
        "cli_connect": lambda: cli.connect(str(tmp_path / "db")),
        "cli_main": lambda: cli.main(["--dsn", str(tmp_path / "db"),
                                      "-c", "SELECT * FROM d"]),
        "daemon_main": lambda: daemon.main(["--http-port", "0",
                                            "--rpc-port", "0"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fns[make]()


def test_daemon_grpc_port_raises_naming_a13b():
    """`--grpc-port` (it raised before the gRPC plane was ported; the name
    is kept) serves gRPC beside HTTP and RPC: the daemon answers the same
    calls as the reference's service over the same requests. Needs
    grpcio."""
    grpc = pytest.importorskip("grpc")
    import socket
    from reindexer_tpu.server import grpc_service as ref_g
    from reindexer_tpu.server.http import DBManager as RefManager
    from reindexer_tpu_torch.server import grpc_service as g
    ident = lambda b: b  # noqa: E731

    def session(port_no):
        with grpc.insecure_channel(f"127.0.0.1:{port_no}") as ch:
            def unary(method, req, spec, resp):
                return g.decode(ch.unary_unary(
                    f"/{g.SERVICE}/{method}", request_serializer=ident,
                    response_deserializer=ident)(g.encode(req, spec)), resp)
            out = [unary("CreateDatabase", {"dbName": "d"}, g.DB_REQ,
                         g.ERROR),
                   unary("AddNamespace", {"dbName": "d", "namespace": {
                       "name": "n", "indexesDefinitions": [{
                           "name": "id", "jsonPaths": ["id"],
                           "indexType": "hash", "fieldType": "int",
                           "options": {"isPk": True}}]}}, g.ADD_NS, g.ERROR)]
            out += [g.decode(b, g.ERROR) for b in ch.stream_stream(
                f"/{g.SERVICE}/ModifyItem", request_serializer=ident,
                response_deserializer=ident)(iter([g.encode({
                    "dbName": "d", "nsName": "n", "mode": 0,
                    "encodingType": 0, "data": json.dumps(
                        {"id": i, "v": i * i}).encode()}, g.MODIFY)
                    for i in range(4)]))]
            out += [g.decode(b, g.QR_RESP) for b in ch.unary_stream(
                f"/{g.SERVICE}/ExecSql", request_serializer=ident,
                response_deserializer=ident)(g.encode({
                    "dbName": "d", "sql": "SELECT * FROM n WHERE id > 0"},
                    g.SQL_REQ))]
            return out

    ref = ref_g.GrpcReindexerServer(RefManager())
    ref.start()
    try:
        want = session(ref.port)
    finally:
        ref.stop()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "reindexer_tpu_torch.server", "--http-port",
         "0", "--rpc-port", "0", "--grpc-port", str(free), "--device",
         "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"grpc={free}" in line, line + proc.stderr.read()
        assert session(free) == want and len(want) == 9
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)
        proc.stdout.close()
        proc.stderr.close()


def test_daemon_serves_storage_and_exits_on_sigterm(tmp_path):
    """python -m reindexer_tpu_torch.server over a storage root: it
    rediscovers the databases, answers an HTTP KNN request and exits 0 on
    SIGTERM."""
    db = port.Reindexer(str(tmp_path / "vdb"), device="cpu")
    db.open_namespace("v", [
        port.IndexDef("id", "hash", "int", opts=port.IndexOpts(is_pk=True)),
        port.IndexDef("vec", "vec_bf", vector_opts=port.FloatVectorOpts(
            dims=D, metric=port.VectorMetric.L2))])
    for doc in _rows(20):
        db.upsert("v", {"id": doc["id"], "vec": doc["vec"]})
    want = [d["id"] for d in db.select(port.Query("v").where_knn(
        "vec", np.asarray(QV, np.float32), port.KnnSearchParams(k=4))).docs()]
    db.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "reindexer_tpu_torch.server", "--http-port",
         "0", "--rpc-port", "0", "--storage", str(tmp_path), "--device",
         "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "device=cpu" in line, line + proc.stderr.read()
        http_port = int(line.split("http://127.0.0.1:")[1].split()[0])
        code, body = call(http_port, "POST", "/api/v1/db/vdb/query", {
            "namespace": "v", "filters": [{"field": "vec", "cond": "knn",
                                           "value": QV,
                                           "params": {"k": 4}}]})
        assert code == 200 and [d["id"] for d in body["items"]] == want
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)
        proc.stdout.close()
        proc.stderr.close()
