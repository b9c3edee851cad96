"""The gRPC service of reindexer_tpu_torch vs reindexer_tpu's, on the CPU.

Every test of tests/test_grpc.py has a counterpart here: the same requests,
encoded by the port's codec, go to a reference server and to a port server
(its manager on the CPU) over real grpcio channels, and the decoded
responses, streamed ones item by item, must be equal. The port's contract
(server/reindexer_grpc.proto) must compile with protoc, as the reference's
does, and be the same file (the daemon's `--grpc-port` is held in
tests/test_torch_server.py). Skipped where grpcio is not installed.
"""
import json
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

grpc = pytest.importorskip("grpc")

from _torch_pkgs import Pkg  # noqa: E402
from reindexer_tpu_torch.server import grpc_service as g  # noqa: E402

torch.set_num_threads(2)

IDENT = lambda b: b  # noqa: E731
IDX_ID = {"name": "id", "jsonPaths": ["id"], "indexType": "hash",
          "fieldType": "int", "options": {"isPk": True}}
IDX_TITLE = {"name": "title", "jsonPaths": ["title"], "indexType": "hash",
             "fieldType": "string", "options": {}}


class Client:
    """Unary, server-stream and bidi calls on one server, decoded."""

    def __init__(self, port_no: int):
        self.ch = grpc.insecure_channel(f"127.0.0.1:{port_no}")

    def call(self, method, req, spec):
        fn = self.ch.unary_unary(f"/{g.SERVICE}/{method}",
                                 request_serializer=IDENT,
                                 response_deserializer=IDENT)
        return g.decode(fn(g.encode(*req)), spec)

    def stream(self, method, req):
        fn = self.ch.unary_stream(f"/{g.SERVICE}/{method}",
                                  request_serializer=IDENT,
                                  response_deserializer=IDENT)
        return [g.decode(b, g.QR_RESP) for b in fn(g.encode(*req))]

    def bidi(self, method, reqs):
        fn = self.ch.stream_stream(f"/{g.SERVICE}/{method}",
                                   request_serializer=IDENT,
                                   response_deserializer=IDENT)
        return [g.decode(b, g.ERROR) for b in fn(
            iter([g.encode(*r) for r in reqs]))]


def both_servers(session):
    """Run session(client, server) on a reference server and on a port
    server; the lists of responses must be equal."""
    out = {}
    for name in ("ref", "port"):
        pkg = Pkg(name)
        mgr = pkg.mod("server.http").DBManager(**pkg.cpu())
        srv = pkg.mod("server.grpc_service").GrpcReindexerServer(mgr)
        srv.start()
        c = Client(srv.port)
        try:
            out[name] = session(c, srv)
        finally:
            c.ch.close()
            srv.stop()
    assert out["port"] == out["ref"], out
    return out["port"]


def _setup_books(c, db):
    out = [c.call("Connect", ({"url": f"cproto://127.0.0.1:6534/{db}",
                               "dbName": db}, g.CONNECT_REQ), g.ERROR),
           c.call("AddNamespace", ({"dbName": db, "namespace": {
               "name": "books", "indexesDefinitions": [IDX_ID, IDX_TITLE]}},
               g.ADD_NS), g.ERROR)]
    out.append(c.bidi("ModifyItem", [
        ({"dbName": db, "nsName": "books", "mode": 0, "encodingType": 0,
          "data": json.dumps({"id": i, "title": f"b{i}"}).encode()},
         g.MODIFY) for i in range(5)]))
    assert not out[0]["code"] and not out[1]["code"]
    assert len(out[2]) == 5 and not any(a["code"] for a in out[2])
    return out


def test_proto_contract_compiles_and_is_the_reference_contract():
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("protoc not available")
    subprocess.run([protoc, f"--proto_path={os.path.dirname(g.proto_path())}",
                    "--descriptor_set_out=/dev/null", g.proto_path()],
                   check=True)
    ref = Pkg("ref").mod("server.grpc_service").proto_path()

    def body(path):    # the contract without its leading comment
        lines = Path(path).read_text().splitlines()
        return [s for s in lines if not s.startswith("//")]
    assert body(g.proto_path()) == body(ref)


def test_grpc_full_flow():
    def session(c, srv):
        db = "g1"
        out = _setup_books(c, db)
        sql = ("ExecSql", ({"dbName": db,
                            "sql": "SELECT * FROM books WHERE id < 3"},
                           g.SQL_REQ))
        out.append(c.stream(*sql))
        assert len(out[-1]) == 3
        dsl = {"namespace": "books", "filters": [
            {"field": "id", "cond": "le", "value": 1}],
            "sort": [{"field": "id", "desc": False}]}
        out.append(c.stream("Select", ({
            "dbName": db,
            "query": {"encodingType": 0, "data": json.dumps(dsl).encode()},
            "flags": {"encodingType": 0, "withItemID": True}},
            g.QUERY_REQ)))
        up = {"namespace": "books",
              "filters": [{"field": "id", "cond": "eq", "value": 4}],
              "update_fields": [{"name": "title", "values": ["patched"]}]}
        out.append(c.stream("Update", ({"dbName": db, "query": {
            "encodingType": 0, "data": json.dumps(up).encode()}},
            g.QUERY_REQ)))
        dele = {"namespace": "books",
                "filters": [{"field": "id", "cond": "eq", "value": 0}]}
        out.append(c.stream("Delete", ({"dbName": db, "query": {
            "encodingType": 0, "data": json.dumps(dele).encode()}},
            g.QUERY_REQ)))
        out.append(c.stream("ExecSql", ({"dbName": db,
                                         "sql": "SELECT * FROM books"},
                                        g.SQL_REQ)))
        meta = {"nsName": "books", "key": "k"}
        out += [c.call("PutMeta", ({"dbName": db, "metadata": {
                    **meta, "value": "v7"}}, g.META_REQ), g.ERROR),
                c.call("GetMeta", ({"dbName": db, "metadata": meta},
                                   g.META_REQ), g.META_RESP),
                c.call("EnumMeta", ({"dbName": db, "nsName": "books"},
                                    g.ENUM_META_REQ), g.META_KEYS_RESP),
                c.call("DeleteMeta", ({"dbName": db, "metadata": meta},
                                      g.META_REQ), g.ERROR),
                c.call("EnumMeta", ({"dbName": db, "nsName": "books"},
                                    g.ENUM_META_REQ), g.META_KEYS_RESP),
                c.call("EnumNamespaces", ({"dbName": db, "options": {
                    "hideSystems": True}}, g.ENUM_NS_REQ), g.ENUM_NS_RESP),
                c.call("EnumDatabases", ({}, {}), g.NAMES_RESP),
                c.call("GetProtobufSchema", ({"dbName": db, "namespaces": [
                    "books"]}, g.PB_SCHEMA_REQ), g.PB_SCHEMA_RESP),
                c.call("SetSchema", ({"dbName": db,
                                      "schemaDefinitionRequest": {
                                          "nsName": "books", "jsonData":
                                          json.dumps({"type": "object"})}},
                                     g.SET_SCHEMA), g.ERROR),
                c.call("AddIndex", ({"dbName": db, "nsName": "books",
                                     "definition": {
                                         "name": "year", "jsonPaths": ["year"],
                                         "indexType": "tree",
                                         "fieldType": "int", "options": {}}},
                                    g.ADD_INDEX), g.ERROR),
                c.call("DropIndex", ({"dbName": db, "nsName": "books",
                                      "definition": {"name": "year"}},
                                     g.ADD_INDEX), g.ERROR),
                c.call("AddIndex", ({"dbName": db, "nsName": "nope",
                                     "definition": IDX_TITLE}, g.ADD_INDEX),
                       g.ERROR)]
        assert out[-11]["metadata"] == "v7" and out[-10]["keys"] == ["k"]
        assert out[-1]["code"] and "nope" in out[-1]["what"]
        return out
    out = both_servers(session)
    assert {json.loads(c["data"])["id"] for c in out[7]} == {1, 2, 3, 4}


def test_grpc_transactions():
    def session(c, srv):
        db = "g3"
        out = _setup_books(c, db)
        resp = c.call("BeginTransaction", ({"dbName": db, "nsName": "books"},
                                           g.BEGIN_TX), g.TX_ID_RESP)
        out.append(resp)
        out.append(c.bidi("AddTxItem", [
            ({"id": resp["id"], "mode": 0, "encodingType": 0,
              "data": json.dumps({"id": 100 + i, "title": f"tx{i}"}).encode()},
             g.ADD_TX_ITEM) for i in range(3)]))
        sql = ("ExecSql", ({"dbName": db, "sql":
                            "SELECT * FROM books WHERE id >= 100"}, g.SQL_REQ))
        out.append(c.stream(*sql))
        out.append(c.call("CommitTransaction", ({"id": resp["id"]}, g.TX_ID),
                          g.ERROR))
        out.append(c.stream(*sql))
        out.append(c.call("CommitTransaction", ({"id": 9999}, g.TX_ID),
                          g.ERROR))
        resp = c.call("BeginTransaction", ({"dbName": db, "nsName": "books"},
                                           g.BEGIN_TX), g.TX_ID_RESP)
        out.append(c.bidi("AddTxItem", [(
            {"id": resp["id"], "mode": 0, "encodingType": 0,
             "data": json.dumps({"id": 500, "title": "x"}).encode()},
            g.ADD_TX_ITEM)]))
        out.append(c.call("RollbackTransaction", ({"id": resp["id"]},
                                                  g.TX_ID), g.ERROR))
        out.append(c.stream("ExecSql", ({"dbName": db, "sql":
                                         "SELECT * FROM books WHERE id = 500"},
                                        g.SQL_REQ)))
        assert out[-4]["code"] == 31
        assert out[-5][0]["options"]["queryTotalItems"] == 3
        return out
    both_servers(session)


def test_grpc_item_encodings():
    """ModifyItem and result streams in JSON, CJSON, MSGPACK (where msgpack
    is installed) and the namespace's protobuf encoding."""
    def session(c, srv):
        db = "g4"
        out = _setup_books(c, db)
        ns = srv.mgr.get(db).get_namespace("books")
        pb = Pkg("port").mod("core.protobuf")
        cj = Pkg("port").mod("core.cjson")
        mods = [(3, pb.encode_item(ns, {"id": 41, "title": "pb"})),
                (1, cj.encode_doc({"id": 42, "title": "cj"}))]
        try:
            import msgpack
            mods.append((2, msgpack.packb({"id": 43, "title": "mp"})))
        except ImportError:
            msgpack = None
        for enc, data in mods:
            out.append(c.bidi("ModifyItem", [(
                {"dbName": db, "nsName": "books", "mode": 0,
                 "encodingType": enc, "data": data}, g.MODIFY)]))
            assert not out[-1][0]["code"], out[-1]
        for enc in (0, 1, 2, 3) if msgpack else (0, 1, 3):
            out.append(c.stream("ExecSql", ({
                "dbName": db, "sql": "SELECT * FROM books WHERE id >= 41",
                "flags": {"encodingType": enc}}, g.SQL_REQ)))
        got = {pb.decode_item(ns, ch["data"])["id"] for ch in out[-1]}
        assert got == {41, 42, 43} if msgpack else {41, 42}
        return out
    both_servers(session)


def test_grpc_open_close_namespace():
    def session(c, srv):
        db = "g5"
        return [c.call("CreateDatabase", ({"dbName": db}, g.DB_REQ), g.ERROR),
                c.call("OpenNamespace", ({"dbName": db, "storageOptions": {
                    "nsName": "plain", "enabled": False}}, g.OPEN_NS),
                    g.ERROR),
                c.call("CloseNamespace", ({"dbName": db, "nsName": "plain"},
                                          {1: ("dbName", "string"),
                                           2: ("nsName", "string")}), g.ERROR),
                c.call("EnumNamespaces", ({"dbName": db}, g.ENUM_NS_REQ),
                       g.ENUM_NS_RESP)]
    out = both_servers(session)
    assert not out[1]["code"] and not out[2]["code"]
