"""knn_batch's result assembly: the C++ lane (csrc/scalar_native.cpp
knn_items) and the Python loop (core/database.py _knn_results) against the
loop the facade ran before them, kept here as the oracle.

Each case runs on both lanes: the Python one with `_scalar_native` patched
to give no module. Over small vec_bf, HNSW and IVF namespaces with two
vector indexes, nested non-vector fields, documents without a vector key,
keys in several orders and deleted rows, every `knn_batch` result must
equal the oracle's: the rows (Python ints), the ranks bit for bit, each
document's keys in their order, `joined == {}` and the namespace's name.
Engines stubbed with crafted results add ids of -1 and past the end,
deleted rows, repeated rows and ranks None; the results the lane does not
take (ids not int64, ranks not float32, unequal lengths, a strided buffer,
a document that is not a plain dict, a key that is not a str) go to the
loop. On the CPU, a few seconds.
"""
import struct

import numpy as np
import pytest
import torch

from reindexer_tpu_torch import (FloatVectorOpts, HnswSearchParams, IndexDef,
                                 IndexOpts, IvfSearchParams, KnnSearchParams,
                                 Reindexer, VectorMetric)
from reindexer_tpu_torch.core import database
from reindexer_tpu_torch.index.base import SelectKeyResult
from reindexer_tpu_torch.query import executor
from reindexer_tpu_torch.query.results import QueryResults, ResultItem

torch.set_num_threads(2)

DIMS, ROWS = 8, 120
DELETED = range(3, ROWS, 11)


@pytest.fixture(params=["native", "python"])
def lane(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(executor, "_scalar_native", lambda: None)
    elif executor._scalar_native() is None:
        pytest.skip("the C++ lane did not build: no compiler")
    return request.param


def oracle(ns, ns_name: str, results) -> list[QueryResults]:
    """The loop knn_batch ran before the lane, as it was written."""
    out = []
    for res in results:
        items = []
        for rid, rank in zip(res.ids, res.ranks
                             if res.ranks is not None else []):
            doc = ns.get_item(int(rid))
            if doc is None:
                continue
            doc = {k: v for k, v in doc.items()
                   if ns.index_def(k) is None
                   or not ns.index_def(k).is_vector}
            items.append(ResultItem(doc=doc, row_id=int(rid),
                                    rank=float(rank), ns_name=ns_name))
        out.append(QueryResults(ns_name=ns_name, items=items))
    return out


def document(i: int, rng) -> dict:
    v = rng.normal(size=DIMS).round(3).tolist()
    w = rng.normal(size=DIMS).round(3).tolist()
    doc = {"id": i, "v": v, "meta": {"a": i, "b": [i, "x"]}, "w": w,
           "grp": i % 3, "tags": ["t", i]}
    if i % 5 == 0:
        del doc["w"]                 # no value for the second vector index
    if i % 7 == 0:                   # another key order
        doc = dict(reversed(list(doc.items())))
    return doc


def make_db(kind: str) -> Reindexer:
    opts = {"vec_bf": FloatVectorOpts(dims=DIMS, metric=VectorMetric.L2),
            "hnsw": FloatVectorOpts(dims=DIMS, metric=VectorMetric.L2, m=8,
                                    ef_construction=32),
            "ivf": FloatVectorOpts(dims=DIMS, metric=VectorMetric.L2,
                                   centroids_count=4)}[kind]
    db = Reindexer(device="cpu")
    db.open_namespace("ns", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("grp", "tree", "int"),
        IndexDef("v", kind, vector_opts=opts),
        IndexDef("w", "vec_bf", vector_opts=FloatVectorOpts(
            dims=DIMS, metric=VectorMetric.INNER_PRODUCT))])
    rng = np.random.default_rng(3)
    for i in range(ROWS):
        db.upsert("ns", document(i, rng))
    for i in DELETED:
        db.delete("ns", {"id": i})
    return db


def params(kind: str, field: str):
    if field == "v" and kind == "hnsw":
        return HnswSearchParams(k=10, ef=32)
    if field == "v" and kind == "ivf":
        return IvfSearchParams(k=10, nprobe=4)
    return KnnSearchParams(k=10)


def queries(n: int) -> np.ndarray:
    q = np.random.default_rng(9).normal(size=(n, DIMS)).astype(np.float32)
    q[-1] = q[0]                     # two results of the same rows
    return q


def knn_and_oracle(db, field: str, qs, prm):
    """knn_batch's results, and the oracle's over the same engine
    results."""
    ns = db.get_namespace("ns")
    index = ns.get_index(field)
    seen = []
    engine = index.select_batch_async

    def spy(q, p):
        drain = engine(q, p)

        def kept():
            seen.append(drain())
            return seen[-1]
        return kept

    index.select_batch_async = spy
    try:
        got = db.knn_batch("ns", field, qs, prm)
    finally:
        del index.select_batch_async
    return got, oracle(ns, "ns", seen[0])


def assert_same(ns, got, want) -> int:
    """Every result equal to the oracle's; returns the items compared."""
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        assert type(g) is QueryResults and g.ns_name == w.ns_name
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert type(a) is ResultItem
            assert type(a.row_id) is int and a.row_id == b.row_id
            assert type(a.rank) is float
            assert struct.pack("<d", a.rank) == struct.pack("<d", b.rank)
            assert type(a.doc) is dict
            assert list(a.doc.items()) == list(b.doc.items())
            assert a.joined == {} and a.ns_name == b.ns_name
            assert a.doc is not ns.items[a.row_id]
            n += 1
    return n


def counts() -> tuple:
    return (database.native_assemblies.value,
            database.python_assemblies.value)


@pytest.mark.parametrize("kind,field", [("vec_bf", "v"), ("hnsw", "v"),
                                        ("ivf", "v"), ("hnsw", "w")])
def test_knn_batch_equals_the_loop(lane, kind, field):
    db = make_db(kind)
    ns = db.get_namespace("ns")
    n0, p0 = counts()
    got, want = knn_and_oracle(db, field, queries(6), params(kind, field))
    assert assert_same(ns, got, want) > 0
    # no vector key is left, every other key is
    for res in got:
        for it in res:
            stored = ns.items[it.row_id]
            assert list(it.doc) == [k for k in stored if k not in ("v", "w")]
    assert counts() == ((n0 + 1, p0) if lane == "native" else (n0, p0 + 1))


def crafted(ns) -> list[SelectKeyResult]:
    live = [r for r in range(ROWS) if ns.items[r] is not None]
    ranks = np.array([0.1, 1 / 3, -2.5, 7e-8, 3.4e38, -0.0],
                     dtype=np.float32)
    return [
        SelectKeyResult(np.array([-1, live[0], ROWS + 5, DELETED[0],
                                  len(ns.items), live[1]], dtype=np.int64),
                        ranks),
        SelectKeyResult(np.array(live[:4], dtype=np.int64), None),
        SelectKeyResult.empty(),
        SelectKeyResult(np.array([live[1], live[1], live[0], -7, live[2],
                                  -1], dtype=np.int64), ranks[::-1].copy()),
    ]


def test_padding_deleted_rows_and_missing_ranks(lane, monkeypatch):
    db = make_db("vec_bf")
    ns = db.get_namespace("ns")
    results = crafted(ns)
    monkeypatch.setattr(ns.get_index("v"), "select_batch_async",
                        lambda q, p: lambda: results)
    got = db.knn_batch("ns", "v", queries(4), KnnSearchParams(k=6))
    want = oracle(ns, "ns", results)
    assert assert_same(ns, got, want) == 2 + 4
    assert [len(r) for r in got] == [2, 0, 0, 4]


def test_a_returned_document_is_its_own(lane):
    db = make_db("vec_bf")
    ns = db.get_namespace("ns")
    got = db.knn_batch("ns", "v", queries(3), KnnSearchParams(k=5))
    first, again = got[0][0], got[-1][0]
    assert first.row_id == again.row_id and first.doc is not again.doc
    stored = ns.items[first.row_id]
    before = (dict(stored), dict(again.doc))
    first.doc["grp"] = "changed"
    first.doc["new"] = 1
    del first.doc["id"]
    assert (dict(stored), dict(again.doc)) == before
    assert "v" in stored and "v" not in again.doc


class Doc(dict):
    """A document that is a dict, but not a plain one."""


def subclassed_doc(ns, res):
    row = int(res.ids[1])
    ns.items[row] = Doc(ns.items[row])
    return res


def int_key(ns, res):
    ns.items[int(res.ids[2])][5] = "five"
    return res


BAILS = {
    "int32 ids": lambda ns, r: SelectKeyResult(r.ids.astype(np.int32),
                                               r.ranks),
    "float64 ranks": lambda ns, r: SelectKeyResult(
        r.ids, r.ranks.astype(np.float64)),
    "unequal lengths": lambda ns, r: SelectKeyResult(r.ids, r.ranks[:-2]),
    "strided ids": lambda ns, r: SelectKeyResult(
        np.repeat(r.ids, 2)[::2], r.ranks),
    "dict subclass": subclassed_doc,
    "int key": int_key,
}


@pytest.mark.parametrize("case", sorted(BAILS))
def test_what_the_lane_does_not_take_goes_to_the_loop(lane, case,
                                                      monkeypatch):
    db = make_db("vec_bf")
    ns = db.get_namespace("ns")
    live = [r for r in range(ROWS) if ns.items[r] is not None]
    base = SelectKeyResult(np.array(live[:6], dtype=np.int64),
                           np.linspace(0.5, 3, 6, dtype=np.float32))
    res = BAILS[case](ns, base)
    results = [crafted(ns)[0], res]
    if lane == "native":
        mod = executor._scalar_native()
        vec = frozenset({"v", "w"})
        assert mod.knn_items(ns.items, res.ids, res.ranks, vec, "ns") is None
    monkeypatch.setattr(ns.get_index("v"), "select_batch_async",
                        lambda q, p: lambda: results)
    n0, p0 = counts()
    got = db.knn_batch("ns", "v", queries(2), KnnSearchParams(k=6))
    assert counts() == (n0, p0 + 1)
    assert assert_same(ns, got, oracle(ns, "ns", results)) >= 6
