"""Sharding of reindexer_tpu_torch vs reindexer_tpu's, on the CPU.

Every test of tests/test_sharding.py, and the resharding-under-writes test
of tests/test_replication_events.py, has a counterpart here that runs the
same scenario in each package: a `ShardedReindexer` over three port
databases on the CPU against one over three reference databases, the same
documents routed by the same config. The answers held equal: documents and
their order, ids and ranks of the distributed KNN (rtol 1e-5: the same fp32
sums on the CPU), merged aggregations, rows moved by a reshard.

A distributed KNN keeps the k nearest of the union of the shards' top-k,
so on an exact index it equals one database holding every document
(`test_distributed_knn_equals_one_database`); full-text ranks are per
shard, in both packages, so a `match` or hybrid select is held to the
reference's sharded answer, not to one database's.
"""
import threading

import numpy as np
import pytest
import torch
from _torch_pkgs import Pkg, both, docs

torch.set_num_threads(2)

RTOL = 1e-5
N, D = 30, 4


def _config(pkg, swap=False):
    s = pkg.mod("sharding")
    first, second = ("spb", "msk") if swap else ("msk", "spb")
    return s.NamespaceShardingConfig(
        namespace="items", index="location",
        shards=(s.ShardSpec(0, values=(first,)),
                s.ShardSpec(1, values=(second,)),
                s.ShardSpec(2, ranges=(s.ShardKeyRange("a", "l"),))),
        default_shard=2 if swap else 0)


def _defs(pkg):
    return [pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("location", "hash", "string"),
            pkg.IndexDef("score", "tree", "int"),
            pkg.IndexDef("txt", "text", "string"),
            pkg.IndexDef("vec", pkg.IndexType.VEC_BF,
                         vector_opts=pkg.FloatVectorOpts(
                             dims=D, metric=pkg.VectorMetric.L2))]


def _rows():
    words = ["red fox", "lazy dog", "red dog", "blue fox", "quick red fox"]
    return [{"id": i, "location": ["msk", "spb", "kazan"][i % 3],
             "score": i, "txt": words[i % 5],
             "vec": [float(i), 0.0, 0.0, 0.0]} for i in range(N)]


def _cluster(pkg):
    """The reference test's fixture: three shards, 30 documents."""
    shards = [pkg.db() for _ in range(3)]
    sr = pkg.mod("sharding").ShardedReindexer(shards, [_config(pkg)])
    sr.open_namespace("items", _defs(pkg))
    for doc in _rows():
        sr.upsert("items", doc)
    return sr, shards


def sharded(fn):
    """Run fn(pkg, sr, shards) in each package on the fixture; the
    outcomes must be equal."""
    def run(pkg):
        sr, shards = _cluster(pkg)
        try:
            return fn(pkg, sr, shards)
        finally:
            sr.close()
    return both(run)


def _ids(res):
    return [d["id"] for d in res.docs()]


def test_key_routing():
    def run(pkg, sr, shards):
        got = [docs(sh, "items") for sh in shards]
        assert all(d["location"] == "msk" for d in got[0])
        assert all(d["location"] == "spb" for d in got[1])
        assert all(d["location"] == "kazan" for d in got[2])
        assert len(got[0]) == 10
        return got
    sharded(run)


def test_pinned_select():
    def run(pkg, sr, shards):
        res = sr.select(pkg.Query("items").where("location", "=", "spb"))
        assert len(res) == 10
        assert all(d["location"] == "spb" for d in res.docs())
        return sorted(_ids(res))
    sharded(run)


def test_distributed_select_sorted():
    def run(pkg, sr, shards):
        res = sr.select(pkg.Query("items").where("score", ">=", 10)
                        .sort("score", desc=True).limit(5))
        assert [d["score"] for d in res.docs()] == [29, 28, 27, 26, 25]
        return res.docs()
    sharded(run)


def test_distributed_offset():
    def run(pkg, sr, shards):
        res = sr.select(pkg.Query("items").sort("score").offset(10).limit(5))
        assert [d["score"] for d in res.docs()] == [10, 11, 12, 13, 14]
        return res.docs()
    sharded(run)


def test_distributed_knn_merge():
    def run(pkg, sr, shards):
        res = sr.select(pkg.Query("items").where_knn(
            "vec", np.asarray([7.0, 0, 0, 0], np.float32),
            pkg.KnnSearchParams(k=3)))
        got = _ids(res)
        assert got[0] == 7 and set(got) == {6, 7, 8}
        return got, res.ranks()
    sharded(run)


def test_distributed_aggregations():
    def run(pkg, sr, shards):
        res = sr.select(pkg.Query("items").aggregate_sum("score"))
        assert res.aggregations[0].value == sum(range(N))
        res2 = sr.select(pkg.Query("items").aggregate_max("score"))
        assert res2.aggregations[0].value == 29
        res3 = sr.select(pkg.Query("items").distinct("location"))
        assert set(res3.aggregations[0].distincts) == {"msk", "spb", "kazan"}
        res4 = sr.select(pkg.Query("items").aggregate_facet("location"))
        return (res.aggregations[0].value, res2.aggregations[0].value,
                sorted(res3.aggregations[0].distincts),
                [(f.values, f.count) for f in res4.aggregations[0].facets])
    sharded(run)


def test_local_select():
    def run(pkg, sr, shards):
        res = sr.select(pkg.Query("items").local())
        assert len(res) == 10
        return sorted(_ids(res))
    sharded(run)


def test_delete_query_distributed():
    def run(pkg, sr, shards):
        n = sr.delete_query(pkg.Query("items").where("score", "<", 3))
        assert n == 3
        assert len(sr.select(pkg.Query("items"))) == 27
        return n, [docs(sh, "items") for sh in shards]
    sharded(run)


def test_sql_through_proxy():
    def run(pkg, sr, shards):
        res = sr.select(
            "SELECT * FROM items WHERE location = 'msk' ORDER BY id")
        assert len(res) == 10
        return res.docs()
    sharded(run)


def test_runtime_resharding():
    def run(pkg, sr, shards):
        moved = sr.apply_sharding_config([_config(pkg, swap=True)])
        assert moved == {"items": 20}
        assert all(d["location"] == "spb" for d in docs(shards[0], "items"))
        assert all(d["location"] == "msk" for d in docs(shards[1], "items"))
        assert len(docs(shards[1], "items")) == 10
        sr.upsert("items", {"id": 100, "location": "msk", "score": 1,
                            "txt": "new", "vec": [0.0, 0, 0, 0]})
        assert 100 in [d["id"] for d in docs(shards[1], "items")]
        res = sr.select(pkg.Query("items").where("location", "=", "msk"))
        assert len(res) == 11
        assert len(sr.select(pkg.Query("items"))) == 31
        return moved, [docs(sh, "items") for sh in shards]
    sharded(run)


def test_resharding_validation():
    def run(pkg, sr, shards):
        s = pkg.mod("sharding")
        errors = []
        for cfg in (s.NamespaceShardingConfig(
                namespace="items", index="location",
                shards=(s.ShardSpec(7, values=("x",)),)),
                s.NamespaceShardingConfig(
                namespace="items", index="location",
                shards=(s.ShardSpec(0, values=("x",)),
                        s.ShardSpec(1, values=("x",))))):
            with pytest.raises(pkg.ParamsError) as e:
                sr.apply_sharding_config([cfg])
            errors.append(str(e.value))
        return errors
    sharded(run)


def test_reshard_under_write():
    """apply_sharding_config migrates rows while two writer threads upsert;
    afterwards every row lives once, on the shard the new config routes it
    to. The interleaving is the threads', so each package is held to its
    own writes."""
    for name in ("ref", "port"):
        pkg = Pkg(name)
        s = pkg.mod("sharding")
        shards = [pkg.db() for _ in range(2)]

        def cfg(a, b, default):
            return s.NamespaceShardingConfig(
                namespace="items", index="loc",
                shards=(s.ShardSpec(0, values=(a,)),
                        s.ShardSpec(1, values=(b,))), default_shard=default)
        sr = s.ShardedReindexer(shards, [cfg("a", "b", 0)])
        sr.open_namespace("items", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("loc", "hash", "string")])
        for i in range(100):
            sr.upsert("items", {"id": i, "loc": "a" if i % 2 else "b"})
        stop, errors, written = threading.Event(), [], []

        def writer(base):
            for j in range(500):
                if stop.is_set():
                    return
                i = base + j
                try:
                    sr.upsert("items", {"id": i, "loc": "a" if i % 2 else "b"})
                    written.append(i)
                except Exception as e:          # surfaced below
                    errors.append(e)
                    return

        threads = [threading.Thread(target=writer, args=(1000 * (t + 1),),
                                    daemon=True) for t in range(2)]
        for th in threads:
            th.start()
        new_cfg = cfg("b", "a", 1)
        sr.apply_sharding_config([new_cfg])
        stop.set()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads) and not errors
        sr.apply_sharding_config([new_cfg])
        seen = {}
        for si, sh in enumerate(shards):
            for d in docs(sh, "items"):
                assert d["id"] not in seen, (name, d["id"])
                seen[d["id"]] = (si, d["loc"])
        assert set(seen) == set(range(100)) | set(written), name
        assert all(si == (1 if loc == "a" else 0)
                   for si, loc in seen.values()), name
        sr.close()


# --- the port's merge against one database, and the text merges ------------

def _same_up_to_ties(got, want):
    """Ranks equal (rtol 1e-5); ids equal but for ties at the k-th rank."""
    np.testing.assert_allclose(got.ranks(), want.ranks(), rtol=RTOL)
    rank = {**dict(zip(_ids(want), want.ranks())),
            **dict(zip(_ids(got), got.ranks()))}
    kth = want.ranks()[-1]
    for i in set(_ids(got)) ^ set(_ids(want)):
        assert abs(rank[i] - kth) <= RTOL * abs(kth) + 1e-6, (i, rank[i])


def test_distributed_knn_equals_one_database():
    """On an exact index the union of the shards' top-k holds the k
    nearest: the sharded answer is one database's, ids and ranks, ties of
    equal vectors across shards included. Not so under a filter, in either
    package: a KNN keeps its k nearest and then filters them, so each shard
    keeps more rows that pass than one database does (the sharded answer
    has at least as many rows; ROADMAP C)."""
    port = Pkg("port")
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(200, D)).astype(np.float32)
    vecs[150:160] = vecs[10]                     # ties across shards
    one = port.db()
    sr = port.mod("sharding").ShardedReindexer(
        [port.db() for _ in range(3)], [_config(port)])
    try:
        for db in (one, sr):
            db.open_namespace("items", _defs(port))
        for i in range(200):
            doc = {"id": i, "location": ["msk", "spb", "kazan"][i % 3],
                   "score": i, "txt": "w", "vec": vecs[i].tolist()}
            one.upsert("items", doc)
            sr.upsert("items", doc)
        for qi, qv in enumerate(rng.normal(size=(8, D)).astype(np.float32)):
            q = port.Query("items").where_knn(
                "vec", qv if qi else vecs[10], port.KnnSearchParams(k=17))
            _same_up_to_ties(sr.select(q), one.select(q))
            q = port.Query("items").where("score", ">", 40).where_knn(
                "vec", qv, port.KnnSearchParams(k=17))
            assert len(sr.select(q)) >= len(one.select(q))
    finally:
        sr.close()


def test_match_and_hybrid_merge_as_the_reference():
    """Full text and hybrid RRF ranks are each shard's own; merged, the
    sharded answer is the reference's sharded answer: ids equal, ranks
    within 1e-4 on full text's 0-255 scale (the same BM25 sums in another
    order, tests/test_torch_ft.py) and rtol 1e-5 after the fusion."""
    def run(pkg):
        sr, _ = _cluster(pkg)
        try:
            qv = np.asarray([4.5, 0.0, 0.0, 0.0], np.float32)
            m = sr.select(pkg.Query("items").match("txt", "red fox").limit(8))
            h = sr.select(pkg.Query("items").match("txt", "red").where_knn(
                "vec", qv, pkg.KnnSearchParams(k=10))
                .sort("RRF()", desc=True).limit(6))
            return _ids(m), m.ranks(), _ids(h), h.ranks()
        finally:
            sr.close()
    want, got = run(Pkg("ref")), run(Pkg("port"))
    assert got[0] == want[0] and got[2] == want[2] and got[0] and got[2]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL)


def test_distributed_selects_from_threads_equal_serial():
    """The scatter runs the shards' selects from the proxy's pool; 8
    threads of distributed KNN selects give the serial answers."""
    port = Pkg("port")
    sr, _ = _cluster(port)
    qs = [port.Query("items").where_knn(
        "vec", np.asarray([float(i), 1.0, 0, 0], np.float32),
        port.KnnSearchParams(k=5)) for i in range(12)]
    try:
        serial = [_ids(sr.select(q)) for q in qs]
        got, errors = {}, []

        def worker(t):
            try:
                for i, q in enumerate(qs):
                    got[(t, i)] = _ids(sr.select(q))
            except Exception as e:          # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors and not any(th.is_alive() for th in threads)
        assert all(got[(t, i)] == serial[i] for t in range(8)
                   for i in range(len(qs)))
    finally:
        sr.close()


# --- the reference's fault, not copied --------------------------------------

def _reshard_knn(pkg):
    """Reshard the fixture (msk and spb swap shards: 20 rows move), then a
    KNN near row 7 (a moved spb row) and the moved rows' stored fields."""
    sr, shards = _cluster(pkg)
    try:
        moved = sr.apply_sharding_config([_config(pkg, swap=True)])
        res = sr.select(pkg.Query("items").where_knn(
            "vec", np.asarray([7.0, 0, 0, 0], np.float32),
            pkg.KnnSearchParams(k=3)))
        stored = {d["id"]: d for sh in shards
                  for d in sh.get_namespace("items").items if d is not None}
        return moved, _ids(res), stored
    finally:
        sr.close()


@pytest.mark.reference_divergence
def test_reference_reshard_drops_the_vectors_of_moved_rows():
    """The reference reads the rows it moves with a plain select, which
    leaves the float vectors out: the 20 moved rows reach their new shards
    without `vec`, and a KNN finds only the 10 rows that stayed."""
    moved, ids, stored = _reshard_knn(Pkg("ref"))
    assert moved == {"items": 20}
    assert sorted(i for i, d in stored.items() if "vec" not in d) == [
        i for i in range(N) if i % 3 != 2]
    assert ids and all(i % 3 == 2 for i in ids)


@pytest.mark.reference_divergence
def test_port_reshard_moves_rows_with_their_vectors():
    """The port moves each row with its vectors: every stored row is the
    one written, and the KNN after the reshard is the one before it."""
    moved, ids, stored = _reshard_knn(Pkg("port"))
    assert moved == {"items": 20}
    assert stored == {d["id"]: d for d in _rows()}
    assert ids[0] == 7 and set(ids) == {6, 7, 8}


def _hybrid_on_a_shard_without_matches(pkg):
    """The fixture's hybrid RRF query on the msk and kazan rows: shards 0
    and 2 answer, shard 1 (spb) holds no such row, so its conjunction is
    empty before the ranked entries. Returns the ids, or the error."""
    sr, _ = _cluster(pkg)
    try:
        q = pkg.Query("items").where("location", "SET", ["msk", "kazan"]) \
            .match("txt", "red").where_knn(
                "vec", np.asarray([4.5, 0, 0, 0], np.float32),
                pkg.KnnSearchParams(k=10)).sort("RRF()", desc=True)
        assert sr._pinned_shard(q) is None
        try:
            return _ids(sr.select(q))
        except pkg.QueryError as e:
            return str(e)
    finally:
        sr.close()


@pytest.mark.reference_divergence
def test_reference_hybrid_fails_on_a_shard_without_matches():
    """The reference's executor skips the entries after an empty
    conjunction, the ranked ones too, and then RRF() finds no rank source:
    a distributed hybrid query fails when one shard has no matching row."""
    assert _hybrid_on_a_shard_without_matches(Pkg("ref")) == \
        "RRF() used in non-ranked query"


@pytest.mark.reference_divergence
def test_port_hybrid_answers_on_a_shard_without_matches():
    """The port ranks no rows as no ranks: the empty shard answers nothing
    and the distributed hybrid query answers from the others; one database
    answers an empty hybrid query with no rows, not an error."""
    ids = _hybrid_on_a_shard_without_matches(Pkg("port"))
    assert ids and all(i % 3 != 1 for i in ids)
    port = Pkg("port")
    db = port.db()
    db.open_namespace("items", _defs(port))
    for doc in _rows():
        db.upsert("items", doc)
    empty = db.select(port.Query("items").where("score", ">", 1000).match(
        "txt", "red").where_knn("vec", np.asarray([1.0, 0, 0, 0],
                                                  np.float32),
                                port.KnnSearchParams(k=3))
        .sort("RRF()", desc=True))
    assert _ids(empty) == []
