"""reindexer_tpu_torch's brute-force engine vs reindexer_tpu's, through the
public API: the same documents go into `reindexer_tpu.Reindexer()` and
`reindexer_tpu_torch.Reindexer(device="cpu")`, on the cases of
tests/test_vector_bf.py. Each database gets its definitions and queries
built from its own package: the port's `IndexDef`, `Query`, ... are classes
of its own.

Tolerance: ids match as sets, except between near-ties at the k-th rank
(within rtol 1e-4 of it); ranks match within rtol 1e-4 (atol 1e-4 for
ranks near zero). The `cuda` test runs the port on the card against the
port on the CPU and skips without a card.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                 IndexType, KnnSearchParams, Query,
                                 QuantizationConfig, VectorMetric)
from reindexer_tpu_torch.convert import keeper_state_from_reference
from reindexer_tpu_torch.index.vector import brute_force
from reindexer_tpu_torch.index.vector.brute_force import BruteForceIndex

# this file runs beside timing-sensitive tests (the TCP cluster's raft
# timeouts) when the suite is spread over processes: a small intra-op pool
# keeps torch from taking every core
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-4


def _defs(metric, dims, pkg=port):
    return [pkg.IndexDef("id", "hash", "int",
                         opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("v", "vec_bf", vector_opts=pkg.FloatVectorOpts(
                dims=dims, metric=pkg.VectorMetric(metric))),
            pkg.IndexDef("grp", "hash", "int")]


def make_pair(metric="l2", dims=32, n=300, seed=0, device="cpu"):
    """The reference and the port, holding the same n documents."""
    base = np.random.default_rng(seed).normal(size=(n, dims)).astype(
        np.float32)
    dbs = (ref.Reindexer(), port.Reindexer(device=device))
    for db, pkg in zip(dbs, (ref, port)):
        db.open_namespace("vecs", _defs(metric, dims, pkg))
        for i, row in enumerate(base.tolist()):
            db.upsert("vecs", {"id": i, "v": row, "grp": i % 3})
    return dbs, base


def _ids_ranks(res):
    return [d["id"] for d in res.docs()], np.asarray(res.ranks(), np.float64)


def assert_same_knn(res_ref, res_port):
    ids_r, ranks_r = _ids_ranks(res_ref)
    ids_p, ranks_p = _ids_ranks(res_port)
    assert len(ids_p) == len(ids_r)
    np.testing.assert_allclose(ranks_p, ranks_r, rtol=RTOL, atol=ATOL)
    if ids_r:
        rank_of = dict(zip(ids_r, ranks_r)) | dict(zip(ids_p, ranks_p))
        edge = ranks_r[-1]
        for i in set(ids_r) ^ set(ids_p):
            assert abs(rank_of[i] - edge) <= RTOL * abs(edge) + ATOL, i


def both(dbs, query):
    """query(pkg) -> the query built from pkg's classes, run on each
    database with its own package's query."""
    return [db.select(query(pkg)) for db, pkg in zip(dbs, (ref, port))]


def knn(field, value, **params):
    """query(pkg) for `vecs` with a KNN condition on `field`."""
    return lambda pkg: pkg.Query("vecs").where_knn(
        field, value, pkg.KnnSearchParams(**params))


@pytest.fixture(scope="module")
def pair_3k():
    """About 3k documents at D=128, L2: capacity 4096 rows, 64 blocks."""
    return make_pair("l2", dims=128, n=3000, seed=11)


@pytest.mark.parametrize("metric", ["l2", "inner_product", "cosine"])
def test_select_matches_reference(metric):
    dbs, base = make_pair(metric)
    rng = np.random.default_rng(1)
    for _ in range(3):
        q = rng.normal(size=base.shape[1]).astype(np.float32)
        assert_same_knn(*both(dbs, knn("v", q, k=10)))


def test_deletes_and_reupserts():
    dbs, base = make_pair("l2", n=200, seed=2)
    rng = np.random.default_rng(3)
    # a select first, so that the deletes hit rows already on the device
    assert_same_knn(*both(dbs, knn("v", base[14], k=40)))
    for db in dbs:
        for i in range(0, 200, 7):
            db.delete("vecs", {"id": i})
        for i in range(1, 200, 11):     # move some vectors far away
            db.upsert("vecs", {"id": i, "v": (base[i] + 50.0).tolist(),
                               "grp": 0})
        db.upsert("vecs", {"id": 7, "v": base[7].tolist(), "grp": 0})
    for _ in range(3):
        q = rng.normal(size=32).astype(np.float32)
        res = both(dbs, knn("v", q, k=40))
        assert_same_knn(*res)
        assert not {0, 14, 21} & {d["id"] for d in res[1].docs()}


def test_k_above_count():
    dbs, base = make_pair("l2", n=50, seed=4)
    res = both(dbs, knn("v", base[3], k=80))
    assert len(res[1]) == 50
    assert_same_knn(*res)


def test_radius_with_k():
    dbs, base = make_pair("l2", n=100, seed=5)
    d = np.sort(((base - base[0]) ** 2).sum(1))
    radius = float((d[9] + d[10]) / 2)
    res = both(dbs, knn("v", base[0], k=100, radius=radius))
    assert len(res[1]) == 10
    assert_same_knn(*res)


def test_radius_only():
    dbs, base = make_pair("inner_product", n=100, seed=6)
    s = np.sort(base @ base[0])
    radius = float((s[-5] + s[-4]) / 2)
    res = both(dbs, knn("v", base[0], radius=radius))
    assert len(res[1]) == 4
    assert_same_knn(*res)


def test_knn_batch_128_queries(pair_3k):
    dbs, base = pair_3k
    q = np.random.default_rng(7).normal(size=(128, 128)).astype(np.float32)
    outs = [db.knn_batch("vecs", "v", q, pkg.KnnSearchParams(k=25))
            for db, pkg in zip(dbs, (ref, port))]
    assert len(outs[1]) == 128
    for r_ref, r_port in zip(*outs):
        assert_same_knn(r_ref, r_port)


def test_select_3k_k100(pair_3k):
    dbs, base = pair_3k
    for qi in (0, 1234, 2999):
        assert_same_knn(*both(dbs, knn("v", base[qi] + 0.01, k=100)))


def test_where_filter_and_knn(pair_3k):
    dbs, base = pair_3k
    q = np.zeros(128, np.float32)
    res = both(dbs, lambda pkg: pkg.Query("vecs").where(
        "grp", "=", 1).where_knn("v", q, pkg.KnnSearchParams(k=60)))
    assert all(d["grp"] == 1 for d in res[1].docs())
    assert_same_knn(*res)


def test_concurrent_selects_match_sequential(pair_3k):
    """16 threads select at once through dynamic batching, with a shortened
    switch interval; every answer equals the sequential one."""
    db = pair_3k[0][1]
    qs = np.random.default_rng(17).normal(size=(48, 128)).astype(np.float32)
    p = KnnSearchParams(k=10)
    want = [db.select(Query("vecs").where_knn("v", q, p)) for q in qs]
    got = [None] * len(qs)
    errors = []

    def work(t):
        try:
            for j in range(t, len(qs), 16):
                got[j] = db.select(Query("vecs").where_knn("v", qs[j], p))
        except Exception as e:      # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for w, g in zip(want, got):
        assert_same_knn(w, g)


def _bf_index(metric="l2", dims=16, device="cpu"):
    return BruteForceIndex(IndexDef("v", IndexType.VEC_BF,
                                    vector_opts=FloatVectorOpts(
                                        dims=dims,
                                        metric=VectorMetric(metric))),
                           torch.device(device))


def test_keeper_state_from_reference():
    """A JAX keeper's state (deleted rows included) loads into the port's
    index, which then answers like the reference index."""
    (db_ref, _), base = make_pair("l2", dims=16, n=120, seed=8)
    for i in (3, 50, 119):
        db_ref.delete("vecs", {"id": i})
    ref_ix = db_ref.get_namespace("vecs").get_index("v")
    state = keeper_state_from_reference(ref_ix.keeper.state_dict())
    ix = _bf_index()
    ix.load_state_dict({"keeper": state})
    assert ix.keeper.count == ref_ix.keeper.count == 117
    assert ix.memstat() == ref_ix.memstat()
    q = np.random.default_rng(9).normal(size=(4, 16)).astype(np.float32)
    for r_ref, r_port in zip(
            ref_ix.select_batch(q, ref.KnnSearchParams(k=20)),
            ix.select_batch(q, KnnSearchParams(k=20))):
        assert set(r_ref.ids.tolist()) == set(r_port.ids.tolist())
        assert not {3, 50, 119} & set(r_port.ids.tolist())
        np.testing.assert_allclose(r_port.ranks, r_ref.ranks, rtol=RTOL,
                                   atol=ATOL)


def test_state_dict_round_trip_and_any_empty():
    ix = _bf_index()
    rng = np.random.default_rng(10)
    for r in range(40):
        ix.upsert(r, rng.normal(size=16).astype(np.float32))
    ix.delete(5, None)
    ix.upsert(41, None)                       # empty vector
    from reindexer_tpu_torch import CondType
    ix2 = _bf_index()
    ix2.load_state_dict(ix.state_dict())
    any_ids = ix2.select_key(CondType.ANY, ()).ids
    assert 5 not in any_ids and 41 not in any_ids and len(any_ids) == 39
    assert 5 in ix2.select_key(CondType.EMPTY, ()).ids
    q = rng.normal(size=16).astype(np.float32)
    a = ix.select(q, KnnSearchParams(k=10))
    b = ix2.select(q, KnnSearchParams(k=10))
    assert a.ids.tolist() == b.ids.tolist()
    np.testing.assert_array_equal(a.ranks, b.ranks)
    np.testing.assert_array_equal(ix2.keeper.get_host(7),
                                  ix.keeper.get_host(7))
    assert ix2.keeper.get_host(5) is None


def test_mass_ties_rerun_through_knn_scan():
    """16384 identical vectors tie every block max: K2 overflows, the drain
    reruns the batch through knn_scan and counts it; the rerun keeps the
    reference's tie order, the lower rows first (ROADMAP C1)."""
    ix = _bf_index(dims=8)
    one = np.random.default_rng(12).normal(size=(1, 8)).astype(np.float32)
    ix.keeper.bulk_load(np.tile(one, (16384, 1)))
    brute_force.overflow_reruns.reset()
    q = np.random.default_rng(13).normal(size=(3, 8)).astype(np.float32)
    outs = ix.select_batch(q, KnnSearchParams(k=32))
    assert brute_force.overflow_reruns.value == 1
    for b, res in enumerate(outs):
        want = ((q[b] - one[0]) ** 2).sum()
        assert res.ids.tolist() == list(range(32))
        np.testing.assert_allclose(res.ranks, want, rtol=RTOL, atol=ATOL)


def test_k_above_128_runs_knn_scan():
    dbs, base = make_pair("l2", n=400, seed=14)
    brute_force.geometry_scans.reset()
    res = both(dbs, knn("v", base[9], k=200))
    assert brute_force.geometry_scans.value == 1
    assert len(res[1]) == 200
    assert_same_knn(*res)


def test_dims_mismatch_raises():
    (_, db), _ = make_pair("l2", dims=16, n=10)
    with pytest.raises(port.ParamsError):
        db.select(Query("vecs").where_knn("v", np.zeros(8, np.float32),
                                          KnnSearchParams(k=3)))
    with pytest.raises(port.ParamsError):
        db.upsert("vecs", {"id": 99, "v": [0.0] * 9, "grp": 0})


@pytest.mark.parametrize("idef", [
    IndexDef("h", "hnsw", vector_opts=FloatVectorOpts(dims=4)),
    IndexDef("i", "ivf", opts=IndexOpts(is_array=True),
             vector_opts=FloatVectorOpts(dims=4, centroids_count=2)),
    IndexDef("t", "text", "string"),
    IndexDef("a", "vec_bf", opts=IndexOpts(is_array=True),
             vector_opts=FloatVectorOpts(dims=4)),
    IndexDef("q", "hnsw", vector_opts=FloatVectorOpts(
        dims=4, quantization=QuantizationConfig(enabled=True,
                                                min_elements=8))),
], ids=["hnsw", "ivf", "text", "array", "sq8"])
def test_not_ported_indexes_raise(idef):
    """Every index type of the reference is ported now, full text
    included: HNSW (fp32 and its SQ8 graph) and array vector indexes build
    on the CPU and answer a KNN select with the nearest document first
    (tests/test_torch_hnsw.py holds them against the reference); a `text`
    index added to a live namespace answers a full-text match
    (tests/test_torch_ft.py holds it against the reference)."""
    db = port.Reindexer(device="cpu")
    db.open_namespace("x", [IndexDef("id", "hash", "int",
                                     opts=IndexOpts(is_pk=True))])
    if idef.index_type == IndexType.TEXT:
        db.add_index("x", idef)
        for i, text in enumerate(["red fox", "lazy dog", "red dog"]):
            db.upsert("x", {"id": i, "t": text})
        res = db.select(Query("x").match("t", "dog"))
        assert sorted(d["id"] for d in res.docs()) == [1, 2]
        assert res.ranks()[0] == pytest.approx(255.0)
        return
    db.add_index("x", idef)
    base = np.random.default_rng(3).normal(size=(40, 4)).astype(np.float32)
    for i, row in enumerate(base.tolist()):
        vec = [row, [-x for x in row]] if idef.opts.is_array else row
        db.upsert("x", {"id": i, idef.name: vec})
    res = db.select(Query("x").where_knn(idef.name, base[11],
                                         KnnSearchParams(k=3)))
    ids = [d["id"] for d in res.docs()]
    assert ids[0] == 11 and len(ids) == len(set(ids)) == 3, ids


def test_not_ported_options_and_missing_device_raise(tmp_path):
    # storage is ported (tests/test_torch_storage.py): a DSN opens it
    from reindexer_tpu_torch.storage.engine import FileStorage
    db = port.Reindexer(str(tmp_path / "db"), device="cpu")
    assert isinstance(db.storage, FileStorage)
    db.close()
    # mesh= is ported (tests/test_torch_mesh_engines.py): a CPU mesh opens
    # on a CPU database and shards its vector indexes; a mesh on another
    # device type than the database's is refused
    from reindexer_tpu_torch.parallel.context import MeshContext
    mdb = port.Reindexer(mesh=MeshContext(["cpu"] * 2), device="cpu")
    mdb.open_namespace("vecs", _defs("l2", 4))
    for i in range(5):
        mdb.upsert("vecs", {"id": i, "v": [float(i)] * 4, "grp": 0})
    res = mdb.select(Query("vecs").where_knn(
        "v", np.full(4, 3.2, np.float32), KnnSearchParams(k=2)))
    assert [d["id"] for d in res.docs()] == [3, 4]
    assert len(mdb.get_namespace("vecs").get_index("v").keeper.shards) == 2
    with pytest.raises(port.ParamsError, match="device"):
        port.Reindexer(mesh=MeshContext(["cpu"] * 2), device="cuda")
    with pytest.raises(RuntimeError, match="cuda:1000"):
        port.Reindexer(device="cuda:1000")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.Reindexer(device="meta")


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")
    base = np.random.default_rng(15).normal(size=(3000, 128)).astype(
        np.float32)
    dbs = (port.Reindexer(device="cpu"), port.Reindexer(device="cuda"))
    for db in dbs:
        db.open_namespace("vecs", _defs("l2", 128))
        for i, row in enumerate(base.tolist()):
            db.upsert("vecs", {"id": i, "v": row, "grp": i % 3})
        db.delete("vecs", {"id": 17})
    q = np.random.default_rng(16).normal(size=(70, 128)).astype(np.float32)
    outs = [db.knn_batch("vecs", "v", q, KnnSearchParams(k=100))
            for db in dbs]
    for r_cpu, r_gpu in zip(*outs):
        assert_same_knn(r_cpu, r_gpu)
        assert 17 not in [d["id"] for d in r_gpu.docs()]
