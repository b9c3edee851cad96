"""A mesh HNSW snapshot ({"mesh_shards": [...]}) crosses packages both
ways through `convert.hnsw_state_from_reference` and the indexes'
state_dict / load_state_dict, each package on a 4-shard CPU mesh (the
reference on its virtual CPU devices): the loaded index holds the other's
per-shard link tables row for row and answers as it does.

Through a storage root: the reference's ANN cache cannot write a mesh
HNSW snapshot (its `_flatten` raises on the list of shard states, so a
mesh database with an HNSW field fails to close); the port writes it
(`__dict_list__`), reopens from it, and a root it wrote opens in the
reference, which drops the cache it cannot read and rebuilds the graph
from the documents to the same answers.
"""
import numpy as np
import pytest
import torch

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu_torch.convert import hnsw_state_from_reference
from reindexer_tpu_torch.parallel.context import MeshContext

torch.set_num_threads(2)

S, N, DIMS = 4, 500, 12


def _mesh(name):
    if name == "ref":
        from reindexer_tpu.parallel.context import make_mesh_context
        return make_mesh_context(S)
    return MeshContext(["cpu"] * S)


def _pkg(name):
    return ref if name == "ref" else port


def _db(name, dsn=""):
    if name == "ref":
        return ref.Reindexer(dsn, mesh=_mesh(name))
    return port.Reindexer(dsn, mesh=_mesh(name), device="cpu")


def _defs(P):
    return [P.IndexDef("id", "hash", "int", opts=P.IndexOpts(is_pk=True)),
            P.IndexDef("hn", "hnsw", vector_opts=P.FloatVectorOpts(
                dims=DIMS, metric=P.VectorMetric.L2, m=8,
                ef_construction=32)),
            P.IndexDef("bf", "vec_bf", vector_opts=P.FloatVectorOpts(
                dims=DIMS, metric=P.VectorMetric.L2))]


def _data():
    rng = np.random.default_rng(31)
    return (rng.normal(size=(N, DIMS)).astype(np.float32),
            rng.normal(size=(6, DIMS)).astype(np.float32))


def _answers(name, db, qs):
    P = _pkg(name)
    out = []
    for q in qs:
        for field, params in (("hn", P.HnswSearchParams(k=8, ef=32)),
                              ("bf", P.BruteForceSearchParams(k=8))):
            res = db.select(P.Query("ns").where_knn(field, q, params))
            out.append(([d["id"] for d in res.docs()],
                        np.asarray(res.ranks(), np.float64)))
    return out


def _assert_same(a, b):
    for (ia, ra), (ib, rb) in zip(a, b):
        assert ia == ib
        np.testing.assert_allclose(ra, rb, rtol=1e-4, atol=1e-4)


def _links(db):
    return [sh._links0 for sh in
            db.get_namespace("ns").get_index("hn")._mesh_shards]


def test_mesh_snapshot_converts_both_ways():
    base, qs = _data()
    dbs = {}
    for name in ("ref", "port"):
        db = _db(name)
        db.open_namespace("ns", _defs(_pkg(name)))
        for i in range(N):
            db.upsert("ns", {"id": i, "hn": base[i].tolist(),
                             "bf": base[i].tolist()})
        dbs[name] = db
    idx = {n: db.get_namespace("ns").get_index("hn")
           for n, db in dbs.items()}
    want = _answers("ref", dbs["ref"], qs)
    _assert_same(_answers("port", dbs["port"], qs), want)
    # the reference's snapshot into the port, the port's into the reference
    state = idx["ref"].state_dict()
    idx["port"].load_state_dict(hnsw_state_from_reference(state))
    _assert_same(_answers("port", dbs["port"], qs), want)
    idx["ref"].load_state_dict(idx["port"].state_dict())
    _assert_same(_answers("ref", dbs["ref"], qs), want)
    for a, b in zip(_links(dbs["ref"]), _links(dbs["port"])):
        np.testing.assert_array_equal(a, b)


def _fill_root(name, path, base):
    db = _db(name, path)
    db.open_namespace("ns", _defs(_pkg(name)))
    for i in range(N):
        db.upsert("ns", {"id": i, "hn": base[i].tolist(),
                         "bf": base[i].tolist()})
    return db


def test_mesh_storage_root_crosses_packages(tmp_path):
    base, qs = _data()
    path = str(tmp_path / "db")
    db = _fill_root("port", path, base)
    want = _answers("port", db, qs)
    links = _links(db)
    db.close()
    again = _db("port", path)
    assert again.storage.load_report["ns"]["ann_applied"] == ["hn", "bf"]
    for a, b in zip(links, _links(again)):
        np.testing.assert_array_equal(a, b)
    _assert_same(_answers("port", again, qs), want)
    again.close()
    in_ref = _db("ref", path)
    _assert_same(_answers("ref", in_ref, qs), want)   # builds its graphs
    for a, b in zip(links, _links(in_ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.reference_divergence
def test_reference_mesh_hnsw_cache_fails_to_write(tmp_path):
    base, _ = _data()
    db = _fill_root("ref", str(tmp_path / "db"), base)
    with pytest.raises(TypeError, match="not JSON serializable"):
        db.close()
