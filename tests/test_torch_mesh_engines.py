"""reindexer_tpu_torch's mesh-resident engines vs reindexer_tpu's: the
twins of tests/test_mesh_engines.py. Each scenario runs in both packages
on the same data: the reference on its 8 virtual CPU devices
(`make_mesh_context(8)`), the port on `MeshContext(["cpu"] * 8)`, eight
shards of its own tensors on the CPU (the plain versions of the kernels).

Tolerance: exact engines (BF, IVF over every list, SQ8 approx on the
reference's mesh formula) give equal ids, ties as sets, ranks within rtol
1e-4 (2e-5 for SQ8, as the reference's own test); HNSW and IVF at a
partial probe are held to the reference's recall at the same parameters;
full text to the single-device answer (sets, ranks within 1e-4).
"""
import numpy as np
import pytest
import torch

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu.parallel.context import make_mesh_context
from reindexer_tpu_torch.parallel.context import MeshContext

torch.set_num_threads(2)

PKGS = ("ref", "port")


@pytest.fixture(scope="module")
def ctxs():
    return {"ref": make_mesh_context(8), "port": MeshContext(["cpu"] * 8)}


def _pkg(name):
    return ref if name == "ref" else port


def _db(name, ctx):
    """A database of package `name`, on the mesh ctx or on one device."""
    if name == "ref":
        return ref.Reindexer(mesh=ctx)
    return port.Reindexer(mesh=ctx, device="cpu")


def _vec_defs(P, dims, itype, **vo):
    return [
        P.IndexDef("id", "hash", "int", opts=P.IndexOpts(is_pk=True)),
        P.IndexDef("grp", "hash", "int"),
        P.IndexDef("vec", itype, vector_opts=P.FloatVectorOpts(dims=dims,
                                                               **vo)),
    ]


def _fill(db, ns, base, extra=None):
    tx = db.new_transaction(ns)
    for i, v in enumerate(base):
        doc = {"id": i, "grp": i % 3, "vec": v.tolist()}
        if extra is not None:
            doc.update(extra(i))
        tx.upsert(doc)
    tx.commit()


def _ids(res):
    return [d["id"] for d in res.docs()]


def test_bf_mesh_oracle_exact(ctxs, rng):
    n, dims, k = 3000, 24, 12
    base = rng.normal(size=(n, dims)).astype(np.float32)
    q = rng.normal(size=(dims,)).astype(np.float32)
    d2 = ((base - q) ** 2).sum(1)
    want = np.argsort(d2)[:k].tolist()
    victims = set(want[:3])
    d2[list(victims)] = np.inf
    want2 = np.argsort(d2)[:k].tolist()
    for name in PKGS:
        P = _pkg(name)
        db = _db(name, ctxs[name])
        db.open_namespace("m", _vec_defs(P, dims, P.IndexType.VEC_BF,
                                         metric=P.VectorMetric.L2))
        _fill(db, "m", base)
        params = P.BruteForceSearchParams(k=k)
        assert _ids(db.select(P.Query("m").where_knn("vec", q, params))) \
            == want, name
        idx = db.get_namespace("m").get_index("vec")
        assert idx._mesh_ctx is not None
        if name == "port":
            # each shard owns its rows: 8 tensors of capacity / 8 rows
            shards = idx.keeper.shards
            assert len(shards) == 8 and idx.keeper.data is None
            assert len({sh.data.data_ptr() for sh in shards}) == 8
        for rid in victims:
            db.delete("m", {"id": rid})
        assert _ids(db.select(P.Query("m").where_knn("vec", q, params))) \
            == want2, name


def test_bf_mesh_batch_matches_single(ctxs, rng):
    n, dims, k, B = 2000, 16, 8, 5
    base = rng.normal(size=(n, dims)).astype(np.float32)
    qs = rng.normal(size=(B, dims)).astype(np.float32)
    sims = qs @ base.T
    want = [np.argsort(-sims[b])[:k].tolist() for b in range(B)]
    for name in PKGS:
        P = _pkg(name)
        db = _db(name, ctxs[name])
        db.open_namespace("mb", _vec_defs(
            P, dims, P.IndexType.VEC_BF,
            metric=P.VectorMetric.INNER_PRODUCT))
        _fill(db, "mb", base)
        idx = db.get_namespace("mb").get_index("vec")
        outs = idx.select_batch(qs, P.BruteForceSearchParams(k=k))
        assert [o.ids.tolist() for o in outs] == want, name


def _clustered(rng, n, dims, nlist):
    centers = rng.normal(size=(nlist, dims)).astype(np.float32) * 4
    assign = rng.integers(0, nlist, size=n)
    base = (centers[assign]
            + 0.3 * rng.normal(size=(n, dims))).astype(np.float32)
    return centers, base


def test_ivf_mesh_full_probe_exact(ctxs, rng):
    n, dims, k, nlist = 2048, 16, 10, 16
    _, base = _clustered(rng, n, dims, nlist)
    q = base[7] + 0.05 * rng.normal(size=dims).astype(np.float32)
    want = np.argsort(((base - q) ** 2).sum(1))[:k].tolist()
    for name in PKGS:
        P = _pkg(name)
        db = _db(name, ctxs[name])
        db.open_namespace("mi", _vec_defs(P, dims, P.IndexType.IVF,
                                          metric=P.VectorMetric.L2,
                                          centroids_count=nlist))
        _fill(db, "mi", base)
        # probing EVERY list makes IVF exact -> oracle equality
        res = db.select(P.Query("mi").where_knn(
            "vec", q, P.IvfSearchParams(k=k, nprobe=nlist)))
        assert _ids(res) == want, name
        res2 = db.select(P.Query("mi").where_knn(
            "vec", q, P.IvfSearchParams(k=k, nprobe=2)))
        assert 7 in _ids(res2), name
    from reindexer_tpu_torch.index.vector import ivf
    assert ivf.mesh_sweeps.value > 0


def test_hnsw_mesh_recall_upper_layers_and_deletes(ctxs, rng):
    n, dims, k = 1600, 24, 10
    base = rng.normal(size=(n, dims)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = base[42] + 0.01 * rng.normal(size=dims).astype(np.float32)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    want = set(np.argsort(-(base @ q))[:k].tolist())
    recall = {}
    subs = {}
    for name in PKGS:
        P = _pkg(name)
        db = _db(name, ctxs[name])
        db.open_namespace("mh", _vec_defs(
            P, dims, P.IndexType.HNSW,
            metric=P.VectorMetric.INNER_PRODUCT, m=8, ef_construction=64))
        _fill(db, "mh", base)
        idx = db.get_namespace("mh").get_index("vec")
        assert idx._mesh_shards is not None and len(idx._mesh_shards) == 8
        idx.commit()
        assert any(len(sh._upper) > 0 for sh in idx._mesh_shards)
        subs[name] = idx._mesh_shards
        params = P.HnswSearchParams(k=k, ef=96)
        got = _ids(db.select(P.Query("mh").where_knn("vec", q, params)))
        recall[name] = len(set(got) & want) / k
        assert recall[name] >= 0.8 and 42 in got, (name, recall)
        db.delete("mh", {"id": 42})
        assert 42 not in _ids(db.select(P.Query("mh").where_knn(
            "vec", q, params))), name
    # round-robin routing: the shards hold the same rows and build the
    # same graphs in both packages
    for rs, ps in zip(subs["ref"], subs["port"]):
        np.testing.assert_array_equal(rs._levels, ps._levels)
        np.testing.assert_array_equal(rs._links0, ps._links0)
    assert recall["port"] >= recall["ref"]


def _ft_db(name, ctx, ns, texts, field="txt", path="body"):
    P = _pkg(name)
    db = _db(name, ctx) if ctx is not None else (
        ref.Reindexer() if name == "ref" else port.Reindexer(device="cpu"))
    db.open_namespace(ns, [
        P.IndexDef("id", "hash", "int", opts=P.IndexOpts(is_pk=True)),
        P.IndexDef(field, "text", "string", json_paths=(path,)),
    ])
    tx = db.new_transaction(ns)
    for i, t in enumerate(texts):
        tx.upsert({"id": i, path: t})
    tx.commit()
    return db


def test_ft_mesh_matches_single_device(ctxs, rng):
    from reindexer_tpu_torch.ft import selector
    vocab = [f"w{i}" for i in range(30)]
    n = 400
    zipf = np.minimum(rng.zipf(1.4, size=(n, 8)) - 1, len(vocab) - 1)
    texts = [" ".join(vocab[j] for j in zipf[i]) for i in range(n)]
    dbs = {(name, mesh): _ft_db(name, ctxs[name] if mesh else None, "ft",
                                texts)
           for name in PKGS for mesh in (True, False)}
    assert dbs[("port", True)].get_namespace("ft").get_index(
        "txt")._mesh_ctx is not None
    selector.sharded_scores.reset()
    for dsl in ("w1", "w1 w2", "w0 -w3", "=w2 w5", "w1 w2 w3"):
        out = {key: db.select(_pkg(key[0]).Query("ft").match("txt", dsl)
                              .limit(50)) for key, db in dbs.items()}
        single = out[("port", False)]
        for key in (("port", True), ("ref", True)):
            assert {d["id"] for d in out[key].docs()} == \
                {d["id"] for d in single.docs()}, (key, dsl)
            np.testing.assert_allclose(np.sort(out[key].ranks()),
                                       np.sort(single.ranks()),
                                       rtol=1e-4, atol=1e-4)
    assert selector.sharded_scores.value > 0


def test_ft_mesh_prefix_typo_phrase(ctxs, rng):
    words = ["alpha", "alphabet", "alpine", "beta", "betamax", "gamma",
             "gamble", "delta"]
    n = 300
    texts = [" ".join(words[(i + j) % len(words)] for j in range(4))
             for i in range(n)]
    dbs = {(name, mesh): _ft_db(name, ctxs[name] if mesh else None, "ftv",
                                texts)
           for name in PKGS for mesh in (True, False)}
    for dsl in ("alph*", "beta~", '"alpha beta"~3', "gam* -delta",
                "+alpha +beta"):
        got = {key: {d["id"] for d in db.select(
            _pkg(key[0]).Query("ftv").match("txt", dsl).limit(100)).docs()}
            for key, db in dbs.items()}
        assert got[("port", True)] == got[("port", False)] \
            == got[("ref", True)], dsl


def test_ivf_mesh_recall_partial_probe(ctxs, rng):
    """Sharded IVF at a partial probe keeps recall: nprobe=4 of 16 lists
    recovers >= 90% of the exact top-10 in both packages."""
    n, dims, k, nlist = 4096, 16, 10, 16
    centers, base = _clustered(rng, n, dims, nlist)
    qs = [(centers[c] + 0.2 * rng.normal(size=dims)).astype(np.float32)
          for c in range(8)]
    recall = {}
    for name in PKGS:
        P = _pkg(name)
        db = _db(name, ctxs[name])
        db.open_namespace("mir", _vec_defs(P, dims, P.IndexType.IVF,
                                           metric=P.VectorMetric.L2,
                                           centroids_count=nlist))
        _fill(db, "mir", base)
        hits = 0
        for q in qs:
            got = set(_ids(db.select(P.Query("mir").where_knn(
                "vec", q, P.IvfSearchParams(k=k, nprobe=4)))))
            hits += len(got & set(np.argsort(
                ((base - q) ** 2).sum(1))[:k].tolist()))
        recall[name] = hits / (k * len(qs))
    assert recall["port"] >= 0.9 and recall["ref"] >= 0.9, recall


def test_hybrid_rrf_on_mesh(ctxs, rng):
    n, dims = 1500, 16
    base = rng.normal(size=(n, dims)).astype(np.float32)
    vocab = [f"t{i}" for i in range(20)]
    q = rng.normal(size=(dims,)).astype(np.float32)
    got = {}
    for name in PKGS:
        P = _pkg(name)
        db = _db(name, ctxs[name])
        db.open_namespace("hy", [
            P.IndexDef("id", "hash", "int", opts=P.IndexOpts(is_pk=True)),
            P.IndexDef("grp", "hash", "int"),
            P.IndexDef("txt", "text", "string", json_paths=("body",)),
            P.IndexDef("vec", P.IndexType.VEC_BF,
                       vector_opts=P.FloatVectorOpts(
                           dims=dims, metric=P.VectorMetric.L2)),
        ])
        tx = db.new_transaction("hy")
        for i in range(n):
            tx.upsert({"id": i, "grp": i % 2,
                       "body": vocab[i % len(vocab)] + " filler",
                       "vec": base[i].tolist()})
        tx.commit()
        res = db.select(P.Query("hy").where("grp", "=", 0)
                        .match("txt", "t4")
                        .where_knn("vec", q, P.BruteForceSearchParams(k=1024))
                        .sort("RRF()", desc=True).limit(10))
        docs = list(res.docs())
        assert docs
        assert all(d["grp"] == 0 and d["body"].startswith("t4")
                   for d in docs)
        got[name] = ([d["id"] for d in docs], list(res.ranks()))
    assert got["port"][0] == got["ref"][0]
    np.testing.assert_allclose(got["port"][1], got["ref"][1], rtol=1e-4)


def test_bf_mesh_sq8_approx_and_rerank(ctxs, rng):
    """Approx SQ8 on the mesh scores every shard's codes with the
    reference's mesh formula (K3 S mode + K2 in the port), approx_rerank
    re-scores each shard's local top-k exactly before the merge: ids and
    ranks equal the reference's mesh answer."""
    n, dims, k = 2048, 24, 10
    base = rng.normal(size=(n, dims)).astype(np.float32)
    q = rng.normal(size=(dims,)).astype(np.float32)
    results = {}
    for mode in ("approx", "approx_rerank"):
        for name in PKGS:
            P = _pkg(name)
            db = _db(name, ctxs[name])
            db.open_namespace("qm", _vec_defs(
                P, dims, P.IndexType.VEC_BF, metric=P.VectorMetric.L2,
                quantization={"enabled": True, "min_elements": 8,
                              "mode": mode}))
            _fill(db, "qm", base)
            res = db.select(P.Query("qm").where_knn(
                "vec", q, P.BruteForceSearchParams(k=k)))
            results[(mode, name)] = (_ids(res), list(res.ranks()))
            idx = db.get_namespace("qm").get_index("vec")
            assert idx._quant is not None and idx._quant.active
        ids_r, rk_r = results[(mode, "ref")]
        ids_p, rk_p = results[(mode, "port")]
        assert ids_p == ids_r, mode
        np.testing.assert_allclose(rk_p, rk_r, rtol=2e-5, atol=2e-5)
    want = set(np.argsort(((base - q) ** 2).sum(1))[:k].tolist())
    assert len(set(results[("approx_rerank", "port")][0]) & want) >= k - 2


def test_streaming_knn_on_mesh(ctxs, rng):
    """Streaming KNN (an HNSW query with neither k nor radius) over the
    shards: per-shard sessions merged on the host; batches disjoint, the
    union covers the filter's survivors in rank order. Held to the
    reference test's own bound (11 of the oracle's 15), which its twin in
    tests/test_mesh_engines.py checks on the reference."""
    n, dims = 600, 16
    base = rng.normal(size=(n, dims)).astype(np.float32)
    q = rng.normal(size=(dims,)).astype(np.float32)
    grp1 = np.asarray([i for i in range(n) if i % 3 == 1])
    want = set(grp1[np.argsort(((base[grp1] - q) ** 2).sum(1))[:15]].tolist())
    db = _db("port", ctxs["port"])
    db.open_namespace("sm", _vec_defs(
        port, dims, port.IndexType.HNSW, metric=port.VectorMetric.L2,
        m=8, ef_construction=64))
    _fill(db, "sm", base)
    res = db.select(port.Query("sm").where_knn(
        "vec", q, port.HnswSearchParams()).where("grp", "=", 1).limit(15))
    ids = _ids(res)
    assert len(ids) == len(set(ids)) == 15
    assert all(i % 3 == 1 for i in ids)
    assert len(set(ids) & want) >= 11, (sorted(ids), sorted(want))


def test_ft_device_dense_on_mesh(ctxs, rng, monkeypatch):
    """Frequent-word dense FT under the mesh: the resident matrices
    doc-shard and the shards' top-k merge once; docs and ranks equal the
    single-device dense route."""
    from reindexer_tpu_torch.ft import device_dense, selector
    monkeypatch.setattr(device_dense, "DEVICE_MIN", 0)
    monkeypatch.setattr(device_dense, "DEVICE_MIN_SINGLE", 0)
    monkeypatch.setattr(device_dense, "DENSE_MIN_COUNT", 1)
    words = [f"w{i:03d}" for i in range(30)]
    zipf = rng.zipf(1.3, size=20000) % 30
    docs = []
    for i in range(1500):
        toks = [words[int(zipf[rng.integers(0, len(zipf))])]
                for _ in range(rng.integers(4, 12))]
        docs.append(" ".join(toks))
    frequent = [words[i] for i in np.bincount(zipf, minlength=30
                                              ).argsort()[::-1][:2]]
    q_text = f"{frequent[0]} {frequent[1]}"
    out = {}
    selector.dense_scores.reset()
    for mesh in (False, True):
        db = _ft_db("port", ctxs["port"] if mesh else None, "fd", docs,
                    field="ft", path="t")
        res = db.select(port.Query("fd").match("ft", q_text).limit(50))
        out[mesh] = ([d["id"] for d in res.docs()], list(res.ranks()))
        dd = db.get_namespace("fd").get_index("ft")._selector._ddense
        assert dd is not None and (dd._mesh is not None) == mesh
    assert selector.dense_scores.value == 2
    assert out[True][0] == out[False][0]
    np.testing.assert_allclose(out[True][1], out[False][1],
                               rtol=1e-5, atol=1e-5)
