"""Hybrid full-text + KNN selects of reindexer_tpu_torch vs reindexer_tpu, on
the CPU, through the public API.

Each case of tests/test_hybrid.py (RRF, RRF(rank_const), AND / OR, a linear
rerank, scalar post-filters, merged queries) runs on both packages, and
BASELINE config #5's query (`bench.py` bench_hybrid: a grp filter, a
`match`, a vec_bf KNN of k=100, fused by RRF or a linear rerank) runs on
2,000 documents made from a seed. Both give the same ids, and ranks within
rtol 1e-5: the fused ranks are RRF sums of positions or linear sums of
the full-text ranks and the fp32 distances, which the port computes to
fp32 rounding of the reference's.
"""
import numpy as np
import pytest
import torch

import reindexer_tpu_torch as port

torch.set_num_threads(2)

RTOL = 1e-5
PKGS = ("ref", "port")


def _pkg(name):
    if name == "port":
        return port
    import reindexer_tpu
    return reindexer_tpu


def _db(pkg):
    return pkg.Reindexer(device="cpu") if pkg is port else pkg.Reindexer()


def small_db(pkg):
    """tests/test_hybrid.py's namespace: ids 0..4 match "apple", ids 3..7
    lie near the query vector."""
    db = _db(pkg)
    db.open_namespace("h", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("txt", "text", "string", json_paths=("title",)),
        pkg.IndexDef("vec", pkg.IndexType.VEC_BF,
                     vector_opts=pkg.FloatVectorOpts(
                         dims=4, metric=pkg.VectorMetric.L2))])
    for i in range(10):
        db.upsert("h", {"id": i, "title": "apple pie" if i < 5 else
                        "banana split", "vec": [float(i), 0.0, 0.0, 0.0]})
    return db


QV = np.array([5.0, 0, 0, 0], dtype=np.float32)


def _fused(pkg, sort=None, where=None, join="or"):
    """match("txt", "apple") [op_or] where_knn(k=4), optionally sorted and
    post-filtered."""
    q = pkg.Query("h").match("txt", "apple")
    if join == "or":
        q = q.op_or()
    q = q.where_knn("vec", QV, pkg.KnnSearchParams(k=4))
    if sort:
        q = q.sort(sort, desc=True)
    if where:
        q = q.where(*where)
    return q


def _merged(pkg):
    q = pkg.Query("h").match("txt", "apple").limit(2)
    q.merge(pkg.Query("h").where_knn("vec", QV, pkg.KnnSearchParams(k=2)))
    return q


def _check_rrf(ids, ranks):
    # docs in BOTH streams (3, 4) outrank single-stream docs via RRF
    assert set(ids) >= {0, 1, 2, 3, 4, 5, 6} and set(ids[:2]) == {3, 4}
    assert ranks == sorted(ranks, reverse=True)


def _check_rank_const(ids, ranks):
    assert set(ids[:2]) == {3, 4}
    assert all(r <= 2.0 / 121 + 1e-9 for r in ranks)


def _check_and(ids, ranks):
    assert set(ids) == {3, 4}


def _check_linear(ids, ranks):
    # ft-only docs get rank(vec)'s default 100 and dominate
    assert len(ids) == 7 and set(ids[:3]) == {0, 1, 2}


def _check_filtered(ids, ranks):
    assert set(ids) <= {0, 1, 2, 3}


def _check_merged(ids, ranks):
    assert len(ids) == 4


# case -> (the query from a package's classes, the reference's expectations)
CASES = {
    "default_rrf": (_fused, _check_rrf),
    "rrf_rank_const": (lambda pkg: _fused(pkg, sort="RRF(rank_const=120)"),
                       _check_rank_const),
    "and_semantics": (lambda pkg: _fused(pkg, join="and"), _check_and),
    "linear_rerank": (lambda pkg: _fused(
        pkg, sort="30 * rank(txt) + 50 * rank(vec, 100.0) + 100"),
        _check_linear),
    "with_scalar_filter": (lambda pkg: _fused(pkg, where=("id", "<", 4)),
                           _check_filtered),
    "merge_queries": (_merged, _check_merged),
}


def _run(db, q):
    res = db.select(q)
    return [d["id"] for d in res.docs()], [it.rank for it in res]


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_case_matches_reference(case):
    """A case of tests/test_hybrid.py on each package: its expectations
    hold on both, with the same ids and ranks."""
    build, check = CASES[case]
    got = []
    for name in PKGS:
        pkg = _pkg(name)
        got.append(_run(small_db(pkg), build(pkg)))
        check(*got[-1])
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=RTOL)


# --- BASELINE config #5's query at a small size ----------------------------

N_DOCS, DIMS = 2000, 16


def config5_db(pkg, seed=13):
    """bench_hybrid's namespace (grp hash, a text index over 8 zipf(1.3)
    words of 5,000, a 16-dim L2 vec_bf field) at 2,000 documents."""
    rng = np.random.default_rng(seed)
    db = _db(pkg)
    db.open_namespace("h", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("grp", "hash", "int"),
        pkg.IndexDef("ft", "text", "string", json_paths=("title",)),
        pkg.IndexDef("vec", pkg.IndexType.VEC_BF,
                     vector_opts=pkg.FloatVectorOpts(
                         dims=DIMS, metric=pkg.VectorMetric.L2))])
    vocab = [f"w{i}" for i in range(5000)]
    zipf = np.minimum(rng.zipf(1.3, size=(N_DOCS, 8)) - 1, len(vocab) - 1)
    base = rng.normal(size=(N_DOCS, DIMS)).astype(np.float32)
    tx = db.new_transaction("h")
    for i in range(N_DOCS):
        tx.upsert({"id": i, "grp": i % 10,
                   "title": " ".join(vocab[j] for j in zipf[i]),
                   "vec": base[i].tolist()})
    tx.commit()
    return db, rng.normal(size=(DIMS,)).astype(np.float32)


@pytest.mark.parametrize("sort", ["RRF()", "RRF(rank_const=20)",
                                  "10 * rank(ft) + 2 * rank(vec, 50.0)"])
@pytest.mark.parametrize("join", ["and", "or"])
def test_config5_query_matches_reference(sort, join):
    got = []
    for name in PKGS:
        pkg = _pkg(name)
        db, qv = config5_db(pkg)
        q = pkg.Query("h").where("grp", "<", 5).match("ft", "w3 w7")
        if join == "or":
            q = q.op_or()
        q = q.where_knn("vec", qv, pkg.KnnSearchParams(k=100)).sort(
            sort, desc=True).limit(20)
        got.append(_run(db, q))
    assert got[0][0], "the query matched nothing"
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=RTOL)
