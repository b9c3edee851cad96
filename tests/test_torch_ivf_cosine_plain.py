"""reindexer_tpu_torch's cosine IVF against a plain float64 IVF, on the CPU.

The plain IVF (`plain_ivf`) imports neither JAX nor any kernel of the port:
plain `torch` in float64, TF32 off. From the index's `state_dict()` (its
centroids and its assignment of rows to lists) it ranks the lists for each
unit query by the cosine metric's list score, the query's inner product
with each centroid, as the port's stage 1 does; then it takes the exact
cosine top-k over the rows of the query's best nprobe lists. The port is
driven through its public `knn_batch` and `select` on both stage-2 routes
(RX_IVF_SEGMENTS=1: K6's plain version; =0: the masked sweep), at the
widths of a text embedding (768 dims).

Tolerances, with their reasons: ids equal exactly (the data is seeded and
clustered, so no two probed centroids nor the k-th and the (k+1)-th rows
tie within fp32's rounding); ranks within RANK_ATOL of the float64
cosines: the port normalises rows and queries in fp32 and sums 768 fp32
products of unit vectors, about sqrt(768) x 2^-24 = 1.7e-6 of error, and
1e-5 leaves six times that. With nprobe = nlist the answers are the exact
top-k of h100bench/reference.py. The last cases hold the IVF spans and
counters the benchmark reads (`ivf.probe`, `ivf.plan`, `ivf.train`,
`ivf.reorder`; `ivf.seg_rows`, `ivf.seg_live`) to the plan they describe.
"""
import numpy as np
import pytest
import torch

from h100bench import reference
from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                 IvfSearchParams, Query, Reindexer,
                                 VectorMetric, tracing)
from reindexer_tpu_torch.ops.ivf_kernels import SEG_BLK

torch.set_num_threads(2)

N, DIMS, NLIST, NPROBE, K, NQ = 4096, 768, 64, 8, 10, 16
RANK_ATOL = 1e-5
SEED = 2 ** 31 + 41
ROUTES = {"segments": "1", "masked": "0"}


def make_data():
    """Clustered rows (256 gaussian centres, noise 1.0 a coordinate, the
    rows then scaled at random: cosine must not see a row's length) and
    queries drawn around the same centres."""
    rng = np.random.default_rng(SEED)
    centers = rng.normal(size=(256, DIMS))
    rows = centers[rng.integers(0, 256, N)] + rng.normal(size=(N, DIMS))
    rows *= rng.uniform(0.2, 5.0, size=(N, 1))
    queries = centers[rng.integers(0, 256, NQ)] + rng.normal(size=(NQ, DIMS))
    return rows.astype(np.float32), queries.astype(np.float32)


@pytest.fixture(scope="module")
def built():
    rows, queries = make_data()
    db = Reindexer(device="cpu")
    db.open_namespace("n", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "ivf", vector_opts=FloatVectorOpts(
            dims=DIMS, metric=VectorMetric.COSINE, centroids_count=NLIST))])
    for i, row in enumerate(rows.tolist()):
        db.upsert("n", {"id": i, "vec": row})
    # the first search trains the index and builds its lists
    db.knn_batch("n", "vec", queries[:1], IvfSearchParams(k=K, nprobe=1))
    ix = db.get_namespace("n").get_index("vec")
    return db, ix, rows, queries


def unit64(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(x)).to(torch.float64)
    norm = t.norm(dim=-1, keepdim=True)
    return t / torch.where(norm == 0, torch.ones_like(norm), norm)


def plain_ivf(rows, state, queries, nprobe, k):
    """(ids [Q, k], ranks [Q, k]) of the plain IVF, best first, ties by
    the lower list and the lower id."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        centroids = torch.from_numpy(state["centroids"]).to(torch.float64)
        assign = torch.from_numpy(state["assign"][:len(rows)]).to(
            torch.int64)
        base, q = unit64(rows), unit64(queries)
        ids_out, ranks_out = [], []
        for qv in q:
            list_score = (centroids @ qv).tolist()
            lists = sorted(range(len(list_score)),
                           key=lambda c: (-list_score[c], c))[:nprobe]
            cand = torch.nonzero(torch.isin(assign, torch.tensor(lists)))[:, 0]
            score = (base[cand] @ qv).tolist()
            best = sorted(zip(score, cand.tolist()),
                          key=lambda sc: (-sc[0], sc[1]))[:k]
            ids_out.append([i for _, i in best])
            ranks_out.append([s for s, _ in best])
        return np.array(ids_out), np.array(ranks_out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def answers(results):
    return (np.array([[d["id"] for d in r.docs()] for r in results]),
            np.array([r.ranks() for r in results], dtype=np.float64))


def port_knn_batch(db, queries, nprobe):
    return answers(db.knn_batch("n", "vec", queries,
                                IvfSearchParams(k=K, nprobe=nprobe)))


def port_select(db, queries, nprobe):
    return answers([db.select(Query("n").where_knn(
        "vec", q, IvfSearchParams(k=K, nprobe=nprobe))) for q in queries])


@pytest.mark.parametrize("entry", [port_knn_batch, port_select],
                         ids=["knn_batch", "select"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_port_is_the_plain_ivf(built, route, entry, monkeypatch):
    db, ix, rows, queries = built
    monkeypatch.setenv("RX_IVF_SEGMENTS", ROUTES[route])
    counter = tracing.counter("ivf.segment_scans" if route == "segments"
                              else "ivf.masked_sweeps")
    before = counter.value
    qs = queries if entry is port_knn_batch else queries[:4]
    ids, ranks = entry(db, qs, NPROBE)
    assert counter.value > before
    want_ids, want_ranks = plain_ivf(rows, ix.state_dict(), qs, NPROBE, K)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(ranks, want_ranks, rtol=0, atol=RANK_ATOL)


def test_the_probed_set_is_a_real_cut(built):
    """At nprobe 8 of 64 the plain IVF misses some of the exact top-k: the
    comparison above holds the port to the probe set, not to the exact
    answer."""
    _, ix, rows, queries = built
    ids, _ = plain_ivf(rows, ix.state_dict(), queries, NPROBE, K)
    exact, _ = reference.exact_topk(rows, queries, K, "cosine")
    assert (ids != exact).any()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_list_probed_gives_the_exact_top_k(built, route, monkeypatch):
    db, ix, rows, queries = built
    monkeypatch.setenv("RX_IVF_SEGMENTS", ROUTES[route])
    ids, ranks = port_knn_batch(db, queries, NLIST)
    want_ids, want_ranks = reference.exact_topk(rows, queries, K, "cosine")
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(ranks, want_ranks, rtol=0, atol=RANK_ATOL)


@pytest.fixture
def traced():
    tracing.configure(None, keep=True)
    tracing.take()
    yield
    tracing.configure(None)
    tracing.take()


def names(spans) -> list:
    return [s[0] for s in spans if s[0].startswith("ivf.")]


def test_a_build_is_one_train_and_one_reorder_under_the_dispatch(
        traced, monkeypatch):
    monkeypatch.setenv("RX_IVF_SEGMENTS", "1")
    rows, queries = make_data()
    db = Reindexer(device="cpu")
    db.open_namespace("m", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "ivf", vector_opts=FloatVectorOpts(
            dims=DIMS, metric=VectorMetric.COSINE, centroids_count=16))])
    for i, row in enumerate(rows[:1024].tolist()):
        db.upsert("m", {"id": i, "vec": row})
    tracing.take()
    params = IvfSearchParams(k=K, nprobe=4)
    db.knn_batch("m", "vec", queries, params)
    spans = tracing.take()
    assert sorted(names(spans)) == ["ivf.plan", "ivf.probe", "ivf.reorder",
                                    "ivf.train"]
    by_id = {s[4]: s for s in spans}
    assert {by_id[s[5]][0] for s in spans
            if s[0].startswith("ivf.")} == {"engine.dispatch"}
    # nothing left to build
    db.knn_batch("m", "vec", queries, params)
    assert "ivf.train" not in names(tracing.take())


def test_each_dispatch_is_one_probe_and_one_plan(built, traced,
                                                 monkeypatch):
    db, ix, rows, queries = built
    monkeypatch.setenv("RX_IVF_SEGMENTS", "1")
    before = tracing.counters()
    port_knn_batch(db, queries, NPROBE)
    port_knn_batch(db, queries[:3], NPROBE)
    spans = tracing.take()
    assert sorted(names(spans)) == ["ivf.plan"] * 2 + ["ivf.probe"] * 2
    by_id = {s[4]: s for s in spans}
    assert {by_id[s[5]][0] for s in spans
            if s[0] in ("ivf.plan", "ivf.probe")} == {"engine.dispatch"}
    after = tracing.counters()
    # the counters against the plan K6 was given: its live segments, and
    # the rows of the distinct blocks they score
    rows_want = live_want = whole_blocks = 0
    for qs in (queries, queries[:3]):
        prepared = np.stack([ix.keeper.prepare_query(q) for q in qs])
        starts, _, counts = ix._segment_plan(ix._probe_host(prepared,
                                                            NPROBE))
        live = counts > 0
        live_want += int(live.sum())
        blocks = dict(zip(starts[live].tolist(), counts[live].tolist()))
        rows_want += sum(blocks.values())
        whole_blocks += SEG_BLK * len(blocks)
    assert after["ivf.seg_live"] - before["ivf.seg_live"] == live_want
    assert after["ivf.seg_rows"] - before["ivf.seg_rows"] == rows_want
    # a list's last block is ragged: its padding is not read
    assert rows_want < whole_blocks < live_want * SEG_BLK


def test_the_sweep_plans_nothing_and_counts_no_segment(built, traced,
                                                       monkeypatch):
    db, _, _, queries = built
    monkeypatch.setenv("RX_IVF_SEGMENTS", "0")
    before = tracing.counters()
    port_knn_batch(db, queries, NPROBE)
    assert names(tracing.take()) == ["ivf.probe"]
    after = tracing.counters()
    for name in ("ivf.seg_rows", "ivf.seg_live"):
        assert after[name] == before[name]


def test_off_the_counters_do_not_count(built, monkeypatch):
    db, _, _, queries = built
    monkeypatch.setenv("RX_IVF_SEGMENTS", "1")
    before = tracing.counters()
    port_knn_batch(db, queries, NPROBE)
    after = tracing.counters()
    assert after["ivf.segment_scans"] == before["ivf.segment_scans"] + 1
    for name in ("ivf.seg_rows", "ivf.seg_live"):
        assert after[name] == before[name]
