"""reindexer_tpu_torch's IVF engine and ops vs reindexer_tpu's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port. The reference runs as its own tests run it off a TPU: the
masked sweep by default, the segment route in Pallas interpret mode with
RX_IVF_SEGMENTS=1.

Tolerances, with their reasons:
  - plain ops (kmeans, assignment, probes, list expansion, the gather and
    masked scans, segment_topk): ids and assignments equal; scores within
    rtol 1e-5 / atol 1e-5 (fp32 sums in another order);
  - K6's plain version vs the reference's `scan_segments`: rtol 2e-3 /
    atol 2e-3, the reference's own bound for its segment kernel
    (tests/test_ivf.py::test_ivf_segment_scan_parity): the Pallas kernel
    forms its dots from bf16x3 limb products (pallas_scan.py::_dot3), which
    lose about 2^-16 of each product's magnitude before the L2 terms
    cancel;
  - the engines: ids equal as sets, except between near-ties at the k-th
    rank (within rtol 1e-4 of it); ranks within rtol 1e-4 / atol 1e-4 on
    the masked and gather routes, and within the reference's own 2e-3
    (tests/test_ivf.py::test_ivf_segment_scan_parity) when the reference
    runs its bf16x3 segment kernel;
  - trained from scratch on isotropic data, where k-means may settle
    differently from rounding alone: recall@k of the two engines within
    0.05 of each other at every nprobe.
The `cuda` tests run K6 and the engine on the card and skip without one.
"""
import copy
import functools
import types

import numpy as np
import pytest
import torch

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu.query import dsl as ref_dsl
from reindexer_tpu_torch.query import dsl as port_dsl
from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                 IndexType, IvfSearchParams, Query,
                                 VectorMetric)
from reindexer_tpu_torch.convert import ivf_state_from_reference
from reindexer_tpu_torch.index.vector import ivf as port_ivf
from reindexer_tpu_torch.index.vector.ivf import IvfIndex
from reindexer_tpu_torch.index.vector.keeper import VectorKeeper
from reindexer_tpu_torch.ops import ivf_kernels as pk

# this file runs beside timing-sensitive tests (the TCP cluster's raft
# timeouts) when the suite is spread over processes: a small intra-op pool
# keeps torch from taking every core
torch.set_num_threads(2)

OP_RTOL, OP_ATOL = 1e-5, 1e-5
SEG_RTOL, SEG_ATOL = 2e-3, 2e-3
RTOL, ATOL = 1e-4, 1e-4
REF_SEG_RTOL = 2e-3
RECALL_SLACK = 0.05
METRICS = [VectorMetric.L2, VectorMetric.INNER_PRODUCT, VectorMetric.COSINE]
CPU = torch.device("cpu")


@functools.cache
def _ref():
    """The JAX package's IVF modules, imported here rather than at module
    level so that the `cuda` tests of this file run where JAX is absent:

        python -m pytest --noconftest -p no:cacheprovider -m cuda \\
            tests/test_torch_ivf.py
    """
    import jax.numpy as jnp
    from reindexer_tpu.index.vector.ivf import IvfIndex as RefIvfIndex
    from reindexer_tpu.index.vector.keeper import VectorKeeper as RefKeeper
    from reindexer_tpu.ops import ivf_kernels
    return types.SimpleNamespace(jnp=jnp, rk=ivf_kernels, Ivf=RefIvfIndex,
                                 Keeper=RefKeeper)


def t(x):
    return torch.from_numpy(np.array(x))


def idef(dims, metric, nlist, is_array=False):
    return IndexDef("vec", IndexType.IVF, opts=IndexOpts(is_array=is_array),
                    vector_opts=FloatVectorOpts(dims=dims, metric=metric,
                                                centroids_count=nlist))


def clustered(rng, n, dims, n_c, scale=3.0, noise=0.1, n_q=6):
    centers = scale * rng.normal(size=(n_c, dims)).astype(np.float32)
    base = (centers[rng.integers(0, n_c, size=n)]
            + noise * rng.normal(size=(n, dims))).astype(np.float32)
    qs = (centers[rng.integers(0, n_c, size=n_q)]
          + noise * rng.normal(size=(n_q, dims))).astype(np.float32)
    return base, qs


def assert_same(res_ref, res_port, rtol=RTOL, atol=ATOL):
    """ids equal up to near-ties at the k-th rank; ranks within rtol.
    Takes engine results (.ids, .ranks) or query results (docs, ranks())."""
    def ids_ranks(res):
        if hasattr(res, "docs"):
            return _ids(res), np.asarray(res.ranks(), float)
        return res.ids.tolist(), np.asarray(res.ranks, float)

    ids_r, ranks_r = ids_ranks(res_ref)
    ids_p, ranks_p = ids_ranks(res_port)
    assert len(ids_p) == len(ids_r)
    np.testing.assert_allclose(ranks_p, ranks_r, rtol=rtol, atol=atol)
    if ids_r:
        rank_of = dict(zip(ids_r, ranks_r)) | dict(zip(ids_p, ranks_p))
        edge = ranks_r[-1]
        for i in set(ids_r) ^ set(ids_p):
            assert abs(rank_of[i] - edge) <= rtol * abs(edge) + atol, i


# --- 1. each op against its JAX function -------------------------------

def test_kmeans_l2_matches_reference():
    R = _ref()
    rng = np.random.default_rng(1)
    train, _ = clustered(rng, 400, 8, 4, scale=10.0, noise=0.5)
    init = train[rng.choice(400, size=4, replace=False)]
    want = np.asarray(R.rk.kmeans_l2(R.jnp.asarray(train), R.jnp.asarray(init), 20))
    got = pk.kmeans_l2(t(train), t(init), 20).numpy()
    np.testing.assert_allclose(got, want, rtol=OP_RTOL, atol=OP_ATOL)
    a_ref = np.asarray(R.rk.assign_lists(R.jnp.asarray(train), R.jnp.asarray(want),
                                       VectorMetric.L2))
    a_port = pk.assign_lists(t(train), t(got), VectorMetric.L2).numpy()
    np.testing.assert_array_equal(a_port, a_ref)


def test_kmeans_empty_cluster_keeps_its_centroid():
    R = _ref()
    train = np.array([[0.0, 0.0], [0.1, 0.0], [10.0, 0.0]], np.float32)
    init = np.array([[0.0, 0.0], [10.0, 0.0], [100.0, 100.0]], np.float32)
    got = pk.kmeans_l2(t(train), t(init), 3).numpy()
    want = np.asarray(R.rk.kmeans_l2(R.jnp.asarray(train), R.jnp.asarray(init), 3))
    np.testing.assert_allclose(got, want, rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(got[2], init[2])


@pytest.mark.parametrize("metric", METRICS)
def test_assign_and_probe_match_reference(metric):
    R = _ref()
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    cent = rng.normal(size=(12, 16)).astype(np.float32)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        pk.assign_lists(t(vecs), t(cent), metric, chunk=64).numpy(),
        np.asarray(R.rk.assign_lists(R.jnp.asarray(vecs), R.jnp.asarray(cent),
                                   metric)))
    for nprobe in (1, 5, 12, 40):
        np.testing.assert_array_equal(
            pk.probe_centroids(t(q), t(cent), nprobe, metric).numpy(),
            np.asarray(R.rk.probe_centroids(R.jnp.asarray(q), R.jnp.asarray(cent),
                                          nprobe, metric)))


def _csr(rng, n_rows=200, nlist=10):
    assign = rng.integers(0, nlist, size=n_rows)
    assign[rng.choice(n_rows, 20, replace=False)] = -1
    assign[assign == 3] = -1                       # one empty list
    rows = np.flatnonzero(assign >= 0)
    order = np.argsort(assign[rows], kind="stable")
    list_rows = np.zeros(256, np.int32)
    list_rows[: len(rows)] = rows[order]
    list_start = np.searchsorted(assign[rows][order],
                                 np.arange(nlist + 1)).astype(np.int32)
    return list_rows, list_start


def test_expand_probes_matches_reference():
    R = _ref()
    rng = np.random.default_rng(3)
    list_rows, list_start = _csr(rng)
    probes = np.stack([rng.choice(10, 4, replace=False) for _ in range(5)]
                      ).astype(np.int32)
    probes[0, 1] = 3
    want_c, want_ok = R.rk.expand_probes(R.jnp.asarray(probes),
                                       R.jnp.asarray(list_start),
                                       R.jnp.asarray(list_rows), 256)
    got_c, got_ok = pk.expand_probes(t(probes), t(list_start), t(list_rows),
                                     256)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("chunk", [65536, 64], ids=["whole", "chunked"])
def test_scan_lists_batch_matches_reference(metric, chunk):
    R = _ref()
    rng = np.random.default_rng(4)
    list_rows, list_start = _csr(rng)
    data = rng.normal(size=(200, 8)).astype(np.float32)
    sq = (data * data).sum(1).astype(np.float32)
    valid = np.ones(200, bool)
    valid[::9] = False
    q = rng.normal(size=(3, 8)).astype(np.float32)
    probes = np.stack([rng.choice(10, 6, replace=False) for _ in range(3)]
                      ).astype(np.int32)
    cand, ok = R.rk.expand_probes(R.jnp.asarray(probes), R.jnp.asarray(list_start),
                                R.jnp.asarray(list_rows), 256)
    want_s, want_i = R.rk.scan_lists_batch(
        R.jnp.asarray(q), R.jnp.asarray(data), R.jnp.asarray(sq),
        R.jnp.asarray(valid), cand, ok, 32, metric, chunk=chunk)
    got_s, got_i = pk.scan_lists_batch(
        t(q), t(data), t(sq), t(valid), t(np.asarray(cand)),
        t(np.asarray(ok)), 32, metric, chunk=chunk)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    ids = got_i.numpy()
    assert valid[ids[ids >= 0]].all()


def _reorder(rng, npad=1024, dims=12, n_b=4):
    reordered = rng.normal(size=(npad, dims)).astype(np.float32)
    perm = rng.permutation(npad).astype(np.int32)
    perm[rng.random(npad) < 0.2] = -1
    reordered[perm < 0] = 0.0
    sq = np.where(perm >= 0, (reordered * reordered).sum(1), 0.0).astype(
        np.float32)
    bmask = rng.random((n_b, npad // 128)) < 0.5
    bmask[0] = False                               # a query with no probe
    q = rng.normal(size=(n_b, dims)).astype(np.float32)
    return q, reordered, sq, perm, bmask


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("chunk", [262144, 256], ids=["whole", "chunked"])
def test_scan_reordered_masked_matches_reference(metric, chunk):
    R = _ref()
    q, reordered, sq, perm, bmask = _reorder(np.random.default_rng(5))
    want_s, want_i = R.rk.scan_reordered_masked(
        R.jnp.asarray(q), R.jnp.asarray(reordered), R.jnp.asarray(sq),
        R.jnp.asarray(perm), R.jnp.asarray(bmask), 32, metric, chunk=chunk)
    got_s, got_i = pk.scan_reordered_masked(t(q), t(reordered), t(sq),
                                            t(perm), t(bmask), 32, metric,
                                            chunk=chunk)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i.numpy()[0] == -1).all()


def _segments(rng, npad=1024, n_b=3, s_q=8):
    """Query-major segments over npad / 128 blocks: ragged counts, full
    blocks and count-0 padding segments."""
    n_blocks = npad // 128
    starts = rng.integers(0, n_blocks, size=n_b * s_q).astype(np.int32)
    qids = np.repeat(np.arange(n_b, dtype=np.int32), s_q)
    counts = rng.integers(1, 129, size=n_b * s_q).astype(np.int32)
    counts[::3] = 128
    counts[s_q - 3:s_q] = 0                       # padding segments
    starts[s_q - 3:s_q] = n_blocks - 1
    return starts, qids, counts


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dims", [8, 13, 32])
def test_scan_segments_plain_matches_reference(metric, dims):
    R = _ref()
    rng = np.random.default_rng(6)
    q, reordered, _, _, _ = _reorder(rng, dims=dims)
    starts, qids, counts = _segments(rng)
    want = np.asarray(R.rk.scan_segments(
        R.jnp.asarray(starts), R.jnp.asarray(qids), R.jnp.asarray(counts),
        R.jnp.asarray(q[:3]), R.jnp.asarray(reordered), metric, interpret=True))
    args = (t(starts), t(qids), t(counts), t(q[:3]), t(reordered), metric)
    pk.seg_scan_launches.reset()
    for got in (pk.scan_segments_plain(*args, chunk=5),
                pk.scan_segments(*args)):
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=SEG_RTOL, atol=SEG_ATOL)
        dead = np.arange(128)[None, :] >= counts[:, None]
        assert (got[dead] == np.float32(-1e30)).all()
    assert pk.seg_scan_launches.value == 0        # the CPU runs no kernel


def test_scan_segments_checks_operands():
    rng = np.random.default_rng(7)
    q, reordered, _, _, _ = _reorder(rng)
    starts, qids, counts = (t(x) for x in _segments(rng))
    with pytest.raises(ValueError, match="i32"):
        pk.scan_segments(starts.long(), qids, counts, t(q), t(reordered),
                         VectorMetric.L2)
    with pytest.raises(ValueError, match="Npad"):
        pk.scan_segments(starts, qids, counts, t(q), t(reordered[:100]),
                         VectorMetric.L2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.scan_segments(starts.to("meta"), qids.to("meta"),
                         counts.to("meta"), t(q).to("meta"),
                         t(reordered).to("meta"), VectorMetric.L2)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [10, 2000], ids=["k10", "k_above_width"])
def test_segment_topk_matches_reference(metric, k):
    R = _ref()
    rng = np.random.default_rng(8)
    q, reordered, _, perm, _ = _reorder(rng)
    starts, qids, counts = _segments(rng)
    seg = pk.scan_segments_plain(t(starts), t(qids), t(counts), t(q[:3]),
                                 t(reordered), metric)
    want_s, want_i = R.rk.segment_topk(R.jnp.asarray(seg.numpy()),
                                     R.jnp.asarray(starts), R.jnp.asarray(perm),
                                     R.jnp.asarray(q[:3]), k, metric)
    got_s, got_i = pk.segment_topk(seg, t(starts), t(perm), t(q[:3]), k,
                                   metric)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# --- 2. the engine, with the reference's state carried across ----------

ROUTES = {"masked": {}, "segments": {"RX_IVF_SEGMENTS": "1"},
          "gather": {"RX_IVF_GATHER": "1"}}


def carried_pair(metric, n=600, dims=16, nlist=8, seed=9):
    """A trained reference IvfIndex and the port's index loaded from its
    state through convert.ivf_state_from_reference."""
    R = _ref()
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, dims)).astype(np.float32)
    r = R.Ivf(idef(dims, metric, nlist))
    for i in range(n):
        r.upsert(i, base[i])
    r.commit()
    p = IvfIndex(idef(dims, metric, nlist), CPU)
    p.load_state_dict(ivf_state_from_reference(r.state_dict()))
    return r, p, base, rng.normal(size=(5, dims)).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("nprobe", [1, 8], ids=["nprobe1", "full"])
def test_engine_matches_reference(metric, route, nprobe, monkeypatch):
    for name, v in ROUTES[route].items():
        monkeypatch.setenv(name, v)
    r, p, _, qs = carried_pair(metric)
    rtol = REF_SEG_RTOL if route == "segments" else RTOL
    params = IvfSearchParams(k=20, nprobe=nprobe)
    for a, b in zip(r.select_batch(qs, params), p.select_batch(qs, params)):
        assert_same(a, b, rtol, rtol)
    for q in qs[:2]:
        assert_same(r.select(q, params), p.select(q, params), rtol, rtol)


@pytest.mark.parametrize("metric", METRICS)
def test_radius_only_matches_reference(metric):
    r, p, base, qs = carried_pair(metric)
    full = p.select(qs[0], IvfSearchParams(k=50, nprobe=3))
    radius = float(full.ranks[len(full.ranks) // 2])
    params = IvfSearchParams(radius=radius, nprobe=3)
    port_ivf.gather_scans.reset()
    a, b = r.select(qs[0], params), p.select(qs[0], params)
    assert port_ivf.gather_scans.value == 1
    assert 0 < len(b.ids) < 50
    assert_same(a, b)
    outs = (r.select_batch(qs[:2], params), p.select_batch(qs[:2], params))
    for a, b in zip(*outs):
        assert_same(a, b)


def test_deletes_and_incremental_upserts_match_reference():
    r, p, base, qs = carried_pair(VectorMetric.L2, seed=10)
    rng = np.random.default_rng(11)
    extra = rng.normal(size=(100, 16)).astype(np.float32)
    for ix in (r, p):
        for i in range(0, 600, 7):
            ix.delete(i, None)
        for i in range(100):                      # assigned in _commit
            ix.upsert(600 + i, extra[i])
        ix.upsert(5, base[5] + 3.0)               # moved to another list
    params = IvfSearchParams(k=30, nprobe=3)
    for a, b in zip(r.select_batch(qs, params), p.select_batch(qs, params)):
        assert_same(a, b)
        assert not {0, 7, 14} & set(b.ids.tolist())
    np.testing.assert_array_equal(p.state_dict()["assign"],
                                  r.state_dict()["assign"])


def test_rebuild_centroids_matches_reference():
    """On separated clusters, with the reference's sampling generator
    state copied across, a retrain lands on the same lists."""
    R = _ref()
    rng = np.random.default_rng(12)
    base, qs = clustered(rng, 800, 16, 8)
    r = R.Ivf(idef(16, VectorMetric.L2, 8))
    for i in range(800):
        r.upsert(i, base[i])
    r.commit()
    p = IvfIndex(idef(16, VectorMetric.L2, 8), CPU)
    p.load_state_dict(ivf_state_from_reference(r.state_dict()))
    p._rng = copy.deepcopy(r._rng)
    r.rebuild_centroids()
    p.rebuild_centroids()
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(r.centroids),
                               rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(p._assign, r._assign)
    params = IvfSearchParams(k=10, nprobe=1)
    for a, b in zip(r.select_batch(qs, params), p.select_batch(qs, params)):
        assert_same(a, b)


def test_state_dict_round_trip():
    r, p, _, qs = carried_pair(VectorMetric.COSINE, seed=13)
    st = p.state_dict()
    ref_st = r.state_dict()
    np.testing.assert_array_equal(st["keeper"]["data"],
                                  ref_st["keeper"]["data"])
    np.testing.assert_array_equal(st["centroids"], ref_st["centroids"])
    np.testing.assert_array_equal(st["assign"], ref_st["assign"])
    p2 = IvfIndex(idef(16, VectorMetric.COSINE, 8), CPU)
    p2.load_state_dict(st)
    params = IvfSearchParams(k=10, nprobe=2)
    for a, b in zip(p.select_batch(qs, params), p2.select_batch(qs, params)):
        assert a.ids.tolist() == b.ids.tolist()
        np.testing.assert_array_equal(a.ranks, b.ranks)
    assert p2.memstat() == p.memstat()


def test_ivf_state_from_reference_checks_shapes():
    r, _, _, _ = carried_pair(VectorMetric.L2, n=100, seed=14)
    st = r.state_dict()
    bad_c = dict(st, centroids=np.zeros((8, 5), np.float32))
    with pytest.raises(port.ParamsError, match="centroids"):
        ivf_state_from_reference(bad_c)
    bad_a = dict(st, assign=np.full(st["keeper"]["data"].shape[0], 8))
    with pytest.raises(port.ParamsError, match="assign"):
        ivf_state_from_reference(bad_a)
    untrained = dict(st, centroids=None,
                     assign=np.full(len(st["assign"]), -1))
    assert ivf_state_from_reference(untrained)["centroids"] is None


def test_routes_are_counted(monkeypatch):
    _, p, _, qs = carried_pair(VectorMetric.L2, n=200, seed=15)
    counters = (port_ivf.segment_scans, port_ivf.masked_sweeps,
                port_ivf.gather_scans)

    def run(**env):
        for name in ("RX_IVF_SEGMENTS", "RX_IVF_GATHER"):
            monkeypatch.delenv(name, raising=False)
        for name, v in env.items():
            monkeypatch.setenv(name, v)
        for c in counters:
            c.reset()
        p.select_batch(qs, IvfSearchParams(k=5, nprobe=2))
        return tuple(c.value for c in counters)

    assert run() == (0, 1, 0)                     # the CPU default
    assert run(RX_IVF_SEGMENTS="1") == (1, 0, 0)
    assert run(RX_IVF_SEGMENTS="0") == (0, 1, 0)
    assert run(RX_IVF_GATHER="1") == (0, 0, 1)


def test_router_inequality(monkeypatch):
    """seg_rows * penalty + fixed_rows < capacity, fixed_rows = fixed_ms at
    the sweep's per-row cost for this batch and width."""
    monkeypatch.setenv("RX_IVF_SEG_PENALTY", "4")
    monkeypatch.setenv("RX_IVF_SEG_FIXED_MS", "0")
    assert port_ivf.segments_win(1000, 4001, 16, 8)
    assert not port_ivf.segments_win(1000, 4000, 16, 8)
    monkeypatch.setenv("RX_IVF_SEG_FIXED_MS", "1")
    sweep_ns = (port_ivf.SWEEP_NS_PER_ROW
                + port_ivf.SWEEP_NS_PER_ROW_QUERY * 8) * 16 / 768
    rows_per_ms = 1e6 / sweep_ns
    assert port_ivf.segments_win(1000, 4001 + int(rows_per_ms), 16, 8)
    assert not port_ivf.segments_win(1000, 4000 + int(rows_per_ms), 16, 8)


# The H100 route table at 1M x 768, capacity 1,048,576 (PERF.md, "IVF
# router"; chip_smoke.py's `[ivf routes]` lines on an NVIDIA H100 80GB HBM3
# at 700 W): (batch, nprobe, seg_rows, stage-2 ms of the segment route, of
# the masked sweep). Since K6 reads a probed block once for all its queries
# the segments are faster at every point.
ROUTE_TABLE = [
    (1, 8, 7168, 0.8572, 7.3255), (1, 16, 13440, 1.2749, 6.4691),
    (1, 32, 28160, 1.2960, 6.2795), (1, 64, 55808, 1.4473, 6.3586),
    (1, 128, 112768, 1.5222, 7.9706), (16, 8, 117632, 2.1982, 9.2239),
    (16, 16, 237312, 2.0322, 9.6523), (16, 32, 489856, 2.3708, 8.3902),
    (16, 64, 1004672, 2.8776, 9.3326), (16, 128, 2046208, 3.3869, 9.6565),
    (32, 8, 240512, 2.1785, 11.6060), (32, 16, 478592, 3.0614, 13.0403),
    (32, 32, 981760, 3.1900, 11.3574), (32, 64, 1984000, 3.6840, 11.0508),
    (32, 128, 4068608, 4.5408, 8.9675), (64, 8, 491136, 4.0350, 14.7048),
    (64, 16, 982016, 3.8783, 15.3720), (64, 32, 1985792, 5.1793, 14.7252),
    (64, 64, 3987840, 5.3987, 14.1325), (64, 128, 8112896, 6.3496, 12.4139),
    (128, 8, 998400, 5.2805, 20.3033), (128, 16, 1992320, 5.5555, 21.3486),
    (128, 32, 4008448, 5.3867, 19.1556), (128, 64, 8044672, 6.9064, 19.6410),
    (128, 128, 16309888, 12.1714, 22.3661),
    (256, 8, 2007168, 7.2479, 36.7883), (256, 16, 3996288, 7.6797, 38.3218),
    (256, 32, 8012672, 9.7100, 36.5824),
    (256, 64, 16150400, 13.8451, 37.1655),
    (256, 128, 32630144, 19.3378, 36.9254),
]
ROUTE_CAPACITY = 1_048_576


def _no_router_overrides(monkeypatch):
    for name in ("RX_IVF_SEG_PENALTY", "RX_IVF_SEG_FIXED_MS"):
        monkeypatch.delenv(name, raising=False)


# (batch, seg_rows, segments faster), points of ROUTE_TABLE
@pytest.mark.parametrize("batch, seg_rows, seg_faster", [
    (1, 112_768, True), (16, 2_046_208, True), (32, 4_068_608, True),
    (64, 8_112_896, True), (128, 16_309_888, True), (256, 2_007_168, True),
    (256, 32_630_144, True)])
def test_router_defaults_follow_the_h100_table(monkeypatch, batch, seg_rows,
                                               seg_faster):
    _no_router_overrides(monkeypatch)
    assert port_ivf.segments_win(seg_rows, ROUTE_CAPACITY, 768,
                                 batch) == seg_faster


def test_router_constants_are_the_fit_of_the_h100_table(monkeypatch):
    """The router's constants are the least-squares fit of ROUTE_TABLE
    (segments: fixed + ns a probed row; sweep: fixed + ms a query, its rate
    a row of capacity after the segments' fixed cost), and the router takes
    the faster route at 29 of the 30 points at least."""
    _no_router_overrides(monkeypatch)
    b, _, rows, seg_ms, sweep_ms = (np.array(c, dtype=np.float64)
                                    for c in zip(*ROUTE_TABLE))
    ones = np.ones_like(b)
    seg_fixed, seg_per_row = np.linalg.lstsq(np.c_[ones, rows], seg_ms,
                                             rcond=None)[0]
    sweep_fixed, sweep_per_q = np.linalg.lstsq(np.c_[ones, b], sweep_ms,
                                               rcond=None)[0]
    np.testing.assert_allclose(
        [port_ivf.SEG_NS_PER_ROW, port_ivf.SWEEP_NS_PER_ROW,
         port_ivf.SWEEP_NS_PER_ROW_QUERY],
        [seg_per_row * 1e6, (sweep_fixed - seg_fixed) * 1e6 / ROUTE_CAPACITY,
         sweep_per_q * 1e6 / ROUTE_CAPACITY], rtol=1e-3)
    right = sum(port_ivf.segments_win(int(r), ROUTE_CAPACITY, 768, int(n))
                == (s < w) for n, _, r, s, w in ROUTE_TABLE)
    assert right >= 29


# --- 3. trained from scratch, through the public API ---------------------

PKGS = (ref, port)       # each database gets its own package's classes


def _pair_dbs(base, metric, nlist, dims):
    dbs = (ref.Reindexer(), port.Reindexer(device="cpu"))
    for db, pkg in zip(dbs, PKGS):
        db.open_namespace("v", [
            pkg.IndexDef("id", "hash", "int",
                         opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("vec", pkg.IndexType.IVF,
                         vector_opts=pkg.FloatVectorOpts(
                             dims=dims, metric=pkg.VectorMetric(metric.value),
                             centroids_count=nlist))])
        for i, row in enumerate(base.tolist()):
            db.upsert("v", {"id": i, "vec": row})
    return dbs


def _ids(res):
    return [d["id"] for d in res.docs()]


@pytest.mark.parametrize("metric", METRICS)
def test_separated_clusters_match_from_scratch(metric):
    rng = np.random.default_rng(16)
    base, qs = clustered(rng, 700, 16, 8)
    dbs = _pair_dbs(base, metric, 8, 16)
    for nprobe in (1, 3, 8):
        params = [pkg.IvfSearchParams(k=15, nprobe=nprobe) for pkg in PKGS]
        for q in qs:
            assert_same(*(db.select(pkg.Query("v").where_knn("vec", q, p))
                          for db, pkg, p in zip(dbs, PKGS, params)))
        outs = [db.knn_batch("v", "vec", qs, p)
                for db, p in zip(dbs, params)]
        for a, b in zip(*outs):
            assert_same(a, b)


def test_isotropic_recall_matches_from_scratch():
    rng = np.random.default_rng(17)
    n, dims, k = 1500, 16, 10
    base = rng.normal(size=(n, dims)).astype(np.float32)
    qs = rng.normal(size=(20, dims)).astype(np.float32)
    dbs = _pair_dbs(base, VectorMetric.L2, 32, dims)
    want = [set(np.argsort(((base - q) ** 2).sum(1))[:k].tolist())
            for q in qs]
    prev = None
    for nprobe in (1, 4, 16, 32):
        rec = [np.mean([len(set(_ids(r)) & w) / k for r, w in zip(
            db.knn_batch("v", "vec", qs, pkg.IvfSearchParams(
                k=k, nprobe=nprobe)), want)]) for db, pkg in zip(dbs, PKGS)]
        assert abs(rec[0] - rec[1]) <= RECALL_SLACK, (nprobe, rec)
        assert prev is None or rec[1] >= prev
        prev = rec[1]
    assert prev == 1.0


def test_sql_dsl_nprobe_and_rebuild_action():
    rng = np.random.default_rng(18)
    base, qs = clustered(rng, 400, 8, 4)
    dbs = _pair_dbs(base, VectorMetric.L2, 4, 8)
    vec = ", ".join(f"{x:.6f}" for x in qs[0])
    sql = f"SELECT * FROM v WHERE KNN(vec, [{vec}], k=5, nprobe=2)"
    dsl = {"namespace": "v", "filters": [
        {"field": "vec", "cond": "knn", "value": qs[0].tolist(),
         "params": {"k": 5, "nprobe": 2}}]}
    got = [(_ids(db.select(sql)), _ids(db.select(dsl_mod.parse_dsl(dsl))))
           for db, dsl_mod in zip(dbs, (ref_dsl, port_dsl))]
    assert got[0] == got[1]
    assert got[1][0] == got[1][1] and len(got[1][0]) == 5
    for db in dbs:
        db.upsert("#config", {"type": "action", "action": {
            "command": "rebuild_ivf_index", "namespace": "v",
            "index": "vec"}})
    ix = dbs[1].get_namespace("v").get_index("vec")
    assert isinstance(ix, IvfIndex) and ix.centroids is not None
    assert [_ids(db.select(sql)) for db in dbs] == [got[0][0]] * 2


def test_array_ivf_raises():
    db = port.Reindexer(device="cpu")
    db.open_namespace("x", [IndexDef("id", "hash", "int",
                                     opts=IndexOpts(is_pk=True))])
    with pytest.raises(NotImplementedError, match="A10"):
        db.add_index("x", idef(4, VectorMetric.L2, 2, is_array=True))


# --- 4. the cases of tests/test_ivf.py on the port's engine --------------

REF_CASES = [("test_ivf_recall_full_probe", {"metric": m}) for m in METRICS]
REF_CASES += [(name, {}) for name in (
    "test_ivf_nprobe_sweep_recall", "test_ivf_incremental_and_delete",
    "test_ivf_rank_values", "test_ivf_state_roundtrip", "test_ivf_via_query",
    "test_ivf_select_batch", "test_ivf_segment_scan_parity",
    "test_ivf_segment_scan_partial_probe")]


@pytest.mark.parametrize("name,kwargs", REF_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(REF_CASES)])
def test_reference_ivf_cases_on_port(name, kwargs, monkeypatch):
    def make_index(dims=16, metric=VectorMetric.L2, nlist=16):
        return IvfIndex(idef(dims, metric, nlist), CPU)

    import test_ivf                     # the reference's cases; imports JAX
    monkeypatch.setattr(test_ivf, "make_index", make_index)
    monkeypatch.setattr(test_ivf, "Reindexer",
                        lambda: port.Reindexer(device="cpu"))
    # the cases build definitions and queries with the port's own classes
    for name_ in ("FloatVectorOpts", "IndexDef", "IndexOpts", "IndexType",
                  "Query", "VectorMetric", "IvfSearchParams"):
        monkeypatch.setattr(test_ivf, name_, getattr(port, name_))
    fn = getattr(test_ivf, name)
    extra = {}
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        extra["monkeypatch"] = monkeypatch
    fn(rng=np.random.default_rng(42), **kwargs, **extra)


# --- 5. bulk_load with the bf16 upload -------------------------------------

@pytest.mark.parametrize("metric", [VectorMetric.L2, VectorMetric.COSINE])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_bulk_load_bf16_bit_equal_to_reference(metric, bf16):
    R = _ref()
    rng = np.random.default_rng(19)
    m = rng.normal(size=(3000, 24)).astype(np.float32) * 7.3
    r = R.Keeper(24, metric)
    p = VectorKeeper(24, metric, CPU)
    r.upload_bf16 = p.upload_bf16 = bf16
    r.bulk_load(m)
    p.bulk_load(m)
    data = np.asarray(r.data)
    np.testing.assert_array_equal(p.data.numpy(), data)
    want_sq = (np.asarray(r.sq) if metric == VectorMetric.L2
               else np.zeros(len(data), np.float32))
    np.testing.assert_array_equal(p.sq_eff()[:3000].numpy(), want_sq[:3000])
    low_bits = p.data[:3000].numpy().view(np.uint32) & 0xFFFF
    assert (low_bits == 0).all() == bf16           # bf16 rows end in 16 zeros


@pytest.mark.parametrize("env,bf16", [(None, True), ("0", False),
                                      ("false", False)])
def test_ivf_sets_bf16_upload(env, bf16, monkeypatch):
    R = _ref()
    if env is not None:
        monkeypatch.setenv("RX_IVF_BF16_UPLOAD", env)
    p = IvfIndex(idef(8, VectorMetric.L2, 4), CPU)
    r = R.Ivf(idef(8, VectorMetric.L2, 4))
    assert p.keeper.upload_bf16 == r.keeper.upload_bf16 == bf16


def test_bulk_load_train_matches_reference():
    """The loading recipe of bench.py's IVF leg (bulk_load, _grow, _train)
    gives the reference's centroids and lists on separated clusters."""
    R = _ref()
    rng = np.random.default_rng(20)
    base, qs = clustered(rng, 2000, 16, 16, noise=0.2)
    r = R.Ivf(idef(16, VectorMetric.COSINE, 16))
    p = IvfIndex(idef(16, VectorMetric.COSINE, 16), CPU)
    for ix in (r, p):
        ix.keeper.bulk_load(base)
        ix._grow(len(base))
        ix._train()
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(r.centroids),
                               rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_array_equal(p._assign, r._assign)
    params = IvfSearchParams(k=20, nprobe=4)
    for a, b in zip(r.select_batch(qs, params), p.select_batch(qs, params)):
        assert_same(a, b)


# --- 6. on the card --------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")


def _k6_plan(plan, rng, n_blocks=8):
    """(starts, qids, counts, n_q, bad) of a K6 test plan; bad lists the
    segments whose index is out of range (their rows must come out NaN).

    random        query-major, ragged counts, padding (_segments)
    shared        256 queries all probing every block (tiles of a block),
                  each segment its own count
    padding       half the segments count-0 padding on the pad block
    counts        16 queries on one block, counts 0 .. 128
    out_of_range  random, with a block index and a query index out of range
    one_query     one query (no grouping), a block probed twice, padding
    misaligned    random, over a reorder whose base is off 16 bytes"""
    if plan in ("random", "out_of_range", "misaligned"):
        starts, qids, counts = _segments(rng)
        n_q, bad = 3, []
        if plan == "out_of_range":
            starts[1], qids[4], counts[1], counts[4] = n_blocks, 3, 5, 7
            bad = [1, 4]
        return starts, qids, counts, n_q, bad
    if plan == "shared":
        n_q, s_q = 256, n_blocks
        starts = np.tile(rng.permutation(n_blocks), n_q)
        qids = np.repeat(np.arange(n_q), s_q)
        counts = rng.integers(1, 129, size=n_q * s_q)
    elif plan == "padding":
        n_q, s_q = 8, 16
        starts = rng.integers(0, n_blocks - 1, size=n_q * s_q)
        qids = np.repeat(np.arange(n_q), s_q)
        counts = rng.integers(1, 129, size=n_q * s_q)
        pad = (np.arange(n_q * s_q) % s_q) >= s_q // 2
        starts[pad], counts[pad] = n_blocks - 1, 0
    elif plan == "counts":
        n_q = 16
        starts = np.full(n_q, 3)
        qids = rng.permutation(n_q)
        counts = np.linspace(0, 128, n_q).astype(np.int64)
    else:                                           # one_query
        n_q = 1
        starts = np.array([2, 5, 2, 0, n_blocks - 1, n_blocks - 1])
        qids = np.zeros(6)
        counts = np.array([128, 77, 3, 128, 0, 0])
    return (starts.astype(np.int32), qids.astype(np.int32),
            counts.astype(np.int32), n_q, [])


K6_PLANS = ["random", "shared", "padding", "counts", "out_of_range",
            "one_query", "misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", K6_PLANS)
@pytest.mark.parametrize("dims", [8, 13, 768])
def test_cuda_seg_scan_matches_plain(dims, plan):
    """K6 within 8 fp32 ulps of the magnitude each score is summed from
    (sum |q_d b_d|, plus |b|^2 for L2): its 3xTF32 products and the plain
    version's fp32 ones round in another order; a single bf16 or TF32
    operand would be off by ~1e3 ulps. Segments with an index out of range
    come out NaN and are compared with nothing."""
    _need_cuda()
    rng = np.random.default_rng(21)
    starts, qids, counts, n_q, bad = _k6_plan(plan, rng)
    q = rng.normal(size=(n_q, dims)).astype(np.float32)
    _, reordered, _, _, _ = _reorder(rng, dims=dims)
    dev = torch.device("cuda")
    base = t(reordered).to(dev)
    if plan == "misaligned":
        flat = torch.empty(base.numel() + 1, device=dev)
        flat[1:] = base.reshape(-1)
        base = flat[1:].view(base.shape)
        assert base.data_ptr() % 16
    # the plain version indexes with every start: give it valid ones
    ok_starts, ok_qids = starts.copy(), qids.copy()
    ok_starts[bad], ok_qids[bad] = 0, 0
    eps = float(np.finfo(np.float32).eps)
    for metric in METRICS:
        args = [t(x).to(dev) for x in (starts, qids, counts, q)] + [base,
                                                                     metric]
        plain = [t(x).to(dev) for x in (ok_starts, ok_qids)] + args[2:]
        pk.seg_scan_launches.reset()
        got = pk.scan_segments(*args)
        want = pk.scan_segments_plain(*plain)
        torch.cuda.synchronize()
        assert pk.seg_scan_launches.value == 1
        mag = pk.scan_segments_plain(*plain[:3], plain[3].abs(),
                                     plain[4].abs(),
                                     VectorMetric.INNER_PRODUCT)
        if metric == VectorMetric.L2:
            mag = 2.0 * mag - pk.scan_segments_plain(
                *plain[:3], torch.zeros_like(plain[3]), plain[4], metric)
        keep = torch.ones(len(starts), dtype=torch.bool, device=dev)
        keep[bad] = False
        assert bool(torch.isnan(got[~keep]).all())
        assert bool(((got - want).abs()
                     <= 8 * eps * mag.clamp_min(0.0))[keep].all())


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(monkeypatch):
    """The same trained state on the card and on the CPU: both stage-2
    routes and the router give the CPU engine's answers. The L2 rank is
    |q|^2 - 2 q.b + |b|^2 in fp32, so two devices summing in another order
    differ by a few ulps of |q|^2 + |b|^2 (~1200 here): atol 8 ulps of
    that."""
    _need_cuda()
    rng = np.random.default_rng(22)
    base, qs = clustered(rng, 3000, 64, 16, n_q=16)
    atol = 8 * float(np.finfo(np.float32).eps) * float(
        (base * base).sum(1).max() + (qs * qs).sum(1).max())
    cpu = IvfIndex(idef(64, VectorMetric.L2, 16), CPU)
    cpu.keeper.bulk_load(base)
    cpu._grow(len(base))
    cpu._train()
    gpu = IvfIndex(idef(64, VectorMetric.L2, 16), torch.device("cuda"))
    gpu.load_state_dict(cpu.state_dict())
    params = IvfSearchParams(k=50, nprobe=4)
    want = cpu.select_batch(qs, params)
    for env in ("1", "0", None):
        if env is None:
            monkeypatch.delenv("RX_IVF_SEGMENTS", raising=False)
        else:
            monkeypatch.setenv("RX_IVF_SEGMENTS", env)
        pk.seg_scan_launches.reset()
        got = gpu.select_batch(qs, params)
        assert (pk.seg_scan_launches.value > 0) == (env == "1") or env is None
        for a, b in zip(want, got):
            assert_same(a, b, RTOL, atol)
        for q, a in zip(qs[:3], want):
            assert_same(a, gpu.select(q, params), RTOL, atol)
