"""reindexer_tpu_torch's HNSW engine, graph-search ops, streaming KNN and
array vector indexes vs reindexer_tpu's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port (the JAX device code of HNSW is plain XLA, so the reference
runs as its own tests run it). Tolerances, with their reasons:
  - the ops (beam search, streaming begin/resume, greedy descent, the
    heuristic, insertion, the exact build step): scores within rtol / atol
    1e-5 (fp32 sums in another order); ids equal as sets, except between
    near-ties (within rtol 1e-5 of the k-th score); visited bitsets and the
    beam's iteration counts equal;
  - the engines on one graph (the reference's state carried into the
    port): ids equal except near-ties at the k-th rank, ranks within rtol /
    atol 1e-4; deleted rows never returned;
  - the engines built from scratch through the public API: the link tables
    equal in at least 98% of rows (fp32 near-ties in the scan or the
    heuristic may decide a link otherwise), recall@10 within 0.02 of the
    reference's at ef 16, 32 and 64.
The `cuda` tests run the engine on the card against the engine on the CPU
(repeated and concurrent searches, streaming sessions, a one-card mesh;
one descent launch and one K7 launch a search, no host read of a stop
flag), and the two kernels, K7 and the descent, against their plain twins
on the card, bit for bit on rows of small integers (every fp32 sum exact
in any order), and skip without one; the JAX package is imported lazily,
so they run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_hnsw.py
"""
import functools
import sys
import threading
import types

import numpy as np
import pytest
import torch

import reindexer_tpu_torch as port
from reindexer_tpu_torch import (FloatVectorOpts, HnswSearchParams, IndexDef,
                                 IndexOpts, IndexType, Query, VectorMetric)
from reindexer_tpu_torch.convert import hnsw_state_from_reference
from reindexer_tpu_torch.index.vector import hnsw as port_hnsw
from reindexer_tpu_torch.index.vector.hnsw import HnswIndex
from reindexer_tpu_torch.index.vector.keeper import VectorKeeper
from reindexer_tpu_torch.index.vector.streaming import KnnStreamingSession
from reindexer_tpu_torch.ops import hnsw_kernels as pk

# this file runs beside timing-sensitive tests (the TCP cluster's raft
# timeouts) when the suite is spread over processes: a small intra-op pool
# keeps torch from taking every core
torch.set_num_threads(2)

OP_RTOL, OP_ATOL = 1e-5, 1e-5
RTOL, ATOL = 1e-4, 1e-4
LINK_SHARE = 0.98
RECALL_SLACK = 0.02
METRICS = ["L2", "INNER_PRODUCT", "COSINE"]
CPU = torch.device("cpu")


@functools.cache
def _ref():
    """The JAX package's HNSW modules, imported here rather than at module
    level so that the `cuda` tests of this file run where JAX is absent."""
    import jax.numpy as jnp
    import reindexer_tpu
    from reindexer_tpu.index.vector.hnsw import HnswIndex as RefHnsw
    from reindexer_tpu.index.vector.keeper import VectorKeeper as RefKeeper
    from reindexer_tpu.ops import hnsw_kernels
    return types.SimpleNamespace(jnp=jnp, pkg=reindexer_tpu, rk=hnsw_kernels,
                                 Hnsw=RefHnsw, Keeper=RefKeeper)


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    """A JAX or torch array as numpy (uint32 bitsets as int32)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def metrics(name):
    return _ref().pkg.VectorMetric[name], VectorMetric[name]


# --- 1. the ops against their JAX functions --------------------------------

def make_graph(rng, n_rows=400, dims=16, m=8, quantized=False):
    """Random rows (or SQ8 codes) and a random link table with empty slots;
    returns (reference pack, port pack, links)."""
    R = _ref()
    links = rng.integers(-1, n_rows, size=(n_rows, m)).astype(np.int32)
    if not quantized:
        data = rng.normal(size=(n_rows, dims)).astype(np.float32)
        sq = np.sum(data * data, axis=1, dtype=np.float32)
        return (R.rk.DataPack(R.jnp.asarray(data), R.jnp.asarray(sq)),
                pk.DataPack(t(data), t(sq)), links)
    codes = rng.integers(0, 256, size=(n_rows, dims)).astype(np.uint8)
    lo = rng.normal(size=dims).astype(np.float32)
    alpha = rng.uniform(0.005, 0.02, size=dims).astype(np.float32)
    deq = lo + alpha * codes.astype(np.float32)
    sq = np.sum(deq * deq, axis=1, dtype=np.float32)
    arrs = (codes, sq, lo, alpha)
    return (R.rk.DataPack(*map(R.jnp.asarray, arrs)),
            pk.DataPack(*map(t, arrs)), links)


def assert_same_topk(ref_s, ref_i, s, i, rtol=OP_RTOL, atol=OP_ATOL):
    """Row by row: scores within rtol / atol, ids equal as sets except
    between near-ties at the k-th (last finite) score."""
    ref_s, ref_i, s, i = n(ref_s), n(ref_i), n(s), n(i)
    np.testing.assert_allclose(s, ref_s, rtol=rtol, atol=atol)
    for row in range(ref_i.shape[0]):
        finite = np.isfinite(ref_s[row])
        assert (i[row] >= 0).sum() == finite.sum()
        if not finite.any():
            continue
        kth = ref_s[row][finite][-1]
        score = dict(zip(ref_i[row].tolist(), ref_s[row].tolist()))
        score.update(zip(i[row].tolist(), s[row].tolist()))
        for x in set(ref_i[row].tolist()) ^ set(i[row].tolist()):
            assert abs(score[x] - kth) <= rtol * abs(kth) + atol, (row, x)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_beam_search_layer_matches_reference(metric, quantized):
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(1)
    rp, pp, links = make_graph(rng, quantized=quantized)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    ent = rng.integers(-1, 400, size=(6, 2)).astype(np.int32)
    ent[:, 0] = np.abs(ent[:, 0])
    for ef in (16, 48):
        want = R.rk.beam_search_layer(
            R.jnp.asarray(q), rp, R.jnp.asarray(links), R.jnp.asarray(ent),
            ef=ef, expand=2, max_iters=2 * ef, metric=rm)
        got = pk.beam_search_layer(t(q), pp, t(links), t(ent), ef, 2,
                                   2 * ef, pm)
        assert_same_topk(*want, *got[:2])


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_streaming_begin_and_two_resumes_match_reference(metric, quantized):
    """beam_begin_stream, then two beam_search_resume calls carrying the
    state over: equal frontiers, visited bits and iteration counts."""
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(2)
    rp, pp, links = make_graph(rng, n_rows=600, quantized=quantized)
    q = np.zeros((8, 16), np.float32)
    q[0] = rng.normal(size=16)
    ent = np.full((8, 1), 5, np.int32)
    want = R.rk.beam_begin_stream(R.jnp.asarray(q), rp, R.jnp.asarray(ent),
                                  n_rows=600, fcap=128, metric=rm)
    got = pk.beam_begin_stream(t(q), pp, t(ent), 600, 128, pm)
    assert_same_topk(*want[:2], *got[:2])
    assert_same_topk(*want[2:4], *got[2:4])
    np.testing.assert_array_equal(n(got[4]), n(want[4]))
    seed_r, seed_p = want[:2], got[:2]
    state_r, state_p = want[2:], got[2:]
    before = n(state_p[2]).copy()
    for ef in (32, 64):
        out_r = R.rk.beam_search_resume(
            R.jnp.asarray(q), rp, R.jnp.asarray(links), *seed_r, *state_r,
            ef=ef, expand=2, max_iters=2 * ef, metric=rm)
        out_p = pk.beam_search_resume(t(q), pp, t(links), *seed_p, *state_p,
                                      ef, 2, 2 * ef, pm)
        assert_same_topk(*out_r[:2], *out_p[:2])
        assert_same_topk(*out_r[2:4], *out_p[2:4])
        np.testing.assert_array_equal(n(out_p[4]), n(out_r[4]))
        assert int(out_p[5]) == int(out_r[5]) > 0
        # later batches start from an empty seed, as the session's do
        seed_r = (R.jnp.full((8, 1), -np.inf, R.jnp.float32),
                  R.jnp.full((8, 1), -1, R.jnp.int32))
        seed_p = (torch.full((8, 1), float("-inf")),
                  torch.full((8, 1), -1, dtype=torch.int32))
        state_r, state_p = out_r[2:5], out_p[2:5]
    # the inputs of a resume are not modified (the session keeps them)
    np.testing.assert_array_equal(n(got[4]), before)


def test_zero_row_keeps_the_loop_running():
    """The batch-wide stop: under IP a zero query row scores every node 0,
    so it stays active while its frontier holds nodes and keeps the loop
    going for the whole batch, as the engine's padded rows do. The port runs
    as many iterations as the reference, more than the real query alone."""
    R = _ref()
    rm, pm = metrics("INNER_PRODUCT")
    rng = np.random.default_rng(3)
    rp, pp, links = make_graph(rng, n_rows=500)
    q = np.zeros((8, 16), np.float32)
    q[0] = rng.normal(size=16)
    ent = np.full((8, 1), 7, np.int32)
    iters = {}
    for rows in (1, 8):
        want = R.rk.beam_begin_stream(R.jnp.asarray(q[:rows]), rp,
                                      R.jnp.asarray(ent[:rows]), n_rows=500,
                                      fcap=32, metric=rm)
        out_r = R.rk.beam_search_resume(
            R.jnp.asarray(q[:rows]), rp, R.jnp.asarray(links), *want,
            ef=32, expand=2, max_iters=64, metric=rm)
        got = pk.beam_begin_stream(t(q[:rows]), pp, t(ent[:rows]), 500, 32,
                                   pm)
        out_p = pk.beam_search_resume(t(q[:rows]), pp, t(links), *got,
                                      32, 2, 64, pm)
        assert int(out_p[5]) == int(out_r[5])
        assert_same_topk(*out_r[:2], *out_p[:2])
        np.testing.assert_array_equal(n(out_p[4]), n(out_r[4]))
        iters[rows] = int(out_p[5])
    assert iters[8] > iters[1], iters


def test_beam_loop_syncs_once_every_sync_every_steps():
    """The beam returns its count `it` (an int32 tensor) and does not add
    it to `beam_steps`: its caller does, once the count is on the host.
    The plain loop reads its condition once before each step and once
    after the last."""
    rm, pm = metrics("L2")
    rng = np.random.default_rng(4)
    _, pp, links = make_graph(rng, n_rows=500)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    got = pk.beam_begin_stream(t(q), pp, t(np.full((8, 1), 3, np.int32)),
                               500, 64, pm)
    pk.beam_steps.reset()
    from reindexer_tpu_torch import tracing
    tracing.configure(keep=True)
    try:
        out = pk.beam_search_resume(t(q), pp, t(links), *got, 64, 2, 128,
                                    pm)
        reads = sum(s[0] == "hnsw.stop_read" for s in tracing.take())
    finally:
        tracing.configure(None)
    iters = int(out[5])
    assert out[5].dtype == torch.int32 and out[5].shape == ()
    assert 0 < iters < 128 and pk.beam_steps.value == 0
    assert reads == iters + 1


@pytest.mark.parametrize("mesh", [False, True], ids=["engine", "mesh"])
def test_search_adds_its_beam_count_at_drain(mesh, monkeypatch):
    """A search brings its beams' counts back in its one result copy and
    adds them to `beam_steps` when it drains, not before: the sum of the
    `it` its beams returned (one beam, or one a shard)."""
    from reindexer_tpu_torch.parallel import sharded_hnsw
    from reindexer_tpu_torch.parallel.context import MeshContext
    rng = np.random.default_rng(22)
    base = rng.normal(size=(300, 8)).astype(np.float32)
    ix = HnswIndex(hnsw_def(port, 8, "L2"), CPU)
    if mesh:
        ix.attach_mesh(MeshContext(["cpu"] * 2))
    for i in range(300):
        ix.upsert(i, base[i])
    ix.commit()
    its = []

    def beam(*args, **kw):
        out = pk.beam_search_layer(*args, **kw)
        its.append(int(out[2]))
        return out
    monkeypatch.setattr(port_hnsw, "beam_search_layer", beam)
    monkeypatch.setattr(sharded_hnsw, "beam_search_layer", beam)
    pk.beam_steps.reset()
    drain = ix._search_batch_async(
        rng.normal(size=(3, 8)).astype(np.float32), 32)
    assert len(its) == (2 if mesh else 1) and min(its) > 0
    assert pk.beam_steps.value == 0
    scores, ids = drain()
    assert pk.beam_steps.value == sum(its)
    assert scores.shape == ids.shape == (3, 32) and (ids[:, 0] >= 0).all()


@pytest.mark.parametrize("max_hops", [1, 2, 64])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_greedy_descend_matches_reference(metric, quantized, max_hops):
    """Three upper layers, the JAX loop's entries at every hop cap: one and
    two hops stop layers that were still moving, 64 runs every layer to
    its own stop."""
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(5)
    rp, pp, _ = make_graph(rng, n_rows=500, quantized=quantized)
    stack = rng.integers(-1, 500, size=(3, 500, 6)).astype(np.int32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    entry = np.full(9, 11, np.int32)
    want = R.rk.greedy_descend(R.jnp.asarray(q), rp, R.jnp.asarray(stack),
                               R.jnp.asarray(entry), rm, max_hops=max_hops)
    got = pk.greedy_descend(t(q), pp, t(stack), t(entry), pm,
                            max_hops=max_hops)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), n(want))


@pytest.mark.parametrize("metric", METRICS)
def test_heuristic_select_matches_reference(metric):
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(6)
    B, C, D = 7, 40, 8
    vecs = rng.normal(size=(B, C, D)).astype(np.float32)
    q = rng.normal(size=(B, D)).astype(np.float32)
    scores = np.einsum("bcd,bd->bc", vecs, q).astype(np.float32)
    if metric == "L2":
        scores = -np.sum((vecs - q[:, None]) ** 2, axis=2).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")
    scores = np.take_along_axis(scores, order, axis=1)
    vecs = np.take_along_axis(vecs, order[:, :, None], axis=1)
    ids = np.tile(np.arange(C, dtype=np.int32), (B, 1)) + 100
    ids[:, -5:] = -1                   # padding at the tail
    scores[:, -5:] = -np.inf
    for m in (4, 12):
        want = R.rk.heuristic_select(R.jnp.asarray(ids),
                                     R.jnp.asarray(scores),
                                     R.jnp.asarray(vecs), m=m, metric=rm)
        got = pk.heuristic_select(t(ids), t(scores), t(vecs), m, pm)
        np.testing.assert_array_equal(got.numpy(), n(want))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_insert_layer_matches_reference(metric, quantized):
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(7)
    rp, pp, links = make_graph(rng, n_rows=300, quantized=quantized)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    entry = rng.integers(0, 300, size=8).astype(np.int32)
    extra_i = rng.integers(-1, 300, size=(8, 8)).astype(np.int32)
    extra_s = rng.normal(size=(8, 8)).astype(np.float32) - 40.0
    want = R.rk.insert_layer(
        R.jnp.asarray(q), rp, R.jnp.asarray(links), R.jnp.asarray(entry),
        R.jnp.asarray(extra_i), R.jnp.asarray(extra_s), ef=32, expand=2,
        max_iters=64, m=6, metric=rm)
    got = pk.insert_layer(t(q), pp, t(links), t(entry), t(extra_i),
                          t(extra_s), 32, 2, 64, 6, pm)
    np.testing.assert_array_equal(got[1].numpy(), n(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), n(want[0]))


@pytest.mark.parametrize("heuristic", [True, False],
                         ids=["heuristic", "top_m"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_build_layer_matches_reference(metric, heuristic):
    """One build step: exact scan of layer lc's population (levels >= lc,
    not deleted) plus the chunk's own members, then the heuristic; with and
    without chunk-internal candidates (kc 8 / 0)."""
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(8)
    N, D = 512, 16
    data = rng.normal(size=(N, D)).astype(np.float32)
    if metric == "COSINE":
        data /= np.linalg.norm(data, axis=1, keepdims=True)
    sq = np.sum(data * data, axis=1, dtype=np.float32)
    levels = rng.integers(-1, 3, size=N).astype(np.int32)
    deleted = rng.random(N) < 0.1
    rows = np.full(16, -1, np.int64)
    rows[:11] = rng.choice(np.flatnonzero(levels < 0), 11, replace=False)
    q = np.zeros((16, D), np.float32)
    q[:11] = data[rows[:11]]
    lvl = np.full(16, -1, np.int32)
    lvl[:11] = rng.integers(0, 3, size=11)
    rp = R.rk.DataPack(R.jnp.asarray(data), R.jnp.asarray(sq))
    pp = pk.DataPack(t(data), t(sq))
    for lc in (0, 1):
        for kc in (8, 0):
            want = R.rk.exact_build_layer(
                R.jnp.asarray(q), rp, R.jnp.asarray(levels),
                R.jnp.asarray(deleted), R.jnp.int32(lc),
                R.jnp.asarray(rows.astype(np.int32)),
                R.jnp.asarray(lvl >= lc), k=64, kc=kc, m=8, metric=rm,
                use_heuristic=heuristic)
            got = pk.exact_build_layer(t(q), pp, t(levels), t(deleted), lc,
                                       t(rows), t(lvl >= lc), 64, kc, 8, pm,
                                       use_heuristic=heuristic)
            # the 11 members (the engine reads no padding row's selection:
            # a zero row ties every candidate under IP and cosine)
            np.testing.assert_array_equal(got.numpy()[:11], n(want)[:11])


# --- 2. the keeper's |b|^2 ---------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_keeper_sq_bit_equal_to_reference(metric):
    """The keeper's true |b|^2 equals the JAX keeper's bit for bit: kept
    stale for removed rows, zero for rows an empty keeper's flush did not
    write, and through bulk_load and load_state_dict."""
    R = _ref()
    rm, pm = metrics(metric)
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(60, 12)).astype(np.float32)
    rk, kp = R.Keeper(12, rm), VectorKeeper(12, pm, CPU, copy_on_write=True)

    def same():
        np.testing.assert_array_equal(kp.sq.numpy(), np.asarray(rk.sq))
        np.testing.assert_array_equal(kp.data.numpy(), np.asarray(rk.data))

    for i in range(0, 60, 2):
        rk.set(i, vecs[i])
        kp.set(i, vecs[i])
    rk.flush()
    kp.flush()
    same()
    for i in range(0, 60, 6):
        rk.remove(i)
        kp.remove(i)
    for i in range(1, 20, 2):
        rk.set(i, vecs[i])
        kp.set(i, vecs[i])
    rk.flush()
    old = kp.data
    kp.flush()
    same()
    assert kp.data is not old         # copy on write: the old one is kept
    for i in range(60):
        rk.remove(i)
        kp.remove(i)
    rk.flush()
    kp.flush()
    rk.set(3, vecs[3])
    kp.set(3, vecs[3])
    rk.flush()
    kp.flush()
    same()                            # an empty keeper's flush zeroes
    rk.bulk_load(vecs[:30], start_row=10)
    kp.bulk_load(vecs[:30], start_row=10)
    same()
    state = rk.state_dict()
    kp.load_state_dict(state)
    rk.load_state_dict(state)
    same()


# --- 3. the engine against the reference's, on one graph and from scratch --

def hnsw_def(pkg, dims, metric, m=8, efc=48, quant=False):
    q = pkg.QuantizationConfig(enabled=True, min_elements=64) if quant \
        else pkg.QuantizationConfig()
    return pkg.IndexDef("vec", pkg.IndexType.HNSW, vector_opts=(
        pkg.FloatVectorOpts(dims=dims, metric=pkg.VectorMetric[metric], m=m,
                            ef_construction=efc, quantization=q)))


def assert_same(res_ref, res_port, rtol=RTOL, atol=ATOL):
    """ids equal up to near-ties at the k-th rank; ranks within rtol."""
    ids_r, ranks_r = res_ref.ids.tolist(), np.asarray(res_ref.ranks, float)
    ids_p, ranks_p = res_port.ids.tolist(), np.asarray(res_port.ranks, float)
    assert len(ids_p) == len(ids_r)
    np.testing.assert_allclose(ranks_p, ranks_r, rtol=rtol, atol=atol)
    if ids_r:
        rank_of = dict(zip(ids_r, ranks_r)) | dict(zip(ids_p, ranks_p))
        edge = ranks_r[-1]
        for i in set(ids_r) ^ set(ids_p):
            assert abs(rank_of[i] - edge) <= rtol * abs(edge) + atol, i


def ref_and_port(metric, quant=False, n_rows=900, dims=16, seed=10):
    """A reference HNSW index built from seeded rows with 60 deletes, and a
    port index loaded from its state."""
    R = _ref()
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_rows, dims)).astype(np.float32)
    r = R.Hnsw(hnsw_def(R.pkg, dims, metric, quant=quant))
    for i in range(n_rows):
        r.upsert(i, base[i])
    r.commit()
    deleted = rng.choice(n_rows, 60, replace=False)
    for i in deleted:
        r.delete(int(i), None)
    p = HnswIndex(hnsw_def(port, dims, metric, quant=quant), CPU)
    p.load_state_dict(hnsw_state_from_reference(r.state_dict()))
    return r, p, base, set(deleted.tolist()), rng


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("metric", METRICS)
def test_engine_on_one_graph_matches_reference(metric, quant):
    R = _ref()
    r, p, base, deleted, rng = ref_and_port(metric, quant)
    qs = rng.normal(size=(12, 16)).astype(np.float32)
    qs[0] = base[next(iter(deleted))]         # a deleted row's own vector
    for ef in (16, 48):
        params = [pkg.HnswSearchParams(k=10, ef=ef)
                  for pkg in (R.pkg, port)]
        for q in qs:
            a, b = r.select(q, params[0]), p.select(q, params[1])
            assert_same(a, b)
            assert not set(b.ids.tolist()) & deleted
        for a, b in zip(r.select_batch(qs, params[0]),
                        p.select_batch(qs, params[1])):
            assert_same(a, b)
            assert not set(b.ids.tolist()) & deleted
    if quant:
        assert p._quant.active and r._quant.active
    # a radius select: ranks past the radius dropped in both
    a = r.select(qs[1], R.pkg.HnswSearchParams(k=10,
                                                                   ef=32))
    radius = float(a.ranks[5])
    a = r.select(qs[1], R.pkg.HnswSearchParams(
        k=10, ef=32, radius=radius))
    b = p.select(qs[1], HnswSearchParams(k=10, ef=32, radius=radius))
    assert_same(a, b)
    assert 0 < len(b.ids) < 10


def _public_db(pkg, base, metric, efc=48):
    db = pkg.Reindexer(**({"device": "cpu"} if pkg is port else {}))
    db.open_namespace("v", [
        pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
        pkg.IndexDef("vec", pkg.IndexType.HNSW,
                     vector_opts=pkg.FloatVectorOpts(
                         dims=base.shape[1], metric=pkg.VectorMetric[metric],
                         m=8, ef_construction=efc))])
    for i, row in enumerate(base.tolist()):
        db.upsert("v", {"id": i, "vec": row})
    return db


@pytest.mark.parametrize("metric", METRICS)
def test_engine_built_from_scratch_matches_reference(metric):
    """Both packages build through the public API from the same rows: the
    graphs agree in at least 98% of link-table rows, and recall@10 against
    the exact oracle is within 0.02 at ef 16, 32 and 64."""
    R = _ref()
    rng = np.random.default_rng(11)
    base = rng.normal(size=(1200, 24)).astype(np.float32)
    qs = rng.normal(size=(24, 24)).astype(np.float32)
    dbs = [_public_db(pkg, base, metric) for pkg in (R.pkg, port)]
    ixs = [db.get_namespace("v").get_index("vec") for db in dbs]
    for ix in ixs:
        ix.commit()
    share = float((ixs[0]._links0 == ixs[1]._links0).all(axis=1).mean())
    upper = [float((a == b).all(axis=1).mean())
             for a, b in zip(ixs[0]._upper, ixs[1]._upper)]
    print(f"{metric}: link rows equal: layer 0 {share:.4f}, upper {upper}")
    assert share >= LINK_SHARE
    assert len(ixs[0]._upper) == len(ixs[1]._upper)
    assert all(u >= LINK_SHARE for u in upper)
    if metric == "L2":
        s = -((qs[:, None, :] - base[None]) ** 2).sum(-1)
    else:
        b = base if metric == "INNER_PRODUCT" else \
            base / np.linalg.norm(base, axis=1, keepdims=True)
        s = qs @ b.T
    oracle = np.argsort(-s, axis=1)[:, :10]
    for ef in (16, 32, 64):
        recall = []
        for db, pkg in zip(dbs, (R.pkg, port)):
            p = pkg.HnswSearchParams(k=10, ef=ef)
            hits = [len(set(d["id"] for d in db.select(pkg.Query("v").where_knn(
                "vec", q, p)).docs()) & set(oracle[j].tolist()))
                for j, q in enumerate(qs)]
            recall.append(sum(hits) / (10 * len(qs)))
        assert abs(recall[0] - recall[1]) <= RECALL_SLACK, (ef, recall)


def test_native_and_python_linkers_give_identical_tables(monkeypatch):
    """The C++ link loop and its Python fallback (RX_TPU_DISABLE_NATIVE or
    no compiler) produce the same tables, in the port as in the reference
    (tests/test_native.py)."""
    assert port_hnsw._hnsw_native_module() is not None
    rng = np.random.default_rng(12)
    base = rng.normal(size=(300, 8)).astype(np.float32)

    def build(native):
        if not native:
            monkeypatch.setattr(port_hnsw, "_HNSW_NATIVE", None)
        ix = HnswIndex(IndexDef("v", IndexType.HNSW, vector_opts=(
            FloatVectorOpts(dims=8, metric=VectorMetric.L2, m=4,
                            ef_construction=16))), CPU)
        for i in range(300):
            ix.upsert(i, base[i])
        ix.commit()
        return ix

    a, b = build(True), build(False)
    np.testing.assert_array_equal(a._links0, b._links0)
    assert len(a._upper) == len(b._upper)
    for ua, ub in zip(a._upper, b._upper):
        np.testing.assert_array_equal(ua, ub)
    assert (a._entry, a._max_level) == (b._entry, b._max_level)


def test_disable_native_selects_the_python_linker(monkeypatch):
    monkeypatch.setattr(port_hnsw, "_HNSW_NATIVE", None)
    monkeypatch.setattr(port_hnsw, "_HNSW_NATIVE_TRIED", False)
    monkeypatch.setenv("RX_TPU_DISABLE_NATIVE", "1")
    assert port_hnsw._hnsw_native_module() is None


def test_state_converter_checks_shapes():
    R = _ref()
    r, p, base, _, _ = ref_and_port("L2", n_rows=200)
    state = r.state_dict()
    got = hnsw_state_from_reference(state)
    assert got["links0"] is not state["links0"]
    np.testing.assert_array_equal(got["links0"], state["links0"])
    bad = dict(state, links0=state["links0"][:, :3])
    bad["upper"] = [u.copy() for u in state["upper"]]
    bad["upper"][0] = bad["upper"][0][:5]
    with pytest.raises(port.ParamsError):
        hnsw_state_from_reference(bad)
    out_of_range = dict(state, links0=state["links0"] + 10 ** 6)
    with pytest.raises(port.ParamsError):
        hnsw_state_from_reference(out_of_range)
    # a mesh snapshot converts shard by shard, and loads only into an
    # index on a mesh of as many shards
    mesh_state = hnsw_state_from_reference({"mesh_shards": [state]})
    np.testing.assert_array_equal(mesh_state["mesh_shards"][0]["links0"],
                                  state["links0"])
    with pytest.raises(port.ParamsError, match="mesh"):
        p.load_state_dict({"mesh_shards": [state]})


def test_mesh_is_not_ported():
    """The mesh mode is ported (tests/test_torch_mesh_engines.py): on a
    2-shard CPU mesh the rows round-robin over two sub-indexes, and a
    mesh snapshot of the reference's loads into it and answers as the
    reference does."""
    from reindexer_tpu_torch.parallel.context import MeshContext
    R = _ref()
    from reindexer_tpu.parallel.context import make_mesh_context
    rng = np.random.default_rng(21)
    base = rng.normal(size=(300, 8)).astype(np.float32)
    r = R.Hnsw(hnsw_def(R.pkg, 8, "L2"))
    r.attach_mesh(make_mesh_context(2))
    ix = HnswIndex(hnsw_def(port, 8, "L2"), CPU)
    ix.attach_mesh(MeshContext(["cpu"] * 2))
    assert len(ix._mesh_shards) == 2
    for i in range(300):
        r.upsert(i, base[i])
    r.commit()
    ix.load_state_dict(hnsw_state_from_reference(r.state_dict()))
    assert ix._mesh_shards[1].keeper.count == 150
    for q in rng.normal(size=(4, 8)).astype(np.float32):
        params = (HnswSearchParams(k=5, ef=32),
                  R.pkg.HnswSearchParams(k=5, ef=32))
        assert_same(r.select(q, params[1]), ix.select(q, params[0]))


# --- 4. the reference's cases on the port's engine -------------------------

REF_CASES = [("test_hnsw_recall", {"metric": m}) for m in METRICS]
REF_CASES += [(name, {}) for name in (
    "test_hnsw_rank_values_l2", "test_hnsw_delete_and_reinsert",
    "test_hnsw_radius", "test_hnsw_state_roundtrip",
    "test_hnsw_incremental_inserts", "test_hnsw_via_query",
    "test_hnsw_quantized_search", "test_hnsw_recall_at_scale",
    "test_hnsw_vector_update_relinks")]


def _port_names(module, monkeypatch, names):
    for name in names:
        if hasattr(module, name):
            monkeypatch.setattr(module, name, getattr(port, name))


@pytest.mark.parametrize("name,kwargs", REF_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(REF_CASES)])
def test_reference_hnsw_cases_on_port(name, kwargs, monkeypatch):
    import test_hnsw                    # the reference's cases; imports JAX

    def make_index(dims=16, metric=VectorMetric.L2, m=8, efc=64):
        return HnswIndex(IndexDef("vec", IndexType.HNSW, vector_opts=(
            FloatVectorOpts(dims=dims, metric=metric, m=m,
                            ef_construction=efc))), CPU)

    monkeypatch.setattr(test_hnsw, "make_index", make_index)
    monkeypatch.setattr(test_hnsw, "HnswIndex",
                        lambda idef: HnswIndex(idef, CPU))
    monkeypatch.setattr(test_hnsw, "Reindexer",
                        lambda: port.Reindexer(device="cpu"))
    _port_names(test_hnsw, monkeypatch, (
        "FloatVectorOpts", "IndexDef", "IndexOpts", "IndexType", "Query",
        "VectorMetric", "HnswSearchParams"))
    if "metric" in kwargs:
        kwargs = {"metric": VectorMetric[kwargs["metric"]]}
    getattr(test_hnsw, name)(rng=np.random.default_rng(42), **kwargs)


def _streaming_db(rng):
    """tests/test_streaming_knn.py's `db` fixture, on the port."""
    d = port.Reindexer(device="cpu")
    d.open_namespace("v", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("grp", "hash", "int"),
        IndexDef("vec", IndexType.HNSW, vector_opts=FloatVectorOpts(
            dims=8, metric=VectorMetric.L2, m=8, ef_construction=48)),
    ])
    base = rng.normal(size=(300, 8)).astype(np.float32)
    for i in range(300):
        d.upsert("v", {"id": i, "grp": i % 3, "vec": base[i].tolist()})
    d._base = base
    return d


STREAM_CASES = ("test_estimator_matches_reference",
                "test_streaming_with_filter", "test_streaming_offset",
                "test_streaming_requires_hnsw")


@pytest.mark.parametrize("name", STREAM_CASES)
def test_reference_streaming_cases_on_port(name, monkeypatch):
    import test_streaming_knn as ts     # the reference's cases; imports JAX
    from reindexer_tpu_torch.index.vector import streaming
    monkeypatch.setattr(ts, "StreamingKnnEstimator",
                        streaming.StreamingKnnEstimator)
    monkeypatch.setattr(ts, "Reindexer",
                        lambda: port.Reindexer(device="cpu"))
    _port_names(ts, monkeypatch, (
        "FloatVectorOpts", "IndexDef", "IndexOpts", "IndexType", "Query",
        "QueryError", "VectorMetric", "HnswSearchParams"))
    fn = getattr(ts, name)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    rng = np.random.default_rng(42)
    kw = {}
    if "db" in args:
        kw["db"] = _streaming_db(rng)
    if "rng" in args:
        kw["rng"] = rng
    fn(**kw)


def test_continuation_is_incremental():
    """tests/test_streaming_knn.py's case of that name with the port's
    session: batches are disjoint, best-first, cover the exact top-N and
    cost no more iterations than one fresh search of both batches' size
    (plus one batch)."""
    rng = np.random.default_rng(42)
    db = _streaming_db(rng)
    q_vec = rng.normal(size=8).astype(np.float32)
    index = db.get_namespace("v").get_index("vec")
    s1 = KnnStreamingSession(index, q_vec, 64)
    ids_a, sc_a = s1.next_batch(64)
    it_a = s1.iters_total
    ids_b, sc_b = s1.next_batch(64)
    it_b = s1.iters_total - it_a
    assert not set(ids_a.tolist()) & set(ids_b.tolist())
    assert list(sc_a) == sorted(sc_a, reverse=True)
    assert list(sc_b) == sorted(sc_b, reverse=True)
    assert sc_a[-1] >= sc_b[0]
    d2 = np.sum((db._base - q_vec) ** 2, axis=1)
    n_got = len(ids_a) + len(ids_b)
    want = set(np.argsort(d2)[:n_got].tolist())
    got = set(ids_a.tolist()) | set(ids_b.tolist())
    assert len(got & want) >= int(0.75 * n_got)
    s2 = KnnStreamingSession(index, q_vec, 64)
    s2.next_batch(128)
    assert it_a + it_b <= s2.iters_total + max(it_a, it_b)


def test_session_survives_index_mutation():
    """tests/test_streaming_knn.py's case of that name with the port's
    session: a commit between two batches (new rows, an updated vector)
    leaves the running stream on the graph and vectors it started on."""
    rng = np.random.default_rng(42)
    db = _streaming_db(rng)
    q_vec = rng.normal(size=8).astype(np.float32)
    index = db.get_namespace("v").get_index("vec")
    s = KnnStreamingSession(index, q_vec, 64)
    links, data = s._links, s._pack.data
    snap = (links.clone(), data.clone())
    ids_a, _ = s.next_batch(64)
    db.upsert("v", {"id": 500, "grp": 0,
                    "vec": rng.normal(size=8).astype(np.float32).tolist()})
    db.upsert("v", {"id": 1, "grp": 1, "vec": (q_vec + 0.01).tolist()})
    db.select(Query("v").where_knn("vec", q_vec, HnswSearchParams(k=1)))
    assert index._d_links0 is not links and index.keeper.data is not data
    assert torch.equal(links, snap[0]) and torch.equal(data, snap[1])
    ids_b, _ = s.next_batch(64)
    assert not set(ids_a.tolist()) & set(ids_b.tolist())
    assert all(0 <= i < 300 for i in ids_b.tolist())


def test_streaming_sql_and_sq8_stream():
    """A streaming query on an SQ8 graph returns exact ranks (each batch is
    re-scored in fp32), in the reference's order, and the same ids as the
    reference on the same data up to near-ties."""
    R = _ref()
    rng = np.random.default_rng(13)
    base = rng.normal(size=(400, 8)).astype(np.float32)
    q = rng.normal(size=8).astype(np.float32)
    got = []
    for pkg in (R.pkg, port):
        db = pkg.Reindexer(**({"device": "cpu"} if pkg is port else {}))
        db.open_namespace("s", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("grp", "hash", "int"),
            pkg.IndexDef("vec", pkg.IndexType.HNSW, vector_opts=(
                pkg.FloatVectorOpts(dims=8, metric=pkg.VectorMetric.L2, m=8,
                                    ef_construction=48,
                                    quantization=pkg.QuantizationConfig(
                                        enabled=True, min_elements=64))))])
        for i in range(400):
            db.upsert("s", {"id": i, "grp": i % 2, "vec": base[i].tolist()})
        res = db.select(pkg.Query("s").where("grp", "=", 0).where_knn(
            "vec", q, pkg.HnswSearchParams()).limit(12))
        got.append(([d["id"] for d in res.docs()],
                    np.asarray([it.rank for it in res])))
    (ids_r, ranks_r), (ids_p, ranks_p) = got
    assert len(ids_p) == 12 and all(i % 2 == 0 for i in ids_p)
    np.testing.assert_allclose(ranks_p, ((base[ids_p] - q) ** 2).sum(1),
                               rtol=RTOL)
    np.testing.assert_allclose(ranks_p, ranks_r, rtol=RTOL, atol=ATOL)
    assert ids_p == ids_r


# --- 5. array vector indexes against the reference --------------------------

def _array_dbs(kind, metric="L2"):
    R = _ref()
    rng = np.random.default_rng(14)
    base = rng.normal(size=(240, 8)).astype(np.float32)
    dbs = []
    for pkg in (R.pkg, port):
        db = pkg.Reindexer(**({"device": "cpu"} if pkg is port else {}))
        vo = dict(dims=8, metric=pkg.VectorMetric[metric])
        if kind == "ivf":
            vo["centroids_count"] = 4
        db.open_namespace("a", [
            pkg.IndexDef("id", "hash", "int", opts=pkg.IndexOpts(is_pk=True)),
            pkg.IndexDef("vec", kind, opts=pkg.IndexOpts(is_array=True),
                         vector_opts=pkg.FloatVectorOpts(**vo))])
        for i in range(90):
            vecs = base[2 * i: 2 * i + i % 3].tolist()    # 0, 1 or 2 vectors
            db.upsert("a", {"id": i, "vec": vecs})
        dbs.append(db)
    return dbs, base, rng


def _params(pkg, kind, k):
    if kind == "ivf":
        return pkg.IvfSearchParams(k=k, nprobe=4)
    if kind == "hnsw":
        return pkg.HnswSearchParams(k=k, ef=64)
    return pkg.KnnSearchParams(k=k)


def _docs(res):
    return [d["id"] for d in res.docs()], np.asarray([it.rank for it in res])


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("kind", ["vec_bf", "ivf", "hnsw"])
def test_array_index_matches_reference(kind, metric):
    """Per-document dedup (each document once, with its best vector's
    rank), ANY / EMPTY, an update that replaces a document's vectors and a
    delete: the same documents and ranks in both packages."""
    R = _ref()
    dbs, base, rng = _array_dbs(kind, metric)
    pkgs = (R.pkg, port)
    qs = rng.normal(size=(6, 8)).astype(np.float32)

    def knn(k=15):
        out = []
        for q in qs:
            a, b = (_docs(db.select(pkg.Query("a").where_knn(
                "vec", q, _params(pkg, kind, k)))) for db, pkg in
                zip(dbs, pkgs))
            assert a[0] == b[0] and len(b[0]) == len(set(b[0]))
            np.testing.assert_allclose(b[1], a[1], rtol=RTOL, atol=ATOL)
            out.append(b)
        return out

    res = knn()
    assert any(len(ids) < 15 for ids, _ in res)      # dedup shortens
    for q, (ids, ranks) in zip(qs, res):             # the best vector's rank
        for doc, rank in zip(ids, ranks):
            vecs = base[2 * doc: 2 * doc + doc % 3]
            best = ((vecs - q) ** 2).sum(1).min() if metric == "L2" else \
                (vecs @ q).max()
            np.testing.assert_allclose(rank, best, rtol=RTOL, atol=ATOL)
    for cond in ("ANY", "EMPTY"):
        got = [sorted(d["id"] for d in db.select(pkg.Query("a").where(
            "vec", pkg.CondType[cond], None)).docs())
            for db, pkg in zip(dbs, pkgs)]
        assert got[0] == got[1] and got[1]
    for db in dbs:
        db.upsert("a", {"id": 5, "vec": [qs[0].tolist(), qs[1].tolist()]})
        db.delete("a", {"id": 4})
        db.upsert("a", {"id": 7, "vec": []})
    res = knn()
    assert all(4 not in ids and 7 not in ids for ids, _ in res)
    assert res[0][0][0] == 5


def test_array_knn_batch_raises_as_in_reference():
    """The array adapter has no *_async split in either package, so
    db.knn_batch on an array field raises AttributeError in both."""
    R = _ref()
    dbs, base, _ = _array_dbs("hnsw")
    for db, pkg in zip(dbs, (R.pkg, port)):
        with pytest.raises(AttributeError):
            db.knn_batch("a", "vec", base[:2], _params(pkg, "hnsw", 3))


# --- 6. on the card ----------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine runs on the card only "
                    "there")


def _cpu_and_cuda(quant=False, n_rows=3000, dims=32, metric="INNER_PRODUCT"):
    rng = np.random.default_rng(15)
    base = rng.normal(size=(n_rows, dims)).astype(np.float32)
    defn = hnsw_def(port, dims, metric, m=16, efc=64, quant=quant)
    gpu = HnswIndex(defn, torch.device("cuda"))
    for i in range(n_rows):
        gpu.upsert(i, base[i])
    gpu.commit()
    for i in range(0, n_rows, 37):
        gpu.delete(i, None)
    cpu = HnswIndex(defn, CPU)
    cpu.load_state_dict(gpu.state_dict())
    return cpu, gpu, base, rng


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "sq8"])
def test_cuda_engine_matches_cpu_engine(quant):
    """One graph, built on the card, searched on the card and on the CPU:
    the same ids (near-ties aside), ranks within rtol 1e-4, the same beam
    iterations."""
    _need_cuda()
    cpu, gpu, _, rng = _cpu_and_cuda(quant)
    qs = rng.normal(size=(16, 32)).astype(np.float32)
    for ef in (16, 64):
        steps = []
        for ix in (cpu, gpu):
            pk.beam_steps.reset()
            res = ix.select_batch(qs, HnswSearchParams(k=10, ef=ef))
            steps.append(pk.beam_steps.value)
            if ix is cpu:
                want = res
        for a, b in zip(want, res):
            assert_same(a, b)
        assert steps[0] == steps[1] > 0, steps
        for q in qs[:4]:
            assert_same(cpu.select(q, HnswSearchParams(k=10, ef=ef)),
                        gpu.select(q, HnswSearchParams(k=10, ef=ef)))
    # the search ran on the card: its link mirror and vectors live there
    assert gpu._d_links0.is_cuda and gpu.keeper.data.is_cuda


@pytest.mark.cuda
def test_cuda_search_syncs_once_every_eight_steps():
    """A search on the card reads no stop flag on the host: no
    `hnsw.stop_read` span, whatever the ef and the batch."""
    _need_cuda()
    from reindexer_tpu_torch import tracing
    _, gpu, _, rng = _cpu_and_cuda(n_rows=2000)
    assert gpu._max_level > 0
    qs = rng.normal(size=(8, 32)).astype(np.float32)
    tracing.configure(keep=True)
    try:
        for ef in (16, 64, 256):
            for batch in (qs[:1], qs):
                pk.beam_steps.reset()
                tracing.take()
                gpu.select_batch(batch, HnswSearchParams(k=10, ef=ef))
                names = [s[0] for s in tracing.take()]
                assert pk.beam_steps.value > 0
                assert "hnsw.stop_read" not in names, (ef, len(batch))
    finally:
        tracing.configure(None)


@pytest.mark.cuda
def test_cuda_streaming_session_survives_a_commit():
    _need_cuda()
    db = port.Reindexer(device="cuda")
    rng = np.random.default_rng(42)
    db.open_namespace("v", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", IndexType.HNSW, vector_opts=FloatVectorOpts(
            dims=8, metric=VectorMetric.L2, m=8, ef_construction=48))])
    base = rng.normal(size=(300, 8)).astype(np.float32)
    for i in range(300):
        db.upsert("v", {"id": i, "vec": base[i].tolist()})
    index = db.get_namespace("v").get_index("vec")
    q_vec = rng.normal(size=8).astype(np.float32)
    s = KnnStreamingSession(index, q_vec, 64)
    assert s._links.is_cuda
    ids_a, _ = s.next_batch(64)
    db.upsert("v", {"id": 500, "vec": (q_vec + 0.001).tolist()})
    db.upsert("v", {"id": 2, "vec": (q_vec + 0.002).tolist()})
    res = db.select(Query("v").where_knn("vec", q_vec, HnswSearchParams(k=1)))
    assert res.docs()[0]["id"] == 500
    ids_b, sc_b = s.next_batch(64)
    assert not set(ids_a.tolist()) & set(ids_b.tolist())
    assert all(0 <= i < 300 for i in ids_b.tolist())
    assert list(sc_b) == sorted(sc_b, reverse=True)


def _deltas(counters, before):
    return tuple(c.value - b for c, b in zip(counters, before))


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [8, 64])
@pytest.mark.parametrize("metric,quant", [("L2", False),
                                          ("INNER_PRODUCT", False),
                                          ("INNER_PRODUCT", True)],
                         ids=["l2", "ip", "sq8"])
def test_cuda_cached_searches_match_cpu_engine(metric, quant, n_q,
                                              monkeypatch):
    """Repeated searches of one shape, a new query set each time: the same
    ids as the CPU engine (near-ties aside), ranks within rtol 1e-4, the
    same beam steps; on the card one descent launch and one K7 launch a
    search; the descent's entries and the beam's results its twins' on the
    card."""
    _need_cuda()
    cpu, gpu, _, rng = _cpu_and_cuda(quant, metric=metric)
    p = HnswSearchParams(k=10, ef=128)
    counters = (pk.hnsw_descend_launches, pk.beam_steps,
                pk.hnsw_beam_launches)
    for rnd in range(3):
        qs = rng.normal(size=(n_q, 32)).astype(np.float32)
        counts = []
        for ix in (cpu, gpu):
            before = [c.value for c in counters]
            res = ix.select_batch(qs, p)
            counts.append(_deltas(counters, before))
            if ix is cpu:
                want = res
        for a, b in zip(want, res):
            assert_same(a, b)
        assert counts[0][1] == counts[1][1] > 0, counts
        assert counts[0][::2] == (0, 0) and counts[1][::2] == (1, 1), counts

    pack, links, m = gpu._pack(for_search=True), gpu._d_links0, gpu.metric
    q = torch.from_numpy(qs).to(links.device)
    ents = torch.full((n_q,), gpu._entry, dtype=torch.int32,
                      device=links.device)
    kernel = pk.greedy_descend(q, pack, gpu._d_upper, ents, m)
    plain = pk._descend_plain(q, pack, gpu._d_upper, ents, 64, m)
    # fp32 sums in another order than the twin's: a near-tie may split
    assert (kernel == plain).float().mean() >= 0.9
    s, i, _ = pk.beam_search_layer(q, pack, links, plain[:, None], 128, 2,
                                   256, m)
    twin = pk._beam_plain("layer", q, pack, links, (plain[:, None],), 128,
                          2, 256, m)
    # fp32 sums in another order than the twin's: near-ties may swap
    assert_same_topk(twin[0].cpu(), twin[1].cpu(), s.cpu(), i.cpu())


@pytest.mark.cuda
def test_cuda_concurrent_searches_share_the_cache():
    """Sixteen threads search one index at once, with four query shapes,
    so that their descent and K7 launches interleave: every answer equals
    the one the same search gave alone."""
    _need_cuda()
    _, gpu, _, rng = _cpu_and_cuda(n_rows=2000)
    p = HnswSearchParams(k=10, ef=64)
    sets = [rng.normal(size=(n, 32)).astype(np.float32)
            for n in (1, 8, 20, 64) for _ in range(3)]

    def answers(qs):
        return [(r.ids.tolist(), r.ranks.tolist())
                for r in gpu.select_batch(qs, p)]
    want = [answers(qs) for qs in sets]
    wrong = []

    def worker(k):
        try:
            for j in range(6):
                i = (k + j) % len(sets)
                if answers(sets[i]) != want[i]:
                    wrong.append(i)
        except Exception as e:      # reported by the assertion below
            wrong.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong, wrong


@pytest.mark.cuda
def test_cuda_streaming_session_matches_cpu_session():
    """Two streaming sessions a side: the same batches as the CPU's
    sessions; a card session's begin launches the descent kernel once."""
    _need_cuda()
    cpu, gpu, _, rng = _cpu_and_cuda(n_rows=2000)
    assert gpu._max_level > 0
    q = rng.normal(size=32).astype(np.float32)
    for _ in range(2):
        batches = []
        for ix in (cpu, gpu):
            before = pk.hnsw_descend_launches.value
            s = KnnStreamingSession(ix, q, 64)
            assert pk.hnsw_descend_launches.value - before == (ix is gpu)
            batches.append([s.next_batch(64) for _ in range(3)])
        for (ids_a, sc_a), (ids_b, sc_b) in zip(*batches):
            assert ids_a.tolist() == ids_b.tolist()
            np.testing.assert_allclose(sc_a, sc_b, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_one_card_mesh_matches_cpu_mesh():
    """Four HNSW shards of one card against four of the CPU holding the
    same graphs: the same answers, each search one descent launch and one
    K7 launch a shard."""
    _need_cuda()
    from reindexer_tpu_torch.parallel.context import MeshContext
    rng = np.random.default_rng(21)
    base = rng.normal(size=(1600, 24)).astype(np.float32)
    idx = {}
    for dev in ("cuda", "cpu"):
        db = port.Reindexer(mesh=MeshContext([dev] * 4), device=dev)
        db.open_namespace("mh", [
            IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
            hnsw_def(port, 24, "INNER_PRODUCT", m=8, efc=64)])
        for i in range(0 if dev == "cuda" else len(base), len(base)):
            db.upsert("mh", {"id": i, "vec": base[i].tolist()})
        idx[dev] = db.get_namespace("mh").get_index("vec")
    idx["cuda"].commit()
    idx["cpu"].load_state_dict(idx["cuda"].state_dict())
    qs = rng.normal(size=(8, 24)).astype(np.float32)
    p = HnswSearchParams(k=10, ef=64)
    counters = (pk.hnsw_descend_launches, pk.hnsw_beam_launches)
    for _ in range(2):
        before = [c.value for c in counters]
        got = idx["cuda"].select_batch(qs, p)
        assert _deltas(counters, before) == (4, 4)
        for a, b in zip(idx["cpu"].select_batch(qs, p), got):
            assert_same(a, b)


def _int_graph(rng, n_rows, dims, m0, quant, dev):
    """Rows of small integer coordinates (SQ8: integer codes, offsets and
    scales), so that every fp32 sum is exact in any order; links with -1
    slots, and rows with none (deleted rows, rows outside the layer).
    Returns (pack, links) on dev."""
    links = rng.integers(-1, n_rows, size=(n_rows, m0)).astype(np.int32)
    links[rng.random(n_rows) < 0.05] = -1
    if quant:
        codes = rng.integers(0, 8, size=(n_rows, dims)).astype(np.uint8)
        lo = rng.integers(-2, 3, size=dims).astype(np.float32)
        alpha = rng.integers(1, 3, size=dims).astype(np.float32)
        deq = lo + alpha * codes.astype(np.float32)
        arrs = (codes, (deq * deq).sum(axis=1), lo, alpha)
    else:
        data = rng.integers(-3, 4, size=(n_rows, dims)).astype(np.float32)
        arrs = (data, (data * data).sum(axis=1))
    return (pk.DataPack(*(t(a).to(dev) for a in arrs)),
            t(links).to(dev))


def _k7_case(kind, quant, metric, n_q, ef, dims=16, n_rows=600, m0=16,
             seed=0):
    """(queries, pack, links, inputs, metric) of one K7 case on the card:
    integer queries, every third row zero (a padded batch), three entries
    a query, some -1; "resume" continues a layer search stopped after three
    plain steps (W and C sorted, some bits visited)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    pack, links = _int_graph(rng, n_rows, dims, m0, quant, dev)
    q = rng.integers(-3, 4, size=(n_q, dims)).astype(np.float32)
    q[::3] = 0
    q = t(q).to(dev)
    ent = rng.integers(-1, n_rows, size=(n_q, 3)).astype(np.int32)
    ent[:, 0] = np.abs(ent[:, 0])
    inputs = (t(ent).to(dev),)
    m = VectorMetric[metric]
    if kind == "resume":
        inputs = pk._beam_plain("layer", q, pack, links, inputs, ef, 2, 3,
                                m)[:5]
    return q, pack, links, inputs, m


def _k7_against_twin(kind, q, pack, links, inputs, ef, m):
    before = pk.hnsw_beam_launches.value
    got = pk.hnsw_beam(kind, q, pack, links, inputs, ef, 2, 2 * ef, m)
    assert pk.hnsw_beam_launches.value == before + 1
    state = pk._beam_plain(kind, q, pack, links, inputs, ef, 2, 2 * ef, m)
    torch.cuda.synchronize()
    for name, a, b in zip(("w_s", "w_ids", "c_s", "c_ids", "visited", "it"),
                          got, state):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), (name, int(got[5]), int(state[5]))
    assert int(got[5]) > 0


def _past_resident_blocks() -> int:
    """More queries than K7's grid can hold blocks at once (an SM holds at
    most 32 resident blocks), so that every block walks several."""
    props = torch.cuda.get_device_properties(0)
    return 32 * props.multi_processor_count + 37


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [16, 128, 512])
@pytest.mark.parametrize("n_q", [1, 8, 64, 200, "past_grid"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "sq8"])
@pytest.mark.parametrize("kind", ["layer", "resume"])
def test_cuda_k7_matches_its_twin(kind, quant, metric, n_q, ef):
    """K7 against the plain loop it replaces, both on the card: W, C, the
    visited words and `it` bit for bit (ties in the stable sort's order).
    13 dimensions take the scalar loads, 16 the vector ones; "past_grid"
    is more queries than the blocks that can be resident at once, so that
    each block walks several queries."""
    _need_cuda()
    dims = 16 if n_q in (1, 64) else 13
    if n_q == "past_grid":
        n_q = _past_resident_blocks()
    q, pack, links, inputs, m = _k7_case(kind, quant, metric, n_q, ef,
                                         dims=dims, seed=n_q + ef)
    _k7_against_twin(kind, q, pack, links, inputs, ef, m)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wide_ef", "wide_ef_sq8_resume",
                                  "wide_dims"])
def test_cuda_k7_spills_past_shared_memory(case):
    """Where a block's arrays outgrow its shared memory (an ef of 16,384 at
    16 dimensions, or 60,000 dimensions at ef 16), K7 takes a global
    scratch in their place and still matches its twin bit for bit; at ef
    8,192 and 16 dimensions it needs none."""
    _need_cuda()
    from reindexer_tpu_torch.ops import _build
    lib = _build.load("hnsw_beam")
    assert lib.hnsw_beam_spill_bytes(8, 16, 32, 8192, 0) == 0
    kind = "resume" if case.endswith("resume") else "layer"
    quant = "sq8" in case
    dims, ef = (60_000, 16) if case == "wide_dims" else (16, 16384)
    assert lib.hnsw_beam_spill_bytes(8, dims, 32, ef, int(quant)) > 0
    q, pack, links, inputs, m = _k7_case(kind, quant, "L2", 8, ef,
                                         dims=dims, seed=ef)
    _k7_against_twin(kind, q, pack, links, inputs, ef, m)


def _descend_case(quant, n_q, dims, seed):
    """(queries, pack, stack, entries) of one descent case on the card:
    rows of small integers, so that every fp32 sum is exact and many
    scores tie; four upper layers of 8 links, the top one all -1 (a padded
    table), -1 slots, rows without links; every third query from the
    second zero; valid entries."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    pack, _ = _int_graph(rng, 600, dims, 16, quant, dev)
    stack = rng.integers(-1, 600, size=(4, 600, 8)).astype(np.int32)
    stack[0] = -1
    stack[:, rng.random(600) < 0.05] = -1
    q = rng.integers(-3, 4, size=(n_q, dims)).astype(np.float32)
    q[1::3] = 0
    ents = rng.integers(0, 600, size=n_q).astype(np.int32)
    return t(q).to(dev), pack, t(stack).to(dev), t(ents).to(dev)


def _descend_against_twin(q, pack, stack, ents, m, max_hops):
    """The kernel (one launch) against the plain twin on the CPU, bit for
    bit; returns the entries."""
    before = pk.hnsw_descend_launches.value
    got = pk.greedy_descend(q, pack, stack, ents, m, max_hops=max_hops)
    assert pk.hnsw_descend_launches.value == before + 1
    cpu = pk.DataPack(*(None if x is None else x.cpu() for x in (
        pack.data, pack.data_sq, pack.lo, pack.alpha)))
    want = pk.greedy_descend(q.cpu(), cpu, stack.cpu(), ents.cpu(), m,
                             max_hops=max_hops)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got.cpu(), want), (got.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("max_hops", [1, 64])
@pytest.mark.parametrize("n_q", [1, 8, 64, 200])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "sq8"])
def test_cuda_descend_matches_its_twin(quant, metric, n_q, max_hops):
    """The descent kernel against its plain twin (the JAX loop written
    out, on the CPU): the same entries bit for bit, ties to the lowest
    link slot, nobody moving on the all -1 top layer. 13 dimensions take
    the scalar loads, 16 the vector ones."""
    _need_cuda()
    dims = 16 if n_q in (1, 64) else 13
    q, pack, stack, ents = _descend_case(quant, n_q, dims, n_q + max_hops)
    got = _descend_against_twin(q, pack, stack, ents, VectorMetric[metric],
                                max_hops)
    if max_hops == 64:
        assert (got != ents.cpu()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "sq8"])
def test_cuda_descend_spills_past_shared_memory(quant):
    """At 60,000 dimensions a block's query outgrows shared memory: the
    kernel takes a global scratch and still matches its twin bit for bit;
    at 96 it takes none."""
    _need_cuda()
    from reindexer_tpu_torch.ops import _build
    lib = _build.load("hnsw_beam")
    assert lib.hnsw_descend_spill_bytes(8, 96, 8) == 0
    assert lib.hnsw_descend_spill_bytes(8, 60_000, 8) > 0
    q, pack, stack, ents = _descend_case(quant, 8, 60_000, 7)
    _descend_against_twin(q, pack, stack, ents, VectorMetric.L2, 64)


@pytest.mark.cuda
def test_cuda_search_past_shared_memory_matches_cpu_engine():
    """A select at an ef whose beam spills past shared memory (10,000,
    padded to 16,384) runs on the card and answers as the CPU engine."""
    _need_cuda()
    cpu, gpu, _, rng = _cpu_and_cuda(n_rows=2000)
    qs = rng.normal(size=(3, 32)).astype(np.float32)
    p = HnswSearchParams(k=10, ef=10_000)
    before = pk.hnsw_beam_launches.value
    got = gpu.select_batch(qs, p)
    assert pk.hnsw_beam_launches.value == before + 1
    for a, b in zip(cpu.select_batch(qs, p), got):
        assert_same(a, b)


@pytest.mark.cuda
def test_cuda_search_launches_k7_once(monkeypatch):
    """A search on the card launches K7 once and the descent kernel once,
    and the descent is greedy_descend's (the engine's only way down)."""
    _need_cuda()
    _, gpu, _, rng = _cpu_and_cuda(n_rows=2000)
    assert gpu._max_level > 0
    p = HnswSearchParams(k=10, ef=64)
    counters = (pk.hnsw_beam_launches, pk.hnsw_descend_launches)
    descents = []

    def descend(*args, **kw):
        descents.append(1)
        return pk.greedy_descend(*args, **kw)
    monkeypatch.setattr(port_hnsw, "greedy_descend", descend)
    for rnd in range(2):
        before = [c.value for c in counters]
        gpu.select_batch(rng.normal(size=(8, 32)).astype(np.float32), p)
        assert _deltas(counters, before) == (1, 1)
        assert len(descents) == rnd + 1


def test_k7_counter_registered_and_nothing_built_at_import():
    """`kernels.hnsw_beam` is a registered counter, and importing the ops
    module builds and loads no kernel (a fresh interpreter: the CPU tests
    import every module on a machine without nvcc)."""
    import subprocess
    code = ("from reindexer_tpu_torch import tracing\n"
            "from reindexer_tpu_torch.ops import _build, hnsw_kernels\n"
            "assert 'kernels.hnsw_beam' in tracing.counters()\n"
            "assert hnsw_kernels.hnsw_beam_launches.value == 0\n"
            "assert not _build._libs and not _build.build_info\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(__import__("pathlib").Path(__file__).parents[1]))
