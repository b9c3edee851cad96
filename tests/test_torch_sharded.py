"""The port's sharded builders vs the reference's, over 8 (or 4) shards:
twins of tests/test_sharded_knn.py, tests/test_sharded_hnsw.py and
tests/test_sharded_ft.py. The reference runs on its virtual CPU devices,
the port on `["cpu"] * S` meshes (the kernels' plain versions).

Tolerance: KNN ids equal the oracle's as sets and the reference's
exactly; HNSW merges equal the reference's ids (the per-shard graphs are
the reference's row for row); BM25 scores within rtol 1e-5 of the
one-device merge, ids in its order.
"""
import numpy as np
import pytest
import torch

import reindexer_tpu as ref
import reindexer_tpu_torch as port
from reindexer_tpu_torch.core.type_consts import VectorMetric
from reindexer_tpu_torch.parallel.mesh import (make_mesh,
                                               pad_rows_to_multiple,
                                               replicate, shard_rows)
from reindexer_tpu_torch.parallel.sharded_knn import build_sharded_knn

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _ref_knn(metric, base, valid, sq, queries, k, n_dev=8, shape=None):
    import jax
    from reindexer_tpu.core.type_consts import VectorMetric as RM
    from reindexer_tpu.parallel import mesh as rmesh
    from reindexer_tpu.parallel.sharded_knn import build_sharded_knn as rb
    if shape is None:
        mesh = rmesh.make_mesh(axis_names=("shards",))
        fn = rb(mesh, k=k, metric=RM(metric.value))
        q = rmesh.replicate(mesh, queries)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = rmesh.make_mesh(axis_names=("shards", "batch"), shape=shape)
        fn = rb(mesh, k=k, metric=RM(metric.value), batch_axis="batch")
        q = jax.device_put(queries, NamedSharding(mesh, P("batch", None)))
    s, i = fn(q, rmesh.shard_rows(mesh, base), rmesh.shard_rows(mesh, valid),
              rmesh.shard_rows(mesh, sq))
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("metric", [VectorMetric.L2,
                                    VectorMetric.INNER_PRODUCT])
def test_sharded_knn_matches_oracle(metric, rng):
    mesh = make_mesh(axis_names=("shards",), devices=CPU8)
    n, d, q_n, k = 1000, 32, 4, 10
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q_n, d)).astype(np.float32)
    base_p = pad_rows_to_multiple(base, 8 * 8)
    valid = np.zeros(base_p.shape[0], dtype=bool)
    valid[:n] = True
    sq = np.sum(base_p * base_p, axis=1).astype(np.float32)

    fn = build_sharded_knn(mesh, k=k, metric=metric)
    scores, ids = fn(replicate(mesh, queries), shard_rows(mesh, base_p),
                     shard_rows(mesh, valid), shard_rows(mesh, sq))
    scores, ids = scores.numpy(), ids.numpy()

    if metric == VectorMetric.L2:
        dmat = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
        oracle = np.argsort(dmat, axis=1)[:, :k]
    else:
        oracle = np.argsort(-(queries @ base.T), axis=1)[:, :k]
    for qi in range(q_n):
        assert set(ids[qi].tolist()) == set(oracle[qi].tolist())
    r_s, r_i = _ref_knn(metric, base_p, valid, sq, queries, k)
    np.testing.assert_array_equal(ids, r_i)
    np.testing.assert_allclose(scores, r_s, rtol=1e-4, atol=1e-3)


def test_sharded_knn_2d_mesh(rng):
    """shards x batch: the queries split into the batch axis's blocks,
    each scanned over the shard axis and merged on its own row."""
    mesh = make_mesh(axis_names=("shards", "batch"), shape=(4, 2),
                     devices=CPU8)
    n, d, k = 512, 16, 5
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(8, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    sq = np.sum(base * base, axis=1).astype(np.float32)
    fn = build_sharded_knn(mesh, k=k, metric=VectorMetric.L2,
                           batch_axis="batch")
    _, ids = fn(torch.from_numpy(queries), shard_rows(mesh, base),
                shard_rows(mesh, valid), shard_rows(mesh, sq))
    ids = ids.numpy()
    dmat = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(dmat, axis=1)[:, :k]
    for qi in range(8):
        assert set(ids[qi].tolist()) == set(oracle[qi].tolist())
    _, r_i = _ref_knn(VectorMetric.L2, base, valid, sq, queries, k,
                      shape=(4, 2))
    np.testing.assert_array_equal(ids, r_i)


@pytest.mark.parametrize("rerank", [False, True], ids=["approx", "rerank"])
def test_sharded_knn_sq8_matches_reference(rerank, rng):
    """The sharded SQ8 builder (each shard's quantized top-k, re-scored
    exactly before the merge with rerank) on the same codes and grid as
    the reference's builder: the same ids, scores within fp32 rounding."""
    import jax.numpy as jnp
    from reindexer_tpu.core.type_consts import VectorMetric as RM
    from reindexer_tpu.parallel import mesh as rmesh
    from reindexer_tpu.parallel.sharded_knn import build_sharded_knn_sq8 as rb
    from reindexer_tpu_torch.parallel.sharded_knn import build_sharded_knn_sq8
    n, d, k = 1024, 16, 10
    base = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(4, d)).astype(np.float32)
    lo = np.quantile(base, 0.001, axis=0).astype(np.float32)
    alpha = ((np.quantile(base, 0.999, axis=0) - lo) / 255.0).astype(
        np.float32)
    codes = np.clip(np.round((base - lo) / alpha), 0, 255).astype(np.uint8)
    valid = np.ones(n, bool)
    valid[::7] = False
    sq = (base * base).sum(1).astype(np.float32)
    mesh = make_mesh(axis_names=("shards",), devices=CPU8)
    fn = build_sharded_knn_sq8(mesh, k, VectorMetric.L2, rerank=rerank)
    sh = lambda a: shard_rows(mesh, a)   # noqa: E731
    s, i = fn(torch.from_numpy(q), sh(codes), torch.from_numpy(lo),
              torch.from_numpy(alpha), sh(base), sh(valid), sh(sq))
    rm = rmesh.make_mesh(axis_names=("shards",))
    rfn = rb(rm, k, RM.L2, rerank=rerank)
    r_s, r_i = rfn(jnp.asarray(q), *(rmesh.shard_rows(rm, a) for a in (
        codes,)), jnp.asarray(lo), jnp.asarray(alpha),
        *(rmesh.shard_rows(rm, a) for a in (base, valid, sq)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(r_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(r_s), rtol=1e-5,
                               atol=1e-3)
    assert not set(i.numpy().ravel().tolist()) & set(range(0, n, 7))


# --- HNSW --------------------------------------------------------------------

def _hnsw_pair(sizes, base, offs, metric):
    """The same per-shard HNSW partitions built in both packages."""
    from reindexer_tpu.index.vector.hnsw import HnswIndex as RH
    from reindexer_tpu_torch.index.vector.hnsw import HnswIndex as PH
    out = {"ref": [], "port": []}
    for s, sz in enumerate(sizes):
        for name, P, cls, extra in (("ref", ref, RH, ()),
                                    ("port", port, PH, ("cpu",))):
            ix = cls(P.IndexDef("v", P.IndexType.HNSW,
                                vector_opts=P.FloatVectorOpts(
                                    dims=base.shape[1],
                                    metric=P.VectorMetric(metric),
                                    m=8, ef_construction=48)), *extra)
            for i in range(sz):
                ix.upsert(i, base[offs[s] + i])
            ix.commit()
            out[name].append(ix)
    # per-shard link tables equal the reference's row for row
    for r, p in zip(out["ref"], out["port"]):
        np.testing.assert_array_equal(p._links0, r._links0)
        assert len(p._upper) == len(r._upper)
        for pu, ru in zip(p._upper, r._upper):
            np.testing.assert_array_equal(pu, ru)
        assert p._entry == r._entry
    return out


def _sharded_hnsw_both(indexes, queries, ef, metric, n_shards):
    import jax.numpy as jnp
    from reindexer_tpu.core.type_consts import VectorMetric as RM
    from reindexer_tpu.parallel.mesh import make_mesh as rmm
    from reindexer_tpu.parallel import sharded_hnsw as rsh
    from reindexer_tpu_torch.parallel import sharded_hnsw as psh
    cap = max(ix.keeper.capacity for ix in indexes["ref"])
    rmesh = rmm(n_shards, axis_names=("shards",))
    rst = rsh.shard_hnsw_state(rmesh, indexes["ref"], cap)
    rfn = rsh.build_sharded_hnsw(rmesh, ef=ef, expand=2,
                                 metric=RM(metric.value), n_upper=rst[5])
    r_s, r_i = rfn(jnp.asarray(queries), *rst[:5])
    pmesh = make_mesh(n_shards, axis_names=("shards",),
                      devices=["cpu"] * n_shards)
    pst = psh.shard_hnsw_state(pmesh, indexes["port"], cap)
    assert pst[5] == rst[5]
    pfn = psh.build_sharded_hnsw(pmesh, ef=ef, expand=2, metric=metric,
                                 n_upper=pst[5])
    p_s, p_i = pfn(torch.from_numpy(queries), *pst[:5])
    return (np.asarray(r_s), np.asarray(r_i), p_s.numpy(), p_i.numpy(),
            cap, pst)


def test_sharded_hnsw_matches_sequential(rng):
    n_shards, per_shard, dims, k, ef = 4, 300, 16, 10, 32
    base = rng.normal(size=(n_shards * per_shard, dims)).astype(np.float32)
    offs = np.arange(n_shards + 1) * per_shard
    indexes = _hnsw_pair([per_shard] * n_shards, base, offs, "l2")
    queries = rng.normal(size=(8, dims)).astype(np.float32)
    r_s, r_i, p_s, p_i, cap, pst = _sharded_hnsw_both(
        indexes, queries, ef, VectorMetric.L2, n_shards)
    np.testing.assert_array_equal(p_i, r_i)
    np.testing.assert_allclose(p_s, r_s, rtol=1e-4, atol=1e-4)
    # sequential oracle: search every shard, merge by score
    for qi in range(len(queries)):
        merged = []
        for s, ix in enumerate(indexes["port"]):
            res = ix.select(queries[qi], port.HnswSearchParams(k=k, ef=ef))
            merged += [(float(r), s * cap + int(i))
                       for i, r in zip(res.ids, res.ranks)]
        merged.sort()
        want = [i for _, i in merged[:k]]
        assert len(set(p_i[qi][:k].tolist()) & set(want)) >= k - 2
        # global ids map back to the right shard rows
        for g in p_i[qi][:k]:
            s, local = divmod(int(g), cap)
            assert 0 <= s < n_shards and local < per_shard
            np.testing.assert_allclose(pst[0][s][local].numpy(),
                                       base[s * per_shard + local],
                                       rtol=1e-6)


def test_sharded_hnsw_ip_uneven_shards(rng):
    """IP + shards of different sizes (the pack pads to a common cap): the
    merge agrees with the reference and never emits a padding row."""
    sizes = [260, 180, 96, 24]
    n_shards, dims, k, ef = len(sizes), 16, 8, 32
    offs = np.cumsum([0] + sizes)
    base = rng.normal(size=(offs[-1], dims)).astype(np.float32)
    indexes = _hnsw_pair(sizes, base, offs, "inner_product")
    queries = rng.normal(size=(6, dims)).astype(np.float32)
    r_s, r_i, p_s, p_i, cap, _ = _sharded_hnsw_both(
        indexes, queries, ef, VectorMetric.INNER_PRODUCT, n_shards)
    np.testing.assert_array_equal(p_i, r_i)
    np.testing.assert_allclose(p_s, r_s, rtol=1e-4, atol=1e-4)
    for qi in range(len(queries)):
        for g in p_i[qi][:k]:
            s, local = divmod(int(g), cap)
            assert local < sizes[s], "id from a shard's padding region"
        valid = p_s[qi][p_i[qi] >= 0]
        assert np.all(np.diff(valid) <= 1e-6)


# --- BM25 --------------------------------------------------------------------

def _bm25_case(rng, n_docs, vocab_n, doc_len, words, weights, n_shards,
               cap_per, merge_k):
    """Score one query with the port's one-device merge and its sharded
    builder, and with the reference's sharded builder."""
    import jax.numpy as jnp
    from reindexer_tpu.ft.config import FtFastConfig as RCfg
    from reindexer_tpu.ft.dataholder import FtDataHolder as RHolder
    from reindexer_tpu.parallel.mesh import make_mesh as rmm
    from reindexer_tpu.parallel import sharded_ft as rsf
    from reindexer_tpu_torch.ft.config import FtFastConfig
    from reindexer_tpu_torch.ft.dataholder import FtDataHolder
    from reindexer_tpu_torch.ft.scorer import idf_host, score_and_merge
    from reindexer_tpu_torch.parallel import sharded_ft as psf
    vocab = [f"w{i}" for i in range(vocab_n)]
    docs = [(i, [" ".join(rng.choice(vocab, size=doc_len))])
            for i in range(n_docs)]
    cfg = FtFastConfig()
    holder = FtDataHolder(cfg, ["text"], torch.device("cpu"))
    holder.build(docs, n_docs)
    rholder = RHolder(RCfg(), ["text"])
    rholder.build(docs, n_docs)
    terms = []
    for t_idx, w in enumerate(words):
        wid = holder.word_id(w)
        assert wid is not None
        s, e = holder.posting_range(wid)
        idf = idf_host(holder.total_docs,
                       holder.word_ndocs[np.asarray([wid])], "rx")[0]
        terms.append((t_idx, np.arange(s, e, dtype=np.int32), idf))
    g_idx = np.concatenate([t[1] for t in terms])
    g_term = np.concatenate([np.full(len(t[1]), t[0], np.int32)
                             for t in terms])
    g_w = np.concatenate([np.full(len(t[1]), weights[t[0]], np.float32)
                          for t in terms])
    g_idf = np.concatenate([np.full(len(t[1]), t[2], np.float32)
                            for t in terms])
    gpad = 1
    while gpad < len(g_idx):
        gpad *= 2

    def padg(a):
        return np.concatenate([a, np.zeros(gpad - len(a), a.dtype)])

    t_count = len(words)
    fb = np.zeros(8, np.float32)
    fb[0] = 1.0
    fp = [fb, np.ones(8, np.float32), np.full(8, 0.1, np.float32),
          np.ones(8, np.float32), np.full(8, 0.1, np.float32)]
    term = [np.ones(t_count, np.float32), np.ones(t_count, np.float32),
            np.zeros(t_count, bool), np.zeros(t_count, bool)]
    T = torch.from_numpy
    dev = holder.device_arrays()
    s1, i1 = score_and_merge(
        *(T(padg(a)) for a in (g_idx, g_term, g_w, g_idf)),
        dev["post_doc"], dev["post_field"], dev["post_tf"],
        dev["post_minpos"], dev["doc_words"], *(T(a) for a in fp),
        *(T(a) for a in term), cfg.bm25.k1, cfg.bm25.b, holder.avg_doc_len,
        t_count, dev["cap"], merge_k, "rx")
    s1, i1 = s1.numpy(), i1.numpy()

    packed, dw, remap_shard, remap_local, _, fw = psf.shard_postings(
        holder, n_shards, cap_per)
    r_out = rsf.shard_postings(rholder, n_shards, cap_per)
    for name in packed:
        np.testing.assert_array_equal(packed[name], r_out[0][name])
    np.testing.assert_array_equal(dw, r_out[1])
    G = gpad
    sg = [np.zeros((n_shards, G), dt) for dt in (np.int32, np.int32,
                                                 np.float32, np.float32)]
    fill = [0] * n_shards
    for j in range(len(g_idx)):
        s = remap_shard[g_idx[j]]
        p = fill[s]
        for a, v in zip(sg, (remap_local[g_idx[j]], g_term[j], g_w[j],
                             g_idf[j])):
            a[s, p] = v
        fill[s] += 1
    scalars = np.asarray([cfg.bm25.k1, cfg.bm25.b, holder.avg_doc_len],
                         np.float32)
    mesh = make_mesh(n_shards, devices=["cpu"] * n_shards)
    fn = psf.build_sharded_bm25(mesh, t_count, cap_per, merge_k, "rx")
    sh = lambda a: shard_rows(mesh, a)   # noqa: E731
    s2, i2 = fn(*(sh(a) for a in sg), sh(packed["post_doc"]),
                sh(packed["post_field"]), sh(packed["post_tf"]),
                sh(packed["post_minpos"]), sh(dw), sh(fw),
                *(T(a) for a in fp), *(T(a) for a in term), scalars)
    rmesh = rmm(n_shards, axis_names=("shards",))
    rfn = rsf.build_sharded_bm25(rmesh, t_count, cap_per, merge_k, "rx")
    J = jnp.asarray
    r_s, r_i = rfn(*(J(a) for a in sg),
                   *(J(r_out[0][k]) for k in ("post_doc", "post_field",
                                              "post_tf", "post_minpos")),
                   J(r_out[1]), J(r_out[5]), *(J(a) for a in fp),
                   *(J(a) for a in term), J(scalars))
    return s1, i1, s2.numpy(), i2.numpy(), np.asarray(r_s), np.asarray(r_i)


def _check_bm25(s1, i1, s2, i2, r_s, r_i):
    v1, v2 = i1 >= 0, i2 >= 0
    assert v1.sum() == v2.sum() and v1.sum() > 0
    np.testing.assert_allclose(s2[v2], s1[v1], rtol=1e-5)
    assert i2[v2].tolist() == i1[v1].tolist()
    np.testing.assert_array_equal(i2, r_i)
    np.testing.assert_allclose(s2[v2], r_s[r_i >= 0], rtol=1e-5)


def test_sharded_bm25_matches_single_chip(rng):
    _check_bm25(*_bm25_case(rng, 64, 40, 12, ["w1", "w2"], [1.0, 1.0],
                            4, 16, 16))


def test_sharded_bm25_three_terms_uneven_fill(rng):
    """3 terms, unequal weights, an underfilled last shard (50 docs over 4
    shards of 16): still equal to the one-device merge."""
    _check_bm25(*_bm25_case(rng, 50, 25, 10, ["w1", "w2", "w3"],
                            [1.0, 0.7, 0.4], 4, 16, 20))
