"""One process of a process-spanning mesh (the port's twin of the JAX
package's tools/multihost_worker.py).

Every process holds 4 CPU shards; torch.distributed (gloo, tcp://
127.0.0.1:<port>) joins them into one 4 x num_processes-shard mesh. Each
process holds the identical host data and runs the same program: the
sharded KNN builder, a sharded BM25 query and the psum leg of the
reference's worker, then the `Reindexer(mesh=...)` facade, a plain and a
filtered KNN select. Every result is checked against a numpy oracle (the
BM25 query against the one-process merge); the worker prints MULTIHOST_OK
and exits 0 when all hold.

Usage: python -m reindexer_tpu_torch.tools.multihost_worker <process_id>
<num_processes> <coordinator_port>
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                 IndexType, Query, Reindexer, VectorMetric)
from reindexer_tpu_torch.index.vector.params import BruteForceSearchParams
from reindexer_tpu_torch.parallel.context import MeshContext
from reindexer_tpu_torch.parallel.mesh import (global_put, init_distributed,
                                               make_mesh)
from reindexer_tpu_torch.parallel.sharded_knn import build_sharded_knn

LOCAL_SHARDS = 4


def knn_leg(mesh, rng, n: int, d: int, n_q: int, k: int):
    base = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[5] = False
    sq = (base * base).sum(1).astype(np.float32)
    q = rng.normal(size=(n_q, d)).astype(np.float32)
    fn = build_sharded_knn(mesh, k, VectorMetric.L2)
    _, ids = fn(torch.from_numpy(q), global_put(mesh, base, "shards"),
                global_put(mesh, valid, "shards"),
                global_put(mesh, sq, "shards"))
    dm = ((q[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    dm[:, ~valid] = np.inf
    want = np.argsort(dm, axis=1)[:, :k]
    for b in range(n_q):
        assert set(ids[b].tolist()) == set(want[b].tolist()), (b, ids[b])
    return base, q


def psum_leg(mesh, rng, n: int):
    """The reference worker's leg: per-shard partial tf sums, summed over
    every shard of every process."""
    tf = rng.poisson(1.0, size=(n,)).astype(np.float32)
    parts = [p for p in global_put(mesh, tf, "shards") if p is not None]
    got = torch.stack([(p / (p + 1.2)).sum() for p in parts]).sum()
    dist.all_reduce(got)
    want = float((tf / (tf + 1.2)).sum())
    assert abs(float(got) - want) < 1e-2 * max(1.0, abs(want)), (got, want)


def bm25_leg(mesh, rng):
    """One 2-term query scored doc-sharded over the process-spanning mesh
    equals the one-process merge."""
    from reindexer_tpu_torch.ft.config import FtFastConfig
    from reindexer_tpu_torch.ft.dataholder import FtDataHolder
    from reindexer_tpu_torch.ft.scorer import idf_host, score_and_merge
    from reindexer_tpu_torch.parallel.sharded_ft import (build_sharded_bm25,
                                                         shard_postings)
    n_docs, n_shards = 128, mesh.shape["shards"]
    cap_per, merge_k = n_docs // n_shards, 24
    vocab = [f"w{i}" for i in range(40)]
    docs = [(i, [" ".join(rng.choice(vocab, size=12))])
            for i in range(n_docs)]
    cfg = FtFastConfig()
    holder = FtDataHolder(cfg, ["text"], torch.device("cpu"))
    holder.build(docs, n_docs)
    gather = [[], [], [], []]
    for t, w in enumerate(("w1", "w2")):
        wid = holder.word_id(w)
        s, e = holder.posting_range(wid)
        idf = idf_host(holder.total_docs,
                       holder.word_ndocs[np.asarray([wid])], "rx")[0]
        for a, v in zip(gather, (np.arange(s, e), np.full(e - s, t),
                                 np.ones(e - s), np.full(e - s, idf))):
            a.append(v)
    g_idx, g_term, g_w, g_idf = (np.concatenate(a) for a in gather)
    gpad = 1
    while gpad < len(g_idx):
        gpad *= 2
    fb = np.zeros(8, np.float32)
    fb[0] = 1.0
    fp = [torch.from_numpy(a) for a in (
        fb, np.ones(8, np.float32), np.full(8, 0.1, np.float32),
        np.ones(8, np.float32), np.full(8, 0.1, np.float32))]
    term = [torch.ones(2), torch.ones(2), torch.zeros(2, dtype=torch.bool),
            torch.zeros(2, dtype=torch.bool)]
    dev = holder.device_arrays()

    def padded(a, dtype):
        out = np.zeros(gpad, dtype)
        out[: len(a)] = a
        return torch.from_numpy(out)

    s1, i1 = score_and_merge(
        padded(g_idx, np.int32), padded(g_term, np.int32),
        padded(g_w, np.float32), padded(g_idf, np.float32),
        dev["post_doc"], dev["post_field"], dev["post_tf"],
        dev["post_minpos"], dev["doc_words"], *fp, *term, cfg.bm25.k1,
        cfg.bm25.b, holder.avg_doc_len, 2, dev["cap"], merge_k, "rx")
    packed, dw, remap_shard, remap_local, _, fw = shard_postings(
        holder, n_shards, cap_per)
    sg = [np.zeros((n_shards, gpad), dt)
          for dt in (np.int32, np.int32, np.float32, np.float32)]
    fill = np.zeros(n_shards, np.int64)
    for j, g in enumerate(g_idx):
        s = remap_shard[g]
        for a, v in zip(sg, (remap_local[g], g_term[j], g_w[j], g_idf[j])):
            a[s, fill[s]] = v
        fill[s] += 1
    fn = build_sharded_bm25(mesh, 2, cap_per, merge_k, "rx")
    put = lambda a: global_put(mesh, a, "shards")   # noqa: E731
    s2, i2 = fn(*(put(a) for a in sg), put(packed["post_doc"]),
                put(packed["post_field"]), put(packed["post_tf"]),
                put(packed["post_minpos"]), put(dw), put(fw), *fp, *term,
                np.asarray([cfg.bm25.k1, cfg.bm25.b, holder.avg_doc_len],
                           np.float32))
    v1, v2 = i1 >= 0, i2 >= 0
    assert int(v1.sum()) == int(v2.sum()) > 0
    assert i2[v2].tolist() == i1[v1].tolist()
    np.testing.assert_allclose(s2[v2].numpy(), s1[v1].numpy(), rtol=1e-5)


def engine_leg(mesh, base, q, k: int):
    """The Reindexer(mesh=...) facade over the process-spanning mesh."""
    n, d = base.shape
    db = Reindexer(mesh=MeshContext(mesh), device="cpu")
    db.open_namespace("items", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("grp", "hash", "int"),
        IndexDef("vec", IndexType.VEC_BF, vector_opts=FloatVectorOpts(
            dims=d, metric=VectorMetric.L2))])
    tx = db.new_transaction("items")
    for i in range(n):
        tx.upsert({"id": i, "grp": i % 3, "vec": base[i].tolist()})
    tx.commit()
    res = db.select(Query("items").where_knn(
        "vec", q[0], BruteForceSearchParams(k=k)))
    want = np.argsort(((q[0][None, :] - base) ** 2).sum(-1))[:k].tolist()
    assert [doc["id"] for doc in res.docs()] == want
    # filtered KNN: the KNN entry's top-k AND the scalar filter
    res = db.select(Query("items").where("grp", "=", 1).where_knn(
        "vec", q[1], BruteForceSearchParams(k=k)))
    dm = ((q[1][None, :] - base) ** 2).sum(-1)
    want = [i for i in np.argsort(dm)[:k].tolist() if i % 3 == 1]
    assert sorted(doc["id"] for doc in res.docs()) == sorted(want)


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", nproc, pid)
    mesh = make_mesh(devices=["cpu"] * LOCAL_SHARDS)   # spans every process
    assert mesh.shape["shards"] == LOCAL_SHARDS * nproc
    rng = np.random.default_rng(7)      # identical data in every process
    k = 10
    base, q = knn_leg(mesh, rng, 1024, 32, 4, k)
    psum_leg(mesh, rng, 1024)
    bm25_leg(mesh, rng)
    engine_leg(mesh, base, q, k)
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST_OK pid={pid} shards={mesh.shape['shards']}",
          flush=True)


if __name__ == "__main__":
    main()
