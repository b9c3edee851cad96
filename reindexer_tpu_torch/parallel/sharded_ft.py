"""Distributed BM25: doc-sharded posting partitions + one top-k merge (port
of reindexer_tpu/parallel/sharded_ft.py).

Each shard holds the CSR postings of its document partition on its device,
scores its local docs with the one-device BM25 core (ft/scorer.py
sum_ranks, proximity and full-match boosts included), takes a local top-k,
and the per-shard candidates merge once (MeshContext.merge): O(k * S)
values move, not the doc rows.

IDF comes from the *global* document frequencies on the host before the
fan-out, so sharded scores equal the one-device scores. Proximity and
full-match boosts are per-doc quantities (a doc's postings all live in its
shard), so they shard without approximation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ft.scorer import NEG_INF, _top_k, sum_ranks


def shard_bm25_topk(gather_idx, g_term, g_weight, g_idf, post_doc, post_field,
                    post_tf, post_minpos, doc_words, field_words, fp: tuple,
                    term_arrays: tuple, scalars: tuple, t_count: int,
                    cap_per_shard: int, merge_k: int, bm25_type: str,
                    lo: int, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's top-min(merge_k, cap_per_shard) (scores f32[1, kk],
    GLOBAL doc ids [1, kk]), on the shard's device: its postings carry
    LOCAL doc ids, lo is the shard's first doc. fp = (field_boost,
    bm25_boost, bm25_weight, pos_boost, pos_weight), term_arrays =
    (term_boost, term_lenboost, must, not), scalars = (k1, b, avg_len)."""
    dev = post_doc.device
    fp = tuple(a.to(dev) for a in fp)
    term_arrays = tuple(a.to(dev) for a in term_arrays)
    sum_rank, ok = sum_ranks(
        gather_idx, g_term, g_weight, g_idf, post_doc, post_field, post_tf,
        post_minpos, doc_words, *fp, *term_arrays, *scalars, t_count,
        cap_per_shard, bm25_type, field_words=field_words, **kw)
    sum_rank = torch.where(ok, sum_rank, torch.full_like(sum_rank, NEG_INF))
    s, i = _top_k(sum_rank[None, :], min(merge_k, cap_per_shard))
    return s, torch.where(s > NEG_INF, i + lo, -1)


def build_sharded_bm25(mesh, t_count: int, cap_per_shard: int,
                       merge_k: int, bm25_type: str = "rx",
                       shard_axis: str = "shards", *,
                       dist_w: float = 0.0, dist_b: float = 1.0,
                       use_proximity: bool = False, n_terms: int = 0,
                       fm_boost: float = 1.0, use_fullmatch: bool = False):
    """fn(gather_idx, g_term, g_weight, g_idf, post_doc, post_field,
    post_tf, post_minpos, doc_words, field_words, field_boost, bb, bw, pb,
    pw, term_boost, term_lenboost, must_mask, not_mask, scalars) ->
    (scores f32[merge_k], GLOBAL doc ids i32[merge_k]). The first ten are
    per-shard lists (parallel.mesh shard_rows of the [S, ...] arrays that
    shard_postings and the per-shard gathers build, one row a shard); the
    rest are replicated tensors, scalars = [k1, b, avg_len]."""
    from .context import MeshContext
    ctx = mesh if isinstance(mesh, MeshContext) else \
        MeshContext(mesh, shard_axis)
    kw = dict(dist_w=dist_w, dist_b=dist_b, use_proximity=use_proximity,
              n_terms=n_terms, fm_boost=fm_boost,
              use_fullmatch=use_fullmatch)

    def fn(gather_idx, g_term, g_weight, g_idf, post_doc, post_field,
           post_tf, post_minpos, doc_words, field_words,
           field_boost, bb, bw, pb, pw, term_boost, term_lenboost,
           must_mask, not_mask, scalars):
        sc = tuple(float(x) for x in np.asarray(
            scalars.cpu() if isinstance(scalars, torch.Tensor)
            else scalars))
        parts = []
        for s in ctx.local_shards:
            row = [a[s].reshape(a[s].shape[1:]) for a in (
                gather_idx, g_term, g_weight, g_idf, post_doc, post_field,
                post_tf, post_minpos, doc_words, field_words)]
            parts.append(shard_bm25_topk(
                *row, (field_boost, bb, bw, pb, pw),
                (term_boost, term_lenboost, must_mask, not_mask), sc,
                t_count, cap_per_shard, merge_k, bm25_type,
                s * cap_per_shard, **kw))
        s, i = ctx.merge(parts, merge_k)
        return s[0], i[0]

    return fn


def shard_postings(holder, n_shards: int, cap_per_shard: int):
    """Host-side partitioning of one FtDataHolder's postings by doc shard
    (doc row -> shard row // cap_per_shard). Returns per-shard padded arrays
    + per-shard posting index remap (global posting idx -> (shard, local))."""
    s_of = holder.post_doc // cap_per_shard
    local_doc = holder.post_doc % cap_per_shard
    parts = []
    max_p = 1
    for s in range(n_shards):
        m = np.flatnonzero(s_of == s)
        parts.append(m)
        max_p = max(max_p, len(m))
    pad = 1
    while pad < max_p:
        pad *= 2

    def pack(src, fill=0):
        out = np.full((n_shards, pad), fill, dtype=src.dtype)
        for s, m in enumerate(parts):
            out[s, : len(m)] = src[m]
        return out

    post_doc = np.full((n_shards, pad), 0, dtype=np.int32)
    for s, m in enumerate(parts):
        post_doc[s, : len(m)] = local_doc[m]
    packed = {
        "post_doc": post_doc,
        "post_field": pack(holder.post_field),
        "post_tf": pack(holder.post_tf),
        "post_minpos": pack(holder.post_minpos),
    }
    # global posting idx -> (shard, local idx)
    remap_shard = np.empty(holder.num_postings, dtype=np.int32)
    remap_local = np.empty(holder.num_postings, dtype=np.int32)
    for s, m in enumerate(parts):
        remap_shard[m] = s
        remap_local[m] = np.arange(len(m), dtype=np.int32)
    dw = np.zeros((n_shards, cap_per_shard), dtype=np.float32)
    n = len(holder.doc_words)
    for s in range(n_shards):
        lo, hi = s * cap_per_shard, min((s + 1) * cap_per_shard, n)
        if hi > lo:
            dw[s, : hi - lo] = holder.doc_words[lo:hi]
    # per-field doc lengths, doc-sharded (fullmatch boost input)
    F = holder.field_words.shape[0]
    fw = np.zeros((n_shards, F, cap_per_shard),
                  dtype=holder.field_words.dtype)
    nfw = holder.field_words.shape[1]
    for s in range(n_shards):
        lo, hi = s * cap_per_shard, min((s + 1) * cap_per_shard, nfw)
        if hi > lo:
            fw[s, :, : hi - lo] = holder.field_words[:, lo:hi]
    return packed, dw, remap_shard, remap_local, pad, fw
