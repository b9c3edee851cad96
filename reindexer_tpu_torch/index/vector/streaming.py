"""Streaming KNN (port of reindexer_tpu/index/vector/streaming.py): batched
candidate streaming for post-filtered queries.

Semantic equivalent of the reference streaming stack
(cpp_src/core/nsselecter/knn_streaming_estimator.h:21-53: ef and batch
estimation, amplification = itemsCount / maxIterations clamped to [100,
800]; hnswalg.h BeginStreamingSearch / ContinueStreamingSearch :1865,
:1945). It serves HNSW KNN queries with neither k nor radius
(nsselecter.cc:483-490); batches stream until offset + limit rows pass the
other filters.

The session keeps the beam state on the device between batches (frontier,
visited bitset, the scored-but-unreturned seed), so each `next_batch`
resumes the traversal where the last one stopped
(ops/hnsw_kernels.beam_search_resume); batches are disjoint by
construction. The session holds the link table and vectors it started on:
the index replaces its device mirrors and the keeper its tensors on a
commit instead of updating them in place. The query pads to 8 rows, as in
the reference: the zero rows take part in the beam's batch-wide stop. A
mesh-sharded index streams through one session a shard, merged on the host
(MeshKnnStreamingSession).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.hnsw_kernels import (NEG_INF, beam_begin_stream,
                                 beam_search_resume, beam_steps,
                                 exact_rescore, greedy_descend)
from .hnsw import _pow2

MIN_EF_BATCH = 100   # reference kMinEfBatch
MAX_EF_BATCH = 800   # reference kMaxEfBatch
_Q_ROWS = 8          # the query's row bucket


def _clamp(v: float) -> int:
    return int(min(max(v, MIN_EF_BATCH), MAX_EF_BATCH))


class StreamingKnnEstimator:
    """Mirror of the reference StreamingKnnEstimator."""

    @staticmethod
    def estimate_ef(max_iterations: int, items_count: int, offset: int,
                    limit: int) -> int:
        if items_count == 0:
            return MIN_EF_BATCH
        restricted = max(1, min(max_iterations, items_count))
        needed = offset + limit
        return _clamp(needed * items_count / restricted)

    @staticmethod
    def estimate_batch_size(accepted: int, presented: int, needed: int) -> int:
        remaining = 1 if accepted >= needed else needed - accepted
        amplification = presented / max(1, accepted)
        return _clamp(amplification * remaining)


class KnnStreamingSession:
    """Streams successive next-nearest batches from an HNSW index
    (reference: KnnStreamingSession facade, float_vector_index.h:95-99;
    Begin/ContinueStreamingSearch, hnswalg.h:1865,1945)."""

    def __init__(self, index, query: np.ndarray, initial_ef: int):
        index._commit()
        index._sync_device()
        self.index = index
        self.metric = index.metric
        self.ef = max(initial_ef, MIN_EF_BATCH)
        self._exhausted = False
        self._returned = 0
        self.iters_total = 0      # beam iterations (tests, stats)

        self._pack = index._pack(for_search=True)
        self._links = index._d_links0
        self._deleted = index._deleted.copy()

        q = index.keeper.prepare_query(np.asarray(query, dtype=np.float32))
        qp = np.zeros((_Q_ROWS, index.dims), dtype=np.float32)
        qp[0] = q
        self._q = index._upload(qp)

        if index._entry < 0:
            self._exhausted = True
            self._seed = None
            return
        dev = index.keeper.device
        ents = torch.full((_Q_ROWS,), index._entry, dtype=torch.int32,
                          device=dev)
        if index._max_level > 0 and index._d_upper is not None:
            ents = greedy_descend(self._q, self._pack, index._d_upper, ents,
                                  self.metric)
        seed_s, seed_i, self._c_s, self._c_ids, self._visited = \
            beam_begin_stream(self._q, self._pack, ents[:, None],
                              n_rows=self._links.shape[0],
                              fcap=_pow2(self.ef, 16), metric=self.metric)
        self._seed = (seed_s, seed_i)

    @property
    def exhausted(self) -> bool:
        return self._exhausted

    def next_batch(self, batch_size: Optional[int] = None,
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (ids, scores higher-better) of the next ranked batch: one
        beam continuation per call, disjoint from every earlier batch by the
        visited bitset."""
        if self._exhausted:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float32))
        ef_b = _pow2(_clamp(batch_size) if batch_size is not None
                     else self.ef, 16)
        if self._seed is None:
            dev = self._q.device
            seed_s = torch.full((_Q_ROWS, 1), NEG_INF, dtype=torch.float32,
                                device=dev)
            seed_i = torch.full((_Q_ROWS, 1), -1, dtype=torch.int32,
                                device=dev)
        else:
            seed_s, seed_i = self._seed
            self._seed = None
        w_s, w_ids, self._c_s, self._c_ids, self._visited, iters = \
            beam_search_resume(self._q, self._pack, self._links,
                               seed_s, seed_i, self._c_s, self._c_ids,
                               self._visited, ef=ef_b, expand=2,
                               max_iters=2 * ef_b, metric=self.metric)
        if self._pack.quantized:
            # exact fp32 re-rank within the batch (HnswIndex._search_batch
            # does the same for one-shot searches)
            w_s, w_ids = exact_rescore(self._q, self.index.keeper.data,
                                       self.index.keeper.sq, w_ids, w_s,
                                       self.metric)
        # scores, ids, iters and the frontier's head in one copy
        host = torch.cat([w_s[0].contiguous().view(torch.int32),
                          w_ids[0].to(torch.int32), iters.reshape(1),
                          self._c_s[0, :1].contiguous().view(torch.int32)]
                         ).cpu().numpy()
        width = w_s.shape[1]
        scores = host[:width].view(np.float32)
        ids = host[width: 2 * width]
        self.iters_total += int(host[2 * width])
        beam_steps.add(int(host[2 * width]))
        frontier_dead = bool(host[2 * width + 1:].view(np.float32)[0]
                             == -np.inf)
        keep = ids >= 0
        scores, ids = scores[keep], ids[keep]
        if len(ids):
            keep = ~self._deleted[ids]
            scores, ids = scores[keep], ids[keep]
        self._returned += len(ids)
        if (len(ids) == 0 or frontier_dead
                or self._returned >= self.index.keeper.count):
            self._exhausted = True
        return ids.astype(np.int64), scores.astype(np.float32)


class MeshKnnStreamingSession:
    """Streaming KNN over a mesh-sharded HNSW index: one KnnStreamingSession
    a subgraph (hnsw.attach_mesh round-robins rows: shard s owns namespace
    rows {r : r % S == s} as local rows r // S), merged on the host by
    score. Batches stay disjoint (per-shard visited bitsets, disjoint id
    spaces) and approximately rank-ordered, the single-device contract."""

    def __init__(self, index, query: np.ndarray, initial_ef: int):
        S = len(index._mesh_shards)
        self._S = S
        self._default = max(initial_ef, MIN_EF_BATCH)
        self._sessions: list[tuple[int, KnnStreamingSession]] = []
        for s, sub in enumerate(index._mesh_shards):
            if sub.keeper.count == 0:
                continue
            self._sessions.append(
                (s, KnnStreamingSession(sub, query, self._default)))
        self._buf_ids: list[int] = []
        self._buf_scores: list[float] = []
        self.iters_total = 0

    @property
    def exhausted(self) -> bool:
        return (not self._buf_ids
                and all(sess.exhausted for _, sess in self._sessions))

    def next_batch(self, batch_size: Optional[int] = None,
                   ) -> tuple[np.ndarray, np.ndarray]:
        need = _clamp(batch_size) if batch_size is not None else self._default
        # refill: one batch from every live shard while the buffer is short
        # (buffered leftovers keep later batches disjoint)
        if len(self._buf_ids) < need:
            for s, sess in self._sessions:
                if sess.exhausted:
                    continue
                ids, scores = sess.next_batch(batch_size)
                self.iters_total += sess.iters_total
                sess.iters_total = 0
                # local row -> namespace row (hnsw._mesh_route inverse)
                self._buf_ids.extend(int(i) * self._S + s for i in ids)
                self._buf_scores.extend(float(x) for x in scores)
        if not self._buf_ids:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float32))
        order = np.argsort(-np.asarray(self._buf_scores))
        take, rest = order[:need], order[need:]
        ids = np.asarray(self._buf_ids, dtype=np.int64)[take]
        scores = np.asarray(self._buf_scores, dtype=np.float32)[take]
        self._buf_ids = [self._buf_ids[j] for j in rest]
        self._buf_scores = [self._buf_scores[j] for j in rest]
        return ids, scores


def open_streaming_session(index, query: np.ndarray, initial_ef: int):
    """A streaming session over `index`: mesh-sharded indexes stream
    through per-shard sessions."""
    if getattr(index, "_mesh_shards", None):
        return MeshKnnStreamingSession(index, query, initial_ef)
    return KnnStreamingSession(index, query, initial_ef)
