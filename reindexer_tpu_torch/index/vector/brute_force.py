"""Brute-force vector index, exact fp32 mode (port of
reindexer_tpu/index/vector/brute_force.py).

Every select scans the whole base: K1 `bf_scan` scores it and K2
`bf_select` picks the exact top-k (ops.select.knn_scan_fused), for
k <= 128. Larger k runs the plain chunked scan ops.distance.knn_scan, and so
does a query whose K2 selection overflowed its slot capacity (mass ties).
Both are counted: `geometry_scans` and `overflow_reruns`.

SQ8 quantization and mesh-resident mode are not ported yet (see ROADMAP).
"""
from __future__ import annotations

import numpy as np
import torch

from reindexer_tpu.core.payload import IndexDef
from reindexer_tpu.index.base import SelectKeyResult
from reindexer_tpu.index.vector.params import KnnSearchParams

from ...ops._build import Counter
from ...ops.distance import knn_scan, pairwise_scores, scores_to_ranks
from ...ops.scan import SQ_EFF_BIG
from ...ops.select import S_SLOTS, knn_scan_fused
from .base import FloatVectorIndexBase

geometry_scans = Counter()    # selects with k > 128, run by knn_scan
overflow_reruns = Counter()   # K2 overflows rerun by knn_scan


class BruteForceIndex(FloatVectorIndexBase):
    def __init__(self, definition: IndexDef, device: torch.device):
        if definition.vector_opts.quantization.enabled:
            raise NotImplementedError(
                "SQ8 quantization of vec_bf is not yet ported to "
                "reindexer_tpu_torch, see ROADMAP (SQ8 brute force)")
        super().__init__(definition, device)

    def _scan_plain(self, q: torch.Tensor, k: int):
        sq_eff = self.keeper.sq_eff()
        return knn_scan(q, self.keeper.data, sq_eff < SQ_EFF_BIG / 2, sq_eff,
                        k, self.metric)

    def _dispatch_scan(self, q: torch.Tensor, k: int):
        """(scores, ids, flag) on the device; flag is None when the plain
        scan ran (it cannot overflow)."""
        if k <= S_SLOTS:
            return knn_scan_fused(q, self.keeper.data, self.keeper.sq_eff(),
                                  k, self.metric)
        geometry_scans.add()
        s, i = self._scan_plain(q, k)
        return s, i, None

    def select_batch_async(self, queries: np.ndarray,
                           params: KnnSearchParams):
        """Dispatch one scan for the whole batch and return the drain
        closure. The caller dispatches under the namespace lock and runs
        the drain with it released, so concurrent clients overlap their
        device round trips. The drain copies scores, ids and flag to the
        host in one device-to-host copy, reruns the batch if any query
        overflowed, and builds the per-query results."""
        self.keeper.flush()
        kp = self.keeper
        queries = np.asarray(queries, dtype=np.float32)
        if kp.count == 0 or params.k is None:
            res = super().select_batch(queries, params)
            return lambda: res
        q = np.stack([kp.prepare_query(v) for v in queries])
        k = min(params.k, kp.capacity)
        qd = torch.from_numpy(q).to(kp.device)
        scores, idx, flag = self._dispatch_scan(qd, k)
        parts = [scores.view(torch.int32), idx]
        if flag is not None:
            parts.append(flag.view(torch.int32))
        packed = torch.cat([p.reshape(-1) for p in parts])
        n = len(queries) * k

        def drain() -> list[SelectKeyResult]:
            host = packed.cpu().numpy()
            s = host[:n].view(np.float32).reshape(-1, k)
            i = host[n:2 * n].reshape(-1, k)
            if flag is not None and (host[2 * n:].view(np.float32) > 0).any():
                overflow_reruns.add()
                s_d, i_d = self._scan_plain(qd, k)
                s, i = s_d.cpu().numpy(), i_d.cpu().numpy()
            out = []
            for b in range(len(queries)):
                keep = i[b] >= 0
                ranks = scores_to_ranks(s[b][keep], self.metric)
                ranks, ids = self._apply_radius(ranks, i[b][keep],
                                                params.radius)
                out.append(SelectKeyResult(ids.astype(np.int64),
                                           ranks.astype(np.float32),
                                           self.ordering))
            return out

        return drain

    def select_batch(self, queries: np.ndarray, params: KnnSearchParams,
                     ) -> list[SelectKeyResult]:
        return self.select_batch_async(queries, params)()

    def select_async(self, query: np.ndarray, params: KnnSearchParams):
        """Single-query dispatch/drain split (see select_batch_async)."""
        self.keeper.flush()
        kp = self.keeper
        if kp.count == 0:
            return lambda: SelectKeyResult.empty()
        if params.k is not None:
            drain = self.select_batch_async(
                np.asarray(query, dtype=np.float32)[None, :], params)
            return lambda: drain()[0]

        # radius-only search: full scan, filter on host
        q = torch.from_numpy(kp.prepare_query(query)[None, :]).to(kp.device)
        sq_eff = kp.sq_eff()
        scores_d = pairwise_scores(q, kp.data, sq_eff < SQ_EFF_BIG / 2,
                                   sq_eff, self.metric)

        def drain_radius() -> SelectKeyResult:
            scores = scores_d[0].cpu().numpy()
            idx = np.flatnonzero(scores > -np.inf)
            scores = scores[idx]
            order = np.argsort(-scores, kind="stable")
            scores, idx = scores[order], idx[order]
            ranks = scores_to_ranks(scores, self.metric)
            ranks, idx = self._apply_radius(ranks, idx, params.radius)
            return SelectKeyResult(idx.astype(np.int64),
                                   ranks.astype(np.float32), self.ordering)

        return drain_radius

    def select(self, query: np.ndarray, params: KnnSearchParams) -> SelectKeyResult:
        return self.select_async(query, params)()
