"""Brute-force vector index (port of
reindexer_tpu/index/vector/brute_force.py).

Every select scans the whole base. `_dispatch_scan` picks the scan:

  fp32 (no SQ8, or SQ8 not active yet)
      K1 `bf_scan` + K2 `bf_select` (ops.select.knn_scan_fused) for
      k <= 128; the plain chunked scan ops.distance.knn_scan above that.
  SQ8, mode "exact"
      K3 `sq8_scan` (bmax only) + K4 `sq8_select` (ops.select.knn_scan_sq8)
      for k <= 124: quantized block maxima, an eps-widened threshold, exact
      fp32 scores of the admitted rows. For k > 124, the fp32 path. Unlike
      the JAX engine off a TPU (or above 128 queries, or k > 124), exact is
      exact for every batch size and k.
  SQ8, modes "approx" / "approx_rerank"
      the top-k of quantized scores (the reference's SQ8 semantics): K5
      `sq8_i8_scan` + K2 (ops.select.knn_scan_approx_sq8) for batches of
      <= 64 or a multiple of 64; K3 (scores) + K2
      (ops.select.knn_scan_fused_sq8) for other batches; the plain
      knn_scan_quantized for k > 128. approx_rerank then re-scores the k
      winners exactly (ops.hnsw_kernels.exact_rescore).

A kernel selection whose admitted blocks overflow its slot capacity raises a
flag; if any query of a batch flags, the drain reruns the whole batch one
rung down its ladder:
  exact SQ8   cert eps -> fast eps (sticky per index) -> the fp32 path;
  approx      K3 + K2 -> the plain knn_scan_quantized;
  fp32        K1 + K2 -> the plain knn_scan.
Every rung off the kernels' first choice is counted: `sq8_cert_overflows`,
`sq8_fast_overflows`, `approx_reruns`, `overflow_reruns` and
`geometry_scans` (selects whose k the kernels do not take).

Mesh-resident mode (attach_mesh, parallel/sharded_knn.py): every shard
scans its own rows, fp32 by K1 + K2, approx / approx_rerank SQ8 by K3 (S
mode) + K2 with approx_rerank's exact re-score on the shard, and the
per-shard top-k merge stably on the merge device; exact SQ8 takes the fp32
path, as in the reference. A shard whose k the kernels do not take scans
plainly (`geometry_scans`, once a select), and a flagged shard reruns its
plain scan (`overflow_reruns` / `approx_reruns`, once a select).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ... import tracing
from ...core.errors import ParamsError
from ...core.payload import IndexDef
from ...index.base import SelectKeyResult
from ...index.vector.params import KnnSearchParams

from ...ops.distance import knn_scan, pairwise_scores, scores_to_ranks
from ...ops.hnsw_kernels import exact_rescore
from ...ops.scan import SQ_EFF_BIG
from ...ops.select import (GROUP, MARGIN, S_SLOTS, knn_scan_approx_sq8,
                           knn_scan_fused, knn_scan_fused_sq8, knn_scan_sq8)
from ...parallel.sharded_knn import (MeshScan, kernel_geometry, shard_topk,
                                     shard_topk_sq8)
from .base import FloatVectorIndexBase, engine_boundary
from .quantization import QuantizedStore, knn_scan_quantized

# selects with a k the kernels do not take
geometry_scans = tracing.counter("bf.geometry_scans")
# fp32 K2 overflows rerun by knn_scan
overflow_reruns = tracing.counter("bf.overflow_reruns")
# approx SQ8 overflows rerun by K3 + K2
approx_reruns = tracing.counter("bf.approx_reruns")
# exact SQ8 cert-eps overflows (-> fast)
sq8_cert_overflows = tracing.counter("bf.sq8_cert_overflows")
# exact SQ8 fast-eps overflows (-> fp32)
sq8_fast_overflows = tracing.counter("bf.sq8_fast_overflows")

QUANT_MODES = ("exact", "approx", "approx_rerank")


class BruteForceIndex(FloatVectorIndexBase):
    def __init__(self, definition: IndexDef, device: torch.device):
        super().__init__(definition, device)
        qc = definition.vector_opts.quantization
        # exact SQ8's eps ladder starts at the certified bound; the first
        # overflow makes the index stick to the 12-sigma "fast" bound.
        # RX_SQ8_EPS=fast skips the certified attempt.
        self._sq8_mode = os.environ.get("RX_SQ8_EPS", "cert")
        self._quant_mode = qc.mode if qc.enabled else "exact"
        if self._quant_mode not in QUANT_MODES:
            raise ParamsError(
                f"unknown quantization mode '{self._quant_mode}'")
        self._quant = (QuantizedStore(qc.left_quantile, qc.right_quantile,
                                      qc.min_elements)
                       if qc.enabled else None)

    def _quant_active(self) -> bool:
        return self._quant is not None and self._quant.active

    def _maybe_quantize(self) -> None:
        if self._quant is None:
            return
        if self._quant.need_requantize(self.keeper.count,
                                       self.keeper.capacity):
            self._quant.quantize(self.keeper)
        elif self._quant.need_refresh(self.keeper.count,
                                      self.keeper.version):
            self._quant.refresh(self.keeper)

    def memstat(self) -> dict:
        st = super().memstat()
        if self._quant is not None:
            st.update(self._quant.memstat())
        return st

    # --- scans ----------------------------------------------------------
    def _scan_plain(self, q: torch.Tensor, k: int):
        sq_eff = self.keeper.sq_eff()
        return knn_scan(q, self.keeper.data, sq_eff < SQ_EFF_BIG / 2, sq_eff,
                        k, self.metric)

    def _scan_fp32(self, q: torch.Tensor, k: int):
        """(scores, ids, flag) of the exact fp32 path; flag is None when the
        plain scan ran (it cannot overflow)."""
        if k <= S_SLOTS:
            return knn_scan_fused(q, self.keeper.data, self.keeper.sq_eff(),
                                  k, self.metric)
        s, i = self._scan_plain(q, k)
        return s, i, None

    def _scan_quantized_plain(self, q: torch.Tensor, k: int):
        st, sq_eff = self._quant, self.keeper.sq_eff()
        return knn_scan_quantized(q, st.codes, st.lo, st.alpha,
                                  sq_eff < SQ_EFF_BIG / 2, sq_eff, k,
                                  self.metric)

    def _rerank(self, q: torch.Tensor, s: torch.Tensor, i: torch.Tensor):
        if self._quant_mode != "approx_rerank":
            return s, i
        return exact_rescore(q, self.keeper.data, self.keeper.sq_eff(), i, s,
                             self.metric)

    def _scan_approx(self, q: torch.Tensor, k: int):
        """(scores, ids, flag) of the approx modes; flag None when the plain
        quantized scan ran."""
        st, sq_eff = self._quant, self.keeper.sq_eff()
        n_q = q.shape[0]
        if k > S_SLOTS:
            geometry_scans.add()
            s, i = self._scan_quantized_plain(q, k)
            flag = None
        elif n_q <= GROUP or n_q % GROUP == 0:
            s, i, flag = knn_scan_approx_sq8(q, st.codes, st.lo, st.alpha,
                                             sq_eff, k, self.metric)
        else:
            s, i, flag = knn_scan_fused_sq8(q, st.codes, st.lo, st.alpha,
                                            sq_eff, k, self.metric)
        return (*self._rerank(q, s, i), flag)

    def _scan_sq8_exact(self, q: torch.Tensor, k: int, eps_mode: str):
        st, kp = self._quant, self.keeper
        return knn_scan_sq8(q, st.codes, st.lo, st.alpha, st.err_dims,
                            st.ms_dims, kp.sq_eff(), kp.data, k, self.metric,
                            eps_mode)

    def _mesh_scan(self, q: torch.Tensor, k: int) -> MeshScan:
        """Dispatch the mesh scan (parallel/sharded_knn.py) of every local
        shard; the merge is queued, nothing waits on the device."""
        kp, ctx, metric = self.keeper, self._mesh_ctx, self.metric
        approx = self._quant_active() and self._quant_mode != "exact"
        if not kernel_geometry(kp.capacity // ctx.n_shards, k):
            geometry_scans.add()
        if approx:
            st, rer = self._quant, self._quant_mode == "approx_rerank"

            def run(s, plain):
                sh, (lo, alpha) = kp.shards[s], st.shard_grid[s]
                return shard_topk_sq8(q, st.shard_codes[s], lo, alpha,
                                      sh.data, sh.sq_eff, sh.lo, k, metric,
                                      rer, plain)
        else:
            def run(s, plain):
                sh = kp.shards[s]
                return shard_topk(q, sh.data, sh.sq_eff, sh.lo, k, metric,
                                  plain)
        return MeshScan(ctx, k, ctx.local_shards, run)

    def _dispatch_scan(self, q: torch.Tensor, k: int):
        """(scores, ids, flag) on the device; flag is None when a plain
        scan ran (it cannot overflow)."""
        if self._quant_active():
            if self._quant_mode != "exact":
                return self._scan_approx(q, k)
            if k + MARGIN <= S_SLOTS:
                return self._scan_sq8_exact(q, k, self._sq8_mode)
            geometry_scans.add()
        elif k > S_SLOTS:
            geometry_scans.add()
        return self._scan_fp32(q, k)

    def _overflow_rerun(self, q: torch.Tensor, k: int,
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Host (scores, ids) for a batch whose first scan flagged, one rung
        down its ladder at a time."""

        def flagged(flag) -> bool:
            return flag is not None and bool((flag > 0).any())

        if self._quant_active() and self._quant_mode != "exact":
            approx_reruns.add()
            st, sq_eff = self._quant, self.keeper.sq_eff()
            s, i, flag = knn_scan_fused_sq8(q, st.codes, st.lo, st.alpha,
                                            sq_eff, k, self.metric)
            if flagged(flag):
                s, i = self._scan_quantized_plain(q, k)
            s, i = self._rerank(q, s, i)
            return s.cpu().numpy(), i.cpu().numpy()
        if self._quant_active() and k + MARGIN <= S_SLOTS:
            if self._sq8_mode == "cert":
                sq8_cert_overflows.add()
                self._sq8_mode = "fast"
                s, i, flag = self._scan_sq8_exact(q, k, "fast")
                if not flagged(flag):
                    return s.cpu().numpy(), i.cpu().numpy()
            sq8_fast_overflows.add()
            s, i, flag = self._scan_fp32(q, k)
            if not flagged(flag):
                return s.cpu().numpy(), i.cpu().numpy()
        overflow_reruns.add()
        s, i = self._scan_plain(q, k)
        return s.cpu().numpy(), i.cpu().numpy()

    @engine_boundary
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
        self._maybe_quantize()
        q = np.stack([kp.prepare_query(v) for v in queries])
        k = min(params.k, kp.capacity)
        qd = torch.from_numpy(q).to(kp.device)
        mesh = None
        if self._mesh_ctx is not None:
            mesh = self._mesh_scan(qd, k)
            scores, idx, flag = mesh.scores, mesh.ids, mesh.flag
        else:
            scores, idx, flag = self._dispatch_scan(qd, k)
        parts = [scores.view(torch.int32), idx]
        if flag is not None:
            parts.append(flag.view(torch.int32))
        packed = torch.cat([p.reshape(-1) for p in parts])
        n = len(queries) * k

        def drain() -> list[SelectKeyResult]:
            host = tracing.device_read(packed, "engine.device_wait").numpy()
            s = host[:n].view(np.float32).reshape(-1, k)
            i = host[n:2 * n].reshape(-1, k)
            fl = host[2 * n:].view(np.float32)
            if flag is not None and (fl > 0).any():
                if mesh is None:
                    s, i = self._overflow_rerun(qd, k)
                else:
                    (approx_reruns if self._quant_active()
                     and self._quant_mode != "exact"
                     else overflow_reruns).add()
                    s, i = mesh.rerun(fl)
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

        # radius-only search: full fp32 scan, filter on host
        self._maybe_quantize()
        q = torch.from_numpy(kp.prepare_query(query)[None, :]).to(kp.device)
        if self._mesh_ctx is not None:
            # every shard's scores, joined in row order on the merge device
            dev = self._mesh_ctx.merge_device
            scores_d = torch.cat([pairwise_scores(
                q.to(sh.data.device), sh.data,
                sh.sq_eff < SQ_EFF_BIG / 2, sh.sq_eff, self.metric).to(dev)
                for _, sh in kp.local_shards()], dim=1)
        else:
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
