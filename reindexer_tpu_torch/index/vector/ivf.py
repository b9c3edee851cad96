"""IVF vector index (port of reindexer_tpu/index/vector/ivf.py).

Two stages: the query is scored against the centroids and the top-nprobe
inverted lists are probed; then the rows of those lists are scored and the
top-k kept. Training is k-means (ops/ivf_kernels.kmeans_l2) on up to
39 x nlist sampled rows, drawn with the reference's own numpy generator so
the sample and the initial centroids are the same rows. The inverted lists
are a host CSR over row ids, and a list-contiguous reorder of the base on
the device puts every list on 128-row-aligned blocks.

Stage 1 runs on the host copy of the centroid table (numpy, the reference's
code), so probes are bit-identical to the reference's. Stage 2 takes one of
three routes, each counted:

  segment_scans   K6 `ivf_seg_scan` scores exactly the probed blocks of the
                  reorder (ops/ivf_kernels.scan_segments), segment_topk
                  folds them; cost follows the probed rows
  masked_sweeps   every row of the reorder by a chunked matmul, masked per
                  block by the probe set (scan_reordered_masked); cost
                  follows the index size
  gather_scans    probed lists expanded to candidate rows on the device and
                  gathered (expand_probes + scan_lists_batch): radius-only
                  selects (k None) and RX_IVF_GATHER=1

Routing between the first two: RX_IVF_SEGMENTS=1 forces segments (on the
CPU through K6's plain version), RX_IVF_SEGMENTS=0 forces the sweep. Unset,
the CPU takes the sweep, as the reference does off a TPU, and CUDA routes by
the reference's inequality

    seg_rows * penalty + fixed_rows < capacity

with the penalty a function of the batch, fitted to both routes measured on
the H100 (PERF.md, "IVF router"). A failure of K6 raises: there is no
fallback.

Mesh-resident mode (scan_probed_full, probe_mask, _stage2_sharded of the
reference) is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from reindexer_tpu.core.payload import IndexDef
from reindexer_tpu.core.type_consts import VectorMetric
from reindexer_tpu.index.base import SelectKeyResult
from reindexer_tpu.index.vector.params import KnnSearchParams

from ...ops._build import Counter
from ...ops.distance import scores_to_ranks
from ...ops.ivf_kernels import (SEG_BLK, assign_lists, expand_probes,
                                kmeans_l2, probe_centroids, scan_lists_batch,
                                scan_reordered_masked, scan_segments,
                                segment_topk)
from ...ops.scan import SQ_EFF_BIG
from .base import FloatVectorIndexBase

_TRAIN_FACTOR = 39      # reference: ivf_index.h:62
_KMEANS_ITERS = 20
_MIN_TRAIN = 64

# The CUDA router's cost model, fitted to both routes' stage 2 (host work
# included) timed at 1M x 768 (capacity 1,048,576), batch {1, 16, 32, 64,
# 128, 256} x nprobe {8..128} on an H100 80GB HBM3 at 700 W (PERF.md, "IVF
# router"): segments cost 0.88 ms + 1.108 ns per probed row, the sweep
# 3.24 ms + 0.1255 ms per query. Both pay the same fixed host work, so the
# rest of the sweep is per row of capacity: 2.255 ns + 0.1197 ns per query
# (its matmul and top-k grow with the batch). Rates are at 768 dims and
# taken to scale with dims. The default penalty is the ratio of the rates
# at the select's batch, so the sweep wins only at large batch x nprobe
# (128 x 128 and 256 x 128 measured). RX_IVF_SEG_PENALTY replaces the
# penalty for every batch; RX_IVF_SEG_FIXED_MS is the segment route's extra
# fixed cost (0: measured equal).
SEG_NS_PER_ROW = 1.108
SWEEP_NS_PER_ROW = 2.255
SWEEP_NS_PER_ROW_QUERY = 0.1197
SEG_FIXED_MS = "0"

segment_scans = Counter()    # stage 2 through K6 (or its plain version)
masked_sweeps = Counter()    # stage 2 through the masked sweep
gather_scans = Counter()     # stage 2 through the gathered candidate scan


def _pow2(n: int, floor: int = 256) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _env_on(name: str) -> bool:
    return os.environ.get(name, "") in ("1", "true")


def _env_off(name: str) -> bool:
    return os.environ.get(name, "") in ("0", "false")


def segments_win(seg_rows: int, capacity: int, dims: int, batch: int,
                 ) -> bool:
    """The CUDA router, the reference's inequality
    seg_rows * penalty + fixed_rows < capacity: a probed row costs penalty
    times a row of the sweep at this batch, and fixed_ms is fixed_rows of
    the sweep's rows."""
    sweep_ns = (SWEEP_NS_PER_ROW + SWEEP_NS_PER_ROW_QUERY * batch) \
        * dims / 768
    penalty = float(os.environ.get("RX_IVF_SEG_PENALTY", 0.0)) or \
        SEG_NS_PER_ROW * dims / 768 / sweep_ns
    fixed_ms = float(os.environ.get("RX_IVF_SEG_FIXED_MS", SEG_FIXED_MS))
    return seg_rows * penalty + fixed_ms * 1e6 / sweep_ns < capacity


class IvfIndex(FloatVectorIndexBase):
    def __init__(self, definition: IndexDef, device: torch.device):
        super().__init__(definition, device)
        self.nlist_cfg = int(definition.vector_opts.centroids_count or 0)
        self.centroids: Optional[torch.Tensor] = None
        self._c_np: Optional[tuple[torch.Tensor, np.ndarray]] = None
        self._assign = np.full(self.keeper.capacity, -1, dtype=np.int32)
        self._pending_rows: list[int] = []
        self._csr_dirty = True
        self._list_start = np.zeros(1, dtype=np.int64)
        self._list_rows = np.empty(0, dtype=np.int32)
        self._d_reordered: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng(0x1F5)
        self.keeper.upload_bf16 = not _env_off("RX_IVF_BF16_UPLOAD")

    # ------------------------------------------------------------------
    def upsert(self, row_id: int, values) -> None:
        super().upsert(row_id, values)
        self._grow(row_id + 1)
        if values is None or (hasattr(values, "__len__") and len(values) == 0):
            self._assign[row_id] = -1
        else:
            self._pending_rows.append(row_id)
        self._csr_dirty = True

    def delete(self, row_id: int, values) -> None:
        super().delete(row_id, values)
        if row_id < len(self._assign):
            self._assign[row_id] = -1
        self._csr_dirty = True

    def clear(self) -> None:
        super().clear()
        self.centroids = None
        self._assign = np.full(self.keeper.capacity, -1, dtype=np.int32)
        self._pending_rows.clear()
        self._d_reordered = None
        self._csr_dirty = True

    def _grow(self, need: int) -> None:
        if need <= len(self._assign):
            return
        cap = len(self._assign)
        while cap < need:
            cap *= 2
        self._assign = np.concatenate(
            [self._assign, np.full(cap - len(self._assign), -1,
                                   dtype=np.int32)])

    def _rows_d(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.keeper.device)

    # ------------------------------------------------------------------
    @property
    def nlist(self) -> int:
        if self.centroids is not None:
            return self.centroids.shape[0]
        if self.nlist_cfg > 0:
            return self.nlist_cfg
        n = max(self.keeper.count, 1)
        return max(1, min(int(4 * math.sqrt(n)), n))

    def _train(self) -> None:
        """k-means on up to 39 * nlist sampled rows, then every valid row is
        assigned to its nearest centroid."""
        self.keeper.flush()
        rows = np.flatnonzero(self.keeper.valid)
        if len(rows) == 0:
            return
        nlist = min(self.nlist, len(rows))
        n_train = min(len(rows), max(_TRAIN_FACTOR * nlist, _MIN_TRAIN))
        sample = self._rng.choice(rows, size=n_train, replace=False)
        train_d = self.keeper.data[self._rows_d(sample)]
        init_rows = self._rng.choice(n_train, size=nlist, replace=False)
        init_d = train_d[self._rows_d(init_rows)]
        self.centroids = kmeans_l2(train_d, init_d, _KMEANS_ITERS)
        assign = assign_lists(self.keeper.data, self.centroids,
                              self.metric).cpu().numpy()
        self._assign[:] = -1
        self._assign[rows] = assign[rows]
        self._pending_rows.clear()
        self._csr_dirty = True

    def rebuild_centroids(self) -> None:
        """The `rebuild_ivf_index` action: retrain from the current rows."""
        self._train()

    def commit(self) -> None:
        self._commit()

    def _commit(self) -> None:
        self.keeper.flush()
        if self.centroids is None:
            if self.keeper.count > 0:
                self._train()
            return
        if self._pending_rows:
            rows = np.unique(np.asarray(self._pending_rows, dtype=np.int32))
            self._pending_rows.clear()
            rows = rows[self.keeper.valid[rows]]
            if len(rows):
                vecs_d = self.keeper.data[self._rows_d(rows)]
                self._assign[rows] = assign_lists(
                    vecs_d, self.centroids, self.metric).cpu().numpy()
            self._csr_dirty = True
        # retrain when the index grew far beyond its training size
        if self.nlist_cfg == 0 and self.keeper.count > 0:
            if self.centroids.shape[0] < 4 * math.sqrt(self.keeper.count) / 2:
                self._train()

    def _rebuild_csr(self) -> None:
        if not self._csr_dirty:
            return
        nlist = self.centroids.shape[0] if self.centroids is not None else 0
        rows = np.flatnonzero(self._assign >= 0)
        a = self._assign[rows]
        order = np.argsort(a, kind="stable")
        self._list_rows = rows[order].astype(np.int32)
        self._list_start = np.searchsorted(
            a[order], np.arange(nlist + 1)).astype(np.int64)
        # device mirror for expand_probes (the gather route)
        rows_p = np.zeros(_pow2(max(len(self._list_rows), 1)), dtype=np.int32)
        rows_p[: len(self._list_rows)] = self._list_rows
        dev = self.keeper.device
        self._d_list_rows = torch.from_numpy(rows_p).to(dev)
        self._d_list_start = torch.from_numpy(self._list_start).to(dev)
        self._rebuild_segments()
        self._csr_dirty = False

    def _rebuild_segments(self) -> None:
        """The list-contiguous reorder on the device: every inverted list
        becomes a 128-row-aligned span of a reordered copy of the base, so
        stage 2 can read exactly the probed blocks. One base-sized buffer
        (rows padded to a power of two) plus at most nlist padding blocks;
        rebuilt only when assignments change."""
        nlist = self.centroids.shape[0] if self.centroids is not None else 0
        lens = np.diff(self._list_start)
        blocks = np.maximum((lens + SEG_BLK - 1) // SEG_BLK, 0)
        seg_start_rows = np.zeros(nlist + 1, dtype=np.int64)
        np.cumsum(blocks * SEG_BLK, out=seg_start_rows[1:])
        total = int(seg_start_rows[-1]) + SEG_BLK   # +1 guaranteed pad block
        npad = _pow2(max(total, SEG_BLK), SEG_BLK)
        perm = np.full(npad, -1, dtype=np.int32)
        for li in range(nlist):
            s, e = self._list_start[li], self._list_start[li + 1]
            if e > s:
                off = int(seg_start_rows[li])
                perm[off: off + (e - s)] = self._list_rows[s:e]
        self._seg_blocks = blocks.astype(np.int64)
        self._seg_first_block = (seg_start_rows[:-1] // SEG_BLK).astype(
            np.int64)
        self._pad_block = int(seg_start_rows[-1]) // SEG_BLK
        # block -> list id (host, -1 on padding blocks): the masked sweep's
        # per-block probe table is built from it
        block_list = np.full(npad // SEG_BLK, -1, dtype=np.int32)
        owned = np.repeat(np.arange(nlist, dtype=np.int32), self._seg_blocks)
        block_list[: len(owned)] = owned
        self._block_list = block_list
        # padding rows are zero; every row of a list is valid, so its
        # sq_eff is |b|^2 (L2) or 0
        self._d_reordered = None        # free the old copy first
        self._d_perm = torch.from_numpy(perm).to(self.keeper.device)
        safe = self._d_perm.clamp_min(0).to(torch.int64)
        pad = (self._d_perm < 0)
        self._d_reordered = self.keeper.data.index_select(0, safe) \
            .masked_fill_(pad[:, None], 0.0)
        self._d_reordered_sq = self.keeper.sq_eff().index_select(0, safe) \
            .masked_fill_(pad, 0.0)

    # ------------------------------------------------------------------
    def _use_segments(self, probes: np.ndarray) -> bool:
        """The route of a select with k: segments (True) or the masked
        sweep (False)."""
        if _env_on("RX_IVF_SEGMENTS"):
            return True
        if self.keeper.device.type != "cuda" or _env_off("RX_IVF_SEGMENTS"):
            return False
        return segments_win(int(self._seg_blocks[probes].sum()) * SEG_BLK,
                            self.keeper.capacity, self.dims, probes.shape[0])

    def _stage2(self, qd: torch.Tensor, nprobe: int, k: Optional[int],
                q_host: np.ndarray):
        """Stage 2 on the device: (scores, ids) tensors, or (None, None)
        when no probed list holds a row (gather route)."""
        if k is None or _env_on("RX_IVF_GATHER"):
            gather_scans.add()
            cand, ok, totals = self._device_cands(qd, nprobe)
            if cand is None:
                return None, None
            k_eff = k if k is not None else int(totals[0])
            kk = _pow2(min(k_eff, cand.shape[1]), 16)
            sq_eff = self.keeper.sq_eff()
            return scan_lists_batch(qd, self.keeper.data, sq_eff,
                                    sq_eff < SQ_EFF_BIG / 2, cand, ok, kk,
                                    self.metric)
        probes = self._probe_host(q_host, min(nprobe,
                                              self.centroids.shape[0]))
        if self._use_segments(probes):
            segment_scans.add()
            return self._stage2_segments(qd, k, probes)
        masked_sweeps.add()
        kk = _pow2(min(k, self.keeper.capacity), 16)
        n_b = probes.shape[0]
        psel = np.zeros((n_b, self.centroids.shape[0]), np.bool_)
        psel[np.arange(n_b)[:, None], probes] = True
        bl = self._block_list
        bmask = np.where(bl[None, :] >= 0, psel[:, np.maximum(bl, 0)], False)
        return scan_reordered_masked(
            qd, self._d_reordered, self._d_reordered_sq, self._d_perm,
            torch.from_numpy(bmask).to(self.keeper.device), kk, self.metric)

    def _host_centroids(self) -> np.ndarray:
        """Host copy of the centroid table, refreshed whenever the device
        tensor changes (train / rebuild / load)."""
        if self._c_np is None or self._c_np[0] is not self.centroids:
            self._c_np = (self.centroids, self.centroids.cpu().numpy())
        return self._c_np[1]

    def _probe_host(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """Stage 1 on the host: the top-nprobe centroids per query, best
        first, i32[B, nprobe] (the reference's numpy code)."""
        cn = self._host_centroids()
        nlist = cn.shape[0]
        npb = min(nprobe, nlist)
        dots = q @ cn.T
        if self.metric == VectorMetric.L2:
            dots = 2.0 * dots - np.sum(cn * cn, axis=1)[None, :]
        part = np.argpartition(-dots, npb - 1, axis=1)[:, :npb]
        order = np.argsort(-np.take_along_axis(dots, part, axis=1),
                           kind="stable", axis=1)
        return np.take_along_axis(part, order, axis=1).astype(np.int32)

    def _segment_plan(self, probes: np.ndarray) -> torch.Tensor:
        """K6's segments for probes i32[B, P]: i32[3, B * S_q] on the
        device, rows (starts, qids, counts). The host expands the probed
        lists into a query-major block list, S_q blocks per query (a power
        of two); the padding segments have count 0 and point at the pad
        block."""
        n_b, n_p = probes.shape
        blk_cnt = self._seg_blocks[probes]               # [B, P]
        lens = np.diff(self._list_start)
        s_q = _pow2(max(int(blk_cnt.sum(axis=1).max()), 1), 4)
        cnt = blk_cnt.reshape(-1)                        # [B * P]
        total = int(cnt.sum())
        plan = np.zeros((3, n_b * s_q), dtype=np.int32)
        plan[0] = self._pad_block
        plan[1] = np.repeat(np.arange(n_b, dtype=np.int32), s_q)
        if total:
            off = np.zeros((n_b, n_p), np.int64)
            off[:, 1:] = np.cumsum(blk_cnt, axis=1)[:, :-1]
            pos0 = (np.arange(n_b, dtype=np.int64)[:, None] * s_q
                    + off).reshape(-1)                   # [B * P]
            csum = np.cumsum(cnt) - cnt
            within = np.arange(total, dtype=np.int64) - np.repeat(csum, cnt)
            flat = np.repeat(pos0, cnt) + within
            fb = self._seg_first_block[probes].reshape(-1)
            plan[0, flat] = np.repeat(fb, cnt) + within
            rem = np.repeat(lens[probes].reshape(-1), cnt) - within * SEG_BLK
            plan[2, flat] = np.minimum(rem, SEG_BLK)
        return torch.from_numpy(plan).to(self.keeper.device)

    def _stage2_segments(self, qd: torch.Tensor, k: int,
                         probes: np.ndarray):
        """Segment route: K6 scores exactly the probed blocks and
        segment_topk folds them with original row ids."""
        starts, qids, counts = self._segment_plan(probes)
        seg_scores = scan_segments(starts, qids, counts, qd,
                                   self._d_reordered, self.metric)
        return segment_topk(seg_scores, starts, self._d_perm, qd,
                            min(k, self.keeper.capacity), self.metric)

    def _device_cands(self, qd: torch.Tensor, nprobe: int):
        """Probe + inverted-list expansion on the device; only the small
        [B, nprobe] probe matrix comes to the host, to size the candidate
        width."""
        probes = probe_centroids(qd, self.centroids, nprobe, self.metric)
        p_np = probes.cpu().numpy()
        totals = (self._list_start[p_np + 1]
                  - self._list_start[p_np]).sum(axis=1)
        if totals.max() == 0:
            return None, None, totals
        cand, ok = expand_probes(probes, self._d_list_start,
                                 self._d_list_rows, _pow2(int(totals.max())))
        return cand, ok, totals

    # ------------------------------------------------------------------
    def _dispatch(self, queries: np.ndarray, params: KnnSearchParams):
        """Stage 2 for prepared queries f32[B, D]: a closure that copies
        scores and ids to the host in one device-to-host copy and returns
        them as numpy ([B, K] each), or None when nothing was probed."""
        self._rebuild_csr()
        nprobe = getattr(params, "nprobe", 1) or 1
        qd = torch.from_numpy(queries).to(self.keeper.device)
        scores_d, ids_d = self._stage2(qd, nprobe, params.k, q_host=queries)
        if scores_d is None:
            return lambda: None
        width = scores_d.shape[1]
        packed = torch.cat([scores_d.contiguous().view(torch.int32).reshape(-1),
                            ids_d.to(torch.int32).reshape(-1)])

        def fetch():
            host = packed.cpu().numpy()
            n = len(host) // 2
            return (host[:n].view(np.float32).reshape(-1, width),
                    host[n:].reshape(-1, width))

        return fetch

    def _result(self, scores: np.ndarray, ids: np.ndarray,
                params: KnnSearchParams) -> SelectKeyResult:
        keep = ids >= 0
        scores, ids = scores[keep], ids[keep]
        if params.k is not None:
            scores, ids = scores[: params.k], ids[: params.k]
        ranks = scores_to_ranks(scores, self.metric)
        ranks, ids = self._apply_radius(ranks, ids, params.radius)
        return SelectKeyResult(ids.astype(np.int64), ranks.astype(np.float32),
                               self.ordering)

    def select_async(self, query: np.ndarray, params: KnnSearchParams):
        """Dispatch/drain split: stage 2 is dispatched here (under the
        namespace lock); the returned closure waits for the copy to the
        host and builds the result."""
        self._commit()
        if self.centroids is None or self.keeper.count == 0:
            res = SelectKeyResult.empty()
            return lambda: res
        fetch = self._dispatch(self.keeper.prepare_query(query)[None, :],
                               params)

        def drain() -> SelectKeyResult:
            got = fetch()
            if got is None:
                return SelectKeyResult.empty()
            return self._result(got[0][0], got[1][0], params)

        return drain

    def select(self, query: np.ndarray, params: KnnSearchParams,
               ) -> SelectKeyResult:
        return self.select_async(query, params)()

    def select_batch_async(self, queries: np.ndarray,
                           params: KnnSearchParams):
        """Batched dispatch/drain split (see select_async)."""
        self._commit()
        queries = np.asarray(queries, dtype=np.float32)
        if self.centroids is None or self.keeper.count == 0 \
                or params.k is None:
            res = super().select_batch(queries, params)
            return lambda: res
        n_b = len(queries)
        fetch = self._dispatch(
            np.stack([self.keeper.prepare_query(v) for v in queries]), params)

        def drain() -> list[SelectKeyResult]:
            got = fetch()
            if got is None:
                return [SelectKeyResult.empty() for _ in range(n_b)]
            return [self._result(got[0][b], got[1][b], params)
                    for b in range(n_b)]

        return drain

    def select_batch(self, queries: np.ndarray, params: KnnSearchParams,
                     ) -> list[SelectKeyResult]:
        """Batched IVF: one stage 1 and one stage 2 for all queries."""
        return self.select_batch_async(queries, params)()

    # ------------------------------------------------------------------
    def memstat(self) -> dict:
        st = super().memstat()
        st["centroids"] = (int(self.centroids.shape[0])
                           if self.centroids is not None else 0)
        return st

    def state_dict(self) -> dict:
        """{"keeper", "centroids": f32[nlist, D] or None, "assign":
        i32[rows]} as numpy, the reference's format."""
        self._commit()
        return {
            "keeper": self.keeper.state_dict(),
            "centroids": (self.centroids.cpu().numpy().copy()
                          if self.centroids is not None else None),
            "assign": self._assign.copy(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.clear()
        self.keeper.load_state_dict(state["keeper"])
        c = state.get("centroids")
        self.centroids = (torch.from_numpy(np.array(c, dtype=np.float32))
                          .to(self.keeper.device) if c is not None else None)
        self._assign = np.array(state["assign"], dtype=np.int32)
        self._csr_dirty = True
