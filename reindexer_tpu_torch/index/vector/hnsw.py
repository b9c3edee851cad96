"""HNSW vector index (port of reindexer_tpu/index/vector/hnsw.py): batched
beam search over padded neighbor tables.

- Graph layout: layer 0 is an i32[cap, 2M] neighbor table, the upper layers
  a top-first stack i32[Lu, cap, M] (hnswlib maxM0 = 2M, hnswalg.h); -1
  marks an empty slot. The tables live on the host (numpy) and are
  mirrored on the index's device; a commit sends only the rows it touched.
- Search (reference SearchKnn, hnswalg.h:1988): `greedy_descend` walks the
  upper layers, `beam_search_layer` runs the ef-beam on layer 0, batched
  over queries (ops/hnsw_kernels.py). Queries pad to a multiple of 8 zero
  rows, the beam to ef_pad = pow2(ef, 16) with 2 * ef_pad iterations at
  most, as in the reference: the padded rows take part in the beam's
  batch-wide stop, so they decide when it ends for the real queries.
- Insertion (reference addPoint, hnswalg.h:1402): points queue on upsert
  and commit in chunks of 32, 64, ... 1024 rows. Each chunk's candidates on
  each layer are an exact scan of the rows already in that layer plus the
  chunk's own members (`exact_build_layer`); the neighbor heuristic prunes
  them to M, and the host links them both ways (csrc/hnsw_native.cpp, or
  the Python loop of `_connect_selected` when RX_TPU_DISABLE_NATIVE is set
  or no compiler is found: the same tables). Every chunk's device work is
  queued before the host links any (`_dispatch_chunks`, `_link_chunk`).
- Deletes mark the node (hnswalg.h markDelete): the search goes on through
  deleted nodes, scored with their stale vectors (the keeper's `sq` keeps
  their |b|^2), and drops them from the results.

The reference's compile workarounds are not carried: it pads every build
chunk to 1,024 rows with a fixed chunk-internal width on accelerators, and
pads the dirty-row scatters of its mirrors to powers of two, only to bound
XLA compiles. This port takes the reference's CPU branch on every device:
chunks pad to pow2(rows) and the chunk-internal width is pow2(min(rows - 1,
2M), 8), so the graph it builds is the one the reference builds on the CPU.

Device mirrors of the link tables are replaced, never updated in place, and
the keeper writes new tensors on each mutation (copy on write), so a
streaming session keeps the graph and vectors it started on, as JAX arrays
do for the reference. The build-only mirrors (levels, deleted) update in
place. Nothing falls back to the CPU: every tensor lives on the index's
device and a device error raises. The mesh mode (attach_mesh) is not ported
yet (ROADMAP A12). RX_HNSW_NO_HEURISTIC=1 is the reference's ablation
switch: forward selection keeps the plain top-M.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ...core.errors import ParamsError
from ...core.payload import IndexDef
from ...core.type_consts import VectorMetric
from ...index.base import SelectKeyResult
from ...index.vector.params import KnnSearchParams

from ...ops.distance import normalize_rows, scores_to_ranks
from ...ops.hnsw_kernels import (DataPack, beam_search_layer,
                                 exact_build_layer, exact_rescore,
                                 greedy_descend)
from .base import FloatVectorIndexBase

_Q_BUCKET = 8
_CHUNK_START = 32
_CHUNK_MAX = 1024

_HNSW_NATIVE = None
_HNSW_NATIVE_TRIED = False


def _hnsw_native_module():
    """Lazily built C++ link maintenance (csrc/hnsw_native.cpp)."""
    global _HNSW_NATIVE, _HNSW_NATIVE_TRIED
    if not _HNSW_NATIVE_TRIED:
        _HNSW_NATIVE_TRIED = True
        if os.environ.get("RX_TPU_DISABLE_NATIVE", "") not in ("1", "true"):
            from ...csrc import load
            _HNSW_NATIVE = load("_hnsw_native", "hnsw_native.cpp")
    return _HNSW_NATIVE


def _pow2(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class HnswIndex(FloatVectorIndexBase):
    KEEPER_COPY_ON_WRITE = True

    def __init__(self, definition: IndexDef, device: torch.device):
        super().__init__(definition, device)
        vo = definition.vector_opts
        self.m = max(int(vo.m), 2)
        self.m0 = 2 * self.m
        self.ef_construction = max(int(vo.ef_construction), self.m)
        self._mult = 1.0 / math.log(self.m)
        self._use_heuristic = os.environ.get(
            "RX_HNSW_NO_HEURISTIC", "0") not in ("1", "true")
        self._rng = np.random.default_rng(0xC0FFEE)
        cap = self.keeper.capacity
        self._levels = np.full(cap, -1, dtype=np.int32)
        self._deleted = np.zeros(cap, dtype=np.bool_)
        self._links0 = np.full((cap, self.m0), -1, dtype=np.int32)
        self._upper: list[np.ndarray] = []   # top-first, each [cap, m]
        self._host_vecs = np.zeros((cap, self.dims), dtype=np.float32)
        self._entry = -1
        self._max_level = -1
        self._pending: dict[int, np.ndarray] = {}
        # device mirrors + dirty row tracking
        self._d_links0: Optional[torch.Tensor] = None
        self._d_upper: Optional[torch.Tensor] = None   # [Lu, cap, m]
        self._dirty0: set[int] = set()
        self._dirty_upper: dict[int, set[int]] = {}   # layer -> rows
        self._full_sync = True
        self._d_levels: Optional[torch.Tensor] = None
        self._d_deleted: Optional[torch.Tensor] = None
        qc = vo.quantization
        self._quant = None
        if qc.enabled:
            from .quantization import QuantizedStore
            self._quant = QuantizedStore(qc.left_quantile, qc.right_quantile,
                                         qc.min_elements)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of arr on the index's device (never a view of it)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.keeper.device, copy=True)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def upsert(self, row_id: int, values) -> None:
        super().upsert(row_id, values)   # keeper bookkeeping
        if values is None or (hasattr(values, "__len__") and len(values) == 0):
            self._pending.pop(row_id, None)
            if row_id < len(self._levels) and self._levels[row_id] >= 0:
                self._deleted[row_id] = True
            return
        vec = np.asarray(values, dtype=np.float32).reshape(-1)
        if self.metric == VectorMetric.COSINE:
            vec = normalize_rows(vec[None, :])[0]
        if row_id < len(self._levels) and self._levels[row_id] >= 0:
            # vector update of an existing node: unlink and re-insert so the
            # graph reflects the new position (reference: updatePoint link
            # repair, hnswalg.h)
            self._grow(row_id + 1)
            self._host_vecs[row_id] = vec
            self._deleted[row_id] = False
            self._unlink(row_id)
        self._pending[row_id] = vec

    def delete(self, row_id: int, values) -> None:
        super().delete(row_id, values)
        self._pending.pop(row_id, None)
        if row_id < len(self._levels) and self._levels[row_id] >= 0:
            self._deleted[row_id] = True
            if row_id == self._entry:
                self._reassign_entry()

    def _unlink(self, row: int) -> None:
        """Detach a node from every layer (incoming + outgoing edges) so it
        can be re-inserted at its new position."""
        if row == self._entry:
            prev_level = self._levels[row]
            self._levels[row] = -1
            self._reassign_entry()
            self._levels[row] = prev_level
        layers = [(0, self._links0)] + [
            (len(self._upper) - li, u) for li, u in enumerate(self._upper)]
        for layer, links in layers:
            dirty = self._dirty0 if layer == 0 else \
                self._dirty_upper.setdefault(layer, set())
            # outgoing
            nbrs = links[row][links[row] >= 0]
            links[row, :] = -1
            dirty.add(row)
            # incoming from former neighbors (HNSW edges are near-symmetric;
            # scan the ex-neighbors' lists)
            for s in nbrs:
                srow = links[s]
                hit = srow == row
                if hit.any():
                    kept = srow[(srow >= 0) & ~hit]
                    links[s, :] = -1
                    links[s, : len(kept)] = kept
                    dirty.add(int(s))
            # repair: bridge the ex-neighbors pairwise so removing the node
            # cannot disconnect the graph (reference: updatePoint ->
            # repairConnectionsForUpdate, hnswalg.h)
            for a in nbrs:
                arow = links[a]
                have = set(int(x) for x in arow[arow >= 0])
                for b in nbrs:
                    if a == b or int(b) in have:
                        continue
                    free = np.flatnonzero(arow < 0)
                    if not len(free):
                        break
                    links[a, free[0]] = b
                    have.add(int(b))
                    dirty.add(int(a))
        self._levels[row] = -1

    def _reassign_entry(self) -> None:
        for lvl in range(self._max_level, -1, -1):
            cand = np.flatnonzero((self._levels >= lvl) & ~self._deleted)
            if len(cand):
                self._entry = int(cand[0])
                self._max_level = int(self._levels[self._entry])
                return
        self._entry = -1
        self._max_level = -1

    def clear(self) -> None:
        super().clear()
        cap = self.keeper.capacity
        self._levels = np.full(cap, -1, dtype=np.int32)
        self._deleted = np.zeros(cap, dtype=np.bool_)
        self._links0 = np.full((cap, self.m0), -1, dtype=np.int32)
        self._upper = []
        self._host_vecs = np.zeros((cap, self.dims), dtype=np.float32)
        self._entry = -1
        self._max_level = -1
        self._pending.clear()
        self._d_links0 = self._d_upper = None
        self._full_sync = True

    # ------------------------------------------------------------------
    # capacity
    # ------------------------------------------------------------------
    def _grow(self, need: int) -> None:
        cap = len(self._levels)
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2

        def pad(a, fill):
            shape = (new_cap - cap,) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)])

        self._levels = pad(self._levels, -1)
        self._deleted = pad(self._deleted, False)
        self._links0 = pad(self._links0, -1)
        self._upper = [pad(u, -1) for u in self._upper]
        self._host_vecs = pad(self._host_vecs, 0.0)
        self._full_sync = True

    # ------------------------------------------------------------------
    # commit: batched insertion
    # ------------------------------------------------------------------
    def commit(self) -> None:
        self._commit()

    def _commit(self) -> None:
        self.keeper.flush()
        if not self._pending:
            return
        rows = sorted(self._pending.keys())
        self._grow(max(rows) + 1)
        for r in rows:
            self._host_vecs[r] = self._pending[r]
            self._deleted[r] = False
        chunk = _CHUNK_START
        i = 0
        plans: list[list[int]] = []
        while i < len(rows):
            plans.append(rows[i: i + chunk])
            i += chunk
            chunk = min(chunk * 2, _CHUNK_MAX)
        staged = self._dispatch_chunks(plans)
        for batch, levels, layer_out in staged:
            self._link_chunk(batch, levels, layer_out)
        self._pending.clear()

    def _pack(self, for_search: bool) -> DataPack:
        """Vector storage for the graph ops. Searches use the SQ8 codes when
        quantization is active (reference: quantized HNSW storage,
        hnswalg.h uint8 template); inserts always use the exact fp32 rows."""
        if for_search and self._quant is not None:
            if self._quant.need_requantize(self.keeper.count,
                                           self.keeper.capacity):
                self._quant.quantize(self.keeper)
            elif self._quant.need_refresh(self.keeper.count):
                self._quant.refresh(self.keeper)
            if self._quant.active:
                return DataPack(self._quant.codes, self.keeper.sq,
                                self._quant.lo, self._quant.alpha)
        return DataPack(self.keeper.data, self.keeper.sq)

    def _sample_level(self) -> int:
        return int(-math.log(max(self._rng.random(), 1e-12)) * self._mult)

    def _dispatch_chunks(self, plans: list[list[int]]):
        """Phase 1 of the build: sample every chunk's levels and queue every
        chunk's device work before any host linking. The exact-scan build
        never reads the link tables: a chunk's candidates depend only on
        which rows precede it in the insertion order (the planned levels),
        known up front. The chunks' rows, vectors and levels go to the
        device in one copy each.

        Returns [(rows, levels, [(layer, connect_here, sel_device)])]."""
        staged = []
        if not plans:
            return staged
        if self._entry < 0:
            # bootstrap: the first point becomes the entry
            r0 = plans[0][0]
            lvl = self._sample_level()
            self._set_level(r0, lvl)
            self._entry, self._max_level = r0, lvl
            plans = [plans[0][1:]] + plans[1:]
        plans = [rows for rows in plans if rows]
        if not plans:
            return staged
        pack = self._pack(for_search=False)
        levels_plan = self._levels.copy()
        run_max = self._max_level
        levels_dev, deleted_dev = self._build_state_device()
        efc_k = _pow2(min(self.ef_construction,
                          max(self.keeper.capacity // 2, 8)), 8)
        # the levels in the reference's order: chunk by chunk, row by row
        chunk_levels = [np.asarray([self._sample_level() for _ in rows],
                                   dtype=np.int32) for rows in plans]
        all_rows = np.concatenate([np.asarray(r, np.int64) for r in plans])
        rows_d = self._upload(all_rows)
        vecs_d = self._upload(self._host_vecs[all_rows])
        levels_d = self._upload(np.concatenate(chunk_levels))
        dev = self.keeper.device
        off = 0
        for rows, levels in zip(plans, chunk_levels):
            B = len(rows)
            qpad = _pow2(B)
            q = torch.zeros((qpad, self.dims), dtype=torch.float32,
                            device=dev)
            q[:B] = vecs_d[off: off + B]
            row_arr = torch.full((qpad,), -1, dtype=torch.int64, device=dev)
            row_arr[:B] = rows_d[off: off + B]
            lv = torch.full((qpad,), -1, dtype=torch.int32, device=dev)
            lv[:B] = levels_d[off: off + B]
            kc = _pow2(min(B - 1, self.m0), 8) if B > 1 else 0
            top_batch = int(levels.max())
            layer_out = []
            for lc in range(min(top_batch, run_max), -1, -1):
                connect_here = np.flatnonzero(levels >= lc) if lc > 0 else \
                    np.arange(B)
                if len(connect_here) == 0:
                    continue
                sel = exact_build_layer(
                    q, pack, levels_dev, deleted_dev, lc, row_arr, lv >= lc,
                    k=efc_k, kc=kc, m=self.m, metric=self.metric,
                    use_heuristic=self._use_heuristic)
                layer_out.append((lc, connect_here, sel))
            staged.append((rows, levels, layer_out))
            # this chunk is in the graph for the next chunk's scan
            levels_dev.index_copy_(0, rows_d[off: off + B],
                                   levels_d[off: off + B])
            levels_plan[rows] = levels
            run_max = max(run_max, top_batch)
            off += B
        # the device mirror now holds the planned levels (phase 2 sets
        # self._levels to the same values row by row)
        self._lv_snap = levels_plan
        return staged

    def _build_state_device(self):
        """Device mirrors of (levels, deleted), diffed against host
        snapshots so incremental commits send only changed rows."""
        cap = len(self._levels)
        if self._d_levels is None or self._d_levels.shape[0] != cap:
            self._d_levels = self._upload(self._levels)
            self._lv_snap = self._levels.copy()
            self._d_deleted = self._upload(self._deleted)
            self._del_snap = self._deleted.copy()
            return self._d_levels, self._d_deleted
        diff = np.flatnonzero(self._levels != self._lv_snap)
        if len(diff):
            self._d_levels.index_copy_(0, self._upload(diff),
                                       self._upload(self._levels[diff]))
            self._lv_snap[diff] = self._levels[diff]
        diffd = np.flatnonzero(self._deleted != self._del_snap)
        if len(diffd):
            self._d_deleted.index_copy_(0, self._upload(diffd),
                                        self._upload(self._deleted[diffd]))
            self._del_snap[diffd] = self._deleted[diffd]
        return self._d_levels, self._d_deleted

    def _link_chunk(self, rows: list[int], levels: np.ndarray,
                    layer_out) -> None:
        """Phase 2: host linking of one chunk from its device-selected
        neighbors (waits for the chunk's results)."""
        B = len(rows)
        for lc, connect_here, sel in layer_out:
            sel_np = sel.cpu().numpy()[:B][connect_here]
            self._connect_selected(lc, [rows[j] for j in connect_here],
                                   sel_np)
        for j, r in enumerate(rows):
            self._set_level(r, int(levels[j]))
        top = int(levels.max()) if B else -1
        if top > self._max_level:
            self._entry = rows[int(np.argmax(levels))]
            self._max_level = top

    def _set_level(self, row: int, lvl: int) -> None:
        self._levels[row] = lvl
        while len(self._upper) < lvl:
            self._upper.insert(0, np.full((len(self._levels), self.m), -1,
                                          dtype=np.int32))
            self._full_sync = True

    def _connect_selected(self, layer: int, rows: list[int],
                          sel: np.ndarray) -> None:
        """Link `rows` into `layer` given their heuristic-selected neighbors
        (sel i32[B, m], -1 padded)."""
        m_l = self.m0 if layer == 0 else self.m
        links = self._links0 if layer == 0 else self._upper[
            len(self._upper) - layer]
        dirty = self._dirty0 if layer == 0 else \
            self._dirty_upper.setdefault(layer, set())

        native = _hnsw_native_module()
        if native is not None:
            # C++ link-maintenance loop (csrc/hnsw_native.cpp)
            touched = native.connect_batch(
                links, self._host_vecs,
                np.asarray(rows, dtype=np.int32),
                np.ascontiguousarray(sel, dtype=np.int32), m_l,
                0 if self.metric == VectorMetric.L2 else 1)
            dirty.update(touched)
            return

        for j, row in enumerate(rows):
            nbrs = sel[j][sel[j] >= 0]
            nbrs = nbrs[nbrs != row][: m_l]
            links[row, :] = -1
            links[row, : len(nbrs)] = nbrs
            dirty.add(row)
            # reverse edges: a free slot, else the selection heuristic over
            # (existing + new) relative to s (reference:
            # mutuallyConnectNewElement, hnswalg.h:1043)
            for s in nbrs:
                srow = links[s]
                free = np.flatnonzero(srow < 0)
                if len(free):
                    links[s, free[0]] = row
                else:
                    cand = np.concatenate([srow, [row]])
                    d = self._host_dists(int(s), cand)
                    order = np.argsort(d, kind="stable")
                    kept: list[int] = []
                    for ci in order:
                        if len(kept) >= m_l:
                            break
                        c = int(cand[ci])
                        dq = d[ci]
                        dc = self._host_dists(c, np.asarray(kept,
                                                            dtype=np.int64)) \
                            if kept else np.empty(0)
                        if not len(dc) or (dc >= dq).all():
                            kept.append(c)
                    links[s, :] = -1
                    links[s, : len(kept)] = kept
                dirty.add(int(s))

    def _host_dists(self, center: int, ids: np.ndarray) -> np.ndarray:
        c = self._host_vecs[center]
        v = self._host_vecs[ids]
        if self.metric == VectorMetric.L2:
            return np.sum((v - c) ** 2, axis=1)
        return -v @ c

    # ------------------------------------------------------------------
    # device mirrors
    # ------------------------------------------------------------------
    def _sync_device(self) -> None:
        """Bring the link-table mirrors up to date. Each update builds new
        tensors, so a streaming session holding the old ones keeps them."""
        if self._full_sync or self._d_links0 is None \
                or self._d_links0.shape[0] != len(self._levels):
            self._d_links0 = self._upload(self._links0)
            self._d_upper = (self._upload(np.stack(self._upper))
                             if self._upper else None)
            self._dirty0.clear()
            self._dirty_upper.clear()
            self._full_sync = False
            return
        if self._dirty0:
            r = np.fromiter(self._dirty0, dtype=np.int64,
                            count=len(self._dirty0))
            self._d_links0 = self._d_links0.index_copy(
                0, self._upload(r), self._upload(self._links0[r]))
            self._dirty0.clear()
        if self._dirty_upper:
            if self._d_upper is None or \
                    self._d_upper.shape[0] != len(self._upper):
                self._d_upper = (self._upload(np.stack(self._upper))
                                 if self._upper else None)
            else:
                cap = len(self._levels)
                flat, vals = [], []
                for layer, rows in self._dirty_upper.items():
                    li = len(self._upper) - layer
                    r = np.fromiter(rows, dtype=np.int64, count=len(rows))
                    flat.append(li * cap + r)
                    vals.append(self._upper[li][r])
                lu, _, m = self._d_upper.shape
                self._d_upper = self._d_upper.view(-1, m).index_copy(
                    0, self._upload(np.concatenate(flat)),
                    self._upload(np.concatenate(vals))).view(lu, cap, m)
            self._dirty_upper.clear()

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def select_async(self, query: np.ndarray, params: KnnSearchParams):
        self._commit()
        if self._entry < 0:
            return lambda: SelectKeyResult.empty()
        k = params.k
        ef = getattr(params, "ef", None) or max(k or 10, 10)
        if k is not None:
            ef = max(ef, k)
        search_drain = self._search_batch_async(
            self.keeper.prepare_query(query)[None, :], ef)

        def drain() -> SelectKeyResult:
            scores, ids = search_drain()
            return self._result(scores[0], ids[0], params)

        return drain

    def select(self, query: np.ndarray, params: KnnSearchParams,
               ) -> SelectKeyResult:
        return self.select_async(query, params)()

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

    def _search_batch_async(self, queries: np.ndarray, ef: int):
        """Run the batched search (descent + beam on the device) and return
        a drain closure producing (scores, ids) [Q, ef] on the host, with
        deleted and empty slots filtered out (-inf / -1). Both come back in
        one device-to-host copy."""
        self._commit()
        self._sync_device()
        Q = queries.shape[0]
        qpad = _pow2(Q, _Q_BUCKET)
        q = np.zeros((qpad, self.dims), dtype=np.float32)
        q[:Q] = queries
        qd = self._upload(q)
        pack = self._pack(for_search=True)
        ents = torch.full((qpad,), self._entry, dtype=torch.int32,
                          device=self.keeper.device)
        if self._max_level > 0 and self._d_upper is not None:
            ents = greedy_descend(qd, pack, self._d_upper, ents, self.metric)
        ef_pad = _pow2(ef, 16)
        bs, bi = beam_search_layer(
            qd, pack, self._d_links0, ents[:, None],
            ef=ef_pad, expand=2, max_iters=2 * ef_pad, metric=self.metric)
        if pack.quantized:
            # exact fp32 re-rank of the quantized beam's results
            bs, bi = exact_rescore(qd, self.keeper.data, self.keeper.sq,
                                   bi, bs, self.metric)
        packed = torch.cat([bs[:Q].contiguous().view(torch.int32),
                            bi[:Q].to(torch.int32)], dim=1).cpu()
        deleted = self._deleted      # snapshot under the caller's lock

        def drain() -> tuple[np.ndarray, np.ndarray]:
            host = packed.numpy()
            width = host.shape[1] // 2
            s = host[:, :width].view(np.float32)
            i = host[:, width:]
            safe = np.where(i >= 0, i, 0)
            bad = (i < 0) | deleted[safe]
            s = np.where(bad, -np.inf, s)
            i = np.where(bad, -1, i)
            # re-sort after filtering
            order = np.argsort(-s, axis=1, kind="stable")
            return (np.take_along_axis(s, order, axis=1)[:, :ef],
                    np.take_along_axis(i, order, axis=1)[:, :ef])

        return drain

    def _search_batch(self, queries: np.ndarray, ef: int,
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Batched HNSW search; returns (scores, ids) [Q, ef] best-first with
        deleted/invalid rows filtered out (-inf/-1)."""
        return self._search_batch_async(queries, ef)()

    def select_batch_async(self, queries: np.ndarray,
                           params: KnnSearchParams):
        """Batched search (descent + layer-0 beam for all queries at once);
        returns the drain closure."""
        self._commit()
        queries = np.asarray(queries, dtype=np.float32)
        if self._entry < 0:
            res = [SelectKeyResult.empty() for _ in queries]
            return lambda: res
        k = params.k
        ef = getattr(params, "ef", None) or max(k or 10, 10)
        if k is not None:
            ef = max(ef, k)
        q = np.stack([self.keeper.prepare_query(v) for v in queries])
        search_drain = self._search_batch_async(q, ef)

        def drain() -> list[SelectKeyResult]:
            scores, ids = search_drain()
            return [self._result(scores[b], ids[b], params)
                    for b in range(len(queries))]

        return drain

    def select_batch(self, queries: np.ndarray, params: KnnSearchParams,
                     ) -> list[SelectKeyResult]:
        return self.select_batch_async(queries, params)()

    # ------------------------------------------------------------------
    def memstat(self) -> dict:
        st = super().memstat()
        st["levels"] = int(self._max_level)
        st["data_size"] += int(self._links0.nbytes
                               + sum(u.nbytes for u in self._upper))
        return st

    def state_dict(self) -> dict:
        """The reference's format, all numpy: keeper, levels, deleted,
        links0, upper (top-first), host_vecs, entry, max_level."""
        self._commit()
        return {
            "keeper": self.keeper.state_dict(),
            "levels": self._levels.copy(),
            "deleted": self._deleted.copy(),
            "links0": self._links0.copy(),
            "upper": [u.copy() for u in self._upper],
            "host_vecs": self._host_vecs.copy(),
            "entry": self._entry,
            "max_level": self._max_level,
        }

    def load_state_dict(self, state: dict) -> None:
        if "mesh_shards" in state:
            raise ParamsError(
                "a mesh HNSW snapshot needs a mesh, and mesh-resident "
                "indexes are not yet ported to reindexer_tpu_torch, see "
                "ROADMAP A12")
        self.clear()
        self.keeper.load_state_dict(state["keeper"])
        self._levels = np.array(state["levels"], dtype=np.int32)
        self._deleted = np.array(state["deleted"], dtype=np.bool_)
        self._links0 = np.array(state["links0"], dtype=np.int32)
        self._upper = [np.array(u, dtype=np.int32) for u in state["upper"]]
        self._host_vecs = np.array(state["host_vecs"], dtype=np.float32)
        self._entry = int(state["entry"])
        self._max_level = int(state["max_level"])
        self._full_sync = True
