"""Device-resident vector storage with capacity doubling (port of
reindexer_tpu/index/vector/keeper.py).

Vectors live in one [capacity, dims] fp32 tensor on the keeper's device,
indexed by namespace row id. Capacity is a power of two, at least 2048, and
doubles as rows arrive. Mutations buffer on the host and `flush` applies
them with in-place `index_copy_` (PyTorch runs eagerly, so the JAX keeper's
bucketed jitted scatters are not needed).

Validity rides `sq_eff` alone on the device: |b|^2 (L2) or 0 (IP/cosine) for
a valid row, SQ_EFF_BIG for an empty or removed one, which the scan kernels
turn into a score of about -1e30. Removed rows therefore keep their stale
data, and the JAX keeper's zeroed-rows rule and zero-vector nudge are not
needed. A host mirror of the validity mask serves the host-side questions
(count, ANY/EMPTY, get_host, state_dict) without a device round trip.

`sq` is the true |b|^2 of every row as the JAX keeper keeps it: written
with the row, left stale when the row is removed (the HNSW graph goes on
scoring removed nodes, which it still traverses), rounded as the JAX
keeper's `np.sum(v * v, dtype=np.float32)`. As in the JAX keeper, a flush
or bulk_load into an empty keeper writes the whole table, so rows it does
not write read as zero. With `copy_on_write` (the HNSW index) a mutation
writes new `data` and `sq` tensors instead of updating them in place, so a
streaming session that holds the old ones keeps its snapshot, as JAX
arrays do.

Mesh-resident mode (`attach_mesh`, the reference keeper's row sharding):
the tables split into `shards`, one `KeeperShard` a shard of the mesh,
shard s holding rows [s * capacity / S, (s + 1) * capacity / S) as tensors
of its own on its device, and `data`, `sq` and `sq_eff()` are None: the
engines scan shard by shard. A mutation writes each row into its shard;
growth re-splits the doubled table, since the blocks move. `take` gathers
rows from either layout. A keeper whose mesh spans processes holds only
its own shards and cannot grow.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.errors import ParamsError
from ...core.type_consts import VectorMetric

from ...ops.distance import normalize_rows
from ...ops.scan import SQ_EFF_BIG

_MIN_CAPACITY = 2048


class KeeperShard:
    """One shard's rows of a mesh keeper: global rows [lo, lo + rows) as
    data f32[rows, D], sq f32[rows] and sq_eff f32[rows] on its device."""
    __slots__ = ("lo", "data", "sq", "sq_eff")

    def __init__(self, lo: int, data: torch.Tensor, sq: torch.Tensor,
                 sq_eff: torch.Tensor):
        self.lo, self.data, self.sq, self.sq_eff = lo, data, sq, sq_eff


class VectorKeeper:
    def __init__(self, dims: int, metric: VectorMetric, device: torch.device,
                 start_size: int = _MIN_CAPACITY, copy_on_write: bool = False):
        if dims <= 0:
            raise ParamsError("vector dims must be > 0")
        self.dims = dims
        self.metric = metric
        self.device = torch.device(device)
        cap = _MIN_CAPACITY
        while cap < start_size:
            cap *= 2
        self.capacity = cap
        self.data = torch.zeros((cap, dims), dtype=torch.float32,
                                device=self.device)
        self.sq = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self._sq_eff = torch.full((cap,), SQ_EFF_BIG, dtype=torch.float32,
                                  device=self.device)
        self.copy_on_write = copy_on_write
        self.valid = np.zeros((cap,), dtype=np.bool_)   # host mirror
        self.count = 0       # number of valid vectors
        # bumped by every change of the device tables' rows (flush,
        # bulk_load, clear, load_state_dict): the SQ8 store re-encodes when
        # it moved, also where the count did not (an upsert of an existing
        # row, a reload to the same count)
        self.version = 0
        self._pending: dict[int, Optional[np.ndarray]] = {}
        self._max_row = -1
        # bulk_load into a fresh keeper rounds the rows to bf16 (IVF sets
        # this, as the JAX keeper's IVF upload does)
        self.upload_bf16 = False
        # mesh-resident mode (attach_mesh): one KeeperShard a shard, None
        # for a shard that another process holds
        self.mesh_ctx = None
        self.shards: Optional[list] = None

    # --- placement (mesh-resident mode) -----------------------------------
    def attach_mesh(self, ctx) -> None:
        """Row-shard the tables over the mesh. Capacities are powers of
        two (>= 2048), so any power-of-two shard count divides them."""
        if ctx is None or ctx.n_shards <= 1:
            return
        if self.capacity % ctx.n_shards:
            raise ParamsError(
                f"mesh shard count {ctx.n_shards} must divide the keeper "
                f"capacity {self.capacity} (use a power-of-two mesh)")
        self.mesh_ctx = ctx
        self._split(self.data, self.sq, self._sq_eff)

    def _split(self, data: torch.Tensor, sq: torch.Tensor,
               sq_eff: torch.Tensor) -> None:
        """Cut whole [capacity] tables into the shards' row blocks, each a
        copy on its shard's device."""
        per = self.capacity // self.mesh_ctx.n_shards
        self.shards = [
            None if dev is None else KeeperShard(
                s * per, data[s * per:(s + 1) * per].to(dev, copy=True),
                sq[s * per:(s + 1) * per].to(dev, copy=True),
                sq_eff[s * per:(s + 1) * per].to(dev, copy=True))
            for s, dev in enumerate(self.mesh_ctx.devices)]
        self.data = self.sq = self._sq_eff = None

    def local_shards(self) -> list:
        """(shard index, KeeperShard) of every shard this process holds."""
        return [(s, sh) for s, sh in enumerate(self.shards)
                if sh is not None]

    def _by_shard(self, rows: np.ndarray):
        """(shard, positions in rows, local rows on its device) for each
        local shard that rows (sorted or not) reach."""
        per = self.capacity // len(self.shards)
        s_of = rows // per
        for s in np.unique(s_of):
            sh = self.shards[int(s)]
            if sh is None:
                continue
            pos = np.flatnonzero(s_of == s)
            yield sh, pos, torch.from_numpy(
                (rows[pos] - sh.lo).astype(np.int64)).to(sh.data.device)

    # --- mutation -------------------------------------------------------
    def set(self, row_id: int, vec: Optional[np.ndarray]) -> None:
        """Upsert a vector (None => empty vector, excluded from KNN)."""
        if vec is not None:
            vec = np.asarray(vec, dtype=np.float32).reshape(-1)
            if vec.shape[0] != self.dims:
                raise ParamsError(
                    f"vector dims mismatch: got {vec.shape[0]}, index has {self.dims}")
            if self.metric == VectorMetric.COSINE:
                vec = normalize_rows(vec[None, :])[0]
        self._pending[row_id] = vec
        self._max_row = max(self._max_row, row_id)

    def remove(self, row_id: int) -> None:
        self._pending[row_id] = None
        self._max_row = max(self._max_row, row_id)

    def _sq_eff_of(self, sq: np.ndarray) -> np.ndarray:
        """sq_eff of valid rows whose |b|^2 is sq."""
        return sq if self.metric == VectorMetric.L2 else np.zeros_like(sq)

    def _fresh_tables(self) -> None:
        """New zero data and sq tables (an empty keeper's flush or
        bulk_load writes the whole table, as the JAX keeper's does)."""
        self.data = torch.zeros_like(self.data)
        self.sq = torch.zeros_like(self.sq)

    def _own_tables(self, fresh: bool) -> None:
        """Make data and sq safe to update in place: zero tables for an
        empty keeper, copies under copy_on_write."""
        if fresh:
            self._fresh_tables()
        elif self.copy_on_write:
            self.data = self.data.clone()
            self.sq = self.sq.clone()

    # --- device sync ----------------------------------------------------
    def _grow_to(self, need: int) -> None:
        if need <= self.capacity:
            return
        cap = self.capacity
        while cap < need:
            cap *= 2
        pad = cap - self.capacity
        if self.shards is not None:
            self._grow_mesh(cap)
            return
        self.data = torch.cat([self.data, torch.zeros(
            (pad, self.dims), dtype=torch.float32, device=self.device)])
        self.sq = torch.cat([self.sq, torch.zeros(
            (pad,), dtype=torch.float32, device=self.device)])
        self._sq_eff = torch.cat([self._sq_eff, torch.full(
            (pad,), SQ_EFF_BIG, dtype=torch.float32, device=self.device)])
        self.valid = np.concatenate([self.valid, np.zeros(pad, np.bool_)])
        self.capacity = cap

    def _grow_mesh(self, cap: int) -> None:
        """Double a mesh keeper: its blocks move, so the table is joined on
        the merge device, padded and split again."""
        if self.mesh_ctx.spans_processes:
            raise ParamsError(
                f"a keeper sharded across processes cannot grow past its "
                f"capacity {self.capacity}: open the index with a "
                f"start_size of the rows it will hold")
        dev = self.mesh_ctx.merge_device
        pad = cap - self.capacity

        def joined(name, fill, shape):
            parts = [getattr(sh, name).to(dev) for sh in self.shards]
            return torch.cat(parts + [torch.full(shape, fill,
                                                 dtype=torch.float32,
                                                 device=dev)])

        data = joined("data", 0.0, (pad, self.dims))
        sq = joined("sq", 0.0, (pad,))
        sq_eff = joined("sq_eff", SQ_EFF_BIG, (pad,))
        self.valid = np.concatenate([self.valid, np.zeros(pad, np.bool_)])
        self.capacity = cap
        self._split(data, sq, sq_eff)

    def _rows(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def flush(self) -> None:
        """Apply pending host mutations to the device tensors."""
        if not self._pending:
            return
        self._grow_to(self._max_row + 1)
        items = sorted(self._pending.items())
        self._pending.clear()
        self.version += 1
        all_rows = np.fromiter((r for r, _ in items), dtype=np.int64,
                               count=len(items))
        prev_valid = int(self.valid[all_rows].sum())
        fresh = self.count == 0
        set_items = [(r, v) for r, v in items if v is not None]
        del_rows = np.asarray([r for r, v in items if v is None],
                              dtype=np.int64)
        self.count += len(set_items) - prev_valid
        if self.shards is not None:
            self._flush_mesh(del_rows, set_items, fresh)
            return
        if len(del_rows):
            self._sq_eff.index_fill_(0, self._rows(del_rows), SQ_EFF_BIG)
            self.valid[del_rows] = False
        if set_items:
            rows = np.fromiter((r for r, _ in set_items), dtype=np.int64,
                               count=len(set_items))
            vals = np.stack([v for _, v in set_items])
            sq = np.sum(vals * vals, axis=1, dtype=np.float32)
            rows_d = self._rows(rows)
            self._own_tables(fresh)
            self.data.index_copy_(0, rows_d,
                                  torch.from_numpy(vals).to(self.device))
            self.sq.index_copy_(0, rows_d, torch.from_numpy(sq).to(
                self.device))
            self._sq_eff.index_copy_(0, rows_d, torch.from_numpy(
                self._sq_eff_of(sq)).to(self.device))
            self.valid[rows] = True

    def _flush_mesh(self, del_rows: np.ndarray, set_items: list,
                    fresh: bool) -> None:
        """flush's device writes on a mesh keeper, shard by shard."""
        for sh, _, loc in self._by_shard(del_rows):
            sh.sq_eff.index_fill_(0, loc, SQ_EFF_BIG)
        self.valid[del_rows] = False
        if not set_items:
            return
        rows = np.fromiter((r for r, _ in set_items), dtype=np.int64,
                           count=len(set_items))
        vals = np.stack([v for _, v in set_items])
        sq = np.sum(vals * vals, axis=1, dtype=np.float32)
        sq_eff = self._sq_eff_of(sq)
        if fresh:
            self._zero_shards()
        elif self.copy_on_write:
            for _, sh in self.local_shards():
                sh.data, sh.sq = sh.data.clone(), sh.sq.clone()
        for sh, pos, loc in self._by_shard(rows):
            dev = sh.data.device
            sh.data.index_copy_(0, loc, torch.from_numpy(vals[pos]).to(dev))
            sh.sq.index_copy_(0, loc, torch.from_numpy(sq[pos]).to(dev))
            sh.sq_eff.index_copy_(0, loc,
                                  torch.from_numpy(sq_eff[pos]).to(dev))
        self.valid[rows] = True

    def _zero_shards(self) -> None:
        """New zero data and sq tables in every local shard (the mesh form
        of _fresh_tables)."""
        for _, sh in self.local_shards():
            sh.data, sh.sq = torch.zeros_like(sh.data), torch.zeros_like(
                sh.sq)

    def _write_block_mesh(self, start: int, data: torch.Tensor,
                          sq: np.ndarray, sq_eff: np.ndarray) -> None:
        """Write host rows [start, start + len(data)) into their shards."""
        end = start + data.shape[0]
        per = self.capacity // len(self.shards)
        for _, sh in self.local_shards():
            lo, hi = max(start, sh.lo), min(end, sh.lo + per)
            if lo >= hi:
                continue
            dev = sh.data.device
            src = slice(lo - start, hi - start)
            dst = slice(lo - sh.lo, hi - sh.lo)
            sh.data[dst] = data[src].to(dev).to(torch.float32)
            sh.sq[dst] = torch.from_numpy(sq[src]).to(dev)
            sh.sq_eff[dst] = torch.from_numpy(sq_eff[src]).to(dev)

    def clear(self) -> None:
        self._pending.clear()
        self.version += 1
        self._max_row = -1
        self.count = 0
        self.valid[:] = False
        if self.shards is not None:
            self._zero_shards()
            for _, sh in self.local_shards():
                sh.sq_eff.fill_(SQ_EFF_BIG)
            return
        self._fresh_tables()
        self._sq_eff.fill_(SQ_EFF_BIG)

    def bulk_load(self, matrix: np.ndarray, start_row: int = 0) -> None:
        """Ingest a [N, dims] block in one host-to-device copy (the fast
        path for loaders and benchmarks). With `upload_bf16` set, a fresh
        keeper (count 0) stores the rows rounded to bf16 (to nearest even,
        as ml_dtypes rounds in the JAX keeper), ships them as bf16 and
        widens them on the device; |b|^2 comes from the rounded rows. Into
        an empty keeper, rows outside the block become zero."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or matrix.shape[1] != self.dims:
            raise ParamsError("bulk_load expects [N, dims] float32")
        if self.metric == VectorMetric.COSINE:
            matrix = normalize_rows(matrix).astype(np.float32)
        n = matrix.shape[0]
        self.flush()
        self.version += 1
        self._grow_to(start_row + n)
        end = start_row + n
        src = torch.from_numpy(matrix)
        fresh = self.count == 0
        if self.upload_bf16 and fresh:
            src = src.to(torch.bfloat16)
            matrix = src.to(torch.float32).numpy()
        sq = np.sum(matrix * matrix, axis=1, dtype=np.float32)
        if self.shards is not None:
            if fresh:
                self._zero_shards()
            self._write_block_mesh(start_row, src, sq, self._sq_eff_of(sq))
        else:
            self._own_tables(fresh)
            self._write_block(start_row, end, src, sq)
        self.count += n - int(self.valid[start_row:end].sum())
        self.valid[start_row:end] = True
        self._max_row = max(self._max_row, end - 1)

    def _write_block(self, start_row: int, end: int, src: torch.Tensor,
                     sq: np.ndarray) -> None:
        self.data[start_row:end] = src.to(self.device).to(torch.float32)
        self.sq[start_row:end] = torch.from_numpy(sq).to(self.device)
        self._sq_eff[start_row:end] = torch.from_numpy(
            self._sq_eff_of(sq)).to(self.device)

    def sq_eff(self) -> torch.Tensor:
        """f32[capacity] on the device: |b|^2 (L2) or 0 (IP/cosine) for
        valid rows, SQ_EFF_BIG for invalid ones. Updated in place by
        flush, in stream order with the scans that read it. None on a mesh
        keeper (each KeeperShard has its own)."""
        return self._sq_eff

    def take(self, rows: np.ndarray) -> torch.Tensor:
        """data[rows] f32[len(rows), D]: on the keeper's device, or on a
        mesh keeper gathered from the shards onto the merge device."""
        rows = np.asarray(rows, dtype=np.int64)
        if self.shards is None:
            return self.data[self._rows(rows)]
        dev = self.mesh_ctx.merge_device
        out = torch.empty((len(rows), self.dims), dtype=torch.float32,
                          device=dev)
        seen = np.zeros(len(rows), np.bool_)
        for sh, pos, loc in self._by_shard(rows):
            out[torch.from_numpy(pos).to(dev)] = sh.data[loc].to(dev)
            seen[pos] = True
        if not seen.all():
            raise ParamsError("rows held by another process's shards "
                              "cannot be read here")
        return out

    # --- access ---------------------------------------------------------
    def prepare_query(self, vec: np.ndarray) -> np.ndarray:
        vec = np.asarray(vec, dtype=np.float32).reshape(-1)
        if vec.shape[0] != self.dims:
            raise ParamsError(
                f"query vector dims mismatch: got {vec.shape[0]}, index has {self.dims}")
        if self.metric == VectorMetric.COSINE:
            vec = normalize_rows(vec[None, :])[0]
        return vec

    def get_host(self, row_id: int) -> Optional[np.ndarray]:
        if row_id in self._pending:
            v = self._pending[row_id]
            return None if v is None else v.copy()
        if row_id >= self.capacity or not self.valid[row_id]:
            return None
        return self.take(np.asarray([row_id]))[0].to(
            "cpu", copy=True).numpy()

    def memstat(self) -> dict:
        return {
            "vectors": self.count,
            "capacity": self.capacity,
            "data_size": int(self.capacity * self.dims * 4),
        }

    def state_dict(self) -> dict:
        """{"data": f32[rows, dims], "valid": bool[rows]} as numpy, the
        JAX keeper's format; rows not valid hold no meaningful data."""
        self.flush()
        n = self._max_row + 1
        return {"data": self.take(np.arange(n)).to("cpu", copy=True).numpy(),
                "valid": self.valid[:n].copy()}

    def load_state_dict(self, state: dict) -> None:
        data = np.array(state["data"], dtype=np.float32, copy=True)
        valid = np.asarray(state["valid"], dtype=np.bool_)
        if data.ndim != 2 or data.shape[1] != self.dims or valid.shape != (
                data.shape[0],):
            raise ParamsError(
                f"keeper state must be data [rows, {self.dims}] and valid "
                f"[rows], got {data.shape} and {valid.shape}")
        self.clear()
        n = data.shape[0]
        if not n:
            return
        self._grow_to(n)
        sq = np.sum(data * data, axis=1, dtype=np.float32)
        sq_eff = np.where(valid, self._sq_eff_of(sq),
                          np.float32(SQ_EFF_BIG)).astype(np.float32)
        if self.shards is not None:
            self._write_block_mesh(0, torch.from_numpy(data), sq, sq_eff)
        else:
            self.data[:n] = torch.from_numpy(data).to(self.device)
            self.sq[:n] = torch.from_numpy(sq).to(self.device)
            self._sq_eff[:n] = torch.from_numpy(sq_eff).to(self.device)
        self.valid[:n] = valid
        self.count = int(valid.sum())
        self._max_row = n - 1
