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


class VectorKeeper:
    def __init__(self, dims: int, metric: VectorMetric, device: torch.device,
                 start_size: int = _MIN_CAPACITY):
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
        self._sq_eff = torch.full((cap,), SQ_EFF_BIG, dtype=torch.float32,
                                  device=self.device)
        self.valid = np.zeros((cap,), dtype=np.bool_)   # host mirror
        self.count = 0       # number of valid vectors
        self._pending: dict[int, Optional[np.ndarray]] = {}
        self._max_row = -1
        # bulk_load into a fresh keeper rounds the rows to bf16 (IVF sets
        # this, as the JAX keeper's IVF upload does)
        self.upload_bf16 = False

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

    def _sq_eff_of(self, vals: np.ndarray) -> np.ndarray:
        if self.metric == VectorMetric.L2:
            return np.sum(vals * vals, axis=1, dtype=np.float32)
        return np.zeros((len(vals),), dtype=np.float32)

    # --- device sync ----------------------------------------------------
    def _grow_to(self, need: int) -> None:
        if need <= self.capacity:
            return
        cap = self.capacity
        while cap < need:
            cap *= 2
        pad = cap - self.capacity
        self.data = torch.cat([self.data, torch.zeros(
            (pad, self.dims), dtype=torch.float32, device=self.device)])
        self._sq_eff = torch.cat([self._sq_eff, torch.full(
            (pad,), SQ_EFF_BIG, dtype=torch.float32, device=self.device)])
        self.valid = np.concatenate([self.valid, np.zeros(pad, np.bool_)])
        self.capacity = cap

    def _rows(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def flush(self) -> None:
        """Apply pending host mutations to the device tensors."""
        if not self._pending:
            return
        self._grow_to(self._max_row + 1)
        items = sorted(self._pending.items())
        self._pending.clear()
        all_rows = np.fromiter((r for r, _ in items), dtype=np.int64,
                               count=len(items))
        prev_valid = int(self.valid[all_rows].sum())
        set_items = [(r, v) for r, v in items if v is not None]
        del_rows = np.asarray([r for r, v in items if v is None],
                              dtype=np.int64)
        self.count += len(set_items) - prev_valid
        if len(del_rows):
            self._sq_eff.index_fill_(0, self._rows(del_rows), SQ_EFF_BIG)
            self.valid[del_rows] = False
        if set_items:
            rows = np.fromiter((r for r, _ in set_items), dtype=np.int64,
                               count=len(set_items))
            vals = np.stack([v for _, v in set_items])
            rows_d = self._rows(rows)
            self.data.index_copy_(0, rows_d,
                                  torch.from_numpy(vals).to(self.device))
            self._sq_eff.index_copy_(0, rows_d, torch.from_numpy(
                self._sq_eff_of(vals)).to(self.device))
            self.valid[rows] = True

    def clear(self) -> None:
        self._pending.clear()
        self._max_row = -1
        self.count = 0
        self.data.zero_()
        self._sq_eff.fill_(SQ_EFF_BIG)
        self.valid[:] = False

    def bulk_load(self, matrix: np.ndarray, start_row: int = 0) -> None:
        """Ingest a [N, dims] block in one host-to-device copy (the fast
        path for loaders and benchmarks). With `upload_bf16` set, a fresh
        keeper (count 0) stores the rows rounded to bf16 (to nearest even,
        as ml_dtypes rounds in the JAX keeper), ships them as bf16 and
        widens them on the device; |b|^2 comes from the rounded rows."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or matrix.shape[1] != self.dims:
            raise ParamsError("bulk_load expects [N, dims] float32")
        if self.metric == VectorMetric.COSINE:
            matrix = normalize_rows(matrix).astype(np.float32)
        n = matrix.shape[0]
        self.flush()
        self._grow_to(start_row + n)
        end = start_row + n
        src = torch.from_numpy(matrix)
        if self.upload_bf16 and self.count == 0:
            src = src.to(torch.bfloat16)
            if self.metric == VectorMetric.L2:
                matrix = src.to(torch.float32).numpy()
        self.data[start_row:end] = src.to(self.device).to(torch.float32)
        self._sq_eff[start_row:end] = torch.from_numpy(
            self._sq_eff_of(matrix)).to(self.device)
        self.count += n - int(self.valid[start_row:end].sum())
        self.valid[start_row:end] = True
        self._max_row = max(self._max_row, end - 1)

    def sq_eff(self) -> torch.Tensor:
        """f32[capacity] on the device: |b|^2 (L2) or 0 (IP/cosine) for
        valid rows, SQ_EFF_BIG for invalid ones. Updated in place by
        flush, in stream order with the scans that read it."""
        return self._sq_eff

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
        return self.data[row_id].to("cpu", copy=True).numpy()

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
        return {"data": self.data[:n].to("cpu", copy=True).numpy(),
                "valid": self.valid[:n].copy()}

    def load_state_dict(self, state: dict) -> None:
        data = np.ascontiguousarray(state["data"], dtype=np.float32)
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
        self.data[:n] = torch.from_numpy(data).to(self.device)
        sq_eff = np.where(valid, self._sq_eff_of(data),
                          np.float32(SQ_EFF_BIG)).astype(np.float32)
        self._sq_eff[:n] = torch.from_numpy(sq_eff).to(self.device)
        self.valid[:n] = valid
        self.count = int(valid.sum())
        self._max_row = n - 1
