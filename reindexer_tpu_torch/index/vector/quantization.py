"""SQ8 scalar quantization of a vector keeper (port of
reindexer_tpu/index/vector/quantization.py).

8-bit per-component codes on an affine grid x ~ lo + alpha * code, with
lo / hi the per-dimension left / right quantiles of the data (the reference
scalar quantizer, scalar_quantization/quantizer.h:11-75). The store
activates once the keeper holds `min_elements` vectors, re-encodes on the
same grid when the vector count changes, and re-quantizes when the count
doubles, the capacity grows, or the data drifts outside the grid.

The quantile step stays on the host, on the JAX store's 65,536-row sample
(`np.random.default_rng(7)`) and `np.quantile`, so `lo` and `alpha` are
bit-identical to the JAX store's on the same keeper state; only the sampled
rows leave the device. Codes (u8, one copy: the int8 scan makes them signed
in registers), the per-dimension error bounds and the drift test are computed
on the keeper's device. On a mesh keeper the codes split like its rows:
`shard_codes[s]` (and the grid `shard_grid[s]`) on shard s's device; the
error bounds, which only exact SQ8 reads and a mesh serves exact SQ8 from
the fp32 rows, are not kept there. Validity is the keeper's: `sq_eff < SQ_EFF_BIG / 2`
on the device, the host mirror `valid` on the host (removed rows keep stale
data, so their values never decide anything).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.type_consts import VectorMetric

from ...ops.distance import chunked_topk
from ...ops.scan import SQ_EFF_BIG

_SAMPLE_ROWS = 65536
_SAMPLE_SEED = 7


def _encode(data: torch.Tensor, lo: torch.Tensor, inv_alpha: torch.Tensor,
            ) -> torch.Tensor:
    """u8 codes of data f32[N, D] on the grid (lo, 1 / alpha): round half to
    even of (x - lo) / alpha, clipped to 0..255."""
    x = ((data - lo[None, :]) * inv_alpha[None, :]).clamp(0.0, 255.0)
    return torch.round(x).to(torch.uint8)


def _max_abs_err(data: torch.Tensor, valid: torch.Tensor, codes: torch.Tensor,
                 lo: torch.Tensor, alpha: torch.Tensor,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension (max, mean square) of |b - dequant(b)| over the valid
    rows. The max certifies knn_scan_sq8's "cert" eps; the mean square sizes
    its "fast" eps. lo + alpha * code is rounded once, as a fused
    multiply-add (the JAX version's compiled form), through float64, where
    the product is exact; the squares are summed in float64."""
    vm = valid[:, None].to(torch.float32)
    f64 = torch.float64
    deq = (lo.to(f64)[None, :]
           + alpha.to(f64)[None, :] * codes.to(f64)).to(torch.float32)
    err = (data - deq).abs() * vm
    denom = vm.sum().clamp_min(1.0)
    ms = (err.to(f64) ** 2).sum(dim=0) / denom
    return err.amax(dim=0), ms.to(torch.float32)


def knn_scan_quantized(queries: torch.Tensor, codes: torch.Tensor,
                       lo: torch.Tensor, alpha: torch.Tensor,
                       valid: torch.Tensor, base_sq: torch.Tensor, k: int,
                       metric: VectorMetric, chunk: int = 262144,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the quantized scores 2 (q.lo + (q * alpha).codes) - |b|^2 -
    |q|^2 (L2) or q.lo + (q * alpha).codes (IP/cosine): the plain chunked
    scan, decoding one chunk of codes at a time. Returns (scores f32[Q, k],
    ids i32[Q, k]), -inf / -1 padded."""
    q = queries.to(torch.float32)
    q_alpha = q * alpha[None, :]
    q_lo = (q @ lo)[:, None]
    q_sq = (q * q).sum(dim=1, keepdim=True)

    def scores_of(rows):
        dots = q_alpha @ codes[rows].to(torch.float32).T + q_lo
        if metric == VectorMetric.L2:
            return 2.0 * dots - base_sq[None, rows] - q_sq
        return dots

    return chunked_topk(codes.shape[0], q, k, chunk, scores_of, valid)


class QuantizedStore:
    """Quantized mirror of a VectorKeeper's data, on the keeper's device."""

    def __init__(self, left_quantile: float, right_quantile: float,
                 min_elements: int):
        self.left_q = left_quantile
        self.right_q = right_quantile
        self.min_elements = max(int(min_elements), 1)
        self.codes: Optional[torch.Tensor] = None    # u8[capacity, D]
        self.lo: Optional[torch.Tensor] = None       # f32[D]
        self.alpha: Optional[torch.Tensor] = None    # f32[D]
        # per-dimension max and mean-square |b - dequant(b)| over valid rows
        self.err_dims: Optional[torch.Tensor] = None
        self.ms_dims: Optional[torch.Tensor] = None
        self._quantized_count = 0
        self._quantized_version = -1    # the keeper's version last encoded
        self._capacity = 0              # the keeper's capacity last encoded
        # mesh keeper: u8[capacity / S, D] codes and (lo, alpha) per shard
        # on its device (None for another process's shard)
        self.shard_codes: Optional[list] = None
        self.shard_grid: Optional[list] = None

    @property
    def active(self) -> bool:
        return self.codes is not None or self.shard_codes is not None

    def need_requantize(self, count: int, capacity: int) -> bool:
        """(reference: Quantizer::NeedRequantize; here: the count doubled or
        the capacity changed since the last quantization)"""
        if not self.active:
            return count >= self.min_elements
        if self._capacity != capacity:
            return True
        return count >= 2 * max(self._quantized_count, 1)

    def need_refresh(self, count: int, version: Optional[int] = None) -> bool:
        """Codes stale (rows added, removed or rewritten since the last
        encode: the keeper's count or, when given, its version moved) while
        the grid still holds: re-encode without new quantiles. The
        reference tests the count alone, so an upsert of an existing row
        keeps its stale codes there; the engines pass the version."""
        return self.active and (count != self._quantized_count or (
            version is not None and version != self._quantized_version))

    def _encode_keeper(self, keeper) -> None:
        lo, alpha = self.lo, self.alpha
        self._quantized_count = keeper.count
        self._quantized_version = keeper.version
        self._capacity = keeper.capacity
        if keeper.shards is not None:
            self.shard_grid = [None if sh is None else
                               (lo.to(sh.data.device),
                                alpha.to(sh.data.device))
                               for sh in keeper.shards]
            self.shard_codes = [None if sh is None else
                                _encode(sh.data, g[0], 1.0 / g[1])
                                for sh, g in zip(keeper.shards,
                                                 self.shard_grid)]
            return
        self.codes = _encode(keeper.data, lo, 1.0 / alpha)
        valid = keeper.sq_eff() < SQ_EFF_BIG / 2
        self.err_dims, self.ms_dims = _max_abs_err(keeper.data, valid,
                                                   self.codes, lo, alpha)

    def refresh(self, keeper) -> None:
        """Re-encode on the existing grid, unless the data drifted outside
        it (by 5% of its span), which re-quantizes (reference:
        Quantizer::NeedRequantize's outlier test)."""
        keeper.flush()
        if keeper.count:
            tables = ([(keeper.data, keeper.sq_eff())]
                      if keeper.shards is None else
                      [(sh.data, sh.sq_eff) for _, sh in
                       keeper.local_shards()])
            d_max = np.full(keeper.dims, -np.inf, np.float32)
            d_min = np.full(keeper.dims, np.inf, np.float32)
            for data, sq_eff in tables:
                valid = (sq_eff < SQ_EFF_BIG / 2)[:, None]
                d_max = np.maximum(d_max, torch.where(
                    valid, data, float("-inf")).amax(0).cpu().numpy())
                d_min = np.minimum(d_min, torch.where(
                    valid, data, float("inf")).amin(0).cpu().numpy())
            lo = self.lo.cpu().numpy()
            hi = lo + self.alpha.cpu().numpy() * 255.0
            span = np.maximum(hi - lo, 1e-12)
            if (np.any(d_max > hi + 0.05 * span)
                    or np.any(d_min < lo - 0.05 * span)):
                self.quantize(keeper)
                return
        self._encode_keeper(keeper)

    def quantize(self, keeper) -> None:
        """Per-dimension quantiles of a row sample, then encode (reference:
        ComponentNthQuantiles, quantizer.h:11-75)."""
        keeper.flush()
        rows = np.flatnonzero(keeper.valid)
        if len(rows) == 0:
            return
        sample = rows if len(rows) <= _SAMPLE_ROWS else \
            np.random.default_rng(_SAMPLE_SEED).choice(rows, _SAMPLE_ROWS,
                                                       replace=False)
        data_s = keeper.take(sample).cpu().numpy()
        lo = np.quantile(data_s, self.left_q, axis=0).astype(np.float32)
        hi = np.quantile(data_s, self.right_q, axis=0).astype(np.float32)
        alpha = np.maximum((hi - lo) / 255.0, 1e-12).astype(np.float32)
        self.lo = torch.from_numpy(lo).to(keeper.device)
        self.alpha = torch.from_numpy(alpha).to(keeper.device)
        self._encode_keeper(keeper)

    def memstat(self) -> dict:
        if not self.active:
            return {"quantized": False}
        return {
            "quantized": True,
            "quantized_size": int(self._capacity * self.lo.shape[0]),
        }

    def state_dict(self) -> dict:
        """{"lo", "alpha": f32[D] numpy, "quantized_count": int}, the JAX
        store's format; {} while inactive."""
        if not self.active:
            return {}
        return {"lo": self.lo.cpu().numpy(), "alpha": self.alpha.cpu().numpy(),
                "quantized_count": self._quantized_count}

    def load_state_dict(self, state: dict, keeper) -> None:
        """Take the grid from `state` and re-encode the keeper's data on it."""
        if not state:
            return
        keeper.flush()
        self.lo = torch.from_numpy(
            np.asarray(state["lo"], dtype=np.float32)).to(keeper.device)
        self.alpha = torch.from_numpy(
            np.asarray(state["alpha"], dtype=np.float32)).to(keeper.device)
        self._encode_keeper(keeper)
        self._quantized_count = int(state["quantized_count"])
