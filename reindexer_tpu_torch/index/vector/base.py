"""Float-vector index base (port of reindexer_tpu/index/vector/base.py).

dims/metric checks, empty-vector bookkeeping, rank ordering per metric,
radius filtering and the select facade of the vector engines, over a
PyTorch `VectorKeeper` on an explicit device. Ranks returned to the planner
are the metric values themselves (L2 distance ascending, similarity
descending).
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from ... import tracing
from ...core.errors import ParamsError
from ...core.payload import IndexDef
from ...core.type_consts import CondType, RankOrdering
from ...index.base import Index, SelectKeyResult
from ...index.vector.params import KnnSearchParams

from ...ops.distance import metric_ordering
from .keeper import VectorKeeper

dispatches = tracing.counter("engine.dispatches")


def engine_boundary(select_batch_async):
    """A vector engine's `select_batch_async`, counted in
    `engine.dispatches`; while tracing is on, the dispatch (entry to
    return) is an `engine.dispatch` span and the drain it returns an
    `engine.drain` span."""
    @functools.wraps(select_batch_async)
    def dispatch(self, queries, params):
        dispatches.add()
        if not tracing.on:
            return select_batch_async(self, queries, params)
        with tracing.span("engine.dispatch", queries=len(queries)):
            drain = select_batch_async(self, queries, params)

        def traced_drain():
            with tracing.span("engine.drain"):
                return drain()
        return traced_drain
    return dispatch


class FloatVectorIndexBase(Index):
    # True for an index whose readers may hold the keeper's tensors across
    # mutations (HNSW's streaming sessions): the keeper then writes new
    # tensors instead of updating them in place
    KEEPER_COPY_ON_WRITE = False

    def __init__(self, definition: IndexDef, device: torch.device):
        super().__init__(definition)
        vo = definition.vector_opts
        if vo is None:
            raise ParamsError(f"index '{definition.name}' has no vector_opts")
        self.dims = vo.dims
        self.metric = vo.metric
        self.ordering = metric_ordering(self.metric)
        self.keeper = VectorKeeper(vo.dims, vo.metric, device, vo.start_size,
                                   copy_on_write=self.KEEPER_COPY_ON_WRITE)
        self._mesh_ctx = None   # mesh-resident mode (attach_mesh)

    def attach_mesh(self, ctx) -> None:
        """Switch the index into mesh-resident mode (parallel/context.py):
        the keeper's rows split over the mesh's shards and selects scan
        every shard and merge the per-shard top-k, behind the same select /
        select_batch API. Subclasses with per-shard structure (HNSW
        subgraphs) override."""
        if ctx is None or ctx.n_shards <= 1:
            return
        self._mesh_ctx = ctx
        self.keeper.attach_mesh(ctx)

    # --- Index interface ------------------------------------------------
    def upsert(self, row_id: int, values: Any) -> None:
        if values is None or (isinstance(values, (list, tuple, np.ndarray))
                              and len(values) == 0):
            self.keeper.set(row_id, None)  # empty vector: excluded from KNN
            return
        self.keeper.set(row_id, np.asarray(values, dtype=np.float32))

    def delete(self, row_id: int, values: Any) -> None:
        self.keeper.remove(row_id)

    def supports(self, condition: CondType) -> bool:
        return condition in (CondType.KNN, CondType.ANY, CondType.EMPTY)

    def select_key(self, condition: CondType, values: tuple, **kw) -> SelectKeyResult:
        if condition in (CondType.ANY, CondType.EMPTY):
            self.keeper.flush()
            valid = self.keeper.valid
            ids = np.flatnonzero(valid if condition == CondType.ANY else ~valid)
            return SelectKeyResult(ids.astype(np.int64))
        raise ParamsError(
            f"float_vector index '{self.name}' supports only KNN/ANY/EMPTY conditions")

    def clear(self) -> None:
        self.keeper.clear()

    # --- KNN ------------------------------------------------------------
    def select(self, query: np.ndarray, params: KnnSearchParams) -> SelectKeyResult:
        raise NotImplementedError

    def select_batch(self, queries: np.ndarray, params: KnnSearchParams,
                     ) -> list[SelectKeyResult]:
        return [self.select(q, params) for q in np.asarray(queries)]

    def _apply_radius(self, ranks: np.ndarray, ids: np.ndarray,
                      radius: Optional[float]) -> tuple[np.ndarray, np.ndarray]:
        """Keep ranks strictly better than radius (L2: rank < radius;
        IP/cosine: rank > radius)."""
        if radius is None:
            return ranks, ids
        if self.ordering == RankOrdering.ASC:
            keep = ranks < radius
        else:
            keep = ranks > radius
        return ranks[keep], ids[keep]

    def memstat(self) -> dict:
        st = self.keeper.memstat()
        st["name"] = self.name
        st["unique_keys_count"] = st["vectors"]
        return st

    def state_dict(self) -> dict:
        return {"keeper": self.keeper.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.keeper.load_state_dict(state["keeper"])
