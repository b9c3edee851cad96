"""Index base interface.

Semantic equivalent of the reference's abstract `Index`
(cpp_src/core/index/index.h:73-88: Upsert/Delete/SelectKey/Commit) with a
batched, id-array-oriented contract: SelectKey returns a `SelectKeyResult`
holding a row-id array (the analog of the reference's IdSet posting
container, cpp_src/core/idset/idset.h) plus optional ranks for ranked
(FT / KNN) indexes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from ..core.errors import QueryError
from ..core.payload import IndexDef
from ..core.type_consts import CondType, RankOrdering


@dataclasses.dataclass
class SelectKeyResult:
    """Result of one index lookup: matching row ids (+ ranks if ranked)."""

    ids: np.ndarray                      # int64 row ids
    ranks: Optional[np.ndarray] = None   # float32 aligned to ids
    ordering: RankOrdering = RankOrdering.DESC
    # True when the index could not serve the condition and the planner must
    # fall back to a column comparator (reference: comparators fallback,
    # nsselecter/comparator/)
    unmatched: bool = False
    # extra per-result data (e.g. FT matched words for highlight/snippet)
    aux: Optional[dict] = None
    # True when ids are already ascending and duplicate-free (lets id-space
    # consumers skip a defensive np.unique)
    sorted_unique: bool = False

    @staticmethod
    def empty() -> "SelectKeyResult":
        return SelectKeyResult(np.empty(0, dtype=np.int64))

    @staticmethod
    def fallthrough() -> "SelectKeyResult":
        return SelectKeyResult(np.empty(0, dtype=np.int64), unmatched=True)


class Index:
    """Base index. Subclasses: scalar (hash/tree/store/ttl), text, vector."""

    def __init__(self, definition: IndexDef):
        self.definition = definition
        self.name = definition.name

    # --- planner hooks ----------------------------------------------------
    def estimate_matches(self, condition: Any, values: Any):
        """Cheap upper-bound match-count estimate for planner ordering
        (reference: Index::SelectKey expectedIterations / cost-based reorder,
        querypreprocessor.cc). None = unknown."""
        return None

    # --- mutation -------------------------------------------------------
    def upsert(self, row_id: int, values: Any) -> None:
        raise NotImplementedError

    def delete(self, row_id: int, values: Any) -> None:
        raise NotImplementedError

    # --- queries --------------------------------------------------------
    def select_key(self, condition: CondType, values: tuple,
                   **kwargs) -> SelectKeyResult:
        raise NotImplementedError

    def supports(self, condition: CondType) -> bool:
        return False

    # --- lifecycle ------------------------------------------------------
    def commit(self) -> None:
        """Finalize pending mutations (reference: Index::Commit /
        CommitFulltext lazy build)."""

    def clear(self) -> None:
        raise NotImplementedError

    def memstat(self) -> dict:
        return {"name": self.name, "unique_keys_count": 0, "data_size": 0}

    # checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass
