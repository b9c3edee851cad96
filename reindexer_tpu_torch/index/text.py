"""Full-text index adapter (port of reindexer_tpu/index/text.py).

The reference's index over the port's full-text engine (reindexer_tpu_torch/
ft/): its holders keep their device arrays on the namespace's torch device.
Under a mesh (attach_mesh) its selectors score doc-sharded over the mesh's
devices (ft/selector.py, parallel/sharded_ft.py).

The reference's notes follow.

Full-text index adapter.

Semantic equivalent of the reference `IndexText`/`FastIndexText`
(cpp_src/core/index/indextext/indextext.h:171-186, indextext.cc:677-825):
documents only store their text on upsert (cheap write path); the first FT
query triggers the lazy commit that builds the posting store
(reference: CommitFulltext -> DataProcessor::Process; here ->
FtDataHolder.build).

Incremental commits mirror the reference's build "steps"
(ft_fast/dataholder.h:73,101-105): mutations since the last commit build a
NEW step holder; a small last step (< max_step_size rows) is re-committed
in place instead (reference NeedRecommitLast), and reaching
max_rebuild_steps (default 50) forces the full rebuild (NeedRebuild).
Queries run against the main holder plus every step; hits of rows owned by
a LATER step are masked, raw scores merge and normalize once.

Query results are LRU-cached per DSL string (reference: FtIdSetCache,
indextext.cc:766) and invalidated on any mutation.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from ..core.errors import QueryError
from ..core.payload import IndexDef
from ..core.type_consts import CondType, RankOrdering
from ..ft.config import FtFastConfig
from ..ft.dataholder import FtDataHolder
from ..ft.selector import FtSelector, normalize_ranks
from .base import Index, SelectKeyResult

_CACHE_SIZE = 256


class FullTextIndex(Index):
    def __init__(self, definition: IndexDef, device: torch.device):
        super().__init__(definition)
        self.device = torch.device(device)
        self.cfg = FtFastConfig.from_dict(definition.ft_config)
        self.field_names = list(definition.json_paths)
        self.holder = FtDataHolder(self.cfg, self.field_names, self.device)
        self.docs: dict[int, list[str]] = {}   # row -> text per ft field
        self._full_dirty = True
        # incremental step state (reference: DataHolder.steps)
        self._steps: list[dict] = []    # {holder, selector, rows:set}
        self._pending: dict[int, list[str]] = {}   # rows since last commit
        # row -> owning step index; rows recorded at mutation time with
        # the UPCOMING step index, so sources with a smaller index (main
        # = -1, earlier steps) mask them. Deleted rows keep an owner but
        # appear in no holder.
        self._owner: dict[int, int] = {}
        self._cache: OrderedDict[str, SelectKeyResult] = OrderedDict()
        self._rows_capacity = 0
        self._selector: Optional[FtSelector] = None
        self._mesh_ctx = None   # mesh-resident mode (attach_mesh)

    def attach_mesh(self, ctx) -> None:
        """Mesh-resident mode: the selectors run the doc-sharded BM25 path
        (parallel/sharded_ft.py) behind the same select_key API."""
        if ctx is None or ctx.n_shards <= 1:
            return
        self._mesh_ctx = ctx
        self._selector = None
        for st in self._steps:
            st["selector"] = None

    # --- mutation (write path stays cheap: just store text) -------------
    def upsert(self, row_id: int, values: Any) -> None:
        texts = self._to_texts(values)
        self.docs[row_id] = texts
        self._rows_capacity = max(self._rows_capacity, row_id + 1)
        self._mutate(row_id, texts)

    def delete(self, row_id: int, values: Any) -> None:
        if self.docs.pop(row_id, None) is not None:
            self._mutate(row_id, None)

    def _mutate(self, row_id: int, texts: Optional[list[str]]) -> None:
        self._cache.clear()
        if self._full_dirty:
            return
        # step-based incremental path
        if texts is None:
            self._pending.pop(row_id, None)
        else:
            self._pending[row_id] = texts
        self._owner[row_id] = len(self._steps)

    def _to_texts(self, values: Any) -> list[str]:
        if values is None:
            return [""] * len(self.field_names)
        if isinstance(values, (list, tuple)):
            out = []
            for v in values:
                if isinstance(v, (list, tuple)):
                    out.append(" ".join(str(x) for x in v if x is not None))
                else:
                    out.append("" if v is None else str(v))
            # pad/trim to field count
            out = out[: len(self.field_names)]
            out += [""] * (len(self.field_names) - len(out))
            return out
        return [str(values)] + [""] * (len(self.field_names) - 1)

    # --- lazy commit (reference: IndexText::commitFulltextImpl) ---------
    @property
    def dirty(self) -> bool:
        return self._full_dirty or bool(self._pending)

    def _build_step(self, docs: dict) -> dict:
        holder = FtDataHolder(self.cfg, self.field_names, self.device)
        holder.build(((row, texts) for row, texts in docs.items()),
                     self._rows_capacity)
        return {"holder": holder,
                "selector": FtSelector(holder, self.cfg, self._mesh_ctx),
                "rows": set(docs)}

    def commit(self) -> None:
        if not self._full_dirty and self._pending                 and len(self._steps) >= self.cfg.max_rebuild_steps:
            self._full_dirty = True        # reference NeedRebuild
        if self._full_dirty:
            self.holder = FtDataHolder(self.cfg, self.field_names,
                                       self.device)
            self.holder.build(
                ((row, texts) for row, texts in self.docs.items()),
                self._rows_capacity)
            self._full_dirty = False
            self._steps.clear()
            self._pending.clear()
            self._owner.clear()
            self._selector = FtSelector(self.holder, self.cfg,
                                         self._mesh_ctx)
            # zipf-head warm: materialize per-word top-k caches so the
            # first frequent single-term query after a rebuild is a dict
            # hit instead of a ~20 ms host stream (selector docstring)
            self._selector.warm_frequent_singles(
                self.cfg.warmup_frequent_words)
            return
        if not self._pending:
            return
        upcoming = len(self._steps)
        if self._steps and len(self._steps[-1]["rows"])                 < self.cfg.max_step_size:
            # reference NeedRecommitLast: a small last step absorbs the
            # pending rows instead of opening a new step
            target = upcoming - 1
            last = self._steps[-1]
            rows = {r for r in last["rows"]
                    if self._owner.get(r) == target and r in self.docs}
            docs = {r: self.docs[r] for r in rows}
            docs.update(self._pending)
            self._steps[-1] = self._build_step(docs)
            for r, o in list(self._owner.items()):
                if o == upcoming:
                    self._owner[r] = target
        else:
            self._steps.append(self._build_step(dict(self._pending)))
        self._pending.clear()

    # --- query ----------------------------------------------------------
    def supports(self, condition: CondType) -> bool:
        return condition in (CondType.EQ, CondType.SET, CondType.ANY,
                             CondType.EMPTY, CondType.LIKE)

    def select_key(self, condition: CondType, values: tuple,
                   **kw) -> SelectKeyResult:
        if condition in (CondType.ANY, CondType.EMPTY):
            has = np.asarray(
                [r for r, t in self.docs.items() if any(t)], dtype=np.int64)
            if condition == CondType.ANY:
                return SelectKeyResult(np.sort(has))
            allr = np.asarray(sorted(self.docs.keys()), dtype=np.int64)
            return SelectKeyResult(np.setdiff1d(allr, has))
        if not values:
            raise QueryError("full-text condition requires a query string")
        dsl = str(values[0])
        cached = self._cache.get(dsl)
        if cached is not None:
            self._cache.move_to_end(dsl)
            return cached
        self.commit()
        if self._selector is None:
            self._selector = FtSelector(self.holder, self.cfg,
                                         self._mesh_ctx)
        # steady state (no delta holder to merge, no overridden rows):
        # the selector normalizes
        if not self._steps and not self._owner and not self._pending:
            res = self._selector.process(dsl)
            out = SelectKeyResult(res.ids, res.ranks, RankOrdering.DESC)
            out.aux = {"matched_words": res.matched_words,
                       "area_sources": [(self.holder, res.matched_wids,
                                         res.searched_fields)]}
            self._cache[dsl] = out
            while len(self._cache) > _CACHE_SIZE:
                self._cache.popitem(last=False)
            return out
        res = self._selector.process(dsl, normalize=False)
        ids, scores, matched = res.ids, res.ranks, res.matched_words
        # source-offset area resolvers (reference: areaholder.h): each
        # (holder, matched word ids) pair maps a rendered doc + field to
        # the token positions that actually matched
        area_sources = [(self.holder, res.matched_wids,
                         res.searched_fields)]
        owner = self._owner
        if owner:
            keep = np.asarray([int(i) not in owner for i in ids],
                              dtype=bool)
            ids, scores = ids[keep], scores[keep]
        if self._steps:
            for i, st in enumerate(self._steps):
                if st["selector"] is None:
                    st["selector"] = FtSelector(st["holder"], self.cfg,
                                                 self._mesh_ctx)
                d = st["selector"].process(dsl, normalize=False)
                dk = np.asarray([owner.get(int(r), i) <= i for r in d.ids],
                                dtype=bool)
                ids = np.concatenate([ids, d.ids[dk]])
                scores = np.concatenate([scores, d.ranks[dk]])
                matched = matched | d.matched_words
                area_sources.append((st["holder"], d.matched_wids,
                                     d.searched_fields))
            order = np.argsort(-scores, kind="stable")
            ids, scores = ids[order], scores[order]
        ids, ranks = normalize_ranks(ids, scores, self.cfg.min_rank)
        out = SelectKeyResult(ids, ranks, RankOrdering.DESC)
        out.aux = {"matched_words": matched, "area_sources": area_sources}
        self._cache[dsl] = out
        while len(self._cache) > _CACHE_SIZE:
            self._cache.popitem(last=False)
        return out

    def clear(self) -> None:
        self.docs.clear()
        self._rows_capacity = 0
        self.holder = FtDataHolder(self.cfg, self.field_names, self.device)
        self._full_dirty = True
        self._steps.clear()
        self._pending.clear()
        self._owner.clear()
        self._cache.clear()

    def memstat(self) -> dict:
        st = self.holder.memstat()
        st["name"] = self.name
        st["unique_keys_count"] = st.pop("words_count", 0)
        st["is_built"] = not self._full_dirty
        st["build_steps"] = len(self._steps)
        st["delta_docs"] = len(self._pending) + sum(
            len(s["rows"]) for s in self._steps)
        return st

    def state_dict(self) -> dict:
        return {"docs": {int(k): list(v) for k, v in self.docs.items()},
                "rows_capacity": self._rows_capacity}

    def load_state_dict(self, state: dict) -> None:
        self.clear()
        self.docs = {int(k): list(v) for k, v in state.get("docs", {}).items()}
        self._rows_capacity = int(state.get("rows_capacity", 0))
