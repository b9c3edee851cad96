"""ANN storage cache: persisted device-index state so restart skips rebuild
(port of reindexer_tpu/storage/ann_cache.py).

A copy of the reference's module: every vector index of the port speaks
the reference's numpy `state_dict` format, so the .npz files and their
`items_count` / `index_type` stamp are the reference's, and a cache written
by either package loads in the other. `load_state_dict` re-uploads the
state to the index's torch device.

Two differences. A state is written with its rows numbered as the snapshot
written beside it numbers them on reload (`compact_rows`): the snapshot
keeps only live documents, so a namespace that had deleted rows comes back
with its rows renumbered. And a state is applied only where its rows that
hold a vector are the rows that hold one after the snapshot's upserts
(`_rows_match`), else it is dropped as stale. The reference writes the
state with the live row numbers and checks only the item count, so after
such a reload its cache answers with the wrong documents (a fault of the
reference, ROADMAP C); the port drops such a cache and rebuilds.

The reference's notes follow.

Semantic equivalent of the reference ANN disk cache
(cpp_src/core/namespace/ann_storage_cache_helper.h:28 UpdateInfo;
FloatVectorIndex::WriteIndexCache/LoadIndexCache, float_vector_index.h:118-121;
env RX_DISABLE_ANN_CACHE, float_vector.md:718): vector index state
(HNSW graph tables, IVF centroids+assignments, keeper arrays) serializes to
one .npz per (namespace, index); on load the cache is validated against the
namespace's item count and dropped when stale.

The FT index is intentionally NOT cached — like the reference, it rebuilds
lazily on first query (fulltext.md:320-326).
"""
from __future__ import annotations

import io
import json
import os
from typing import Optional

import numpy as np

DISABLE_ENV = "RX_TPU_DISABLE_ANN_CACHE"


def _flatten(state: dict, prefix: str = "") -> tuple[dict, dict]:
    """Split a nested state dict into (numpy arrays, json-able scalars)."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            sub_a, sub_m = _flatten(v, key + "/")
            arrays.update(sub_a)
            meta[k] = {"__nested__": sub_m}
        elif isinstance(v, np.ndarray):
            arrays[key] = v
            meta[k] = {"__array__": key}
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            meta[k] = {"__array_list__": []}
            for i, a in enumerate(v):
                akey = f"{key}#{i}"
                arrays[akey] = a
                meta[k]["__array_list__"].append(akey)
        elif isinstance(v, list) and not v:
            meta[k] = {"__array_list__": []}
        elif isinstance(v, list) and isinstance(v[0], dict):
            # a mesh HNSW index's per-shard states (the reference's cache
            # cannot write these: its _flatten raises on them)
            meta[k] = {"__dict_list__": []}
            for i, d in enumerate(v):
                sub_a, sub_m = _flatten(d, f"{key}#{i}/")
                arrays.update(sub_a)
                meta[k]["__dict_list__"].append(sub_m)
        else:
            meta[k] = v
    return arrays, meta


def _unflatten(meta: dict, arrays) -> dict:
    out: dict = {}
    for k, v in meta.items():
        if isinstance(v, dict) and "__nested__" in v:
            out[k] = _unflatten(v["__nested__"], arrays)
        elif isinstance(v, dict) and "__array__" in v:
            out[k] = arrays[v["__array__"]]
        elif isinstance(v, dict) and "__array_list__" in v:
            out[k] = [arrays[a] for a in v["__array_list__"]]
        elif isinstance(v, dict) and "__dict_list__" in v:
            out[k] = [_unflatten(m, arrays) for m in v["__dict_list__"]]
        else:
            out[k] = v
    return out


class AnnStorageCache:
    def __init__(self, base_dir: str):
        self.dir = os.path.join(base_dir, "ann_cache")
        self.enabled = os.environ.get(DISABLE_ENV, "") not in ("1", "true")

    def _path(self, ns_name: str, index_name: str) -> str:
        return os.path.join(self.dir, f"{ns_name}__{index_name}.npz")

    def write(self, ns_name: str, index, items_count: int,
              rows: Optional[np.ndarray] = None) -> None:
        """WriteIndexCache analog: persist index state + validity stamp.
        rows: the namespace's live document rows, ascending, as the
        snapshot written with this state holds them (None: 0..n-1)."""
        if not self.enabled:
            return
        state = index.state_dict()
        if not state:
            return
        if rows is not None:
            state = compact_rows(state, rows)
        if state is None:
            self.drop(ns_name, index.name)
            return
        os.makedirs(self.dir, exist_ok=True)
        arrays, meta = _flatten(state)
        meta["__stamp__"] = {"items_count": items_count,
                             "index_type": index.definition.index_type.value}
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta, default=_json_default).encode(), dtype=np.uint8)
        tmp = self._path(ns_name, index.name) + ".tmp"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                   self._path(ns_name, index.name))

    def load(self, ns_name: str, index, items_count: int) -> bool:
        """LoadIndexCache analog: returns True when the cached state was
        applied; stale caches (count mismatch) are dropped."""
        if not self.enabled:
            return False
        path = self._path(ns_name, index.name)
        if not os.path.isfile(path):
            return False
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                stamp = meta.pop("__stamp__", {})
                if stamp.get("items_count") != items_count or \
                        stamp.get("index_type") != \
                        index.definition.index_type.value:
                    os.remove(path)
                    return False
                state = _unflatten(meta, z)
                if not _rows_match(index, state):
                    os.remove(path)
                    return False
                index.load_state_dict(state)
                return True
        except Exception:
            try:
                os.remove(path)
            except OSError:
                pass
            return False

    def drop(self, ns_name: str, index_name: Optional[str] = None) -> None:
        """`drop_ann_storage_cache` action analog (float_vector.md:741-799)."""
        if not os.path.isdir(self.dir):
            return
        for f in os.listdir(self.dir):
            if index_name is None:
                match = f.startswith(f"{ns_name}__")
            else:
                match = f == f"{ns_name}__{index_name}.npz"
            if match:
                os.remove(os.path.join(self.dir, f))


def _rows_match(index, state: dict) -> bool:
    """Whether the state's rows that hold a vector are the rows of `index`
    that hold one now, after the snapshot's upserts (shard by shard for a
    mesh HNSW snapshot)."""
    if "mesh_shards" in state:
        subs = getattr(index, "_mesh_shards", None) or []
        if len(subs) != len(state["mesh_shards"]):
            return False
        return all(_rows_match(sub, st)
                   for sub, st in zip(subs, state["mesh_shards"]))
    index.keeper.flush()
    return np.array_equal(np.flatnonzero(index.keeper.valid), np.flatnonzero(
        np.asarray(state["keeper"]["valid"])))


def compact_rows(state: dict, rows: np.ndarray) -> dict:
    """`state` (a vector index's state_dict) with its rows renumbered as a
    snapshot renumbers them on reload: the live document rows `rows`
    (ascending) become 0..len(rows)-1, and the rows of an HNSW graph's
    deleted nodes, which its searches still traverse, follow them in
    order. A state whose rows have no gap comes back as it is. A mesh HNSW
    state with gaps is None (not cached): renumbering would move rows
    between its round-robin shards."""
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows) or rows[-1] == len(rows) - 1:
        return state
    if "mesh_shards" in state:
        return None
    keeper = state["keeper"]
    n_old = len(keeper["valid"])
    order = rows
    if "levels" in state:         # HNSW: keep every graph node
        nodes = np.flatnonzero(np.asarray(state["levels"]) >= 0)
        order = np.concatenate([rows, np.setdiff1d(nodes, rows)])
    size = max(n_old, int(order.max()) + 1)
    new_of = np.full(size, -1, dtype=np.int64)
    new_of[order] = np.arange(len(order))

    def move(a, n_new, fill):
        """a's rows at their new places in an array of n_new rows."""
        a = np.asarray(a)
        out = np.full((n_new,) + a.shape[1:], fill, dtype=a.dtype)
        src = order[order < len(a)]
        out[new_of[src]] = a[src]
        return out

    n_keep = len(order)
    out = dict(state)
    out["keeper"] = {"data": move(keeper["data"], n_keep, 0),
                     "valid": move(keeper["valid"], n_keep, False)}
    if "assign" in state:         # IVF
        out["assign"] = move(state["assign"], n_keep, -1)
    if "levels" in state:
        cap = max(len(state["levels"]), n_keep)

        def links(table):
            t = move(table, cap, -1)
            return np.where(t >= 0, new_of[np.maximum(t, 0)], -1).astype(
                t.dtype)
        out.update(levels=move(state["levels"], cap, -1),
                   deleted=move(state["deleted"], cap, False),
                   host_vecs=move(state["host_vecs"], cap, 0),
                   links0=links(state["links0"]),
                   upper=[links(u) for u in state["upper"]],
                   entry=(int(new_of[state["entry"]]) if state["entry"] >= 0
                          else state["entry"]))
    return out


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
