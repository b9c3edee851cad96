"""Carry state from the JAX package into the port."""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

from .core.errors import ParamsError


def keeper_state_from_reference(state: dict) -> dict:
    """The port's keeper state from a reindexer_tpu `VectorKeeper.state_dict()`.

    Both are numpy {"data": f32[rows, dims], "valid": bool[rows]}; the port
    marks invalid rows through sq_eff and ignores their data, so this checks
    the shapes and types and copies. Load the result with
    `index.load_state_dict({"keeper": ...})`."""
    data = np.array(state["data"], dtype=np.float32, copy=True)
    valid = np.array(state["valid"], dtype=np.bool_, copy=True)
    if data.ndim != 2 or valid.shape != (data.shape[0],):
        raise ParamsError(f"keeper state must be data [rows, dims] and valid "
                          f"[rows], got {data.shape} and {valid.shape}")
    return {"data": data, "valid": valid}


def ivf_state_from_reference(state: dict) -> dict:
    """The port's IVF state from a reindexer_tpu `IvfIndex.state_dict()`:
    {"keeper": as keeper_state_from_reference, "centroids": f32[nlist, D]
    or None (not trained yet), "assign": i32[rows] list id per row, -1 for
    none}. Load the result with `IvfIndex.load_state_dict`."""
    keeper = keeper_state_from_reference(state["keeper"])
    dims = keeper["data"].shape[1]
    c = state.get("centroids")
    centroids = None
    if c is not None:
        centroids = np.array(c, dtype=np.float32, copy=True)
        if centroids.ndim != 2 or centroids.shape[1] != dims:
            raise ParamsError(f"IVF centroids must be [nlist, {dims}], got "
                              f"{centroids.shape}")
    assign = np.array(state["assign"], dtype=np.int32, copy=True)
    nlist = 0 if centroids is None else centroids.shape[0]
    if (assign.ndim != 1 or assign.shape[0] < keeper["data"].shape[0]
            or (assign >= nlist).any() or (assign < -1).any()):
        raise ParamsError(f"IVF assign must be i32[>= {keeper['data'].shape[0]}]"
                          f" of list ids in [-1, {nlist}), got "
                          f"{assign.shape}")
    return {"keeper": keeper, "centroids": centroids, "assign": assign}


def quant_state_from_reference(state: dict) -> dict:
    """The port's SQ8 store state from a reindexer_tpu
    `QuantizedStore.state_dict()`: {"lo", "alpha": f32[D], "quantized_count":
    int}, or {} for a store that is not active yet. Load the result with
    `QuantizedStore.load_state_dict(state, keeper)`, which re-encodes the
    keeper's data on that grid."""
    if not state:
        return {}
    lo = np.array(state["lo"], dtype=np.float32, copy=True)
    alpha = np.array(state["alpha"], dtype=np.float32, copy=True)
    if lo.ndim != 1 or alpha.shape != lo.shape:
        raise ParamsError(f"quantizer state must be lo [dims] and alpha "
                          f"[dims], got {lo.shape} and {alpha.shape}")
    return {"lo": lo, "alpha": alpha,
            "quantized_count": int(state["quantized_count"])}


def hnsw_state_from_reference(state: dict) -> dict:
    """The port's HNSW state from a reindexer_tpu `HnswIndex.state_dict()`:
    {"keeper": as keeper_state_from_reference, "levels": i32[cap] (-1: not
    in the graph), "deleted": bool[cap], "links0": i32[cap, 2M], "upper":
    top-first list of i32[cap, M], "host_vecs": f32[cap, dims], "entry",
    "max_level": int}, all numpy in both packages; this checks the shapes,
    types and link ids and copies. Load the result with
    `HnswIndex.load_state_dict`. A mesh snapshot {"mesh_shards": [...]}
    converts shard by shard (load it into an index on a mesh of as many
    shards)."""
    if "mesh_shards" in state:
        return {"mesh_shards": [hnsw_state_from_reference(st)
                                for st in state["mesh_shards"]]}
    keeper = keeper_state_from_reference(state["keeper"])
    dims = keeper["data"].shape[1]
    levels = np.array(state["levels"], dtype=np.int32, copy=True)
    deleted = np.array(state["deleted"], dtype=np.bool_, copy=True)
    links0 = np.array(state["links0"], dtype=np.int32, copy=True)
    upper = [np.array(u, dtype=np.int32, copy=True) for u in state["upper"]]
    host_vecs = np.array(state["host_vecs"], dtype=np.float32, copy=True)
    entry, max_level = int(state["entry"]), int(state["max_level"])
    cap = levels.shape[0]
    if (levels.ndim != 1 or deleted.shape != (cap,) or links0.ndim != 2
            or links0.shape[0] != cap or host_vecs.shape != (cap, dims)
            or cap < keeper["data"].shape[0]):
        raise ParamsError(
            f"HNSW state must hold levels [cap], deleted [cap], links0 [cap, "
            f"2M] and host_vecs [cap, {dims}] with cap >= the keeper's "
            f"{keeper['data'].shape[0]} rows, got {levels.shape}, "
            f"{deleted.shape}, {links0.shape} and {host_vecs.shape}")
    width = links0.shape[1] // 2
    for table in [links0] + upper:
        if table.shape != (cap, table.shape[1]) or (
                table is not links0 and table.shape[1] != width):
            raise ParamsError(f"HNSW upper layers must be [{cap}, {width}], "
                              f"got {table.shape}")
        if ((table < -1) | (table >= cap)).any():
            raise ParamsError("HNSW links must be row ids in [-1, "
                              f"{cap}), got {table.min()}..{table.max()}")
    if not -1 <= entry < cap or max_level > len(upper) or (
            entry >= 0 and levels[entry] != max_level):
        raise ParamsError(f"HNSW entry {entry} at level {max_level} does not "
                          f"fit {len(upper)} upper layers and its levels")
    return {"keeper": keeper, "levels": levels, "deleted": deleted,
            "links0": links0, "upper": upper, "host_vecs": host_vecs,
            "entry": entry, "max_level": max_level}


def ft_state_from_reference(state: dict) -> dict:
    """The port's full-text state from a reindexer_tpu
    `FullTextIndex.state_dict()`: {"docs": {row: [text per field]},
    "rows_capacity": int}. Both packages keep only the documents' text and
    rebuild the posting arrays from it, so this checks the rows and the
    texts (None becomes "") and copies. Load the result with
    `FullTextIndex.load_state_dict`."""
    cap = int(state.get("rows_capacity", 0))
    docs = {}
    for row, texts in state.get("docs", {}).items():
        row = int(row)
        if not 0 <= row < cap:
            raise ParamsError(f"full-text row {row} is outside rows_capacity "
                              f"{cap}")
        if not isinstance(texts, (list, tuple)) or not all(
                t is None or isinstance(t, str) for t in texts):
            raise ParamsError(f"full-text row {row} must hold a list of "
                              f"texts, got {texts!r}")
        docs[row] = ["" if t is None else t for t in texts]
    return {"docs": docs, "rows_capacity": cap}


def _check_ann_state(state: dict, index_type: str) -> None:
    """Raise unless `state` converts by the *_state_from_reference function
    of its index type (array indexes have no cache in either package)."""
    if index_type == "hnsw":
        hnsw_state_from_reference(state)
    elif index_type == "ivf":
        ivf_state_from_reference(state)
    else:
        keeper_state_from_reference(state["keeper"])


def storage_from_reference(src_dir: str, dst_dir: str) -> dict:
    """Copy a reindexer_tpu storage root into `dst_dir` (a new directory)
    for the port: a database directory (the JSONL engine's, or a sqlite://
    one's) or a server's root of them. Both packages write the same files,
    so every file is copied as it is; then every ANN cache file is read and
    checked by the converter of its index type, and a file that fails the
    check is removed, as the engines drop a stale cache (the index then
    rebuilds on its first query). Returns {"kept": [cache files], "dropped":
    {cache file: reason}}, paths relative to `dst_dir`."""
    from .storage.ann_cache import _unflatten
    shutil.copytree(src_dir, dst_dir)
    report: dict = {"kept": [], "dropped": {}}
    for root, _, files in sorted(os.walk(dst_dir)):
        if os.path.basename(root) != "ann_cache":
            continue
        for name in sorted(f for f in files if f.endswith(".npz")):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, dst_dir)
            try:
                with np.load(path, allow_pickle=False) as z:
                    meta = json.loads(bytes(z["__meta__"]).decode())
                    stamp = meta.pop("__stamp__")
                    _check_ann_state(_unflatten(meta, z),
                                     stamp["index_type"])
                report["kept"].append(rel)
            except Exception as e:       # any unreadable state is stale
                os.remove(path)
                report["dropped"][rel] = f"{type(e).__name__}: {e}"
    return report
