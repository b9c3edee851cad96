"""Carry state from the JAX package into the port."""
from __future__ import annotations

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
