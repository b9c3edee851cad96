"""Carry state from the JAX package into the port."""
from __future__ import annotations

import numpy as np

from reindexer_tpu.core.errors import ParamsError


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
