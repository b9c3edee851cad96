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
