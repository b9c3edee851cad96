"""Database facade of the port (port of reindexer_tpu/core/database.py).

The JAX package's Reindexer, with namespaces whose vector indexes live on an
explicit torch device. Persistent storage and device meshes are not ported
yet: their modules in the JAX package import JAX.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from reindexer_tpu.core import database as _ref
from reindexer_tpu.core.errors import ParamsError
from reindexer_tpu.core.payload import IndexDef

from .namespace import Namespace


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device named by `device`; raises if it is not there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "exist")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"reindexer_tpu_torch runs on cuda or cpu, not "
                         f"{device!r}")
    return dev


class Reindexer(_ref.Reindexer):
    """Embedded database engine with its vector indexes on `device`.

        db = Reindexer(device="cuda")      # in-memory, vectors on the GPU
        db = Reindexer(device="cpu")       # plain PyTorch versions of the kernels
    """

    def __init__(self, dsn: str = "", storage=None, mesh=None,
                 device: Union[str, torch.device] = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device) is not yet ported to "
                "reindexer_tpu_torch, see ROADMAP")
        if dsn or storage is not None:
            raise NotImplementedError(
                "persistent storage is not yet ported to "
                "reindexer_tpu_torch, see ROADMAP")
        self.device = resolve_device(device)
        super().__init__()

    def open_namespace(self, name: str,
                       indexes: Sequence[IndexDef] = ()) -> Namespace:
        with self._lock:
            ns = self._namespaces.get(name)
            if ns is None:
                if name.startswith("#"):
                    raise ParamsError("'#' namespace names are reserved")
                ns = Namespace(name, self.device)
                self._namespaces[name] = ns
            for idef in indexes:
                ns.add_index(idef)
                if idef.opts.expire_after:
                    self._ensure_ttl_thread()
            return ns

    add_namespace = open_namespace
