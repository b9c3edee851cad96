"""Index factory (port of reindexer_tpu/index/factory.py).

`vec_bf` and `ivf` build the port's brute-force and IVF engines on the
namespace's device. Scalar, composite and rtree indexes are host-only and
come from the JAX package's own factory, which builds them without touching
JAX. Engines not ported yet (HNSW, full text, array vector indexes) raise
NotImplementedError rather than silently building a JAX engine.
"""
from __future__ import annotations

import torch

from reindexer_tpu.core.payload import IndexDef
from reindexer_tpu.core.type_consts import IndexType
from reindexer_tpu.index import factory as _ref
from reindexer_tpu.index.base import Index

_NOT_PORTED = {
    IndexType.HNSW: "HNSW (and streaming KNN)",
    IndexType.TEXT: "full-text",
}


def create_index(idef: IndexDef, device: torch.device) -> Index:
    if idef.index_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{_NOT_PORTED[idef.index_type]} indexes are not yet ported to "
            "reindexer_tpu_torch, see ROADMAP")
    if idef.index_type in (IndexType.VEC_BF, IndexType.IVF):
        if idef.opts.is_array:
            raise NotImplementedError(
                "array vector indexes are not yet ported to "
                "reindexer_tpu_torch, see ROADMAP A10")
        if idef.index_type == IndexType.IVF:
            from .vector.ivf import IvfIndex
            return IvfIndex(idef, device)
        from .vector.brute_force import BruteForceIndex
        return BruteForceIndex(idef, device)
    return _ref._create(idef)
