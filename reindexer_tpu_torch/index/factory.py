"""Index factory (port of reindexer_tpu/index/factory.py; reference: Index::New
switch, cpp_src/core/index/index.cc:80-115).

Scalar, composite and rtree indexes are the port's copies of the host-only
reference indexes. `vec_bf` and `ivf` build the port's brute-force and IVF
engines on the namespace's torch device. Engines not ported yet (HNSW, full
text, array vector indexes) raise NotImplementedError.
"""
from __future__ import annotations

import torch

from ..core.errors import ParamsError
from ..core.payload import IndexDef
from ..core.type_consts import FieldType, IndexType
from .base import Index
from .scalar import (CompositeIndex, HashIndex, StoreIndex, TreeIndex,
                     TtlIndex, UuidIndex)

_NOT_PORTED = {    # index type -> (what, its ROADMAP item)
    IndexType.HNSW: ("HNSW (and streaming KNN)", "A7"),
    IndexType.TEXT: ("full-text", "A9"),
}


def create_index(idef: IndexDef, device: torch.device) -> Index:
    # a composite index of any type is the host-only CompositeIndex, as in
    # the reference's _create, whatever engine its type would otherwise need
    if idef.is_composite:
        return CompositeIndex(idef, ordered=idef.index_type == IndexType.TREE)
    if idef.index_type in _NOT_PORTED:
        what, item = _NOT_PORTED[idef.index_type]
        raise NotImplementedError(
            f"{what} indexes are not yet ported to reindexer_tpu_torch, see "
            f"ROADMAP {item}")
    if idef.index_type == IndexType.HASH:
        if idef.field_type == FieldType.UUID:
            # dedicated 128-bit-key UUID index (uuid_index.cc)
            return UuidIndex(idef)
        return HashIndex(idef)
    if idef.index_type == IndexType.TREE:
        return TreeIndex(idef)
    if idef.index_type == IndexType.STORE:
        return StoreIndex(idef)
    if idef.index_type == IndexType.TTL:
        if idef.opts.expire_after <= 0:
            raise ParamsError("ttl index requires opts.expire_after > 0")
        return TtlIndex(idef)
    if idef.index_type == IndexType.RTREE:
        from .rtree import RTreeIndex
        return RTreeIndex(idef)
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
    raise ParamsError(f"unknown index type: {idef.index_type}")
