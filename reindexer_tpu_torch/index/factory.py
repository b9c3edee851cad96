"""Index factory (port of reindexer_tpu/index/factory.py; reference: Index::New
switch, cpp_src/core/index/index.cc:80-115).

Scalar, composite and rtree indexes are the port's copies of the host-only
reference indexes. `vec_bf`, `hnsw` and `ivf` build the port's brute-force,
HNSW and IVF engines on the namespace's torch device, each wrapped in an
`ArrayVectorIndex` when the definition is an array, and `text` the port's
full-text index, its posting arrays on the same device.
"""
from __future__ import annotations

import torch

from ..core.errors import ParamsError
from ..core.payload import IndexDef
from ..core.type_consts import FieldType, IndexType
from .base import Index
from .scalar import (CompositeIndex, HashIndex, StoreIndex, TreeIndex,
                     TtlIndex, UuidIndex)

def create_index(idef: IndexDef, device: torch.device) -> Index:
    # a composite index of any type is the host-only CompositeIndex, as in
    # the reference's _create
    if idef.is_composite:
        return CompositeIndex(idef, ordered=idef.index_type == IndexType.TREE)
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
    if idef.index_type == IndexType.TEXT:
        from .text import FullTextIndex
        return FullTextIndex(idef, device)
    if idef.index_type in (IndexType.VEC_BF, IndexType.HNSW, IndexType.IVF):
        if idef.index_type == IndexType.VEC_BF:
            from .vector.brute_force import BruteForceIndex
            inner = BruteForceIndex(idef, device)
        elif idef.index_type == IndexType.HNSW:
            from .vector.hnsw import HnswIndex
            inner = HnswIndex(idef, device)
        else:
            from .vector.ivf import IvfIndex
            inner = IvfIndex(idef, device)
        if idef.opts.is_array:
            # multiple vectors per document with per-doc dedup
            # (reference: float_vector.md:624-630 array vector indexes)
            from .vector.array_adapter import ArrayVectorIndex
            return ArrayVectorIndex(idef, inner)
        return inner
    raise ParamsError(f"unknown index type: {idef.index_type}")
