"""Namespace whose indexes come from the port's factory (port of
reindexer_tpu/core/namespace.py).

Everything but index creation is the JAX package's host-side Namespace.
"""
from __future__ import annotations

import torch

from reindexer_tpu.core import namespace as _ref
from reindexer_tpu.core.errors import ConflictError
from reindexer_tpu.core.payload import Column, IndexDef

from ..index.factory import create_index


class Namespace(_ref.Namespace):
    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self.device = device

    def add_index(self, idef: IndexDef) -> None:
        # the reference's add_index, building the index on self.device and
        # before registering it, so an engine that is not ported yet
        # (NotImplementedError) leaves the namespace unchanged
        with self.lock:
            if idef.name in self.payload_type:
                existing = self.payload_type.indexes[
                    self.payload_type.field_pos(idef.name)]
                if existing.to_dict() == idef.to_dict():
                    return  # idempotent re-add of identical def
                raise ConflictError(
                    f"index '{idef.name}' already exists with different definition")
            if idef.opts.is_pk and self.payload_type.pk_index() is not None:
                raise ConflictError(f"namespace '{self.name}' already has a PK index")
            index = create_index(idef, self.device)
            self.payload_type.add(idef)
            self.indexes.append(index)
            if not idef.is_vector and not idef.is_composite:
                col = Column(idef.field_type, idef.opts.is_array)
                self.columns[idef.name] = col
            # backfill from existing items
            for row, doc in enumerate(self.items):
                if doc is None:
                    continue
                vals = self._extract_values(doc, idef)
                self._set_column(idef, row, vals)
                index.upsert(row, vals)
            self._wal("add_index", idef.to_dict())
            self.version += 1
            self.schema_version += 1
