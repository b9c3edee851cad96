"""Port of reindexer_tpu/orm.py: a copy of the reference's module over the
port's `IndexDef` / `FloatVectorOpts` (host only).

The reference's notes follow.

Model mapping: dataclasses -> index definitions + typed results.

Semantic equivalent of the Go connector's struct-tag describer
(reference: describer.go + reflect.go — `reindex:"name,type,opts"` tags
compile to namespace index definitions): Python dataclass fields carry the
same tag in `field(metadata={"reindex": ...})`; `open_namespace_for` derives
the IndexDefs, and `QueryResults` decode back into model instances.

    @dataclasses.dataclass
    class Item:
        id: int = rx_field("id,hash,pk")
        year: int = rx_field("year,tree")
        name: str = rx_field("name,hash")
        vec: list = rx_field("vec,hnsw", dims=64, metric="cosine")
        extra: str = ""                      # untagged -> not indexed

    db.open_namespace_for("items", Item)    # via open_namespace_for(db, ...)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Type, get_type_hints

from .core.errors import ParamsError
from .core.payload import FloatVectorOpts, IndexDef, IndexOpts
from .core.type_consts import FieldType, IndexType, VectorMetric

_PY_FIELD_TYPES = {
    int: FieldType.INT64,
    float: FieldType.DOUBLE,
    str: FieldType.STRING,
    bool: FieldType.BOOL,
}

_VECTOR_TYPES = {"hnsw": IndexType.HNSW, "ivf": IndexType.IVF,
                 "vec_bf": IndexType.VEC_BF}


def rx_field(tag: str, default: Any = dataclasses.MISSING, **vector_kw):
    """Dataclass field carrying a reindex tag (`name,type[,opt...]`) —
    mirror of the Go struct tag `reindex:"..."` (describer.go)."""
    meta = {"reindex": tag}
    if vector_kw:
        meta["vector"] = vector_kw
    if default is dataclasses.MISSING:
        return dataclasses.field(default=None, metadata=meta)
    return dataclasses.field(default=default, metadata=meta)


def model_indexes(model: Type) -> list[IndexDef]:
    """Derive IndexDefs from a dataclass's reindex tags."""
    if not dataclasses.is_dataclass(model):
        raise ParamsError("model must be a dataclass")
    hints = get_type_hints(model)
    out: list[IndexDef] = []
    for f in dataclasses.fields(model):
        tag = f.metadata.get("reindex")
        if not tag or tag == "-":
            continue
        parts = [p.strip() for p in tag.split(",")]
        name = parts[0] or f.name
        itype_s = parts[1] if len(parts) > 1 else "hash"
        opts_s = set(parts[2:])
        py_t = hints.get(f.name, str)
        is_array = py_t is list or getattr(py_t, "__origin__", None) is list

        if itype_s in _VECTOR_TYPES:
            vk = dict(f.metadata.get("vector", {}))
            dims = int(vk.pop("dims", 0))
            metric = VectorMetric(vk.pop("metric", "l2"))
            out.append(IndexDef(
                name, _VECTOR_TYPES[itype_s],
                json_paths=(f.name,),
                vector_opts=FloatVectorOpts(dims=dims, metric=metric, **vk)))
            continue
        if itype_s == "text":
            out.append(IndexDef(name, IndexType.TEXT, FieldType.STRING,
                                json_paths=(f.name,)))
            continue
        elem_t = py_t.__args__[0] if is_array and getattr(
            py_t, "__args__", None) else py_t
        ftype = _PY_FIELD_TYPES.get(elem_t, FieldType.STRING)
        out.append(IndexDef(
            name, IndexType(itype_s), ftype, json_paths=(f.name,),
            opts=IndexOpts(is_pk="pk" in opts_s, is_array=is_array,
                           is_sparse="sparse" in opts_s,
                           is_dense="dense" in opts_s)))
    return out


def open_namespace_for(db, ns_name: str, model: Type):
    """Open a namespace with indexes derived from the model."""
    return db.open_namespace(ns_name, model_indexes(model))


def to_doc(obj: Any) -> dict:
    d = dataclasses.asdict(obj)
    return {k: v for k, v in d.items() if v is not None}


def from_doc(model: Type, doc: dict) -> Any:
    names = {f.name for f in dataclasses.fields(model)}
    kwargs = {k: v for k, v in doc.items() if k in names}
    return model(**kwargs)


def decode_results(model: Type, results) -> list:
    """QueryResults -> list of model instances (Go iterator analog)."""
    return [from_doc(model, d) for d in results.docs()]
