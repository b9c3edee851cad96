"""Document model: index definitions, payload schema, columnar field store.

TPU-first re-design of the reference payload layer
(cpp_src/core/payload/payloadtype.h, payloadvalue.h, payloadiface.h):
instead of per-row packed tuples with typed accessors, indexed fields live in
*columns* (numpy arrays on host, device arrays for vectors) so that the
select loop, comparators, and aggregations are vectorized over rows — the
batched analog of the reference's per-row PayloadIface access.

Documents themselves (arbitrary JSON) are held as Python dicts — the analog
of the reference's CJSON tuples (cpp_src/core/cjson/) without the binary
encoding; the wire codecs (cjson) are not part of the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from .errors import ParamsError
from .type_consts import FieldType, IndexType, VectorMetric


@dataclasses.dataclass
class QuantizationConfig:
    """SQ8 scalar quantization config (reference: float_vector.md:296-371,
    scalar_quantization/quantizer.h:11-75)."""

    enabled: bool = False
    left_quantile: float = 0.001
    right_quantile: float = 0.999
    # start quantizing once the index holds at least this many vectors
    min_elements: int = 1024
    # scoring contract:
    #   "exact"         — certified eps-ladder candidate set + fp32 scoring
    #                     (stronger than the reference; the engine degrades
    #                     to an fp32 scan when the bound can't be certified)
    #   "approx"        — REFERENCE semantics (quantizer.h:11-75): top-k of
    #                     the quantized scores, no exactness guarantee —
    #                     the scan streams 1/4 the HBM bytes
    #   "approx_rerank" — quantized top-k candidates re-scored from fp32
    #                     (order/ranks exact over the approximate set)
    mode: str = "exact"


@dataclasses.dataclass
class EmbeddingConfig:
    """Auto-embedding config (reference: float_vector.md:98-150, core/embedding/).

    `endpoint` points at an external embedder service implementing the
    reference's embedders API (embedders_api.yaml); `fields` lists the source
    document fields whose values get embedded on upsert.
    """

    endpoint: str = ""
    fields: tuple[str, ...] = ()
    cache_tag: str = ""
    strategy: str = "always"  # always | empty_only | strict


@dataclasses.dataclass
class FloatVectorOpts:
    """Vector index options (reference: FloatVectorIndexOpts, float_vector.md:24-150)."""

    dims: int = 0
    metric: VectorMetric = VectorMetric.L2
    # HNSW
    m: int = 16
    ef_construction: int = 200
    start_size: int = 1000
    multithreading: int = 0  # reference MultithreadingMode; informational here
    # IVF
    centroids_count: int = 0
    # common
    radius: Optional[float] = None
    quantization: QuantizationConfig = dataclasses.field(default_factory=QuantizationConfig)
    embedding: Optional[EmbeddingConfig] = None

    def __post_init__(self):
        # plain-dict configs coerce (API ergonomics: callers pass the same
        # JSON shapes the HTTP/RPC planes use)
        if isinstance(self.quantization, dict):
            q = self.quantization
            self.quantization = QuantizationConfig(
                enabled=bool(q.get("enabled", True)),
                left_quantile=float(q.get("left_quantile", 0.001)),
                right_quantile=float(q.get("right_quantile", 0.999)),
                min_elements=int(q.get("min_elements", 1024)),
                mode=str(q.get("mode", "exact")))
        if isinstance(self.embedding, dict):
            self.embedding = EmbeddingConfig(**self.embedding)
        if isinstance(self.metric, str):
            self.metric = VectorMetric(self.metric)


@dataclasses.dataclass
class IndexOpts:
    """Generic index options (reference: IndexOpts in core/indexopts.h)."""

    is_pk: bool = False
    is_array: bool = False
    is_sparse: bool = False
    is_dense: bool = False
    is_no_column: bool = False
    collate: str = "none"  # none | ascii | utf8 | numeric
    expire_after: int = 0  # TTL seconds
    rtree_type: str = "rstar"


@dataclasses.dataclass
class IndexDef:
    """Definition of one index (reference: IndexDef, core/indexdef.h).

    `json_paths` maps the index onto document fields (possibly several for
    composite indexes, reference: composite index over sub-fields).
    """

    name: str
    index_type: IndexType = IndexType.HASH
    field_type: FieldType = FieldType.STRING
    json_paths: tuple[str, ...] = ()
    opts: IndexOpts = dataclasses.field(default_factory=IndexOpts)
    vector_opts: Optional[FloatVectorOpts] = None
    # FT config dict (reference FTConfig, ft/config/ftconfig.h:151-238)
    ft_config: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.json_paths:
            self.json_paths = (self.name,)
        if isinstance(self.index_type, str):
            self.index_type = IndexType(self.index_type)
        if isinstance(self.field_type, str):
            self.field_type = FieldType(self.field_type)
        if self.index_type in (IndexType.VEC_BF, IndexType.HNSW, IndexType.IVF):
            self.field_type = FieldType.FLOAT_VECTOR
            if self.vector_opts is None or self.vector_opts.dims <= 0:
                raise ParamsError(
                    f"float_vector index '{self.name}' requires vector_opts.dims > 0")
        if self.field_type == FieldType.COMPOSITE and len(self.json_paths) < 2:
            raise ParamsError(
                f"composite index '{self.name}' requires >=2 json_paths")

    @property
    def is_fulltext(self) -> bool:
        return self.index_type == IndexType.TEXT

    @property
    def is_vector(self) -> bool:
        return self.index_type in (IndexType.VEC_BF, IndexType.HNSW, IndexType.IVF)

    @property
    def is_composite(self) -> bool:
        return self.field_type == FieldType.COMPOSITE

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "name": self.name,
            "index_type": self.index_type.value,
            "field_type": self.field_type.value,
            "json_paths": list(self.json_paths),
            "is_pk": self.opts.is_pk,
            "is_array": self.opts.is_array,
            "is_sparse": self.opts.is_sparse,
            "is_dense": self.opts.is_dense,
            "collate_mode": self.opts.collate,
        }
        if self.opts.expire_after:
            d["expire_after"] = self.opts.expire_after
        if self.vector_opts is not None:
            vo = self.vector_opts
            cfg = {"dimension": vo.dims, "metric": vo.metric.value}
            if self.index_type == IndexType.HNSW:
                cfg.update({"m": vo.m, "ef_construction": vo.ef_construction,
                            "start_size": vo.start_size,
                            "multithreading": vo.multithreading})
            if self.index_type == IndexType.IVF:
                cfg["centroids_count"] = vo.centroids_count
            if vo.radius is not None:
                cfg["radius"] = vo.radius
            if vo.quantization.enabled:
                cfg["quantization_config"] = {
                    "left_quantile": vo.quantization.left_quantile,
                    "right_quantile": vo.quantization.right_quantile,
                    "min_elements": vo.quantization.min_elements,
                    "mode": vo.quantization.mode,
                }
            if vo.embedding is not None:
                cfg["embedding"] = dataclasses.asdict(vo.embedding)
            d["config"] = cfg
        if self.ft_config:
            d["config"] = self.ft_config
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IndexDef":
        cfg = d.get("config") or {}
        vopts = None
        itype = IndexType(d.get("index_type", "hash"))
        if itype in (IndexType.VEC_BF, IndexType.HNSW, IndexType.IVF):
            q = cfg.get("quantization_config") or {}
            emb = cfg.get("embedding")
            vopts = FloatVectorOpts(
                dims=int(cfg.get("dimension", 0)),
                metric=VectorMetric(cfg.get("metric", "l2")),
                m=int(cfg.get("m", 16)),
                ef_construction=int(cfg.get("ef_construction", 200)),
                start_size=int(cfg.get("start_size", 1000)),
                multithreading=int(cfg.get("multithreading", 0)),
                centroids_count=int(cfg.get("centroids_count", 0)),
                radius=cfg.get("radius"),
                quantization=QuantizationConfig(
                    enabled=bool(q),
                    left_quantile=float(q.get("left_quantile", 0.001)),
                    right_quantile=float(q.get("right_quantile", 0.999)),
                    min_elements=int(q.get("min_elements", 1024)),
                    mode=str(q.get("mode", "exact")),
                ),
                embedding=EmbeddingConfig(**emb) if emb else None,
            )
        return cls(
            name=d["name"],
            index_type=itype,
            field_type=FieldType(d.get("field_type", "string")),
            json_paths=tuple(d.get("json_paths") or (d["name"],)),
            opts=IndexOpts(
                is_pk=bool(d.get("is_pk", False)),
                is_array=bool(d.get("is_array", False)),
                is_sparse=bool(d.get("is_sparse", False)),
                is_dense=bool(d.get("is_dense", False)),
                collate=d.get("collate_mode", "none"),
                expire_after=int(d.get("expire_after", 0)),
            ),
            vector_opts=vopts,
            ft_config=cfg if itype == IndexType.TEXT else {},
        )


_NUMPY_DTYPES = {
    FieldType.INT: np.int64,
    FieldType.INT64: np.int64,
    FieldType.DOUBLE: np.float64,
    FieldType.BOOL: np.bool_,
    FieldType.STRING: object,
    FieldType.UUID: object,
}

_DEFAULTS = {
    FieldType.INT: 0,
    FieldType.INT64: 0,
    FieldType.DOUBLE: 0.0,
    FieldType.BOOL: False,
    FieldType.STRING: "",
    FieldType.UUID: "00000000-0000-0000-0000-000000000000",
}


def get_json_path(doc: dict, path: str) -> Any:
    """Fetch a (possibly nested, dot-separated) JSON path from a document."""
    if "." not in path and type(doc) is dict:
        # overwhelmingly the common case on the ingest path
        return doc.get(path)
    cur: Any = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            # nested arrays of objects -> collect values from each element
            vals = []
            for el in cur:
                if isinstance(el, dict) and part in el:
                    v = el[part]
                    if isinstance(v, list):
                        vals.extend(v)
                    else:
                        vals.append(v)
            cur = vals if vals else None
        else:
            return None
        if cur is None:
            return None
    return cur


def set_json_path(doc: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    cur = doc
    for part in parts[:-1]:
        nxt = cur.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[part] = nxt
        cur = nxt
    cur[parts[-1]] = value


def coerce_scalar(value: Any, ftype: FieldType) -> Any:
    """Convert a document value to the column's scalar type
    (reference: Variant conversions, core/keyvalue/variant.cc)."""
    # exact-type fast exit: query values overwhelmingly arrive pre-typed
    # and this runs per value per entry on the hot select path
    t = type(value)
    if (t is int and (ftype is FieldType.INT or ftype is FieldType.INT64)) \
            or (t is str and ftype is FieldType.STRING) \
            or (t is float and ftype is FieldType.DOUBLE) \
            or (t is bool and ftype is FieldType.BOOL):
        return value
    if value is None:
        return _DEFAULTS[ftype]
    if ftype in (FieldType.INT, FieldType.INT64):
        if isinstance(value, bool):
            return int(value)
        return int(value)
    if ftype == FieldType.DOUBLE:
        return float(value)
    if ftype == FieldType.BOOL:
        return bool(value)
    if ftype == FieldType.UUID:
        # canonical lowercase dashed form; validates like the reference's
        # dedicated UUID index (core/keyvalue/uuid.cc ParseUuid — accepts
        # dashed or plain 32-hex, case-insensitive; bad input is an error)
        import uuid as _uuid
        try:
            return str(_uuid.UUID(str(value)))
        except (ValueError, AttributeError, TypeError) as e:
            raise ParamsError(f"invalid UUID value {value!r}") from e
    if ftype == FieldType.STRING:
        return str(value)
    return value


class Column:
    """Growable typed column over rows; the vectorized analog of the
    reference's payload field (cpp_src/core/payload/payloadfieldvalue.h).

    Scalar fields are numpy arrays supporting vectorized comparators; array
    fields are object arrays of numpy sub-arrays.
    """

    def __init__(self, ftype: FieldType, is_array: bool = False, capacity: int = 64):
        self.ftype = ftype
        self.is_array = is_array
        self._dtype = _NUMPY_DTYPES.get(ftype, object)
        if is_array:
            self._dtype = object
        self.data = np.empty(capacity, dtype=self._dtype)
        self.size = 0
        self.is_set = np.zeros(capacity, dtype=np.bool_)  # sparse/null tracking

    def _grow(self, need: int) -> None:
        if need <= len(self.data):
            return
        cap = max(need, len(self.data) * 2)
        new = np.empty(cap, dtype=self._dtype)
        new[: self.size] = self.data[: self.size]
        self.data = new
        new_set = np.zeros(cap, dtype=np.bool_)
        new_set[: self.size] = self.is_set[: self.size]
        self.is_set = new_set

    def set_row(self, row: int, value: Any) -> None:
        self._grow(row + 1)
        if row >= self.size:
            # fill any gap with defaults
            default = _DEFAULTS.get(self.ftype, None)
            for r in range(self.size, row):
                self.data[r] = [] if self.is_array else default
            self.size = row + 1
        if value is None:
            self.data[row] = (np.empty(0, dtype=object) if self.is_array
                              else _DEFAULTS.get(self.ftype, None))
            self.is_set[row] = False
            return
        if self.is_array:
            vals = value if isinstance(value, (list, tuple)) else [value]
            self.data[row] = np.array(
                [coerce_scalar(v, self.ftype) for v in vals], dtype=object)
        else:
            if isinstance(value, (list, tuple)):
                value = value[0] if value else None
                if value is None:
                    self.set_row(row, None)
                    return
            self.data[row] = coerce_scalar(value, self.ftype)
        self.is_set[row] = True

    def values(self) -> np.ndarray:
        return self.data[: self.size]

    def set_mask(self) -> np.ndarray:
        return self.is_set[: self.size]

    def get_row(self, row: int) -> Any:
        if row >= self.size or not self.is_set[row]:
            return None
        v = self.data[row]
        if self.is_array and isinstance(v, np.ndarray):
            return list(v)
        return v


class PayloadType:
    """Schema: ordered index definitions + field columns registry
    (reference: PayloadTypeImpl, cpp_src/core/payload/payloadtype.h:13)."""

    def __init__(self, name: str):
        self.name = name
        self.indexes: list[IndexDef] = []
        self._by_name: dict[str, int] = {}

    def add(self, idef: IndexDef) -> int:
        if idef.name in self._by_name:
            raise ParamsError(f"index '{idef.name}' already exists in ns '{self.name}'")
        pos = len(self.indexes)
        self.indexes.append(idef)
        self._by_name[idef.name] = pos
        return pos

    def drop(self, name: str) -> int:
        pos = self._by_name.pop(name)
        self.indexes.pop(pos)
        self._by_name = {d.name: i for i, d in enumerate(self.indexes)}
        return pos

    def field_pos(self, name: str) -> Optional[int]:
        return self._by_name.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self) -> Iterable[IndexDef]:
        return iter(self.indexes)

    def pk_index(self) -> Optional[IndexDef]:
        for d in self.indexes:
            if d.opts.is_pk:
                return d
        return None
