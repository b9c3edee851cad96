"""Type constants for the TPU-native reindexer.

Mirrors the enums of the reference engine (cpp_src/core/type_consts.h) at the
semantic level: condition types, index types, field types, aggregations.
The numeric values of CondType match the reference wire protocol
(type_consts.h: CondAny=0..CondKnn) so serialized queries stay compatible.
"""
from __future__ import annotations

import enum


class CondType(enum.IntEnum):
    """Filter condition types (reference: cpp_src/core/type_consts.h CondType)."""

    ANY = 0
    EQ = 1
    LT = 2
    LE = 3
    GT = 4
    GE = 5
    RANGE = 6
    SET = 7
    ALLSET = 8
    EMPTY = 9
    LIKE = 10
    DWITHIN = 11
    KNN = 12


# String aliases used by the JSON DSL / SQL layer
COND_NAMES = {
    CondType.ANY: "any",
    CondType.EQ: "eq",
    CondType.LT: "lt",
    CondType.LE: "le",
    CondType.GT: "gt",
    CondType.GE: "ge",
    CondType.RANGE: "range",
    CondType.SET: "set",
    CondType.ALLSET: "allset",
    CondType.EMPTY: "empty",
    CondType.LIKE: "like",
    CondType.DWITHIN: "dwithin",
    CondType.KNN: "knn",
}
COND_BY_NAME = {v: k for k, v in COND_NAMES.items()}
COND_BY_NAME.update({"==": CondType.EQ, "=": CondType.EQ, "<": CondType.LT,
                     "<=": CondType.LE, ">": CondType.GT, ">=": CondType.GE,
                     "in": CondType.SET})


class OpType(enum.IntEnum):
    """Logical operation joining query entries (reference: OpType in type_consts.h)."""

    OR = 1
    AND = 2
    NOT = 3


class IndexType(str, enum.Enum):
    """Index structure types (reference: IndexType enum + IndexDef string names,
    cpp_src/core/index/index.cc:80-115 Index::New switch)."""

    HASH = "hash"
    TREE = "tree"
    TTL = "ttl"
    STORE = "-"
    TEXT = "text"            # full-text ft_fast
    RTREE = "rtree"
    # vector index types (reference: float_vector.md:24-56)
    VEC_BF = "vec_bf"
    HNSW = "hnsw"
    IVF = "ivf"


class FieldType(str, enum.Enum):
    """Field value types (reference: KeyValueType, cpp_src/core/keyvalue)."""

    INT = "int"
    INT64 = "int64"
    DOUBLE = "double"
    STRING = "string"
    BOOL = "bool"
    UUID = "uuid"
    POINT = "point"
    COMPOSITE = "composite"
    FLOAT_VECTOR = "float_vector"


class VectorMetric(str, enum.Enum):
    """Distance metric for float_vector indexes (reference: float_vector.md:24-40)."""

    L2 = "l2"
    INNER_PRODUCT = "inner_product"
    COSINE = "cosine"


class AggType(str, enum.Enum):
    """Aggregation types (reference: cpp_src/core/nsselecter/aggregator.h:14)."""

    SUM = "sum"
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    FACET = "facet"
    DISTINCT = "distinct"
    COUNT = "count"
    COUNT_CACHED = "count_cached"


class RankOrdering(enum.IntEnum):
    """Whether higher or lower metric value ranks better.

    Reference: rank ordering differs per metric — L2 ascending, IP/cosine
    descending (float_vector.md, hnsw_index.cc select()).
    """

    ASC = 0   # smaller is better (L2 distance)
    DESC = 1  # larger is better (inner product / cosine similarity / BM25)


class StrictMode(str, enum.Enum):
    """Query strict mode (reference: StrictMode in type_consts.h)."""

    NONE = "none"
    NAMES = "names"
    INDEXES = "indexes"
