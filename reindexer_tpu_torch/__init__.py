"""reindexer_tpu_torch: the PyTorch / CUDA port of reindexer_tpu.

The public API is reindexer_tpu's: `Query`, `IndexDef`, `FloatVectorOpts`,
`KnnSearchParams`, the errors and the type constants are re-exported from it
unchanged. `Reindexer` is the port's, and takes the torch device its vector
indexes live on:

    from reindexer_tpu_torch import Reindexer, Query, IndexDef, IndexOpts
    db = Reindexer(device="cuda")
    db.open_namespace("items", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "vec_bf", vector_opts=FloatVectorOpts(dims=128))])
    res = db.select(Query("items").where_knn("vec", qvec, KnnSearchParams(k=10)))

Ported so far: the brute-force (`vec_bf`) vector index, fp32 and SQ8
(modes exact, approx, approx_rerank), and the IVF (`ivf`) index, with six
hand-written CUDA kernels, and every host-only index type. HNSW, full text,
array vector indexes, storage and meshes raise NotImplementedError (see
ROADMAP.md). The package never imports JAX.
"""
from reindexer_tpu import (AggType, BruteForceSearchParams, CondType,
                           ConflictError, EmbeddingConfig, FieldType,
                           FloatVectorOpts, HnswSearchParams, IndexDef,
                           IndexOpts, IndexType, IvfSearchParams, JoinType,
                           KnnSearchParams, LogicError, NotFoundError, OpType,
                           ParamsError, QuantizationConfig, Query,
                           QueryCanceledError, QueryError, QueryResults,
                           QueryTimeoutError, RdxContext, ReindexerError,
                           ResultItem, SortingEntry, StorageError, StrictMode,
                           Transaction, VectorMetric, rdxcontext)

from .core.database import Reindexer

__version__ = "0.1.0"

__all__ = [
    "Reindexer", "Query", "QueryResults", "ResultItem", "Transaction",
    "IndexDef", "IndexOpts", "FloatVectorOpts", "QuantizationConfig",
    "EmbeddingConfig", "KnnSearchParams", "BruteForceSearchParams",
    "HnswSearchParams", "IvfSearchParams", "JoinType", "SortingEntry",
    "CondType", "OpType", "IndexType", "FieldType", "AggType", "VectorMetric",
    "StrictMode", "ReindexerError", "QueryError", "ParamsError",
    "NotFoundError", "ConflictError", "LogicError", "StorageError",
    "QueryCanceledError", "QueryTimeoutError", "RdxContext", "rdxcontext",
]
