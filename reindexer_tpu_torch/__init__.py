"""reindexer_tpu_torch: the PyTorch / CUDA port of reindexer_tpu.

The public API is reindexer_tpu's, exported from the port's own modules:
`Query`, `IndexDef`, `FloatVectorOpts`, `KnnSearchParams`, the errors and
the type constants are the port's copies of the reference's host layers
(the package imports nothing of reindexer_tpu, and never JAX).
`Reindexer` takes the torch device its vector indexes live on:

    from reindexer_tpu_torch import Reindexer, Query, IndexDef, IndexOpts
    db = Reindexer(device="cuda")
    db.open_namespace("items", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "vec_bf", vector_opts=FloatVectorOpts(dims=128))])
    res = db.select(Query("items").where_knn("vec", qvec, KnnSearchParams(k=10)))

Ported so far: the brute-force (`vec_bf`) vector index, fp32 and SQ8
(modes exact, approx, approx_rerank), the IVF (`ivf`) index, with six
hand-written CUDA kernels, the HNSW (`hnsw`) index, fp32 and SQ8, with
streaming KNN (plain PyTorch: its JAX device code has no Pallas kernel),
array vector indexes over any of the three, every host-only index type,
and full text (`text`: ft_fast BM25, plain PyTorch on the device and the
host C++ merge) with hybrid FT+KNN fusion. Storage and meshes raise
NotImplementedError (see ROADMAP.md).
"""
from .core.database import Reindexer
from .core.errors import (ConflictError, LogicError, NotFoundError, ParamsError,
                          QueryCanceledError, QueryError, QueryTimeoutError,
                          ReindexerError, StorageError)
from .core.rdxcontext import RdxContext
from .core import rdxcontext
from .core.payload import (EmbeddingConfig, FloatVectorOpts, IndexDef, IndexOpts,
                           QuantizationConfig)
from .core.transaction import Transaction
from .core.type_consts import (AggType, CondType, FieldType, IndexType, OpType,
                               StrictMode, VectorMetric)
from .index.vector.params import (BruteForceSearchParams, HnswSearchParams,
                                  IvfSearchParams, KnnSearchParams)
from .query.query import JoinType, Query, SortingEntry
from .query.results import QueryResults, ResultItem

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
