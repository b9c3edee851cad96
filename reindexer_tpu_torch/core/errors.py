"""Error types, mirroring the reference error codes at the semantic level
(reference: cpp_src/tools/errors.h)."""
from __future__ import annotations


class ReindexerError(Exception):
    """Base error of the engine."""


class QueryError(ReindexerError):
    """Malformed query (bad condition/field/params)."""


class ParamsError(ReindexerError):
    """Invalid parameters (index def, config, KNN params)."""


class NotFoundError(ReindexerError):
    """Namespace / index / item not found."""


class ConflictError(ReindexerError):
    """Conflicting namespace/index definitions."""


class LogicError(ReindexerError):
    """Internal invariant violation."""


class StorageError(ReindexerError):
    """Persistence layer failure."""


class OutdatedWalError(ReindexerError):
    """Requested WAL range fell off the ring; follower must force-sync
    (reference: errOutdatedWAL, wal/walselecter.cc)."""


class QueryCanceledError(ReindexerError):
    """Query canceled via its RdxContext token (reference: errCanceled,
    cpp_src/core/rdxcontext.h)."""


class QueryTimeoutError(QueryCanceledError):
    """Query exceeded its execution deadline (reference: errTimeout)."""
