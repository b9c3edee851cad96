"""Per-query cancellation / deadline context.

Semantic analog of the reference RdxContext
(Reindexer's cpp_src/core/rdxcontext.h — every call threads a
cancellation token; ThrowOnCancel() raises errCanceled/errTimeout at
checkpoints) and the cgo context watcher
(Reindexer's cpp_src/core/cbinding/...).

TPU-native design: the context travels in a contextvars.ContextVar, so it
threads implicitly through the whole stack — the asyncio servers inherit it
per task, thread-pool executors per submitted callable — without widening
every signature. Checkpoints call `check_cancel()` at the same altitude the
reference places ThrowOnCancel: select-loop entry, per query-entry
evaluation, between device dispatch and drain (cancelling never interrupts
an in-flight device program — it skips the blocking readback), per join
batch, and inside long host merges.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Optional

from .errors import QueryCanceledError, QueryTimeoutError

_current: contextvars.ContextVar[Optional["RdxContext"]] = \
    contextvars.ContextVar("rdx_context", default=None)


class RdxContext:
    """Cancellation token + optional monotonic deadline."""

    __slots__ = ("deadline", "_cancel", "tag")

    def __init__(self, timeout_ms: Optional[float] = None,
                 cancel: Optional[threading.Event] = None,
                 tag: str = ""):
        self.deadline = (time.monotonic() + timeout_ms / 1e3
                         if timeout_ms is not None else None)
        self._cancel = cancel
        self.tag = tag

    # -- token side ----------------------------------------------------
    def cancel(self) -> None:
        if self._cancel is None:
            self._cancel = threading.Event()
        self._cancel.set()

    @property
    def canceled(self) -> bool:
        return self._cancel is not None and self._cancel.is_set()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return max((self.deadline - time.monotonic()) * 1e3, 0.0)

    # -- checkpoint side -------------------------------------------------
    def check(self) -> None:
        if self.canceled:
            raise QueryCanceledError(
                f"query canceled{' (' + self.tag + ')' if self.tag else ''}")
        if self.expired:
            raise QueryTimeoutError(
                f"query deadline exceeded"
                f"{' (' + self.tag + ')' if self.tag else ''}")


def current() -> Optional[RdxContext]:
    return _current.get()


def check_cancel() -> None:
    """Checkpoint: raise QueryCanceledError/QueryTimeoutError when the
    ambient context is canceled or past its deadline. No-op without one."""
    ctx = _current.get()
    if ctx is not None:
        ctx.check()


@contextlib.contextmanager
def context(timeout_ms: Optional[float] = None,
            cancel: Optional[threading.Event] = None,
            ctx: Optional[RdxContext] = None,
            tag: str = ""):
    """Install a cancellation context for the enclosed block.

        with rdxcontext.context(timeout_ms=100):
            db.select(q)

    Nested contexts stack: the inner block restores the outer context on
    exit. Passing an explicit RdxContext reuses its token (e.g. a server
    holding one token per connection)."""
    if ctx is None:
        ctx = RdxContext(timeout_ms=timeout_ms, cancel=cancel, tag=tag)
    tok = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(tok)
