"""Tracing spans and counters (reference: tracing.go:10-18 — the Go
connector's optional OpenTelemetry spans around client operations).

A minimal span API without an external SDK, with pluggable exporters
(in-memory for tests, JSONL file for collectors that tail files — the
zero-egress analog of an OTLP push), and a registry of the program's
counters. The reference's span names ("Reindexer.Query", "HTTP <method>")
are kept for dashboard parity; the spans inside the program are listed in
SPANS.

Off by default. A span site tests `on`, one module global, and does
nothing more while it is false:

    with (tracing.span("engine.drain") if tracing.on else tracing.OFF):

`configure(exporter)` turns tracing on: then a closed span is the tuple

    (name, start_ns, end_ns, thread, span_id, parent_id, trace_id, attrs)

on time.perf_counter_ns's clock, kept in an in-memory buffer. Span ids
come from a process counter. A span's parent is the span open on its
thread when it opened (0: none); `trace_id` is the span id of the root of
that chain, so the spans of one request share it. Work one thread does
for another's request names the span it served in an attribute
(`dynbatch.wait`'s `dispatch` is the leader's `dynbatch.dispatch`).

`flush()` hands the buffered spans to the exporter as OTLP-shaped dicts,
their times moved to unix nanoseconds by the anchor `configure` takes
(time.time_ns() - time.perf_counter_ns(): the time base torch.profiler's
device events are on). The span that fills the buffer to CAPACITY, or
closes FLUSH_NS after the last flush, flushes it, so an exporter's file
runs at most about that far behind and no span is lost; `configure`
flushes the spans of the exporter it replaces, and the exporter's spans
are flushed at the interpreter's exit. `configure(keep=True)` records
with no exporter, for a reader that takes the tuples themselves
(`take()`): a span past CAPACITY is then dropped and counted in
`dropped`. While tracing is on, the garbage collector's collections are
`python.gc` spans, under the request whose thread ran them.

`counter(name)` registers a counter under a dotted name (the module
attributes that hold them stay); `counters()` reads them all.
"""
from __future__ import annotations

import atexit
import gc
import itertools
import json
import os
import threading
import time

from .ops._build import Counter

# every span name the program records (tests check each site's literal
# against it; h100bench's program probes look names up here)
SPANS = (
    "Reindexer.Query", "Reindexer.knn_batch", "knn_batch.assemble",
    "ns.lock_wait", "dynbatch.wait", "dynbatch.dispatch",
    "engine.dispatch", "engine.drain", "engine.device_wait",
    "hnsw.stop_read", "hnsw.commit", "hnsw.build.link", "hnsw.build.wait",
    "ivf.probe", "ivf.plan", "ivf.train", "ivf.reorder", "python.gc",
)
CAPACITY = 1 << 20      # spans the buffer holds
FLUSH_NS = 1_000_000_000    # an exporter's buffer is flushed this often

on = False              # the one test a span site makes
_exporter = None
_service_name = "reindexer_tpu"
_anchor_ns = 0
_spans: list = []
_flushed_ns = 0         # the last flush (perf_counter_ns)
_flush_lock = threading.RLock()   # a collection inside a flush may flush
_ids = itertools.count(1)
_lock = threading.Lock()
_now = time.perf_counter_ns
_thread = threading.get_ident


class _Local(threading.local):
    top = None      # the span open on this thread
    gc = None       # the start of the collection running on this thread


_local = _Local()
_counters: dict = {}
_exit_hooked = False


def counter(name: str) -> Counter:
    """The counter registered under `name`, made at its first request."""
    with _lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter()
        return c


def counters() -> dict:
    """{name: value} of every registered counter."""
    with _lock:
        items = list(_counters.items())
    return {name: c.value for name, c in items}


dropped = counter("tracing.dropped")     # spans past the buffer's capacity


class InMemoryExporter:
    """Keeps the OTLP-shaped dicts it is handed (at `flush()`)."""

    def __init__(self):
        self.spans: list[dict] = []

    def export(self, span: dict) -> None:
        self.spans.append(span)


class JsonlExporter:
    """One OTLP-shaped JSON object per line; collectors tail the file. The
    lines are written at `flush()`, one open of the file each."""

    def __init__(self, path: str):
        self.path = path
        self._lines: list[str] = []

    def export(self, span: dict) -> None:
        self._lines.append(json.dumps(span))

    def flush(self) -> None:
        lines, self._lines = self._lines, []
        if lines:
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")


def configure(exporter=None, service_name: str = "reindexer_tpu",
              keep: bool = False) -> None:
    """Install an exporter, after flushing the spans recorded so far to
    the exporter they were recorded for. None turns tracing off, unless
    `keep`: then spans are recorded for `take()` and exported nowhere.
    RX_TRACE_FILE in the environment installs the JSONL exporter at
    import time."""
    global on, _exporter, _service_name, _anchor_ns, _flushed_ns, \
        _exit_hooked
    flush()
    with _lock:
        _exporter = exporter
        _service_name = service_name
        _anchor_ns = time.time_ns() - time.perf_counter_ns()
        _flushed_ns = _now()
        on = exporter is not None or keep
        hooked = _on_gc in gc.callbacks
        if on and not hooked:
            gc.callbacks.append(_on_gc)
        elif not on and hooked:
            gc.callbacks.remove(_on_gc)
        if exporter is not None and not _exit_hooked:
            atexit.register(flush)
            _exit_hooked = True


def enabled() -> bool:
    return on


class _Span:
    """An open span; `with` closes it. `id` and `attrs` may be read and
    set inside the block."""

    __slots__ = ("name", "attrs", "id", "parent", "trace", "start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self.parent = top = _local.top
        self.id = sid = next(_ids)
        self.trace = sid if top is None else top.trace
        _local.top = self
        self.start = _now()
        return self

    def __exit__(self, kind, exc, tb) -> bool:
        end = _now()
        parent = _local.top = self.parent
        if exc is not None:
            self.attrs["exception"] = repr(exc)[:200]
        _keep((self.name, self.start, end, _thread(), self.id,
               0 if parent is None else parent.id, self.trace, self.attrs))
        return False


class _Off:
    """What `span` gives while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, exc, tb) -> bool:
        return False


OFF = _Off()


def span(name: str, **attributes):
    """A span around a `with` block (attributes that are None are left out
    at export). Hot sites test `on` first and take `OFF` while it is
    false, which allocates nothing."""
    if not on:
        return OFF
    return _Span(name, attributes)


def _keep(rec: tuple) -> None:
    """Buffer a closed span; flush an exporter's buffer when it is full or
    FLUSH_NS old, or drop and count a span past a kept buffer's CAPACITY."""
    if len(_spans) >= CAPACITY:
        if _exporter is None:
            dropped.add()
            return
        flush()
    _spans.append(rec)
    if _exporter is not None and (len(_spans) >= CAPACITY
                                  or rec[2] - _flushed_ns >= FLUSH_NS):
        flush()


def record(name: str, start_ns: int, end_ns: int, **attributes) -> int:
    """Keep a span whose times (perf_counter_ns) the caller took, as a
    child of the span open on this thread; returns its id."""
    top = _local.top
    sid = next(_ids)
    _keep((name, start_ns, end_ns, _thread(), sid,
           0 if top is None else top.id, sid if top is None else top.trace,
           attributes))
    return sid


def acquire(lock, name: str) -> None:
    """lock.acquire(); while tracing is on, the wait is a `name` span."""
    if not on:
        lock.acquire()
        return
    start = _now()
    lock.acquire()
    record(name, start, _now())


def device_read(tensor, name: str):
    """tensor.cpu(), a blocking read of the device; while tracing is on,
    the read is a `name` span."""
    if not on:
        return tensor.cpu()
    start = _now()
    out = tensor.cpu()
    record(name, start, _now())
    return out


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _local.gc = _now()
        return
    start = _local.gc
    if start is not None:
        _local.gc = None
        record("python.gc", start, _now(),
               generation=info["generation"], collected=info["collected"])


def take() -> list:
    """The buffered span tuples, taken out of the buffer unexported (for
    readers of the tuples themselves). A span closing on another thread
    meanwhile may land in the list taken."""
    global _spans
    out, _spans = _spans, []
    return out


def anchor_ns() -> int:
    """time.time_ns() - time.perf_counter_ns() when tracing was configured:
    add it to a span's times for unix nanoseconds."""
    return _anchor_ns


def to_otlp(rec: tuple) -> dict:
    """A span tuple as an OTLP-shaped dict; the process id leads the trace
    id, since span ids count per process."""
    name, start, end, thread, sid, parent, trace, attrs = rec
    return {
        "name": name,
        "trace_id": f"{os.getpid():016x}{trace:016x}",
        "span_id": f"{sid:016x}",
        "parent_span_id": f"{parent:016x}" if parent else None,
        "start_time_unix_nano": start + _anchor_ns,
        "end_time_unix_nano": end + _anchor_ns,
        "attributes": {**{k: v for k, v in attrs.items() if v is not None},
                       "thread.id": thread},
        "resource": {"service.name": _service_name},
        "status": "ERROR" if "exception" in attrs else "OK",
    }


def flush() -> None:
    """Hand the buffered spans to the exporter as OTLP-shaped dicts, then
    call the exporter's own `flush`, if it has one (with no exporter, the
    buffer is emptied)."""
    global _flushed_ns
    with _flush_lock:
        _flushed_ns = _now()
        exporter = _exporter
        recs = take()
        if exporter is None:
            return
        for rec in recs:
            exporter.export(to_otlp(rec))
        if hasattr(exporter, "flush"):
            exporter.flush()


if os.environ.get("RX_TRACE_FILE"):
    configure(JsonlExporter(os.environ["RX_TRACE_FILE"]))
