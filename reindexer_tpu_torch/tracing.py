"""Tracing spans (reference: tracing.go:10-18 — the Go connector's optional
OpenTelemetry spans around client operations).

TPU-build equivalent without an external SDK dependency: a minimal span API
producing OTLP/JSON-shaped dicts, with pluggable exporters (in-memory for
tests, JSONL file for collectors that tail files — the zero-egress analog
of an OTLP push). Enabled via `configure(...)`; disabled it costs one `if`
per operation. The database facade opens a span per select/upsert and the
HTTP server one per request, with the reference's span names
("Reindexer.Query" etc.) preserved for dashboard parity.
"""
from __future__ import annotations

import json
import os
import threading
import time
import secrets
from contextlib import contextmanager
from typing import Optional

_lock = threading.Lock()
_exporter = None
_service_name = "reindexer_tpu"


class InMemoryExporter:
    def __init__(self):
        self.spans: list[dict] = []

    def export(self, span: dict) -> None:
        self.spans.append(span)


class JsonlExporter:
    """One OTLP-shaped JSON object per line; collectors tail the file."""

    def __init__(self, path: str):
        self.path = path

    def export(self, span: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(span) + "\n")


def configure(exporter=None, service_name: str = "reindexer_tpu") -> None:
    """Install an exporter (None disables tracing). RX_TRACE_FILE in the
    environment configures the JSONL exporter at import time."""
    global _exporter, _service_name
    with _lock:
        _exporter = exporter
        _service_name = service_name


def enabled() -> bool:
    return _exporter is not None


_local = threading.local()


@contextmanager
def span(name: str, **attributes):
    """Context manager producing an OTLP-shaped span dict on exit. Nested
    spans link via parent_span_id (thread-local context propagation)."""
    if _exporter is None:
        yield None
        return
    parent = getattr(_local, "current", None)
    s = {
        "name": name,
        "trace_id": parent["trace_id"] if parent else secrets.token_hex(16),
        "span_id": secrets.token_hex(8),
        "parent_span_id": parent["span_id"] if parent else None,
        "start_time_unix_nano": time.time_ns(),
        "attributes": {k: v for k, v in attributes.items()
                       if v is not None},
        "resource": {"service.name": _service_name},
        "status": "OK",
    }
    _local.current = s
    try:
        yield s
    except Exception as e:
        s["status"] = "ERROR"
        s["attributes"]["exception"] = repr(e)[:200]
        raise
    finally:
        s["end_time_unix_nano"] = time.time_ns()
        _local.current = parent
        try:
            _exporter.export(s)
        except Exception:
            pass


if os.environ.get("RX_TRACE_FILE"):
    configure(JsonlExporter(os.environ["RX_TRACE_FILE"]))
