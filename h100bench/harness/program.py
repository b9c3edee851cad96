"""The program's own spans and counters (`reindexer_tpu_torch.tracing`),
for the traced run's per-layer readers.

The recorder reaches them through counter probes, which it looks up in a
traced run only, when the namespace opens, before set-up's upserts:

  probes/program.json            {"name": "program", "kind": "counter",
                                  "module": "h100bench.harness.program",
                                  "attr": "recording"}
      The one lookup with an effect: it starts the program's recording
      (tracing on, spans kept for the readers, counters counted from
      here) and reads 0.
  probes/program.<name>.json     ... "attr": "span:<name>" (or
                                  "counter:<name>")
      A name check, one a span or counter that a reader reads: it gives
      None when the program lists no such span or counter, so that a
      traced run whose reader reads it fails with no result; else it reads
      0 for a span (readers take the spans themselves, `spans()`) and the
      count since the recording started for a counter.

A program whose tracing has no span registry (the port before it had one)
is said so on stderr; every name check then reads 0, and the readers find
nothing to read and report nothing. The recording stays on to the
process's end: the readers run after the window and the profiled phase.
"""
from __future__ import annotations

import sys

_state: dict = {"on": False, "spans": None, "base": {}}


class _Probe:
    """What a probe's lookup gives: `value` reads it."""

    def __init__(self, read):
        self._read = read

    @property
    def value(self):
        return self._read()


def _tracing():
    """The program's tracing module when it keeps spans and counters."""
    from reindexer_tpu_torch import tracing
    return tracing if hasattr(tracing, "SPANS") else None


def _zero():
    return 0


def __getattr__(attr: str):
    tracing = _tracing()
    if attr == "recording":
        _state.update(on=False, spans=None, base={})
        if tracing is None:
            print("[program] reindexer_tpu_torch.tracing has no span "
                  "registry: the program's readers report nothing",
                  file=sys.stderr, flush=True)
            return _Probe(_zero)
        tracing.configure(None, keep=True)
        tracing.take()
        _state.update(on=True, base=tracing.counters())
        return _Probe(_zero)
    kind, sep, name = attr.partition(":")
    if not sep or kind not in ("span", "counter"):
        raise AttributeError(attr)
    if tracing is None:
        return _Probe(_zero)
    if kind == "span":
        return _Probe(_zero) if name in tracing.SPANS else None
    if name not in tracing.counters():
        return None
    return _Probe(lambda: tracing.counters()[name]
                  - _state["base"].get(name, 0))


def spans(name: str | None = None) -> list:
    """The program's spans as (name, start, end, thread, span_id, parent_id,
    trace_id, attrs), start and end in seconds on time.perf_counter's
    clock; those named `name` only, if given. The first call takes what
    the recording holds."""
    if _state["spans"] is None:
        recs = []
        if _state["on"]:
            tracing = _tracing()
            recs = tracing.take()
            lost = (tracing.dropped.value
                    - _state["base"].get("tracing.dropped", 0))
            if lost:
                print(f"[program] {lost} spans dropped past the buffer's "
                      "capacity", file=sys.stderr, flush=True)
        _state["spans"] = [(n, s / 1e9, e / 1e9, *rest)
                           for n, s, e, *rest in recs]
    if name is None:
        return _state["spans"]
    return [s for s in _state["spans"] if s[0] == name]


def spans_in(r, name: str) -> list:
    """The spans named `name` that lie in the reading's window."""
    a, b = r.window
    return [s for s in spans(name) if a <= s[1] and s[2] <= b]


def setup_count(r, name: str):
    """A program counter's count over set-up: from the recording's start
    to the window's opening (None when the counter has no probe)."""
    return r.counters.get("program." + name, (None, None))[0]
