"""Spans and counters read from outside the program, as the traced run's
per-layer metrics need them. Each probe is a file probes/<name>.json:

  {"name": ..., "kind": "span", "object": "index", "method": ...,
   "ends": "return" | "drain"}     a method of the database ("db"), the
                                   namespace ("ns") or the vector index
                                   ("index"); "drain": the span ends when
                                   the callable the method returns returns
  {"name": ..., "kind": "span", "module": ..., "function": ...}
  {"name": ..., "kind": "counter", "module": ..., "attr": ...}
                                   a counter object with a `.value`
  {"name": ..., "kind": "perfstats", "field": ...}
                                   a field of the namespace's #perfstats
  {"name": "gc", "kind": "gc"}     the interpreter's garbage collections

A probe whose target the program lacks is left out; a reader of
h100bench/metrics/ names the probes it reads in PROBES, and a traced run
whose reader needs a probe left out fails with no result (runner.py), so
that a renamed target never drops a metric, or changes one, unseen.
Probes are set only in a traced run.
"""
from __future__ import annotations

import gc
import importlib
import threading
import time


class Recorder:
    """Spans as (start, end, thread id) on time.perf_counter's clock."""

    def __init__(self):
        self.spans: dict = {}
        # reentrant: a collection, and so the gc probe, can start inside
        # add() on the same thread
        self._lock = threading.RLock()
        self._undo: list = []
        self.counters: dict = {}      # name -> () -> current value or None
        self.installed: set = set()   # probes whose target was found

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.setdefault(name, []).append(
                (t0, t1, threading.get_ident()))

    def span_of(self, name: str, fn, ends: str):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if ends != "drain":
                self.add(name, t0, time.perf_counter())
                return out

            def drain(*a, **k):
                try:
                    return out(*a, **k)
                finally:
                    self.add(name, t0, time.perf_counter())
            return drain
        return timed

    def install(self, probes: list, system) -> None:
        objects = {"db": system.db, "ns": system.ns, "index": system.index}
        for p in probes:
            kind = p["kind"]
            if kind == "span" and "object" in p:
                obj = objects[p["object"]]
                fn = getattr(obj, p["method"], None)
                if fn is None:
                    continue
                self.installed.add(p["name"])
                setattr(obj, p["method"], self.span_of(
                    p["name"], fn, p.get("ends", "return")))
                self._undo.append((obj, p["method"], None))
            elif kind == "span":
                mod = importlib.import_module(p["module"])
                fn = getattr(mod, p["function"], None)
                if fn is None:
                    continue
                self.installed.add(p["name"])
                setattr(mod, p["function"], self.span_of(p["name"], fn,
                                                          "return"))
                self._undo.append((mod, p["function"], fn))
            elif kind == "counter":
                mod = importlib.import_module(p["module"])
                obj = getattr(mod, p["attr"], None)
                if obj is not None:
                    self.installed.add(p["name"])
                    self.counters[p["name"]] = lambda o=obj: o.value
            elif kind == "perfstats":
                # the row's field appears with the namespace's first select
                self.installed.add(p["name"])
                self.counters[p["name"]] = (
                    lambda f=p["field"]: system.perfstats().get(f))
            elif kind == "gc":
                self.installed.add(p["name"])
                self._install_gc(p["name"])

    def absent(self, needed: set, counters: tuple = ()) -> set:
        """The probes of `needed` that found no target: never installed,
        or a counter that read None in one of the `counters` readings."""
        gone = needed - self.installed
        for reading in counters:
            gone |= {k for k in needed if k in reading and reading[k] is None}
        return gone

    def _install_gc(self, name: str) -> None:
        started = {}

        def on_gc(phase, info):
            if phase == "start":
                started[threading.get_ident()] = time.perf_counter()
            elif threading.get_ident() in started:
                self.add(name, started.pop(threading.get_ident()),
                         time.perf_counter())
        gc.callbacks.append(on_gc)
        self._undo.append((None, on_gc, None))

    def read_counters(self) -> dict:
        return {name: read() for name, read in self.counters.items()}

    def remove(self) -> None:
        """Take every probe out again."""
        for obj, attr, orig in reversed(self._undo):
            if obj is None:
                gc.callbacks.remove(attr)
            elif orig is None:
                delattr(obj, attr)       # the instance's own wrapper
            else:
                setattr(obj, attr, orig)
        self._undo.clear()
