"""One run of one cell: set-up, warm-up, the measured window, with --trace 1
the profiled phase after it and the per-layer readers, and the comparison
with the reference. Returns the result object run.py prints."""
from __future__ import annotations

import bisect
import gc
import sys
import time

import numpy as np
import torch

from . import check, load, probes, spec
from .measure import read_trace
from .system import FIELD, NAMESPACE, Data, System, knn_params

PROFILER_MARGIN_S = 0.1     # idle margins inside the profiler's capture,
#                             so that no device event at its edges is lost


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Reading:
    """What a per-layer reader reads (h100bench/metrics/<name>.py):

    cell, config, traffic: the cell's entries; setup: load_s, docs,
    first_call_s; window: (opening, closing) of the measured window on
    time.perf_counter's clock; requests: (start, end, queries, ok) of its
    requests; profiled: those of the profiled phase that follows it;
    spans: {probe: [(start, end, thread)]}, set-up's and the phase's
    included; counters: {probe: (value at the window's opening, at its
    closing)}; trace: the DeviceTrace of the profiled phase, or None;
    trace_queries: the queries the phase answered; trace_offset_ns:
    time.time_ns() - time.perf_counter_ns()."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def spans_in(self, name: str) -> list:
        a, b = self.window
        return [s for s in self.spans.get(name, []) if a <= s[0] and s[1] <= b]

    def delta(self, name: str):
        v0, v1 = self.counters.get(name, (None, None))
        return None if v0 is None or v1 is None else v1 - v0


class Profile:
    """The traced run's readings around the window and its profiled phase:
    the counters when the window opens and when it closes, then
    torch.profiler (on the card) over the phase, with idle margins inside
    its capture so that no device event at its edges is lost."""

    def __init__(self, rec, on_card: bool):
        self.rec, self.on_card = rec, on_card
        self.prof = None
        self.offset_ns = 0
        self.p0 = self.p1 = 0.0

    def open(self, win):
        self.counters_start = self.rec.read_counters()

    def start(self, win):
        self.counters_end = self.rec.read_counters()
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            time.sleep(PROFILER_MARGIN_S)
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.p0 = time.perf_counter()

    def stop(self, win):
        self.p1 = max(r[1] for r in win.profiled)
        if self.prof is not None:
            time.sleep(PROFILER_MARGIN_S)
            self.prof.__exit__(None, None, None)


class _Cover:
    """The union of closed intervals, merged once, asked by bisection
    whether it holds a point."""

    def __init__(self, intervals):
        self.starts, self.ends = [], []
        for s, e in sorted(intervals):
            if self.ends and s <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], e)
            else:
                self.starts.append(s)
                self.ends.append(e)

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def _breakdown(reading) -> dict:
    """The ten device operations that took most time, and the idle time
    of the device split by what the host was doing at each gap's middle."""
    tr = reading.trace
    ops = sorted(tr.by_name().items(), key=lambda kv: -kv[1][1])[:10]
    labels = [(_Cover((s, e) for s, e, _ in reading.spans.get(probe, ())),
               label)
              for probe, label in (("gc", "gc"),
                                   ("graph_capture", "hnsw graph capture"),
                                   ("engine",
                                    "engine host work (dispatch, drain)"))]
    busy = _Cover((s, e) for s, e, _, _ in reading.profiled)
    host = ("result assembly and facade"
            if reading.traffic["entry"] == "knn_batch"
            else "executor, dynbatch and assembly")
    idle: dict = {}
    for g0, g1 in tr.gaps():
        mid = ((g0 + g1) / 2 - reading.trace_offset_ns) / 1e9
        what = next((label for cover, label in labels if mid in cover),
                    host if mid in busy else "client loop")
        idle[what] = idle.get(what, 0.0) + (g1 - g0) / 1e9
    return {"device_ops": [[name[:200], sec] for name, (_, sec) in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def _require(rec, needed: dict, counters: tuple = ()) -> None:
    """Fail the run, with no result, when a probe that a per-layer reader
    of the cell reads found no target in the program."""
    gone = rec.absent(set(needed), counters)
    if gone:
        raise SystemExit("[probes] no target in the program for " + ", ".join(
            f"{p} (read by {', '.join(needed[p])})" for p in sorted(gone))
            + ": no result")


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", control: bool = False,
        overrides: dict | None = None, fault=None) -> dict:
    """One run; t_start is the process's start on perf_counter's clock.
    `overrides` replaces config and traffic keys (tests' small sizes);
    `fault(system)` plants a fault in the program after set-up (tests)."""
    overrides = overrides or {}
    cell = spec.cell(cell_name)
    config = {**spec.config(cell["config"]), **overrides.get("config", {})}
    traffic = {**spec.traffic(cell["traffic"]),
               **overrides.get("traffic", {})}
    on_card = torch.device(device).type == "cuda"
    data = Data(config, traffic, seed)

    params = knn_params(config, traffic)
    rec = probes.Recorder() if trace else None
    needed: dict = {}     # probe -> the cell's per-layer metrics reading it
    if trace:
        for m in spec.metrics_of(cell_name, "per_layer"):
            for p in spec.metric_reader(m["name"]).PROBES:
                needed.setdefault(p, []).append(m["name"])
    system = System(config, data, device,
                    on_open=(lambda s: rec.install(spec.probes(), s))
                    if trace else None)
    if trace:
        _require(rec, needed)
    log(f"[setup] {system.docs} documents by db.upsert in "
        f"{system.load_s:.3f} s")
    if control:
        from ..control import Tf32Reference
        ref = Tf32Reference(data.rows, config["metric"], system.index.keeper
                            .device, system.index.ordering)
        system.index.select_batch_async = ref.select_batch_async
    if fault is not None:
        fault(system)
    call = system.call(traffic, params)

    # the first calls flush the rows to the card (and build an HNSW graph)
    t = time.perf_counter()
    for _ in range(2):
        system.db.knn_batch(NAMESPACE, FIELD, data.warm, params)
    if on_card:
        torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t
    # the window starts from a collected heap, as every run's does
    gc.collect()

    prof = Profile(rec, on_card) if trace else None
    win = load.run(call, data.queries, traffic, seed, seconds,
                   traffic["warmup_s"], profile=prof)
    setup_s = win.t0 - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = len(win.requests) + len(win.profiled)
    failed = sum(not r[3] for r in win.requests + win.profiled)
    for e in sorted(set(win.errors))[:5]:
        log(f"[error] {e}")

    result = {"metrics": {}}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        _require(rec, needed, (prof.counters_start, prof.counters_end))
        tr = None
        if prof.prof is not None:
            off = prof.offset_ns
            captures = [(int(s * 1e9) + off, int(e * 1e9) + off)
                        for s, e, _ in rec.spans.get("graph_capture", ())]
            tr = read_trace(prof.prof, int(prof.p0 * 1e9) + off,
                            int(prof.p1 * 1e9) + off, captures)
            n_events = sum(1 for ev in tr.events
                           if tr.t0_ns <= ev[0] < tr.t1_ns)
            log(f"[trace] 1 trace; device events {n_events}, lost launches "
                f"{sum(tr.lost.values())} {tr.lost}; busy {tr.busy_s:.6f} s "
                f"of {tr.window_s:.6f} s")
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        reading = Reading(
            cell=cell, config=config, traffic=traffic,
            setup={"load_s": system.load_s, "docs": system.docs,
                   "first_call_s": first_call_s},
            window=(win.t0, win.t1), requests=win.requests,
            profiled=win.profiled, spans=rec.spans,
            counters={k: (prof.counters_start[k], v)
                      for k, v in prof.counters_end.items()},
            trace=tr, trace_queries=sum(r[2] for r in win.profiled if r[3]),
            trace_offset_ns=prof.offset_ns)
        rec.remove()
        log("[trace] counters over the window: " + ", ".join(
            f"{k} {reading.delta(k)}" for k in sorted(reading.counters)))
        for m in spec.metrics_of(cell_name, "per_layer"):
            value = spec.metric_reader(m["name"]).read(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if tr is not None:
            result["breakdown"] = _breakdown(reading)
    else:
        e2e = {"qps": load.qps(win.requests, win.t0),
               "p95_ms": load.p95_ms(win.requests),
               "peak_dev_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in spec.metrics_of(cell_name, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    lat = sorted(1e3 * (r[1] - r[0]) for r in win.requests)
    log(f"[window] {attempted} requests, {failed} failed, window opened "
        f"{setup_s:.3f} s after the process started (first calls "
        f"{first_call_s:.3f} s); latency ms p50 {np.percentile(lat, 50):.3f}"
        f" p90 {np.percentile(lat, 90):.3f} p99 {np.percentile(lat, 99):.3f}"
        f" max {lat[-1]:.3f}, {sum(x > 100 for x in lat)} over 100 ms")

    samples = []
    for at, out in win.kept:
        for i, res in enumerate(out):
            docs = res.docs()
            samples.append((at + i, [d["id"] for d in docs], res.ranks(),
                            docs))
    rows, queries, groups = data.rows, data.queries, data.groups
    del system, win, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(samples, rows, queries, groups, config["metric"],
                            traffic["k"], config["check"])
    correct = failed == 0 and bool(samples) and check.passed(numbers)
    log(f"[check] {len(samples)} answers against the float64 reference")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              **result, "device": device_info, "checks": numbers}
    return result
