"""The program's own spans and counters in the traced run: the readers of
h100bench/metrics/ that read them, on synthetic readings; and CPU traced
runs of small cells, in which the program's engine spans agree with the
harness's outside `engine` span, a span or counter the program no longer
has fails the run with no result, and a program with no span registry
(the port before it had one) runs and reports none of these metrics."""
import time

import pytest
import torch

from h100bench.harness import measure, program, runner, spec
from reindexer_tpu_torch import tracing

ROWS = {"sift-bf": 1500, "deep-hnsw": 1000}


def span(name, start, end, sid, parent=0, trace=None, thread=1, **attrs):
    return (name, start, end, thread, sid, parent,
            sid if trace is None else trace, attrs)


def reading(monkeypatch, spans, **kw):
    monkeypatch.setitem(program._state, "spans", spans)
    kw.setdefault("window", (10.0, 20.0))
    kw.setdefault("counters", {})
    return runner.Reading(**kw)


def read(name, r):
    return spec.metric_reader(name).read(r)


def test_ns_lock_wait_is_the_mean_of_each_requests_waits(monkeypatch):
    spans = [span("Reindexer.Query", 11.0, 11.5, 1),
             span("ns.lock_wait", 11.0, 11.1, 2, 1, 1),
             span("ns.lock_wait", 11.3, 11.4, 3, 1, 1),
             span("Reindexer.Query", 12.0, 12.5, 4),
             # a request of the profiled phase, after the window
             span("Reindexer.Query", 30.0, 31.0, 5),
             span("ns.lock_wait", 30.0, 30.9, 6, 5, 5)]
    r = reading(monkeypatch, spans)
    assert read("ns_lock_wait_ms", r) == pytest.approx(1e3 * 0.2 / 2)
    assert read("ns_lock_wait_ms", reading(monkeypatch, spans[:1])) is None


def test_dynbatch_wait_is_the_mean_wait_of_the_window(monkeypatch):
    spans = [span("dynbatch.wait", 11.0, 11.002, 1, role="leader"),
             span("dynbatch.wait", 11.0, 11.004, 2, role="served"),
             span("dynbatch.wait", 25.0, 26.0, 3, role="served")]
    assert read("dynbatch_wait_ms", reading(monkeypatch, spans)) == \
        pytest.approx(3.0)
    assert read("dynbatch_wait_ms", reading(monkeypatch, [])) is None


def test_engine_wait_is_device_waits_and_stop_reads_per_dispatch(
        monkeypatch):
    spans = [span("engine.dispatch", 11.0, 11.05, 1),
             span("hnsw.stop_read", 11.01, 11.02, 2, 1, 1),
             span("hnsw.stop_read", 11.03, 11.04, 3, 1, 1),
             span("engine.device_wait", 11.04, 11.05, 4, 1, 1),
             span("engine.dispatch", 12.0, 12.01, 5),
             span("engine.device_wait", 12.02, 12.03, 6, 5, 5)]
    assert read("engine_wait_ms", reading(monkeypatch, spans)) == \
        pytest.approx(1e3 * 0.04 / 2)
    assert read("engine_wait_ms", reading(monkeypatch, [])) is None


def test_captures_per_dispatch_is_a_ratio_of_counter_changes(monkeypatch):
    counters = {"program.hnsw.graph_captures": (5, 105),
                "program.engine.dispatches": (7, 207)}
    r = reading(monkeypatch, [], counters=counters)
    assert read("hnsw_captures_per_dispatch", r) == 0.5
    # a program that counts nothing: nothing to read
    zero = {k: (0, 0) for k in counters}
    assert read("hnsw_captures_per_dispatch",
                reading(monkeypatch, [], counters=zero)) is None


def test_link_seconds_are_the_builds_link_less_its_waits(monkeypatch):
    spans = [span("hnsw.commit", 1.0, 1.001, 1),
             span("hnsw.commit", 2.0, 8.0, 2),
             span("hnsw.build.link", 3.0, 8.0, 4, 2, 2),
             span("hnsw.build.wait", 3.0, 4.5, 5, 4, 2),
             span("hnsw.build.wait", 6.0, 6.5, 6, 4, 2),
             # an incremental commit inside the window is not set-up's
             span("hnsw.commit", 11.0, 19.0, 7)]
    assert read("hnsw_link_s", reading(monkeypatch, spans)) == \
        pytest.approx(3.0)
    assert read("hnsw_link_s", reading(monkeypatch, spans[:1])) is None


def test_upsert_index_us_reads_set_ups_counts(monkeypatch):
    counters = {"program.ns.upserts": (1000, 1000),
                "program.ns.upsert_index_ns": (25_000_000, 25_000_000)}
    r = reading(monkeypatch, [], counters=counters)
    assert read("upsert_index_us", r) == pytest.approx(25.0)
    zero = {k: (0, 0) for k in counters}
    assert read("upsert_index_us",
                reading(monkeypatch, [], counters=zero)) is None


def test_idle_unspanned_share_attributes_gaps_by_their_middle(monkeypatch,
                                                             capsys):
    off = 1_000_000_000_000
    # device busy [0, 10] and [40, 50] ns after 10 s: gaps [10, 40] and
    # [50, 100]; a request's root and another's lock wait cover both gaps'
    # middles, a span of work the first one's only
    t0 = 10_000_000_000
    tr = measure.DeviceTrace([(t0 + off, t0 + 10 + off, "k"),
                              (t0 + 40 + off, t0 + 50 + off, "k")], {},
                             t0 + off, t0 + 100 + off)
    root = span("Reindexer.Query", 10.0, 10.0 + 90e-9, 1)
    spans = [root,
             span("engine.dispatch", 10.0 + 20e-9, 10.0 + 30e-9, 2, 1, 1),
             span("engine.drain", 10.0 + 15e-9, 10.0 + 35e-9, 3, 9, 9,
                  thread=2),
             span("ns.lock_wait", 10.0 + 10e-9, 10.0 + 90e-9, 4, 9, 9,
                  thread=3)]
    r = reading(monkeypatch, spans, trace=tr, trace_offset_ns=off)
    assert read("idle_unspanned_share", r) == pytest.approx(50 / 80)
    # the log gives the first gap to the innermost (shortest) open span
    log = capsys.readouterr().err
    assert "engine.dispatch 0.000000" in log and "engine.drain" not in log
    # a root or a wait alone explains nothing, nor a dispatch whose thread
    # waits inside it
    r = reading(monkeypatch, [root, spans[-1]], trace=tr,
                trace_offset_ns=off)
    assert read("idle_unspanned_share", r) == 1.0
    parked = [span("dynbatch.dispatch", 10.0, 10.0 + 90e-9, 5, 1, 1),
              span("ns.lock_wait", 10.0 + 5e-9, 10.0 + 85e-9, 6, 5, 1)]
    r = reading(monkeypatch, [root] + parked, trace=tr, trace_offset_ns=off)
    assert read("idle_unspanned_share", r) == 1.0
    r = reading(monkeypatch, [], trace=tr, trace_offset_ns=off)
    assert read("idle_unspanned_share", r) is None


def traced(cell: str, monkeypatch, readings: list | None = None,
           **traffic) -> dict:
    """A traced run of `cell` on the CPU at a small size (`traffic`
    overrides more of its traffic); each reading the readers get is
    appended to `readings`."""
    if readings is not None:
        load = spec.metric_reader

        def keep(name):
            mod = load(name)
            read = mod.read

            class Reader:
                PROBES = mod.PROBES

                @staticmethod
                def read(r):
                    readings.append(r)
                    return read(r)
            return Reader
        monkeypatch.setattr(spec, "metric_reader", keep)
    torch.set_num_threads(2)
    config = spec.cell(cell)["config"]
    try:
        return runner.run(cell, 2 ** 31 + 97, 0.5, True, time.perf_counter(),
                          device="cpu", overrides={
                              "config": {"rows": ROWS[config]},
                              "traffic": {"query_pool": 256,
                                          "warmup_s": 0.2,
                                          "profile_s": 0.2, **traffic}})
    finally:
        tracing.configure(None)
        tracing.take()


@pytest.mark.parametrize("cell,metrics", [
    ("sift-bf.knn64-k100", {"assembly_ms", "engine_ms", "upsert_us",
                            "request_p95_ms", "engine_wait_ms",
                            "upsert_index_us"}),
    ("deep-hnsw.knn64-ef128", {"assembly_ms", "engine_ms", "upsert_us",
                               "hnsw_beam_steps", "hnsw_build_s",
                               "engine_wait_ms", "upsert_index_us",
                               "hnsw_captures_per_dispatch",
                               "hnsw_link_s"}),
    ("sift-bf.select-k10-c16", {"dispatch_batch", "engine_ms", "upsert_us",
                                "request_p95_ms", "ns_lock_wait_ms",
                                "dynbatch_wait_ms", "engine_wait_ms",
                                "upsert_index_us"}),
])
def test_a_traced_run_reports_the_programs_metrics(cell, metrics,
                                                   monkeypatch):
    r = traced(cell, monkeypatch)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == metrics
    for name, m in r["metrics"].items():
        # no CUDA graph is captured on the CPU
        assert m["value"] > 0 or (name == "hnsw_captures_per_dispatch"
                                  and m["value"] == 0), name


@pytest.mark.parametrize("cell", ["deep-hnsw.knn64-ef128",
                                  "sift-bf.select-k10-c16"])
def test_program_engine_spans_agree_with_the_outside_one(cell, monkeypatch):
    """Each outside `engine` span (select_batch_async's entry to its
    drain's return) holds one `engine.dispatch` and then one
    `engine.drain` of its thread, and spans as long as the first's start
    to the second's end. Their sum is its length less the caller's step
    between them: in knn_batch the lock's release, a few us; in the
    executor (c3) the lock's release and the cancel check, tens of us
    under 16 threads, 4-7% of a BF select's engine time, so the sum is
    held to the outside span within 5% on the HNSW cell only."""
    readings = []
    r = traced(cell, monkeypatch, readings)
    assert r["correct"], r["checks"]
    rd = readings[0]
    outside = sorted(rd.spans_in("engine"))
    dispatch = program.spans("engine.dispatch")
    drain = program.spans("engine.drain")
    pairs = []
    for a, b, thread in outside:
        d = [s for s in dispatch if a <= s[1] and s[2] <= b
             and s[3] == thread]
        e = [s for s in drain if a <= s[1] and s[2] <= b and s[3] == thread]
        assert len(d) == len(e) == 1 and d[0][2] <= e[0][1]
        pairs.append((b - a, d[0], e[0]))
    assert pairs
    n = len(pairs)
    outside_s = sum(p[0] for p in pairs) / n
    extent_s = sum(e[2] - d[1] for _, d, e in pairs) / n
    sum_s = sum((d[2] - d[1]) + (e[2] - e[1]) for _, d, e in pairs) / n
    assert extent_s == pytest.approx(outside_s, rel=0.05)
    if cell.startswith("deep-hnsw"):
        assert sum_s == pytest.approx(outside_s, rel=0.05)


@pytest.mark.parametrize("cell,name,probe", [
    ("sift-bf.select-k10-c16", "engine.dispatch", "program.engine.dispatch"),
    ("sift-bf.select-k10-c16", "dynbatch.wait", "program.dynbatch.wait"),
    ("deep-hnsw.knn64-ef128", "hnsw.build.link", "program.hnsw.build.link"),
])
def test_a_renamed_program_span_fails_the_traced_run(cell, name, probe,
                                                     monkeypatch):
    monkeypatch.setattr(tracing, "SPANS", tuple(
        n + "_renamed" if n == name else n for n in tracing.SPANS))
    with pytest.raises(SystemExit, match=f"no target .*{probe} "):
        traced(cell, monkeypatch)


def test_a_renamed_program_counter_fails_the_traced_run(monkeypatch):
    counters = tracing.counters
    monkeypatch.setattr(tracing, "counters", lambda: {
        k: v for k, v in counters().items() if k != "engine.dispatches"})
    with pytest.raises(SystemExit,
                       match="no target .*program.engine.dispatches "):
        traced("deep-hnsw.knn64-ef128", monkeypatch)


def test_a_program_without_span_registry_reports_none_of_them(monkeypatch,
                                                              capsys):
    # the port before its spans: its tracing has no SPANS and no counters
    monkeypatch.delattr(tracing, "SPANS")
    r = traced("sift-bf.select-k10-c16", monkeypatch)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"dispatch_batch", "engine_ms", "upsert_us",
                                 "request_p95_ms"}
    assert "no span registry" in capsys.readouterr().err
    assert not tracing.on and tracing.take() == []


def test_only_the_recording_probe_starts_the_recording():
    tracing.configure(None)
    try:
        probe = program.__getattr__("span:engine.dispatch")
        counter = program.__getattr__("counter:engine.dispatches")
        assert probe.value == 0 and not tracing.on
        assert program.__getattr__("span:engine.renamed") is None
        assert program.__getattr__("counter:engine.renamed") is None
        assert program.recording.value == 0 and tracing.on
        tracing.counter("engine.dispatches").add(3)
        assert counter.value == 3
    finally:
        tracing.configure(None)
        tracing.take()
