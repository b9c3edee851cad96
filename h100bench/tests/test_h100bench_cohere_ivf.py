"""The `cohere-ivf.knn64-np32` cell on the CPU at a small size: a whole run
is correct; the planted fault of its limits (stage 1 keeps only the best
nprobe / 2 lists) fails `recall_min`; the faults planted under the engine
in the other cells' tests and the TF32 control are not correct either; a
traced run reports the cell's host-side IVF metrics and takes the segment
route on every dispatch; and a program without IVF's spans and counters
(the port before it had them) runs the traced cell and reports none of
them. Then
the three readers on synthetic readings: their arithmetic, and None
outside their cell.

The small size keeps the cell's ratio of probed lists to the lists a
generator centre spans (nprobe 32 over ~32): 4,096 rows around 4 centres in
128 lists, so the fault shows as it does at 100k rows around 32 centres in
1,024 lists (recall about 0.95 sound, 0.7 with half the probes, on the CPU).
"""
import time

import pytest
import torch

from h100bench.harness import measure, program, runner, spec
from reindexer_tpu_torch import IvfSearchParams, VectorMetric, tracing
# the faults planted under the engine in every other cell's runs
from test_h100bench_faults import altered, half_batch, stale, swapped

CELL = "cohere-ivf.knn64-np32"
SEED = 2 ** 31 + 61
NLIST = 128


def small() -> dict:
    config = spec.config("cohere-ivf")
    return {"config": {
        "rows": 4096,
        "index": {**config["index"], "centroids_count": NLIST},
        "generator": {"name": config["generator"]["name"],
                      "params": {**config["generator"]["params"],
                                 "n_centers": 4}}},
        "traffic": {"query_pool": 256, "warmup_s": 0.2, "profile_s": 0.2,
                    "checked_requests": 1_000_000}}


def run(trace: bool = False, **kw) -> dict:
    torch.set_num_threads(2)
    try:
        return runner.run(CELL, SEED, 0.5, trace, time.perf_counter(),
                          device="cpu", overrides=small(), **kw)
    finally:
        tracing.configure(None)
        tracing.take()


def spied(seen: dict):
    """A `fault` that keeps the index and each dispatch's parameters."""
    def spy(built):
        seen["index"] = built.index
        orig = built.index.select_batch_async

        def recorded(queries, params):
            seen.setdefault("params", []).append(params)
            return orig(queries, params)
        built.index.select_batch_async = recorded
    return spy


def half_probes(built):
    """The planted fault: stage 1 keeps only the best nprobe / 2 lists."""
    ix = built.index
    probe = ix._probe_host
    ix._probe_host = lambda q, nprobe: probe(q, max(1, nprobe // 2))


def test_the_cell_is_correct_at_a_small_size():
    seen: dict = {}
    r = run(fault=spied(seen))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"answers_short", "fields_wrong",
                                "misordered", "recall_min", "rank_err"}
    assert seen["index"].nlist == NLIST
    assert seen["index"].metric == VectorMetric.COSINE
    assert seen["params"] and all(
        type(p) is IvfSearchParams and p.nprobe == 32 and p.k == 10
        for p in seen["params"])


def test_half_the_probes_fail_recall_min():
    r = run(fault=half_probes)
    assert not r["correct"]
    checks = r["checks"]
    assert checks["recall_min"]["value"] < checks["recall_min"]["limit"]
    # the fault drops neighbours and nothing else
    for name in ("answers_short", "fields_wrong", "misordered", "rank_err"):
        assert checks[name]["value"] <= checks[name]["limit"], name


@pytest.mark.parametrize("fault", [altered, half_batch, stale, swapped],
                         ids=lambda f: f.__name__)
def test_the_engine_faults_of_the_other_cells_are_not_correct(fault):
    assert not run(fault=fault)["correct"]


def test_the_tf32_control_is_not_correct():
    r = run(control=True)
    assert not r["correct"]
    assert r["checks"]["rank_err"]["value"] > r["checks"]["rank_err"]["limit"]


def keep_readings(monkeypatch, readings: list) -> None:
    load = spec.metric_reader

    def keep(name):
        mod = load(name)

        class Reader:
            PROBES = mod.PROBES

            @staticmethod
            def read(r):
                readings.append(r)
                return mod.read(r)
        return Reader
    monkeypatch.setattr(spec, "metric_reader", keep)


def test_a_traced_run_reports_the_cells_host_metrics(monkeypatch):
    # the segment route, as the card's router takes it at 64 queries
    monkeypatch.setenv("RX_IVF_SEGMENTS", "1")
    readings: list = []
    keep_readings(monkeypatch, readings)
    r = run(trace=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"upsert_us", "engine_ms", "ivf_host_ms",
                                 "ivf_build_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    rd = readings[0]
    dispatches = rd.delta("program.engine.dispatches")
    assert dispatches > 0
    assert rd.delta("program.ivf.segment_scans") == dispatches
    assert rd.delta("program.ivf.masked_sweeps") == 0
    assert rd.delta("program.ivf.seg_live") > 0
    assert 0 < rd.delta("program.ivf.seg_rows") <= \
        128 * rd.delta("program.ivf.seg_live")


def test_a_program_without_ivf_spans_runs_the_traced_cell(monkeypatch):
    monkeypatch.setenv("RX_IVF_SEGMENTS", "1")
    monkeypatch.setattr(tracing, "SPANS", tuple(
        n for n in tracing.SPANS if not n.startswith("ivf.")))
    span = tracing.span
    monkeypatch.setattr(tracing, "span", lambda name, **kw: (
        tracing.OFF if name.startswith("ivf.") else span(name, **kw)))
    counters = tracing.counters
    monkeypatch.setattr(tracing, "counters", lambda: {
        k: v for k, v in counters().items()
        if k not in ("ivf.seg_rows", "ivf.seg_live")})
    r = run(trace=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"upsert_us", "engine_ms"}


# --- the readers on synthetic readings ---------------------------------

def span(name, start, end, sid, parent=0):
    return (name, start, end, 1, sid, parent, sid, {})


def reading(monkeypatch, spans, **kw):
    monkeypatch.setitem(program._state, "spans", spans)
    kw.setdefault("window", (10.0, 20.0))
    kw.setdefault("counters", {})
    kw.setdefault("traffic", spec.traffic("knn64-np32"))
    kw.setdefault("config", spec.config("cohere-ivf"))
    kw.setdefault("trace", None)
    return runner.Reading(**kw)


def read(name, r):
    return spec.metric_reader(name).read(r)


def test_ivf_host_ms_is_probe_and_plan_per_dispatch(monkeypatch):
    spans = [span("engine.dispatch", 11.0, 11.01, 1),
             span("ivf.probe", 11.001, 11.003, 2, 1),
             span("ivf.plan", 11.003, 11.004, 3, 1),
             span("engine.dispatch", 12.0, 12.01, 4),
             span("ivf.probe", 12.001, 12.002, 5, 4),
             # set-up's first dispatch, before the window
             span("engine.dispatch", 5.0, 6.0, 6),
             span("ivf.probe", 5.1, 5.9, 7, 6)]
    assert read("ivf_host_ms", reading(monkeypatch, spans)) == \
        pytest.approx(1e3 * 0.004 / 2)


def test_ivf_build_s_sums_set_ups_train_and_reorder(monkeypatch):
    spans = [span("ivf.train", 4.0, 5.5, 1),
             span("ivf.reorder", 5.6, 5.8, 2),
             # a rebuild in the window is not set-up's
             span("ivf.train", 12.0, 13.0, 3)]
    assert read("ivf_build_s", reading(monkeypatch, spans)) == \
        pytest.approx(1.7)


def k6_trace(times_ms: list, name="void ivf_seg_scan_kernel(Args)"):
    events, t = [], 1_000_000
    for ms in times_ms:
        events.append((t, t + int(ms * 1e6), name))
        t += 10_000_000
    # the grouping kernels of each call are not the scan
    events.append((t, t + 5_000, "void ivf_seg_scan_order(Args)"))
    return measure.DeviceTrace(events, {}, 0, t + 1_000_000)


def test_k6_roofline_is_the_bound_of_the_mean_call(monkeypatch):
    counters = {"program.ivf.segment_scans": (10, 110),
                "program.ivf.seg_rows": (0, 100 * 96_000),
                "program.ivf.seg_live": (0, 100 * 2_600)}
    r = reading(monkeypatch, [], counters=counters,
                trace=k6_trace([0.1, 0.12, 0.14]))
    d, q = 768, 64
    n_bytes = 4 * (96_000 * d + q * d + 128 * 2_600)
    ops = 3 * 2 * 128 * d * 2_600
    want = 100.0 * max(n_bytes / measure.PEAK_BYTES_S,
                       ops / measure.PEAK_OPS_S["tf32"]) / 0.12e-3
    assert read("k6_roofline", r) == pytest.approx(want)
    # bound by the bytes of the distinct probed blocks
    assert n_bytes / measure.PEAK_BYTES_S > ops / measure.PEAK_OPS_S["tf32"]
    assert 0 < read("k6_roofline", r) < 100


@pytest.mark.parametrize("name", ["ivf_host_ms", "ivf_build_s",
                                  "k6_roofline"])
def test_each_reader_reads_nothing_outside_its_cell(monkeypatch, name):
    # a BF cell's traced reading: dispatches and a trace, no IVF span,
    # counter or K6 event
    bf = reading(monkeypatch, [span("engine.dispatch", 11.0, 11.01, 1)],
                 traffic=spec.traffic("knn64-k100"),
                 config=spec.config("sift-bf"),
                 counters={"program.engine.dispatches": (0, 100)},
                 trace=k6_trace([0.05], name="void bf_scan_kernel(Args)"))
    assert read(name, bf) is None
    # the parent program on this cell: K6 ran, the new counters and spans
    # were not there to read
    parent = reading(monkeypatch, [span("engine.dispatch", 11.0, 11.01, 1)],
                     counters={"program.ivf.segment_scans": (0, 100)},
                     trace=k6_trace([0.1]))
    assert read(name, parent) is None
