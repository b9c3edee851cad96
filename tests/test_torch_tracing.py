"""reindexer_tpu_torch's tracing: spans and counters inside the program.

Off, a span site records nothing and the event counters still count. On,
`knn_batch` and `select` over a small BF and a small HNSW namespace give
the span tree of the program's layers (names and parents, one trace id a
request), dynbatch waiters point at the leader's dispatch that served them,
spans moved to unix time by the anchor enclose torch.profiler's events,
the JSONL exporter writes OTLP lines at flush and keeps every span past the
buffer's capacity, a buffer kept for `take()` counts the spans it drops
past its cap, and a collection is a `python.gc` span under its request.
A `knn_batch` counts the lane that assembled its results, the C++ one or
the Python loop. On the CPU, a few seconds.
"""
import ast
import gc
import json
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from reindexer_tpu_torch import (FloatVectorOpts, HnswSearchParams, IndexDef,
                                 IndexOpts, KnnSearchParams, Query,
                                 Reindexer, VectorMetric, tracing)
from reindexer_tpu_torch.query import dynbatch

torch.set_num_threads(2)

DIMS, ROWS = 16, 400
PKG = Path(tracing.__file__).resolve().parent


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.configure(None)
    tracing.take()
    yield
    tracing.configure(None)
    tracing.take()


def make_db(kind: str) -> Reindexer:
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(ROWS, DIMS)).astype(np.float32)
    opts = FloatVectorOpts(dims=DIMS, metric=VectorMetric.L2)
    if kind == "hnsw":
        opts = FloatVectorOpts(dims=DIMS, metric=VectorMetric.L2, m=8,
                               ef_construction=32)
    if kind == "ivf":
        opts = FloatVectorOpts(dims=DIMS, metric=VectorMetric.L2,
                               centroids_count=8)
    db = Reindexer(device="cpu")
    db.open_namespace("ns", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("v", kind, vector_opts=opts)])
    for i, row in enumerate(rows.tolist()):
        db.upsert("ns", {"id": i, "v": row})
    return db


def params(kind: str):
    return HnswSearchParams(k=5, ef=32) if kind == "hnsw" else \
        KnnSearchParams(k=5)


def queries(n: int) -> np.ndarray:
    return np.random.default_rng(9).normal(size=(n, DIMS)).astype(
        np.float32)


def run(db, kind: str, entry: str):
    if entry == "knn_batch":
        return db.knn_batch("ns", "v", queries(4), params(kind))
    return db.select(Query("ns").where_knn("v", queries(1)[0],
                                           params(kind)))


def edges(spans: list) -> set:
    """(name, parent's name) of every span; the root's parent is None."""
    by_id = {s[4]: s for s in spans}
    return {(s[0], by_id[s[5]][0] if s[5] else None) for s in spans}


def test_off_records_nothing_and_event_counters_count():
    db = make_db("vec_bf")
    before = tracing.counters()
    run(db, "vec_bf", "knn_batch")
    run(db, "vec_bf", "select")
    after = tracing.counters()
    assert not tracing.on and tracing.take() == []
    assert after["engine.dispatches"] - before["engine.dispatches"] == 2
    # the upsert pair counts only while tracing is on
    db.upsert("ns", {"id": 0, "v": [0.0] * DIMS})
    assert tracing.counters()["ns.upserts"] == after["ns.upserts"]


def test_registered_counters_keep_their_module_attributes():
    from reindexer_tpu_torch.core import namespace
    from reindexer_tpu_torch.index.vector import brute_force, ivf
    from reindexer_tpu_torch.ops import hnsw_kernels
    assert tracing.counter("hnsw.beam_steps") is hnsw_kernels.beam_steps
    assert tracing.counter("ivf.seg_rows") is ivf.seg_rows
    assert tracing.counter("ivf.seg_live") is ivf.seg_live
    assert tracing.counter("ns.hash_fallbacks") is namespace.hash_fallbacks
    assert (tracing.counter("kernels.hnsw_descend")
            is hnsw_kernels.hnsw_descend_launches)
    assert tracing.counter("bf.overflow_reruns") is brute_force.overflow_reruns
    assert {"hnsw.graph_captures", "engine.dispatches", "ns.upserts",
            "ns.upsert_index_ns", "tracing.dropped",
            "kernels.bf_scan", "ivf.seg_rows", "ivf.seg_live",
            "ns.hash_fallbacks"} <= set(tracing.counters())



def test_the_assembly_counters_are_registered():
    from reindexer_tpu_torch.core import database
    assert (tracing.counter("knn_batch.native_assemblies")
            is database.native_assemblies)
    assert (tracing.counter("knn_batch.python_assemblies")
            is database.python_assemblies)
    assert {"knn_batch.native_assemblies",
            "knn_batch.python_assemblies"} <= set(tracing.counters())


@pytest.mark.parametrize("lane", ["native", "python"])
def test_a_knn_batch_counts_the_lane_of_its_assembly(lane, monkeypatch):
    from reindexer_tpu_torch.query import executor
    if lane == "python":
        monkeypatch.setattr(executor, "_scalar_native", lambda: None)
    elif executor._scalar_native() is None:
        pytest.skip("the C++ lane did not build: no compiler")
    db = make_db("vec_bf")
    before = tracing.counters()
    run(db, "vec_bf", "knn_batch")
    after = tracing.counters()
    added = {name: after[name] - before[name]
             for name in ("knn_batch.native_assemblies",
                          "knn_batch.python_assemblies")}
    other = "python" if lane == "native" else "native"
    assert added == {f"knn_batch.{lane}_assemblies": 1,
                     f"knn_batch.{other}_assemblies": 0}

BF_BATCH = {("Reindexer.knn_batch", None),
            ("ns.lock_wait", "Reindexer.knn_batch"),
            ("engine.dispatch", "Reindexer.knn_batch"),
            ("engine.drain", "Reindexer.knn_batch"),
            ("engine.device_wait", "engine.drain"),
            ("knn_batch.assemble", "Reindexer.knn_batch")}
SELECT = {("Reindexer.Query", None),
          ("ns.lock_wait", "Reindexer.Query"),
          ("dynbatch.wait", "Reindexer.Query"),
          ("dynbatch.dispatch", "Reindexer.Query"),
          ("engine.dispatch", "dynbatch.dispatch"),
          ("engine.drain", "dynbatch.dispatch"),
          ("ns.lock_wait", "dynbatch.dispatch")}
HNSW_ENGINE = {("hnsw.stop_read", "engine.dispatch"),
               ("engine.device_wait", "engine.dispatch")}
TREES = {
    ("vec_bf", "knn_batch"): BF_BATCH,
    ("vec_bf", "select"): SELECT | {("engine.device_wait", "engine.drain")},
    ("hnsw", "knn_batch"): (BF_BATCH - {("engine.device_wait",
                                         "engine.drain")}) | HNSW_ENGINE,
    ("hnsw", "select"): SELECT | HNSW_ENGINE,
    # the CPU's IVF route is the masked sweep: stage 1 on the host, no plan
    ("ivf", "knn_batch"): (BF_BATCH - {("engine.device_wait",
                                        "engine.drain")})
    | {("ivf.probe", "engine.dispatch")},
    ("ivf", "select"): SELECT | {("ivf.probe", "engine.dispatch")},
}


@pytest.mark.parametrize("kind,entry", sorted(TREES))
def test_a_request_gives_the_span_tree_of_its_layers(kind, entry):
    db = make_db(kind)
    run(db, kind, entry)        # commits the pending rows (HNSW: builds)
    tracing.configure(keep=True)
    run(db, kind, entry)
    spans = tracing.take()
    assert edges(spans) >= TREES[kind, entry]
    # nothing left to build; a BF search reads no stop flag
    names = {s[0] for s in spans}
    assert "hnsw.commit" not in names
    if kind == "vec_bf":
        assert "hnsw.stop_read" not in names
    # one request: one trace, rooted at the request's span; every child
    # lies inside its parent
    spans = [s for s in spans if s[0] != "python.gc"]
    roots = [s for s in spans if not s[5]]
    assert len(roots) == 1 and {s[6] for s in spans} == {roots[0][4]}
    by_id = {s[4]: s for s in spans}
    for s in spans:
        assert s[1] <= s[2]
        if s[5]:
            assert by_id[s[5]][1] <= s[1] and s[2] <= by_id[s[5]][2]


def test_an_hnsw_build_gives_commit_dispatch_link_and_wait():
    db = make_db("hnsw")
    tracing.configure(keep=True)
    run(db, "hnsw", "knn_batch")
    spans = tracing.take()
    assert edges(spans) >= {("hnsw.commit", "engine.dispatch"),
                            ("hnsw.build.link", "hnsw.commit"),
                            ("hnsw.build.wait", "hnsw.build.link")}
    commit = next(s for s in spans if s[0] == "hnsw.commit")
    assert commit[7]["rows"] == ROWS
    # a search with nothing pending commits nothing
    run(db, "hnsw", "knn_batch")
    assert "hnsw.commit" not in {s[0] for s in tracing.take()}


def test_an_ivf_build_and_search_give_their_stage_spans(monkeypatch):
    assert {"ivf.probe", "ivf.plan", "ivf.train",
            "ivf.reorder"} <= set(tracing.SPANS)
    monkeypatch.setenv("RX_IVF_SEGMENTS", "1")
    db = make_db("ivf")
    tracing.configure(keep=True)
    before = tracing.counters()
    run(db, "ivf", "knn_batch")
    spans = tracing.take()
    ivf = sorted(s[0] for s in spans if s[0].startswith("ivf."))
    assert ivf == ["ivf.plan", "ivf.probe", "ivf.reorder", "ivf.train"]
    assert edges(spans) >= {(name, "engine.dispatch") for name in ivf}
    after = tracing.counters()
    assert after["ivf.seg_live"] > before["ivf.seg_live"]
    assert after["ivf.seg_rows"] > before["ivf.seg_rows"]
    # built: a search is stage 1 and the plan
    run(db, "ivf", "knn_batch")
    assert sorted(s[0] for s in tracing.take() if s[0].startswith(
        "ivf.")) == ["ivf.plan", "ivf.probe"]


def test_upserts_count_their_index_time_while_tracing_is_on():
    db = make_db("vec_bf")
    perf = db.get_namespace("ns").perf
    tracing.configure(keep=True)
    before = tracing.counters()
    us = perf.total_us["updates"]
    for i in range(10):
        db.upsert("ns", {"id": ROWS + i, "v": [float(i)] * DIMS})
    after = tracing.counters()
    d = {k: after[k] - before[k] for k in ("ns.upserts", "ns.upsert_index_ns")}
    assert d["ns.upserts"] == 10
    # inside the whole upserts' time (#perfstats)
    assert 0 < d["ns.upsert_index_ns"] < 1e3 * (perf.total_us["updates"] - us)
    # no span a document
    assert all(s[0] == "python.gc" for s in tracing.take())


def test_every_dynbatch_wait_points_at_a_dispatch(monkeypatch):
    db = make_db("vec_bf")
    run(db, "vec_bf", "select")
    # one dispatch in flight at a time, each slow enough for the other
    # threads to queue behind it: the next leader serves them
    monkeypatch.setattr(dynbatch, "MAX_INFLIGHT", 1)
    index = db.get_namespace("ns").get_index("v")
    dispatch = index.select_batch_async

    def slow(qs, p):
        drain = dispatch(qs, p)

        def slow_drain():
            time.sleep(0.01)     # the ns lock is released in the drain
            return drain()
        return slow_drain
    monkeypatch.setattr(index, "select_batch_async", slow)
    tracing.configure(keep=True)
    start = threading.Barrier(4)
    errors = []

    def client(c):
        try:
            start.wait(timeout=30)
            for j in range(10):
                q = queries(40)[c * 10 + j]
                res = db.select(Query("ns").where_knn("v", q,
                                                      params("vec_bf")))
                assert len(res.docs()) == 5
        except Exception as e:      # reported below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = tracing.take()
    dispatches = {s[4]: s for s in spans if s[0] == "dynbatch.dispatch"}
    waits = [s for s in spans if s[0] == "dynbatch.wait"]
    assert len(waits) == 40
    assert sum(d[7]["queries"] for d in dispatches.values()) == 40
    roles = {w[7]["role"] for w in waits}
    assert roles == {"leader", "served"}
    for w in waits:
        d = dispatches[w[7]["dispatch"]]
        if w[7]["role"] == "served":
            # the leader's dispatch, on another thread, for its request
            assert d[3] != w[3] and d[6] != w[6] and d[7]["queries"] > 1
            assert d[2] <= w[2]
        else:
            assert d[3] == w[3] and d[6] == w[6]
        assert d[7]["padded"] == dynbatch.bucket_of(d[7]["queries"])


def test_spans_share_the_profilers_time_base():
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.configure(keep=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("engine.dispatch") as sp:
            with record_function("rx_probe"):
                time.sleep(0.02)
    rec = next(s for s in tracing.take() if s[4] == sp.id)
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "rx_probe")
    start, end = (rec[1] + tracing.anchor_ns(), rec[2] + tracing.anchor_ns())
    ev_start = ev.start_ns()
    ev_end = ev_start + ev.duration_ns()
    assert start - 1_000_000 <= ev_start and ev_end <= end + 1_000_000
    assert ev.duration_ns() >= 19_000_000


def test_jsonl_exporter_writes_otlp_lines_at_flush(tmp_path):
    path = tmp_path / "spans.jsonl"
    tracing.configure(tracing.JsonlExporter(str(path)))
    with tracing.span("Reindexer.Query", namespace="ns") as root:
        with tracing.span("engine.dispatch", queries=1):
            pass
    assert not path.exists()
    tracing.flush()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [s["name"] for s in lines] == ["engine.dispatch",
                                          "Reindexer.Query"]
    child, parent = lines
    assert child["trace_id"] == parent["trace_id"]
    assert child["parent_span_id"] == parent["span_id"] == f"{root.id:016x}"
    assert parent["parent_span_id"] is None
    assert parent["attributes"]["namespace"] == "ns"
    assert abs(parent["start_time_unix_nano"] - time.time_ns()) < 10 ** 10
    assert parent["start_time_unix_nano"] <= child["start_time_unix_nano"]
    assert child["end_time_unix_nano"] <= parent["end_time_unix_nano"]
    assert parent["status"] == "OK"
    # configure flushes what the replaced exporter recorded
    with tracing.span("Reindexer.Query"):
        pass
    tracing.configure(None)
    assert len(path.read_text().splitlines()) == 3


def test_the_buffer_cap_counts_the_spans_it_drops(monkeypatch):
    # a buffer kept for take(): the spans past its cap are dropped
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.configure(keep=True)
    before = tracing.dropped.value
    for i in range(5):
        tracing.record("engine.device_wait", i, i + 1)
    assert tracing.dropped.value - before == 2
    assert len(tracing.take()) == 3


def test_an_exporter_past_the_cap_keeps_every_span(monkeypatch, tmp_path):
    # the span that fills the buffer flushes it to the exporter's file
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    path = tmp_path / "spans.jsonl"
    tracing.configure(tracing.JsonlExporter(str(path)))
    before = tracing.dropped.value
    gc.disable()        # no python.gc span among the counted ones
    try:
        for i in range(10):
            with tracing.span("engine.dispatch", i=i):
                pass
    finally:
        gc.enable()
    assert len(path.read_text().splitlines()) == 9
    tracing.flush()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [s["attributes"]["i"] for s in lines] == list(range(10))
    assert tracing.dropped.value == before


def test_an_exporter_is_flushed_while_the_program_runs(monkeypatch,
                                                       tmp_path):
    # a span closing FLUSH_NS after the last flush flushes the buffer, so a
    # daemon's trace file grows while it serves
    path = tmp_path / "spans.jsonl"
    tracing.configure(tracing.JsonlExporter(str(path)))
    gc.disable()        # no python.gc span among the counted ones
    try:
        with tracing.span("Reindexer.Query"):
            pass
        assert not path.exists()
        monkeypatch.setattr(tracing, "FLUSH_NS", 0)
        with tracing.span("Reindexer.Query"):
            pass
    finally:
        gc.enable()
    assert len(path.read_text().splitlines()) == 2


def test_a_collection_is_a_span_under_its_request():
    tracing.configure(keep=True)
    with tracing.span("Reindexer.Query") as root:
        gc.collect()
    spans = tracing.take()
    coll = [s for s in spans if s[0] == "python.gc"]
    assert coll and coll[0][5] == root.id and coll[0][6] == root.id
    tracing.configure(None)
    assert tracing._on_gc not in gc.callbacks


def test_an_error_is_recorded_on_its_span():
    tracing.configure(keep=True)
    with pytest.raises(ValueError):
        with tracing.span("engine.dispatch"):
            raise ValueError("boom")
    rec = tracing.take()[0]
    assert "boom" in rec[7]["exception"]
    assert tracing.to_otlp(rec)["status"] == "ERROR"


def test_an_http_request_is_the_root_of_its_query():
    from reindexer_tpu_torch.server.http import ReindexerServer
    exp = tracing.InMemoryExporter()
    tracing.configure(exp)
    srv = ReindexerServer(port=0, device="cpu")
    try:
        srv.start()
        db = srv.mgr.create("t")
        db.open_namespace("items", [
            IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True))])
        db.upsert("items", {"id": 1})
        url = f"http://127.0.0.1:{srv.port}/api/v1/db/t/sqlquery"
        req = urllib.request.Request(url, data=b"SELECT * FROM items",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            json.loads(r.read())
    finally:
        srv.stop()
        tracing.configure(None)
    child = next(s for s in exp.spans if s["name"] == "Reindexer.Query")
    parent = next(s for s in exp.spans if s["name"] == "HTTP POST")
    assert child["trace_id"] == parent["trace_id"]
    assert child["parent_span_id"] == parent["span_id"]


def test_every_span_site_names_a_listed_span():
    """Each literal name a `tracing.span` / `record` / `device_read` /
    `acquire` call of the package passes is in SPANS, and each listed name
    has a site (the collector's `python.gc` is tracing's own)."""
    sites = {"span", "record", "device_read", "acquire"}
    used = {"python.gc"}
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in sites
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "tracing"):
                used |= {a.value for a in node.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str)}
    assert used == set(tracing.SPANS)


@pytest.mark.cuda
def test_on_the_card_a_search_captures_and_replays_its_beam_graph():
    """On the card a search launches the descent kernel once and K7 once
    and reads no stop flag: no `hnsw.stop_read` span, the device wait
    under the dispatch; two searches of the same queries give identical
    answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the HNSW kernels run only there")
    rng = np.random.default_rng(3)
    db = Reindexer(device="cuda")
    db.open_namespace("ns", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("v", "hnsw", vector_opts=FloatVectorOpts(
            dims=DIMS, metric=VectorMetric.L2, m=8, ef_construction=32))])
    for i, row in enumerate(rng.normal(size=(2000, DIMS)).tolist()):
        db.upsert("ns", {"id": i, "v": row})
    p = HnswSearchParams(k=10, ef=128)
    tracing.configure(keep=True)
    runs = []
    for _ in range(2):
        before = tracing.counters()
        res = db.knn_batch("ns", "v", queries(8), p)
        after = tracing.counters()
        spans = tracing.take()
        assert ("engine.device_wait", "engine.dispatch") in edges(spans)
        assert not any(s[0] == "hnsw.stop_read" for s in spans)
        d = {k: after[k] - before[k] for k in after}
        assert d["engine.dispatches"] == 1
        assert d["kernels.hnsw_descend"] == d["kernels.hnsw_beam"] == 1
        assert d["hnsw.graph_captures"] == 0
        runs.append([(r.row_ids().tolist(), r.ranks()) for r in res])
    assert runs[0] == runs[1]
