"""The traced run's probes: a probe that a cell's per-layer reader reads and
whose target the program lacks (a renamed method, function, counter or
#perfstats field) fails the run with no result; with every target found,
the host-side readers report. On the CPU at a small size."""
import time

import pytest
import torch

from h100bench.harness import runner, spec
from reindexer_tpu_torch import tracing

ROWS = {"sift-bf": 1500, "deep-hnsw": 1000}


def traced(cell: str, monkeypatch, rename: str | None = None) -> dict:
    """A traced run of `cell`, with probe `rename`'s target renamed."""
    probes = spec.probes()
    for p in probes:
        if p["name"] == rename:
            for key in ("method", "function", "attr", "field"):
                if key in p:
                    p[key] += "_renamed"
    monkeypatch.setattr(spec, "probes", lambda: probes)
    torch.set_num_threads(2)
    config = spec.cell(cell)["config"]
    return runner.run(cell, 2 ** 31 + 91, 0.5, True, time.perf_counter(),
                      device="cpu", overrides={
                          "config": {"rows": ROWS[config]},
                          "traffic": {"query_pool": 256, "warmup_s": 0.2,
                                      "profile_s": 0.2}})


def test_every_reader_names_probes_that_exist():
    names = {p["name"] for p in spec.probes()}
    for m in spec.benchmark()["per_layer"]:
        assert set(spec.metric_reader(m["name"]).PROBES) <= names, m["name"]


@pytest.mark.parametrize("cell,probe", [
    ("sift-bf.knn64-k100", "engine"),
    ("sift-bf.knn64-k100", "graph_capture"),
    ("deep-hnsw.knn64-ef128", "commit"),
    ("deep-hnsw.knn64-ef128", "beam_steps"),
    ("sift-bf.select-k10-c16", "batched_queries"),
])
def test_a_missing_probe_target_fails_the_traced_run(cell, probe,
                                                     monkeypatch):
    with pytest.raises(SystemExit, match=f"no target .*{probe} "):
        traced(cell, monkeypatch, rename=probe)


def test_a_probe_no_metric_of_the_cell_reads_may_be_missing(monkeypatch):
    r = traced("sift-bf.knn64-k100", monkeypatch, rename="commit")
    assert r["correct"]


def host_metrics(cell: str) -> set:
    """The per-layer metrics BENCHMARK.json lists for `cell`, less those
    read from the device trace, which a CPU run has not."""
    return {m["name"] for m in spec.metrics_of(cell, "per_layer")
            if m["source"] != "device_trace"}


@pytest.mark.parametrize("cell", ["sift-bf.knn64-k100",
                                  "deep-hnsw.knn64-ef128",
                                  "sift-bf.select-k10-c16"])
def test_a_traced_run_reports_its_host_metrics(cell, monkeypatch):
    try:
        r = traced(cell, monkeypatch)
    finally:
        tracing.configure(None)
        tracing.take()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == host_metrics(cell)
    for name, m in r["metrics"].items():
        # no CUDA graph is captured on the CPU
        assert m["value"] > 0 or (name == "hnsw_captures_per_dispatch"
                                  and m["value"] == 0), name
