"""Finds every part of a cell by its name: BENCHMARK.json at the checkout's
root, configs/<config>.json, traffic/<mix>.json, generators/<name>.py,
metrics/<metric>.py and probes/*.json under h100bench/. A new cell, mix,
generator, metric or probe is a new file and a new entry, never an edit.

What a configuration and a traffic file may hold for the program
(system.py reads them, and ends the run on a key it does not know):

- configuration: `metric` (`l2`, `inner_product`, `cosine`), `dims`,
  `rows`, and an `index` block of `type` (`vec_bf`, `hnsw`, `ivf`),
  `precision` (`fp32`) and `FloatVectorOpts` fields as written: `m`,
  `ef_construction`, `start_size`, `multithreading`, `centroids_count`,
  `radius`, `quantization` (`false` or {enabled, left_quantile,
  right_quantile, min_elements, mode});
- traffic: the search keys `k`, `ef` (hnsw), `nprobe` (ivf), `radius`;
  and the load's keys (load.py): `entry` (`knn_batch`, `select`),
  `queries_per_call`, `clients`, `query_pool`, `warmup_s`,
  `checked_requests`, `profile_s` (`loop`: `closed`, the only one).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def probes() -> list:
    return [_json(p) for p in sorted((BENCH_DIR / "probes").glob("*.json"))]


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.{kind}.{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    return _module("generators", name)


def metric_reader(name: str):
    return _module("metrics", name)


def metrics_of(cell_name: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, or list no cells at all."""
    return [m for m in benchmark()[kind]
            if cell_name in m.get("workloads", [cell_name])]
