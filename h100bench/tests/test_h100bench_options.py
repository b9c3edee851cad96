"""A configuration's `index` options and a traffic file's search keys reach
the port as written (harness/system.py), and cosine is ranked alike by the
reference and the control. On the CPU at small sizes: the committed cells
build the objects they always built; a cosine IVF configuration made here
(no file of configs/ or traffic/) runs through a whole run; an unknown
option ends the run naming it."""
import time

import numpy as np
import pytest
import torch

from h100bench import control, reference
from h100bench.harness import runner, spec, system
from reindexer_tpu_torch import (FloatVectorOpts, HnswSearchParams, IndexDef,
                                 IvfSearchParams, KnnSearchParams,
                                 QuantizationConfig, VectorMetric)

SEED = 2 ** 31 + 53

# what each committed cell built before its options were read generically
COMMITTED = {
    "sift-bf.knn64-k100": (
        "vec_bf", FloatVectorOpts(dims=128, metric=VectorMetric.L2),
        KnnSearchParams(k=100)),
    "sift-bf.select-k10-c16": (
        "vec_bf", FloatVectorOpts(dims=128, metric=VectorMetric.L2),
        KnnSearchParams(k=10)),
    "deep-hnsw.knn64-ef128": (
        "hnsw", FloatVectorOpts(dims=96, metric=VectorMetric.INNER_PRODUCT,
                                m=16, ef_construction=200),
        HnswSearchParams(k=10, ef=128)),
    "deep-hnsw.select-ef128-c16": (
        "hnsw", FloatVectorOpts(dims=96, metric=VectorMetric.INNER_PRODUCT,
                                m=16, ef_construction=200),
        HnswSearchParams(k=10, ef=128)),
}

# a cosine IVF configuration and its traffic, for these tests only
IVF = {
    "name": "ivf-cosine-test", "rows": 3000, "dims": 768,
    "metric": "cosine",
    "index": {"type": "ivf", "precision": "fp32", "quantization": False,
              "centroids_count": 32},
    "generator": {"name": "deep1m_like",
                  "params": {"n_centers": 256, "sigma": 1.0}},
    "n_groups": 10,
    "check": {"answers_short": 0, "fields_wrong": 0, "misordered": 0,
              "recall_min": 0.9, "rank_err": 2e-05},
}
IVF_TRAFFIC = {
    "name": "knn16-np8-test", "entry": "knn_batch", "queries_per_call": 16,
    "k": 10, "nprobe": 8, "clients": 1, "loop": "closed",
    "query_pool": 256, "warmup_s": 0.2, "checked_requests": 1_000_000,
    "profile_s": 0.2,
}


def cell_of(name: str) -> tuple:
    w = spec.cell(name)
    return spec.config(w["config"]), spec.traffic(w["traffic"])


@pytest.mark.parametrize("cell", sorted(COMMITTED))
def test_committed_cells_build_the_same_objects(cell):
    config, traffic = cell_of(cell)
    kind, opts, params = COMMITTED[cell]
    built = system.index_def(config)
    assert built == IndexDef(system.FIELD, kind, vector_opts=opts)
    assert built.vector_opts.quantization == QuantizationConfig()
    assert not built.vector_opts.quantization.enabled
    got = system.knn_params(config, traffic)
    assert type(got) is type(params) and got == params


def run_made_up(monkeypatch, config: dict, traffic: dict, fault=None,
                rows: int | None = None) -> dict:
    """A whole untraced run of a cell of `config` and `traffic`, which
    spec's lookups return in place of the committed files."""
    config = {**config, **({"rows": rows} if rows else {})}
    monkeypatch.setattr(spec, "cell", lambda name: {
        "name": name, "config": config["name"], "traffic": traffic["name"],
        "chips": 1})
    monkeypatch.setattr(spec, "config", lambda name: dict(config))
    monkeypatch.setattr(spec, "traffic", lambda name: dict(traffic))
    torch.set_num_threads(2)
    return runner.run(f"{config['name']}.{traffic['name']}", SEED, 0.5,
                      False, time.perf_counter(), device="cpu", fault=fault)


def spied(seen: dict):
    """A `fault` that keeps the index and the parameters each engine
    dispatch gets, and changes nothing."""
    def spy(built):
        seen["index"] = built.index
        orig = built.index.select_batch_async

        def recorded(queries, params):
            seen.setdefault("params", []).append(params)
            return orig(queries, params)
        built.index.select_batch_async = recorded
    return spy


def test_a_cosine_ivf_configuration_runs_as_written(monkeypatch):
    seen: dict = {}
    r = run_made_up(monkeypatch, IVF, IVF_TRAFFIC, fault=spied(seen))
    assert r["correct"], r["checks"]
    assert seen["index"].nlist == 32
    assert seen["index"].metric == VectorMetric.COSINE
    assert seen["params"] and all(
        type(p) is IvfSearchParams and p.nprobe == 8 and p.k == 10
        for p in seen["params"])
    recall8 = r["checks"]["recall_min"]["value"]
    one = run_made_up(monkeypatch, IVF, {**IVF_TRAFFIC, "nprobe": 1})
    assert one["checks"]["recall_min"]["value"] < recall8


def test_a_quantization_dict_builds_an_index_of_that_mode():
    config, traffic = cell_of("sift-bf.knn64-k100")
    quant = {"enabled": True, "mode": "approx_rerank", "min_elements": 1024}
    config = {**config, "rows": 1500,
              "index": {**config["index"], "quantization": quant}}
    assert system.index_def(config).vector_opts.quantization == \
        QuantizationConfig(enabled=True, mode="approx_rerank",
                           min_elements=1024)
    torch.set_num_threads(2)
    data = system.Data(config, {**traffic, "query_pool": 16}, SEED)
    built = system.System(config, data, "cpu")
    built.db.knn_batch(system.NAMESPACE, system.FIELD, data.warm,
                       system.knn_params(config, traffic))
    assert built.index._quant_mode == "approx_rerank"
    assert built.index.memstat()["quantized"]


@pytest.mark.parametrize("config,index,traffic,named", [
    ("sift-bf", {"centroid_count": 32}, {}, "'centroid_count'"),
    ("deep-hnsw", {"ef_construct": 200}, {}, "'ef_construct'"),
    ("sift-bf", {"precision": "fp16"}, {}, "'fp16'"),
    ("sift-bf", {"quantization": True}, {}, "'quantization'"),
    ("deep-hnsw", {"dims": 96}, {}, "'dims'"),
    ("deep-hnsw", {}, {"nprobe": 8}, "'nprobe'"),
    ("sift-bf", {}, {"ef": 128}, "'ef'"),
    ("sift-bf", {}, {"nprobe": 8}, "'nprobe'"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_an_option_the_program_does_not_take_ends_the_run(
        monkeypatch, config, index, traffic, named):
    base = spec.config(config)
    cfg = {**base, "index": {**base["index"], **index}}
    cell = next(w for w in spec.benchmark()["workloads"]
                if w["config"] == config)
    mix = {**spec.traffic(cell["traffic"]), **traffic,
           "query_pool": 64, "warmup_s": 0.2}
    with pytest.raises(SystemExit, match=f"{named}.*no result"):
        run_made_up(monkeypatch, cfg, mix, rows=1000)


def test_an_unknown_metric_ends_the_run(monkeypatch):
    cfg = {**spec.config("sift-bf"), "metric": "hamming"}
    with pytest.raises(SystemExit, match="'hamming'"):
        system.index_def(cfg)


def rows_with_a_zero_row(n: int = 400, d: int = 48) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    rows = (rng.normal(size=(n, d)) * rng.uniform(0.1, 20.0, size=(n, 1))
            ).astype(np.float32)
    rows[7] = 0.0
    return rows


def direct_cosine(rows: np.ndarray, q: np.ndarray) -> np.ndarray:
    r, q = rows.astype(np.float64), q.astype(np.float64)
    out = np.zeros(len(r))
    for i in range(len(r)):
        den = np.sqrt(r[i] @ r[i]) * np.sqrt(q @ q)
        out[i] = 0.0 if den == 0.0 else (r[i] @ q) / den
    return out


def test_the_references_cosine_is_the_float64_similarity():
    rows = rows_with_a_zero_row()
    queries = np.random.default_rng(SEED + 1).normal(
        size=(5, rows.shape[1])).astype(np.float32) * 7.0
    rows64 = rows.astype(np.float64)
    assert not reference.lower_is_better("cosine")
    ids, ranks = reference.exact_topk(rows, queries, 10, "cosine")
    # 4 x is exact in float32
    scaled_ids, scaled = reference.exact_topk(rows, 4.0 * queries, 10,
                                              "cosine")
    every = reference.all_ranks64(rows64, queries.astype(np.float64),
                                  "cosine")
    for j, q in enumerate(queries):
        want = direct_cosine(rows, q)
        assert want[7] == 0.0 and every[j, 7] == 0.0
        np.testing.assert_allclose(every[j], want, rtol=0, atol=1e-14)
        np.testing.assert_allclose(
            reference.ranks64(rows64, q.astype(np.float64),
                              np.arange(len(rows)), "cosine"),
            want, rtol=0, atol=1e-14)
        # best first, ties by the lower id
        order = sorted(range(len(rows)), key=lambda i: (-want[i], i))[:10]
        assert ids[j].tolist() == order
        np.testing.assert_allclose(ranks[j], want[order], rtol=0,
                                   atol=1e-14)
    # the similarity does not see the query's length
    assert (scaled_ids == ids).all()
    np.testing.assert_allclose(scaled, ranks, rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        reference.all_ranks64(rows64, 3.5 * queries.astype(np.float64),
                              "cosine"), every, rtol=0, atol=1e-14)


def test_the_controls_cosine_is_within_tf32_of_the_reference():
    rows = rows_with_a_zero_row(2000, 256)
    queries = np.random.default_rng(SEED + 2).normal(
        size=(8, rows.shape[1])).astype(np.float32) * 3.0
    ctl = control.Tf32Reference(rows, "cosine", "cpu", None)
    answers = ctl.select_batch_async(queries, KnnSearchParams(k=10))()
    rows64 = rows.astype(np.float64)
    worst = 0.0
    for q, a in zip(queries, answers):
        exact = reference.ranks64(rows64, q.astype(np.float64), a.ids,
                                  "cosine")
        worst = max(worst, float(np.abs(a.ranks - exact).max()))
        # descending, as the program ranks cosine
        assert (np.diff(a.ranks) <= 0).all()
    # two inputs rounded to a 10-bit mantissa (2**-11 each) times unit
    # vectors: at most 2**-10, plus fp32's sum; and above fp32's own error
    assert 1e-6 < worst <= 2 ** -10 + 1e-6
