"""Smoke run of reindexer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is not 0:
  0. identity: the card's name and power limit (nvidia-smi), torch, CUDA;
  1. build: K1 bf_scan and K2 bf_select with nvcc from csrc/, timed;
  2. kernels vs their plain PyTorch versions on the card at the main path's
     shapes (131072 x 128, 64 queries, k=100, L2 and IP, with invalid rows)
     and at 1,048,576 x 128 (L2), with times (CUDA events, median of 20
     runs of 10 back-to-back calls, after warm-up);
  3. the main path through the public API: a 100,000 x 128 L2 vec_bf
     namespace, 1,000 deletes, 64 single selects and knn_batch with 64 and
     256 queries, checked against a float64 numpy oracle, with the launch
     counts of K1/K2 over that run;
then one JSON line for the kernels and, last, the result line.
There is no CPU path: without CUDA the script exits non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# reindexer_tpu's __init__ imports jax, when installed, only to configure
# its compile cache; this switch skips that, so the run stays free of JAX
os.environ["RX_TPU_COMPILE_CACHE"] = "0"

SEED = 1234
K = 100
MAIN_N, MAIN_D, MAIN_Q = 131072, 128, 64
BIG_N = 1048576
DOCS, DELETES = 100_000, 1_000
K1_RTOL, K1_ATOL = 1e-5, 1e-3     # fp32 sums in another order than cuBLAS
K2_RTOL, K2_ATOL = 1e-4, 1e-3
TIE_RTOL = 1e-4                   # ids may differ only between near-ties
RANK_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20, burst: int = 10,
                 warmup: int = 3) -> float:
    """Time of one fn() in ms: the median over `reps` runs of CUDA events
    around `burst` back-to-back calls, divided by `burst`. Back-to-back
    calls keep the stream fed, so the host's launch overhead hides behind
    the device work wherever the device work is the longer of the two."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def tie_violations(got, want, score_of, kth: float, rtol: float) -> int:
    """Ids in exactly one of got/want whose score is not within rtol of the
    k-th score: a real mismatch, not a tie at the boundary."""
    diff = set(got) ^ set(want)
    return sum(abs(score_of(i) - kth) > rtol * max(abs(kth), 1.0)
               for i in diff)


def phase_identity() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"[identity] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card, torch.cuda.get_device_name(0)


def phase_build() -> None:
    from reindexer_tpu_torch.ops import _build
    for name in ("bf_scan", "bf_select"):
        t0 = time.perf_counter()
        _build.load(name)
        secs, out = _build.build_info[name]
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {time.perf_counter() - t0:.2f} s "
            f"(nvcc {secs:.2f} s) {' | '.join(ptxas)}")


def make_scan_inputs(rng, n: int, d: int, n_q: int, metric, dev):
    from reindexer_tpu_torch.ops.scan import SQ_EFF_BIG
    from reindexer_tpu_torch import VectorMetric
    base = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((n_q, d), dtype=np.float32)
    invalid = rng.choice(n, size=n // 100, replace=False)
    sq = ((base * base).sum(1) if metric == VectorMetric.L2
          else np.zeros(n)).astype(np.float32)
    sq[invalid] = SQ_EFF_BIG
    return (torch.from_numpy(q).to(dev), torch.from_numpy(base).to(dev),
            torch.from_numpy(sq).to(dev), invalid)


def phase_kernels(dev) -> dict:
    """K1/K2 against their plain versions on the card. Returns per-kernel
    {max_abs_err, ms, plain_ms} (times at the main path's shape)."""
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.scan import bf_scan, bf_scan_plain
    from reindexer_tpu_torch.ops.select import bf_select, bf_select_plain
    if torch.backends.cuda.matmul.allow_tf32:      # the port pins it off
        raise AssertionError("TF32 matmuls are on: the plain versions "
                             "would not be fp32-accurate")
    rng = np.random.default_rng(SEED)
    stats = {"bf_scan": {"max_abs_err": 0.0},
             "bf_select": {"max_abs_err": 0.0}}
    cases = [(MAIN_N, VectorMetric.L2), (MAIN_N, VectorMetric.INNER_PRODUCT),
             (BIG_N, VectorMetric.L2)]
    for n, metric in cases:
        q, base, sq_eff, invalid = make_scan_inputs(rng, n, MAIN_D, MAIN_Q,
                                                    metric, dev)
        s, bmax = bf_scan(q, base, sq_eff, metric)
        s_p, bmax_p = bf_scan_plain(q, base, sq_eff, metric)
        torch.cuda.synchronize()
        for got, want in ((s, s_p), (bmax, bmax_p)):
            if not torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL):
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at N={n} {metric.name}")
        k1_err = max(float((s - s_p).abs().max()),
                     float((bmax - bmax_p).abs().max()))
        eps = torch.zeros(MAIN_Q, dtype=torch.float32, device=dev)
        o_s, o_i, flag = bf_select(s, bmax, eps, K)
        p_s, p_i, p_flag = bf_select_plain(s, bmax, eps, K)
        torch.cuda.synchronize()
        if float(flag.max()) > 0 or float(p_flag.max()) > 0:
            raise AssertionError(f"K2 overflow flag set at N={n}")
        if not torch.allclose(o_s, p_s, rtol=K2_RTOL, atol=K2_ATOL):
            raise AssertionError(f"K2 scores disagree at N={n} {metric.name}")
        k2_err = float((o_s - p_s).abs().max())
        kth = p_s[:, K - 1].cpu().numpy()
        s_host = s.cpu().numpy()
        o_i_h, p_i_h = o_i.cpu().numpy(), p_i.cpu().numpy()
        bad = sum(tie_violations(o_i_h[b], p_i_h[b],
                                 lambda i, b=b: float(s_host[b, i]),
                                 float(kth[b]), TIE_RTOL)
                  for b in range(MAIN_Q))
        if bad or np.isin(o_i_h, invalid).any():
            raise AssertionError(f"K2 ids disagree at N={n} {metric.name}: "
                                 f"{bad} mismatches beyond ties")
        stats["bf_scan"]["max_abs_err"] = max(stats["bf_scan"]["max_abs_err"],
                                              k1_err)
        stats["bf_select"]["max_abs_err"] = max(
            stats["bf_select"]["max_abs_err"], k2_err)
        t = {"k1": cuda_time_ms(lambda: bf_scan(q, base, sq_eff, metric)),
             "k1_plain": cuda_time_ms(
                 lambda: bf_scan_plain(q, base, sq_eff, metric)),
             "k2": cuda_time_ms(lambda: bf_select(s, bmax, eps, K)),
             "k2_plain": cuda_time_ms(
                 lambda: bf_select_plain(s, bmax, eps, K))}
        log(f"[kernels] N={n} D={MAIN_D} Q={MAIN_Q} k={K} {metric.name}: "
            f"K1 err {k1_err:.3g} ms {t['k1']:.4f} (plain {t['k1_plain']:.4f})"
            f"; K2 err {k2_err:.3g} ms {t['k2']:.4f} "
            f"(plain {t['k2_plain']:.4f}); ids match up to ties")
        if n == MAIN_N and metric == VectorMetric.L2:
            stats["bf_scan"].update(ms=t["k1"], plain_ms=t["k1_plain"])
            stats["bf_select"].update(ms=t["k2"], plain_ms=t["k2_plain"])
        del q, base, sq_eff, s, bmax, s_p, bmax_p
        torch.cuda.empty_cache()
    return stats


def oracle_distances(queries, base, alive) -> np.ndarray:
    """Exact squared L2 distances in float64 [Q, DOCS], inf for deleted
    docs (doc id == row)."""
    b = base.astype(np.float64)
    q = queries.astype(np.float64)
    d = (b * b).sum(1)[None, :] - 2.0 * (q @ b.T) + (q * q).sum(1)[:, None]
    d[:, ~alive] = np.inf
    return d


def check_against_oracle(results, dist, tag: str) -> None:
    """results: (ids, ranks) per query, against the float64 oracle."""
    for qi, (ids, ranks) in enumerate(results):
        row = dist[qi]
        want = np.argsort(row, kind="stable")[:K]
        kth = float(row[want[-1]])
        if len(ids) != K:
            raise AssertionError(f"{tag}: query {qi} got {len(ids)} ids")
        if not np.isfinite(row[ids]).all():
            raise AssertionError(f"{tag}: query {qi} returned a deleted id")
        if tie_violations(ids, want.tolist(), lambda i: float(row[i]), kth,
                          TIE_RTOL):
            raise AssertionError(f"{tag}: query {qi} ids disagree with the "
                                 "float64 oracle beyond ties")
        exact = row[ids]
        if not np.allclose(ranks, exact, rtol=RANK_RTOL, atol=1e-3):
            raise AssertionError(f"{tag}: query {qi} ranks off by "
                                 f"{np.abs(np.asarray(ranks) - exact).max()}")


def phase_main_path(card: str) -> dict:
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     KnnSearchParams, Query, Reindexer,
                                     VectorMetric)
    from reindexer_tpu_torch.index.vector import brute_force
    from reindexer_tpu_torch.ops import scan, select
    rng = np.random.default_rng(SEED + 1)
    base = rng.standard_normal((DOCS, MAIN_D), dtype=np.float32)
    queries = rng.standard_normal((256, MAIN_D), dtype=np.float32)
    deleted = rng.choice(DOCS, size=DELETES, replace=False)
    alive = np.ones(DOCS, dtype=bool)
    alive[deleted] = False

    t0 = time.perf_counter()
    db = Reindexer(device="cuda")
    db.open_namespace("bf", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "vec_bf", vector_opts=FloatVectorOpts(
            dims=MAIN_D, metric=VectorMetric.L2))])
    rows = base.tolist()
    for i in range(DOCS):
        db.upsert("bf", {"id": i, "vec": rows[i]})
    for i in deleted.tolist():
        db.delete("bf", {"id": i})
    log(f"[main] set-up: {DOCS} upserts + {DELETES} deletes in "
        f"{time.perf_counter() - t0:.1f} s")

    counters = (scan.launches, select.launches, brute_force.overflow_reruns,
                brute_force.geometry_scans)
    for c in counters:
        c.reset()
    params = KnnSearchParams(k=K)
    # the first select flushes the 100k pending rows to the card
    db.select(Query("bf").where_knn("vec", queries[0], params))
    single = []
    t0 = time.perf_counter()
    for qi in range(64):
        res = db.select(Query("bf").where_knn("vec", queries[qi], params))
        single.append(([d["id"] for d in res.docs()], res.ranks()))
    qps = {"select": 64 / (time.perf_counter() - t0)}
    batch = {}
    for nq in (64, 256):
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = db.knn_batch("bf", "vec", queries[:nq], params)
            secs.append(time.perf_counter() - t0)
            batch.setdefault(nq, [([d["id"] for d in r.docs()], r.ranks())
                                  for r in out])
        qps[f"knn_batch_{nq}"] = nq / statistics.median(secs)
    torch.cuda.synchronize()
    k1, k2, reruns, geo = (c.value for c in counters)
    log(f"[main] launches over the run: bf_scan {k1}, bf_select {k2}, "
        f"overflow reruns {reruns}, k>128 scans {geo}")

    dist = oracle_distances(queries, base, alive)
    check_against_oracle(single, dist, "select")
    for nq, res in batch.items():
        check_against_oracle(res, dist, f"knn_batch({nq})")
    log("[main] select x64, knn_batch(64), knn_batch(256) match the float64 "
        "oracle (ids up to ties, ranks rtol 1e-4), no deleted id")
    for name, v in qps.items():
        log(f"[main] {name}: {v:.1f} qps on {card} (host clock; select: 64 "
            "sequential calls, knn_batch: median of 5 calls)")
    if k1 == 0 or k2 == 0:
        raise AssertionError("the main path did not launch K1 and K2")
    if reruns or geo:
        raise AssertionError(f"the main path fell back to knn_scan: "
                             f"{reruns} overflow reruns, {geo} k>128 scans")
    return {"bf_scan": k1, "bf_select": k2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    card, kind = phase_identity()
    phase_build()
    dev = torch.device("cuda", 0)
    stats = phase_kernels(dev)
    launches = phase_main_path(card)
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")
    replaces = {"bf_scan": "reindexer_tpu/ops/pallas_scan.py:94",
                "bf_select": "reindexer_tpu/ops/pallas_select.py:574"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"reindexer_tpu_torch/csrc/{name}.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
               for name in ("bf_scan", "bf_select")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
