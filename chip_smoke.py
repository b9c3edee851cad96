"""Smoke run of reindexer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is not 0:
  0. identity: the card's name and power limit (nvidia-smi), torch, CUDA;
  1. build: the six kernels (K1 bf_scan, K2 bf_select, K3 sq8_scan, K4
     sq8_select, K5 sq8_i8_scan, K6 ivf_seg_scan) with nvcc from csrc/, one
     nvcc per source,
     all started together, timed, with ptxas's registers and spills;
  2. K1/K2 vs their plain PyTorch versions on the card at the main path's
     shapes (131072 x 128, 64 queries and 1 query, k=100, L2 and IP, with
     invalid rows) and at 1,048,576 x 128 (L2). K1's S is held within
     K1_ULPS fp32 ulps of the summed magnitude against a float64 product,
     its bmax bit-equal to S's block maxima, and the same check is shown to
     reject a TF32 product of the same inputs; K2 equals its plain version
     exactly (scores, ids with ties by the smaller row, flags). Times are
     device time per call (torch.profiler kernel time, mean of 20 calls
     after warm-up), beside each kernel's plain version, its library call
     (K1: torch.addmm, TF32 off; K2: torch.topk) and its bound;
  3. the fp32 main path through the public API: a 100,000 x 128 L2 vec_bf
     namespace, 1,000 deletes, 64 single selects and knn_batch with 64 and
     256 queries, checked against a float64 numpy oracle, with the launch
     counts of K1/K2 over that run; then the host ms, device ms and idle
     share of knn_batch(64) and select (torch.profiler);
  4. K3/K4/K5 vs their plain versions on the card at the same shapes, codes
     from the port's encoder on a 0.001 / 0.999 quantile grid: K3 in both
     modes at 64 queries and 1, within K3_RTOL / K3_ATOL of its plain
     version and within K3_ULPS fp32 ulps of the summed magnitude against a
     float64 product (and the same check shown to reject a product of one
     bf16 limb of q_alpha); K5 bit for bit at 1, 5 and 64 queries (and at
     D = 100 and 1,536) and K5 + K2's ids; K4 on
     clustered data at 64 queries and 1 (no flag, same top-k) and on
     isotropic data (the same queries flag). K3 (both modes, 64 queries and
     1, and at 1M rows) and K4 (64 queries and 1) are timed three times
     (median, min, max), K4's three kernels apart and on a flagged batch,
     beside the plain versions and the bounds (K3's products at the bf16
     tensor-core peak, three limbs; K4's bytes over the unique admitted
     blocks);
  5. the SQ8 main path through the public API: a 100,000 x 128 L2
     namespace with three SQ8 vec_bf fields over the same vectors (modes
     exact, approx, approx_rerank), 1,000 deletes, and a second, clustered
     namespace in exact mode; per field 64 single selects and knn_batch with
     64, 100 and 256 queries. Exact matches the float64 oracle; approx
     matches the plain versions' composition on the card up to ties and
     recalls >= 0.9 of the oracle's top-100; approx_rerank ranks are the
     exact distances. The launch counts and the ladder's counters of each
     field's run are printed, and K3, K4 and K5 must each have launched;
     then each field's knn_batch(64) and select under torch.profiler
     (device ms, idle share);
  6. IVF set-up, BASELINE config #3: 1,000,000 x 768 cosine, 1,024 lists,
     clustered rows made as bench.py's IVF leg makes them (seed 12), loaded
     as it loads them (keeper.bulk_load with the bf16 upload, _grow,
     _train); every row's list checked against its float64-nearest
     centroid;
  7. K6 ivf_seg_scan vs its plain version on the card, on the segment plans
     of that index at batch 1 x nprobe 8, 16 x 128 and 256 x 128 (ragged
     last blocks and count-0 padding segments), in cosine and in L2, within
     K6_ULPS fp32 ulps of the summed magnitude, with device times (three,
     and CUDA events) beside the bound over the unique probed rows;
  8. the IVF main path on that index: 16 queries, k=100, nprobe 8 to 128,
     select_batch and single select, the segment route forced, the masked
     sweep forced and the router's choice. Ids equal a float64 oracle over
     the rows of the query's probed lists (near-ties aside), from the stored
     vectors; recall@100 against the full float64 oracle may not fall as
     nprobe grows. Then both stage-2 routes are timed at batch 1 to 256 at
     each nprobe, with device time and idle share (the router table,
     PERF.md);
  9. the IVF public API: a 100,000 x 128 cosine IVF namespace with 1,024
     lists filled by db.upsert, 1,000 deletes; 64 db.select, knn_batch of
     16 at nprobe 8 and 128, one SQL KNN(..., nprobe=8), the
     rebuild_ivf_index action and a select after it, each against the
     probed-set oracle (the list assignment checked as in 6). K6 must have
     launched on the IVF paths; then host ms, device ms and idle share of
     knn_batch(16) and select;
then one JSON line for the kernels (with each one's bound: the larger of
its bytes over 3.35 TB/s and its operations over the H100's peak for their
type) and, last, the result line.
There is no CPU path: without CUDA the script exits non-zero. The script
imports neither JAX nor the JAX package, and fails if either was loaded.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
K = 100
MAIN_N, MAIN_D, MAIN_Q = 131072, 128, 64
BIG_N = 1048576
DOCS, DELETES = 100_000, 1_000
K1_ULPS = 8       # K1 vs a float64 product: fp32 ulps of the summed
#                   magnitude; a TF32 product misses it by ~100x
K3_RTOL, K3_ATOL = 1e-5, 1e-3     # fp32 sums in another order than cuBLAS
K3_ULPS = 8       # K3 vs a float64 product, as K1 is held; one bf16 limb
#                   of q_alpha (a plain bf16 product) misses it by ~10^3
K3_LIMBS = 3      # bf16 limbs of q_alpha: three bf16 wgmmas a product
K2_RTOL, K2_ATOL = 1e-4, 1e-3
TIE_RTOL = 1e-4                   # ids may differ only between near-ties
RANK_RTOL = 1e-4
APPROX_TIE_RTOL = 1e-5            # K5 is bit-equal to its plain version;
#                                   K3's fp32 sums round in another order
APPROX_MIN_RECALL = 0.9
K5_QS = (1, 5, 64)                # K5 held bit-equal at these batches,
K5_OTHER_DS = (100, 1536)         # and at an odd and a wide width
CLUSTER_ROWS = 7168               # rows per cluster: 112 blocks of 64
IVF_N, IVF_D, IVF_NLIST, IVF_BATCH = 1_000_000, 768, 1024, 16
IVF_NPROBES = (8, 16, 32, 64, 128)
IVF_API_DOCS, IVF_API_D = 100_000, 128
IVF_RANK_ATOL = 1e-5              # cosine similarities of unit vectors
IVF_ROUTES = {"segments": "1", "sweep": "0", "router": None}
IVF_ROUTE_BATCHES = (1, 16, 32, 64, 128, 256)   # the router table, PERF.md
K6_ULPS = 8       # K6 vs its plain version: fp32 ulps of sum |q_d b_d|;
#                   a bf16 or TF32 rounding of an operand is ~1e3x more
K6_POINTS = ((1, 8), (IVF_BATCH, 128), (256, 128))   # (batch, nprobe)
ASSIGN_TIE_RTOL = 1e-5            # f32 argmax vs f64 argmax near-ties


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


PROFILER_TRIES = 3    # torch.profiler now and then returns a trace that
#                      holds no device event; such a trace is taken again
PROFILER_MARGIN_S = 0.1
# [traces that lost device events, traces]: torch.profiler drops device
# events whose converted time stamps fall outside its capture window
TRACE_LOSSES = [0, 0]


def profile_device(fn, n: int, host: bool = False) -> tuple[dict, float]:
    """torch.profiler over n calls of fn: ({device item: ms per call},
    wall ms of the n calls). host=True also traces the host's operators.
    A trace without any device event is taken again, up to PROFILER_TRIES
    times; the dict is empty if every one came back so. Every call launches
    the same kernels, so an item's count of events should be a multiple of
    n; where the trace lost some, its time per call is the mean of the
    events it kept times its launches per call (the count over n, rounded
    up), not the kept total over n."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host
    for attempt in range(1, PROFILER_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            # idle margins inside the capture window, so that a device
            # event whose converted time stamp drifts is not dropped as
            # lying outside it
            time.sleep(PROFILER_MARGIN_S)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            time.sleep(PROFILER_MARGIN_S)
        per, lost = {}, False
        for ev in prof.key_averages():
            dt = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if dt and ev.device_type == torch.autograd.DeviceType.CUDA:
                per_call = -(-ev.count // n)
                lost |= ev.count != per_call * n
                per[ev.key] = (per.get(ev.key, 0.0)
                               + dt / 1e3 / ev.count * per_call)
        if per:
            TRACE_LOSSES[0] += lost
            TRACE_LOSSES[1] += 1
            return per, wall_ms
        log(f"[timer] torch.profiler recorded no device time (trace "
            f"{attempt} of {PROFILER_TRIES})")
    return {}, wall_ms


def device_ms(fn, n: int = 20) -> float:
    """Device time of one fn() in ms: the CUDA kernel time torch.profiler
    records over n calls (after warm-up), divided by n. Unlike a host clock
    or events around back-to-back calls, it does not count the host's
    launch overhead, which exceeds the time of the faster kernels. Where
    no trace holds device time, CUDA events time fn instead (logged)."""
    for _ in range(3):
        fn()
    per, _ = profile_device(fn, n)
    if per:
        return sum(per.values())
    ms = cuda_time_ms(fn)
    log(f"[timer] timed with CUDA events instead: {ms:.4f} ms (host launch "
        "overhead included)")
    return ms


# the H100 SXM's published peaks (NVIDIA H100 datasheet)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "int8": 1979e12}


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of n_bytes over the
    memory rate and ops over the peak rate of their type."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * ops / PEAK_OPS_S[kind]
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


KERNELS = ("bf_scan", "bf_select", "sq8_scan", "sq8_select", "sq8_i8_scan",
           "ivf_seg_scan")


def phase_build() -> None:
    from reindexer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_all(list(KERNELS))
    log(f"[build] all {len(KERNELS)} kernels: "
        f"{time.perf_counter() - t0:.2f} s wall")
    for name in KERNELS:
        secs, out = _build.build_info[name]
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        # the wgmma kernels (K1, K3, K5): ptxas's C7515 / C7517 / C7518
        # warnings say it serialized the wgmmas (their overlap lost), not
        # that they are wrong
        serial = sum(any(c in ln for c in ("C7515", "C7517", "C7518"))
                     for ln in out.splitlines())
        log(f"[build] {name}: nvcc {secs:.2f} s, {serial} wgmma "
            f"serialization warnings {' | '.join(ptxas)}")


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


def k1_ulps(s: torch.Tensor, q: torch.Tensor, base: torch.Tensor,
            sq_eff: torch.Tensor, fac: float) -> float:
    """The largest error of s f32[Q, N] against the float64 product, in
    fp32 ulps of the magnitude each score is summed from: fac * sum_d
    |q_d b_d| + |sq_eff| (as K6 is held)."""
    q64, b64, sq64 = q.double(), base.double(), sq_eff.double()
    worst = 0.0
    for lo in range(0, base.shape[0], 262144):
        b = b64[lo:lo + 262144]
        want = fac * (q64 @ b.T) - sq64[None, lo:lo + 262144]
        mag = fac * (q64.abs() @ b.abs().T) + sq64[None, lo:lo + 262144].abs()
        err = (s[:, lo:lo + 262144].double() - want).abs()
        worst = max(worst, float((err / (torch.finfo(torch.float32).eps
                                         * mag).clamp_min(1e-300)).max()))
    return worst


def device_ms3(fn) -> tuple[float, float, float]:
    """(min, median, max) of three device_ms(fn) timings: a kernel's spread
    between repeats in one run."""
    t = sorted(device_ms(fn) for _ in range(3))
    return t[0], t[1], t[2]


def spread(t: tuple[float, float, float]) -> str:
    return f"{t[1]:.4f} (min {t[0]:.4f}, max {t[2]:.4f})"


def k3_ulps(s: torch.Tensor, qa: torch.Tensor, codes: torch.Tensor,
            sq_eff: torch.Tensor, shift: torch.Tensor, fac: float) -> float:
    """The largest error of s f32[Q, N] (K3's S, clamped at -1e30) against
    the float64 product, in fp32 ulps of the magnitude each score is summed
    from: fac * sum_d |q_alpha_d code_d| + |sq_eff| + |shift|."""
    q64, sh64 = qa.double(), shift.double()[:, None]
    worst = 0.0
    for lo in range(0, codes.shape[0], 262144):
        c = codes[lo:lo + 262144].double()
        sq = sq_eff[lo:lo + 262144].double()[None, :]
        want = (fac * (q64 @ c.T) - sq + sh64).clamp_min(-1e30)
        mag = fac * (q64.abs() @ c.T) + sq.abs() + sh64.abs()
        err = (s[:, lo:lo + 262144].double() - want).abs()
        worst = max(worst, float((err / (torch.finfo(torch.float32).eps
                                         * mag)).max()))
    return worst


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def k2_admitted_rows(bmax: torch.Tensor, eps: torch.Tensor, kk: int) -> int:
    """Rows of the blocks the threshold admits (at most S_SLOTS blocks a
    query), summed over the queries: what a select reads of its scores."""
    from reindexer_tpu_torch.ops.scan import BLK, SENT_HALF
    from reindexer_tpu_torch.ops.select import S_SLOTS
    valid = bmax > SENT_HALF
    neg_inf = torch.tensor(float("-inf"), device=bmax.device)
    kth = torch.topk(torch.where(valid, bmax, neg_inf), min(kk, bmax.shape[1]),
                     dim=1).values[:, -1]
    tau = torch.where(valid.sum(dim=1) >= kk, kth - eps, neg_inf)
    count = (valid & (bmax >= tau[:, None])).sum(dim=1)
    return int(count.clamp_max(S_SLOTS).sum()) * BLK


def k4_blocks(bmax: torch.Tensor, eps: torch.Tensor, kk: int,
              ) -> tuple[int, int]:
    """(admitted blocks summed over the queries that do not flag, the
    unique blocks among them): what K4 scores and what it reads."""
    from reindexer_tpu_torch.ops.scan import SENT_HALF
    from reindexer_tpu_torch.ops.select import S_SLOTS
    valid = bmax > SENT_HALF
    neg_inf = torch.tensor(float("-inf"), device=bmax.device)
    kth = torch.topk(torch.where(valid, bmax, neg_inf), min(kk, bmax.shape[1]),
                     dim=1).values[:, -1]
    tau = torch.where(valid.sum(dim=1) >= kk, kth - eps, neg_inf)
    admit = valid & (bmax >= tau[:, None])
    admit &= (admit.sum(dim=1) <= S_SLOTS)[:, None]
    return int(admit.sum()), int(admit.any(dim=0).sum())


def phase_kernels(dev) -> dict:
    """K1/K2 against their plain versions on the card. Returns per-kernel
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by} (at the main
    path's shape: 131072 x 128, 64 queries, L2)."""
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.scan import (BLK, bf_scan, bf_scan_plain,
                                              score_factor)
    from reindexer_tpu_torch.ops.select import bf_select, bf_select_plain
    if torch.backends.cuda.matmul.allow_tf32:      # the port pins it off
        raise AssertionError("TF32 matmuls are on: the plain versions "
                             "would not be fp32-accurate")
    rng = np.random.default_rng(SEED)
    stats = {"bf_scan": {"max_abs_err": 0.0},
             "bf_select": {"max_abs_err": 0.0}}
    cases = [(MAIN_N, MAIN_Q, VectorMetric.L2), (MAIN_N, 1, VectorMetric.L2),
             (MAIN_N, MAIN_Q, VectorMetric.INNER_PRODUCT),
             (BIG_N, MAIN_Q, VectorMetric.L2)]
    for n, n_q, metric in cases:
        tag = f"N={n} D={MAIN_D} Q={n_q} k={K} {metric.name}"
        fac = score_factor(metric)
        q, base, sq_eff, invalid = make_scan_inputs(rng, n, MAIN_D, n_q,
                                                    metric, dev)
        s, bmax = bf_scan(q, base, sq_eff, metric)
        s_p, bmax_p = bf_scan_plain(q, base, sq_eff, metric)
        torch.cuda.synchronize()
        ulps = k1_ulps(s, q, base, sq_eff, fac)
        plain_ulps = k1_ulps(s_p, q, base, sq_eff, fac)
        if ulps > K1_ULPS or plain_ulps > K1_ULPS:
            raise AssertionError(f"K1 ({ulps:.3f}) or its plain version "
                                 f"({plain_ulps:.3f}) is off the float64 "
                                 f"product by more than {K1_ULPS} fp32 ulps "
                                 f"at {tag}")
        if not torch.equal(bmax, s.view(n_q, -1, BLK).amax(dim=2)):
            raise AssertionError(f"K1's bmax is not the block max of its S "
                                 f"at {tag}")
        k1_err = max(float((s - s_p).abs().max()),
                     float((bmax - bmax_p).abs().max()))
        tf32_note = ""
        if n == MAIN_N and n_q == MAIN_Q:
            # the same check on a TF32 product of the same inputs must fail
            s_tf = (fac * (tf32(q).double() @ tf32(base).double().T)
                    - sq_eff.double()[None, :]).float()
            tf_ulps = k1_ulps(s_tf, q, base, sq_eff, fac)
            if tf_ulps <= K1_ULPS:
                raise AssertionError(f"the K1 check passes a TF32 product "
                                     f"({tf_ulps:.1f} ulps) at {tag}")
            tf32_note = (f"; a TF32 product is off by {tf_ulps:.1f} ulps "
                         "(rejected)")
            del s_tf
        eps = torch.zeros(n_q, dtype=torch.float32, device=dev)
        o = bf_select(s, bmax, eps, K)
        p = bf_select_plain(s, bmax, eps, K)
        torch.cuda.synchronize()
        if float(o[2].max()) > 0 or float(p[2].max()) > 0:
            raise AssertionError(f"K2 overflow flag set at {tag}")
        if not all(torch.equal(a, b) for a, b in zip(o, p)):
            raise AssertionError(f"K2 differs from its plain version at "
                                 f"{tag}")
        if np.isin(o[1].cpu().numpy(), invalid).any():
            raise AssertionError(f"K2 returned an invalid row at {tag}")
        k2_err = float((o[0] - p[0]).abs().max())
        stats["bf_scan"]["max_abs_err"] = max(stats["bf_scan"]["max_abs_err"],
                                              k1_err)
        stats["bf_select"]["max_abs_err"] = max(
            stats["bf_select"]["max_abs_err"], k2_err)
        neg_sq = -sq_eff       # outside the timed call: addmm's own input
        t = {"k1": device_ms(lambda: bf_scan(q, base, sq_eff, metric)),
             "k1_plain": device_ms(
                 lambda: bf_scan_plain(q, base, sq_eff, metric)),
             "k1_lib": device_ms(lambda: torch.addmm(
                 neg_sq, q, base.T, alpha=fac)),
             "k2": device_ms(lambda: bf_select(s, bmax, eps, K)),
             "k2_plain": device_ms(
                 lambda: bf_select_plain(s, bmax, eps, K)),
             "k2_lib": device_ms(lambda: torch.topk(s, K, dim=1))}
        g = n // BLK
        k1_bound = bound(4 * (n_q * MAIN_D + n * MAIN_D + n + n_q * n
                              + n_q * g),
                         3 * 2 * n_q * n * MAIN_D, "tf32")
        adm = k2_admitted_rows(bmax, eps, K)
        k2_bound = bound(4 * (n_q * g + adm + 2 * n_q) + 8 * n_q * K, 0,
                         "fp32")
        log(f"[kernels] {tag}: K1 {ulps:.3f} ulps of the summed magnitude "
            f"(plain {plain_ulps:.3f}, bound {K1_ULPS}), bmax bit-equal to "
            f"S's block max, err vs plain {k1_err:.3g}{tf32_note}; device ms "
            f"K1 {t['k1']:.4f} (plain {t['k1_plain']:.4f}, torch.addmm "
            f"{t['k1_lib']:.4f}, bound {k1_bound['bound_ms']:.4f} by "
            f"{k1_bound['bound_by']}); K2 equals its plain version, ms "
            f"{t['k2']:.4f} (plain {t['k2_plain']:.4f}, torch.topk "
            f"{t['k2_lib']:.4f}, bound {k2_bound['bound_ms']:.3g} by "
            f"{k2_bound['bound_by']}, {adm // BLK} admitted blocks)")
        if n == MAIN_N and n_q == MAIN_Q and metric == VectorMetric.L2:
            stats["bf_scan"].update(ms=t["k1"], plain_ms=t["k1_plain"],
                                    library_ms=t["k1_lib"], **k1_bound)
            stats["bf_select"].update(ms=t["k2"], plain_ms=t["k2_plain"],
                                      library_ms=t["k2_lib"], **k2_bound)
        del q, base, sq_eff, s, bmax, s_p, bmax_p, o, p, neg_sq
        torch.cuda.empty_cache()
    # K1's other paths: D % 4 != 0 (no tensor map), D > 128 (the query
    # group streamed, not resident), Q > 64 (the resident split redone per
    # query group), Q in 2..8 (fp32 FMA), N % 128 == 64, and Q <= 8 with
    # one D-chunk a tile (D <= 32) over many tiles a CTA, where the sq_eff
    # buffer of a tile is refilled two tiles later (L2: every row's sq_eff
    # differs, so a tile scored with another's shows)
    ip, l2 = VectorMetric.INNER_PRODUCT, VectorMetric.L2
    for n, n_q, d, metric in ((640, 5, 100, ip), (192, 70, 37, ip),
                              (1088, 130, 256, ip), (2048, 100, 128, ip),
                              (MAIN_N, 1, 16, l2), (MAIN_N, 8, 16, l2),
                              (MAIN_N, 1, 32, l2), (MAIN_N, 8, 32, l2)):
        q, base, sq_eff, _ = make_scan_inputs(rng, n, d, n_q, metric, dev)
        s, bmax = bf_scan(q, base, sq_eff, metric)
        torch.cuda.synchronize()
        ulps = k1_ulps(s, q, base, sq_eff, score_factor(metric))
        if ulps > K1_ULPS or not torch.equal(
                bmax, s.view(n_q, -1, BLK).amax(dim=2)):
            raise AssertionError(f"K1 fails at Q={n_q} N={n} D={d} "
                                 f"{metric.name}: {ulps:.3f} ulps")
        log(f"[kernels] K1 at Q={n_q} N={n} D={d} {metric.name}: "
            f"{ulps:.3f} ulps, bmax bit-equal")
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
    for tag, fn in (("knn_batch(64)", lambda: db.knn_batch(
            "bf", "vec", queries[:64], params)),
            ("select", lambda: db.select(
                Query("bf").where_knn("vec", queries[0], params)))):
        secs = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        busy, idle, top = device_profile(fn)
        log(f"[main] {tag}: host {1e3 * statistics.median(secs):.3f} ms, "
            f"device {busy:.4f} ms, idle share {idle:.4f} ({top}) on {card}")
    return {"bf_scan": k1, "bf_select": k2}


def make_clustered(rng, n: int, n_q: int):
    """Block-coherent clustered rows: clusters of CLUSTER_ROWS consecutive
    rows (112 blocks of 64) around their own center, as a bulk load ordered
    by category or source lays them out; queries near a full cluster's
    center."""
    n_cl = -(-n // CLUSTER_ROWS)
    centers = rng.standard_normal((n_cl, MAIN_D), dtype=np.float32) * 3.0
    base = centers[np.arange(n) // CLUSTER_ROWS]
    base += 0.3 * rng.standard_normal((n, MAIN_D), dtype=np.float32)
    q = (centers[rng.integers(0, n // CLUSTER_ROWS, n_q)]
         + 0.3 * rng.standard_normal((n_q, MAIN_D), dtype=np.float32))
    return base, q.astype(np.float32)


def make_sq8_case(rng, n: int, metric, clustered: bool, dev):
    """A keeper of n rows on the card (1% of them removed) and its SQ8
    store, quantized by the port's own QuantizedStore (0.001 / 0.999
    quantile grid, the port's encoder)."""
    from reindexer_tpu_torch.index.vector.keeper import VectorKeeper
    from reindexer_tpu_torch.index.vector.quantization import QuantizedStore
    if clustered:
        base, q = make_clustered(rng, n, MAIN_Q)
    else:
        base = rng.standard_normal((n, MAIN_D), dtype=np.float32)
        q = rng.standard_normal((MAIN_Q, MAIN_D), dtype=np.float32)
    keeper = VectorKeeper(MAIN_D, metric, dev, start_size=n)
    keeper.bulk_load(base)
    invalid = rng.choice(n, size=n // 100, replace=False)
    for r in invalid.tolist():
        keeper.remove(r)
    keeper.flush()
    store = QuantizedStore(0.001, 0.999, 1)
    store.quantize(keeper)
    return keeper, store, torch.from_numpy(q).to(dev), invalid


def check_k4(o, p, exact, tag: str, require_no_flag: bool) -> tuple[int, float]:
    """K4 (o) against its plain version (p), both (scores, ids, flag): the
    same queries flag; unflagged ones have the same top-k up to near-ties of
    the exact scores and scores within fp32 rounding. Returns (flagged
    queries, max abs score error)."""
    flag, p_flag = o[2].cpu().numpy() > 0, p[2].cpu().numpy() > 0
    if (flag != p_flag).any():
        raise AssertionError(f"{tag}: K4 and its plain version flag "
                             f"different queries")
    if require_no_flag and flag.any():
        raise AssertionError(f"{tag}: K4 flagged {int(flag.sum())} queries")
    ok = ~flag
    if not ok.any():
        return int(flag.sum()), 0.0
    o_s, p_s = o[0].cpu().numpy()[ok], p[0].cpu().numpy()[ok]
    o_i, p_i = o[1].cpu().numpy()[ok], p[1].cpu().numpy()[ok]
    ex = exact[ok]
    scale = float(np.abs(ex).max())
    if not np.allclose(o_s, p_s, rtol=K2_RTOL, atol=K2_ATOL):
        raise AssertionError(f"{tag}: K4 scores disagree")
    bad = sum(tie_violations(o_i[b], p_i[b], lambda i, b=b: float(ex[b, i]),
                             float(p_s[b, -1]), TIE_RTOL)
              for b in range(len(o_i)))
    if bad:
        raise AssertionError(f"{tag}: K4 ids disagree: {bad} mismatches "
                             f"beyond ties (score scale {scale:.3g})")
    return int(flag.sum()), float(np.abs(o_s - p_s).max())


def k4_kernel_times(per: dict) -> str:
    """K4's three kernels (and anything else) from a profile_device dict."""
    names = ("sq8_admit", "sq8_score", "sq8_emit")
    out = []
    for key, ms in per.items():
        short = next((nm for nm in names if nm in key), key[:24])
        out.append(f"{short} {ms:.4f}")
    return ", ".join(out)


def phase_sq8_kernels(dev) -> dict:
    """K3/K5/K4 against their plain versions on the card. Returns
    per-kernel {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}
    (times at the main path's shape, L2)."""
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.scan import (BLK, SQ_EFF_BIG, bf16_limbs,
                                              score_factor, sq8_i8_scan,
                                              sq8_i8_scan_plain, sq8_scan,
                                              sq8_scan_plain)
    from reindexer_tpu_torch.ops.select import (FAST_EPS_SIGMA, MARGIN,
                                                bf_select, bf_select_plain,
                                                quantize_queries, sq8_select,
                                                sq8_select_plain)
    rng = np.random.default_rng(SEED + 3)
    stats = {name: {"max_abs_err": 0.0}
             for name in ("sq8_scan", "sq8_select", "sq8_i8_scan")}

    def err(name, value):
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], value)

    cases = [(MAIN_N, VectorMetric.L2), (MAIN_N, VectorMetric.INNER_PRODUCT),
             (BIG_N, VectorMetric.L2)]
    for n, metric in cases:
        tag = f"N={n} D={MAIN_D} k={K} {metric.name}"
        main = n == MAIN_N and metric == VectorMetric.L2
        fac = score_factor(metric)
        g = n // BLK
        keeper, st, q, invalid = make_sq8_case(rng, n, metric, False, dev)
        sq_eff, codes = keeper.sq_eff(), st.codes
        qa = q * st.alpha[None, :]
        zeros = torch.zeros(MAIN_Q, dtype=torch.float32, device=dev)
        shift = fac * (q @ st.lo)

        def check_k3(rows):
            """K3 at queries `rows`: S mode (shift 0 and the bmax-only
            shift) and bmax-only mode against the plain versions (rtol
            K3_RTOL, atol K3_ATOL) and the float64 product (K3_ULPS); the
            bmax-only bmax bit-equal to S mode's and to its S's block max.
            Returns (bmax-only bmax, max abs err, worst ulps)."""
            a, z, sh = qa[rows], zeros[rows], shift[rows]
            s0, b0 = sq8_scan(a, codes, sq_eff, z, metric)
            s0_p, b0_p = sq8_scan_plain(a, codes, sq_eff, z, metric)
            s1, b1 = sq8_scan(a, codes, sq_eff, sh, metric)
            _, bq = sq8_scan(a, codes, sq_eff, sh, metric, with_s=False)
            _, bq_p = sq8_scan_plain(a, codes, sq_eff, sh, metric,
                                     with_s=False)
            torch.cuda.synchronize()
            pairs = ((s0, s0_p), (b0, b0_p), (bq, bq_p))
            if not all(torch.allclose(x, y, rtol=K3_RTOL, atol=K3_ATOL)
                       for x, y in pairs):
                raise AssertionError(f"K3 disagrees with its plain version "
                                     f"at {tag} Q={a.shape[0]}")
            ulps = max(k3_ulps(s0, a, codes, sq_eff, z, fac),
                       k3_ulps(s1, a, codes, sq_eff, sh, fac))
            if ulps > K3_ULPS:
                raise AssertionError(f"K3 is off the float64 product by "
                                     f"{ulps:.3f} fp32 ulps at {tag} "
                                     f"Q={a.shape[0]}")
            if not (torch.equal(bq, b1) and torch.equal(
                    b1, s1.view(a.shape[0], -1, BLK).amax(dim=2))):
                raise AssertionError(f"K3's bmax is not its S's block max at "
                                     f"{tag} Q={a.shape[0]}")
            return bq, max(float((x - y).abs().max()) for x, y in pairs), ulps

        bq, k3_err, k3_u = check_k3(slice(0, MAIN_Q))
        _, k3_err1, k3_u1 = check_k3(slice(0, 1))
        err("sq8_scan", max(k3_err, k3_err1))
        note = ""
        if n == MAIN_N:
            # one bf16 limb of q_alpha (a plain bf16 product) must fail
            hi = bf16_limbs(qa)[0].to(torch.float32)
            s_c = (fac * (hi.double() @ codes.double().T)
                   - sq_eff.double()[None, :]).clamp_min(-1e30).float()
            c_u = k3_ulps(s_c, qa, codes, sq_eff, zeros, fac)
            if c_u <= K3_ULPS:
                raise AssertionError(f"the K3 check passes a one-limb bf16 "
                                     f"product ({c_u:.1f} ulps) at {tag}")
            note = f"; one bf16 limb is off by {c_u:.1f} ulps (rejected)"
            del s_c
        log(f"[sq8 kernels] {tag}: K3 (bf16 x {K3_LIMBS} limbs, wgmma) "
            f"{k3_u:.3f} ulps of the summed magnitude at Q={MAIN_Q}, "
            f"{k3_u1:.3f} at Q=1 (bound {K3_ULPS}), err vs plain "
            f"{max(k3_err, k3_err1):.3g} (rtol {K3_RTOL}, atol {K3_ATOL}), "
            f"bmax-only bmax bit-equal to S mode's{note}")
        # K5 bit-equal at Q = 1, 5 (a wgmma N of 8) and 64; K5 + K2
        qa_i8, sqscale, _ = quantize_queries(q, st.lo, st.alpha, metric)
        for nq in K5_QS:
            a5 = (qa_i8[:nq], sqscale[:nq], codes, sq_eff)
            s5, b5 = sq8_i8_scan(*a5)
            s5_p, b5_p = sq8_i8_scan_plain(*a5)
            torch.cuda.synchronize()
            if not (torch.equal(s5, s5_p) and torch.equal(b5, b5_p)):
                raise AssertionError(f"K5 is not bit-equal to its plain "
                                     f"version at {tag} Q={nq}")
        o = bf_select(s5, b5, zeros, K)
        p = bf_select_plain(s5_p, b5_p, zeros, K)
        s_host = s5_p.cpu().numpy()
        o_i, p_i = o[1].cpu().numpy(), p[1].cpu().numpy()
        kth = p[0][:, K - 1].cpu().numpy()
        bad = sum(tie_violations(o_i[b], p_i[b],
                                 lambda i, b=b: float(s_host[b, i]),
                                 float(kth[b]), APPROX_TIE_RTOL)
                  for b in range(MAIN_Q))
        if bad or not torch.equal(o[0], p[0]) or np.isin(o_i, invalid).any():
            raise AssertionError(f"K5 + K2 ids disagree with the plain "
                                 f"composition at {tag}")
        del s5, b5, s5_p, b5_p, s_host
        # K4 on this isotropic data: cert and fast eps
        base = keeper.data
        exact = (fac * (q.double() @ base.double().T)
                 - sq_eff.double()[None, :]).cpu().numpy()
        eps = {"cert": fac * (q.abs() * st.err_dims).sum(dim=1),
               "fast": FAST_EPS_SIGMA * fac * torch.sqrt(
                   (q * q * st.ms_dims).sum(dim=1))}
        flagged = {}
        for mode, e in eps.items():
            o = sq8_select(bq, e, q, base, sq_eff, K, metric)
            p = sq8_select_plain(bq, e, q, base, sq_eff, K, metric)
            torch.cuda.synchronize()
            flagged[mode], k4_err = check_k4(o, p, exact, f"{tag} {mode}",
                                             require_no_flag=False)
            err("sq8_select", k4_err)
        # K4 on clustered data, 64 queries and 1: nothing may flag
        ckeeper, cst, cq, _ = make_sq8_case(rng, n, metric, True, dev)
        c_sq, c_base = ckeeper.sq_eff(), ckeeper.data
        _, cbq = sq8_scan(cq * cst.alpha[None, :], cst.codes, c_sq,
                          fac * (cq @ cst.lo), metric, with_s=False)
        c_eps = fac * (cq.abs() * cst.err_dims).sum(dim=1)
        c_exact = (fac * (cq.double() @ c_base.double().T)
                   - c_sq.double()[None, :]).cpu().numpy()
        k4_args = {nq: (cbq[:nq].contiguous(), c_eps[:nq].contiguous(),
                        cq[:nq].contiguous(), c_base, c_sq, K, metric)
                   for nq in (MAIN_Q, 1)}
        for nq, a in k4_args.items():
            o, p = sq8_select(*a), sq8_select_plain(*a)
            torch.cuda.synchronize()
            _, k4_err = check_k4(o, p, c_exact[:nq], f"{tag} clustered "
                                 f"Q={nq}", require_no_flag=True)
            err("sq8_select", k4_err)
        if n == MAIN_N:
            # K3 and its plain version against the float64 product on the
            # clustered data: neither is held to the other here, each
            # error is logged (the cuda tests hold K3 score by score no
            # further from float64 than the plain version, plus 8 ulps)
            c_qa, c_sh = cq * cst.alpha[None, :], fac * (cq @ cst.lo)
            want = (fac * (c_qa.double() @ cst.codes.double().T)
                    - c_sq.double()[None, :] + c_sh.double()[:, None])
            live = c_sq < SQ_EFF_BIG / 2
            e_k, e_p = (float((x.double() - want)[:, live].abs().max())
                        for x in (sq8_scan(c_qa, cst.codes, c_sq, c_sh,
                                           metric)[0],
                                  sq8_scan_plain(c_qa, cst.codes, c_sq, c_sh,
                                                 metric)[0]))
            log(f"[sq8 kernels] {tag} clustered: largest error against the "
                f"float64 product, K3 {e_k:.4g}, plain version {e_p:.4g}")
            del want
        del exact, c_exact
        # bounds. K3: codes, sq_eff, q_alpha, shift in, bmax (and S) out;
        # K3_LIMBS bf16 products of every code. K5: codes, sq_eff, int8
        # queries, scales in, S and bmax out; int8 products. K4: bmax, eps,
        # q in, each admitted block's rows and sq_eff read once, the top k
        # and flags out; fp32 products of every query's admitted rows.

        def k3_bound(nq, with_s):
            return bound(n * MAIN_D + 4 * (n + nq * MAIN_D + nq + nq * g
                                           + with_s * nq * n),
                         K3_LIMBS * 2 * nq * n * MAIN_D, "bf16")

        def k4_bound(nq):
            per_q, uniq = k4_blocks(cbq[:nq], c_eps[:nq], min(K + MARGIN, g))
            b = bound(4 * (nq * g + 2 * nq + nq * MAIN_D
                           + uniq * BLK * (MAIN_D + 1)) + 8 * nq * K,
                      2 * per_q * BLK * MAIN_D, "fp32")
            return b, per_q, uniq

        def k5_bound(nq):
            return bound(n * MAIN_D + 4 * n + nq * MAIN_D
                         + 4 * (nq + nq * n + nq * g),
                         2 * nq * n * MAIN_D, "int8")

        bounds = {"k3": k3_bound(MAIN_Q, False), "k3_s": k3_bound(MAIN_Q, True),
                  "k3_q1": k3_bound(1, False), "k3_s_q1": k3_bound(1, True),
                  "k5": k5_bound(MAIN_Q), "k5_q1": k5_bound(1)}
        (bounds["k4"], per_q, uniq), (bounds["k4_q1"], per_q1, _) = (
            k4_bound(MAIN_Q), k4_bound(1))
        # times: three of each of K3 (both modes, Q = 64 and 1) and K4 (Q =
        # 64 and 1) at the main shape, of K3 at 1M rows; one elsewhere
        timer = device_ms3 if main or n == BIG_N else (
            lambda fn: (device_ms(fn),) * 3)
        q1 = slice(0, 1)
        t = {"k3": timer(lambda: sq8_scan(qa, codes, sq_eff, shift, metric,
                                          with_s=False)),
             "k3_s": timer(lambda: sq8_scan(qa, codes, sq_eff, zeros,
                                            metric))}
        if n == MAIN_N:
            t["k3_q1"] = timer(lambda: sq8_scan(
                qa[q1], codes, sq_eff, shift[q1], metric, with_s=False))
            t["k3_s_q1"] = timer(lambda: sq8_scan(
                qa[q1], codes, sq_eff, zeros[q1], metric))
        k4_timer = timer if n == MAIN_N else (
            lambda fn: (device_ms(fn),) * 3)
        t["k4"] = k4_timer(lambda: sq8_select(*k4_args[MAIN_Q]))
        t["k4_q1"] = k4_timer(lambda: sq8_select(*k4_args[1]))
        plain = {"k3": device_ms(lambda: sq8_scan_plain(
                     qa, codes, sq_eff, shift, metric, with_s=False)),
                 "k3_s": device_ms(lambda: sq8_scan_plain(
                     qa, codes, sq_eff, zeros, metric)),
                 "k5": device_ms(lambda: sq8_i8_scan_plain(
                     qa_i8, sqscale, codes, sq_eff)),
                 "k4": device_ms(lambda: sq8_select_plain(
                     *k4_args[MAIN_Q]))}
        t["k5"] = timer(lambda: sq8_i8_scan(qa_i8, sqscale, codes, sq_eff))
        if n == MAIN_N:
            t["k5_q1"] = timer(lambda: sq8_i8_scan(
                qa_i8[q1], sqscale[q1], codes, sq_eff))
        k4_split, _ = profile_device(lambda: sq8_select(*k4_args[MAIN_Q]), 20)
        flag_args = (bq, eps["cert"], q, base, sq_eff, K, metric)
        flag_split, _ = profile_device(lambda: sq8_select(*flag_args), 20)

        def k3_line(key):
            b = bounds[key]
            return (f"{spread(t[key])} (bound {b['bound_ms']:.4f} by "
                    f"{b['bound_by']})")

        log(f"[sq8 kernels] {tag}: K3 device ms at Q={MAIN_Q} bmax-only "
            f"{k3_line('k3')}, plain {plain['k3']:.4f}; S mode "
            f"{k3_line('k3_s')}, plain {plain['k3_s']:.4f}"
            + (f"; at Q=1 bmax-only {k3_line('k3_q1')}, S mode "
               f"{k3_line('k3_s_q1')}" if n == MAIN_N else ""))
        log(f"[sq8 kernels] {tag}: K5 (int8 wgmma) bit-equal at Q="
            f"{', '.join(map(str, K5_QS))}, K5 + K2 ids match up to ties; K5 "
            f"device ms at Q={MAIN_Q} {k3_line('k5')}, plain "
            f"{plain['k5']:.4f}"
            + (f"; at Q=1 {k3_line('k5_q1')}" if n == MAIN_N else ""))
        log(f"[sq8 kernels] {tag}: K4 isotropic flags cert "
            f"{flagged['cert']}/{MAIN_Q}, fast {flagged['fast']}/{MAIN_Q} "
            f"(same queries as plain), flagged batch device ms "
            f"{sum(flag_split.values()):.4f} ({k4_kernel_times(flag_split)})"
            f"; clustered flags 0, ids match up to ties; K4 device ms at "
            f"Q={MAIN_Q} {spread(t['k4'])} ({k4_kernel_times(k4_split)}; "
            f"plain {plain['k4']:.4f}; bound {bounds['k4']['bound_ms']:.4f} "
            f"by {bounds['k4']['bound_by']}: {uniq} unique admitted blocks, "
            f"{per_q} summed over the queries); at Q=1 {spread(t['k4_q1'])} "
            f"(bound {bounds['k4_q1']['bound_ms']:.4f} by "
            f"{bounds['k4_q1']['bound_by']}, {per_q1} admitted blocks)")
        if main:
            # no single PyTorch call computes these functions: K3's and
            # K5's u8 codes need a conversion or a shift first, K4 is a
            # gather plus a rescore
            for name, key, ms in (("sq8_scan", "k3", t["k3"][1]),
                                  ("sq8_i8_scan", "k5", t["k5"][1]),
                                  ("sq8_select", "k4", t["k4"][1])):
                stats[name].update(ms=ms, plain_ms=plain[key],
                                   library_ms=None, **bounds[key])
        del keeper, st, ckeeper, cst, codes, sq_eff, qa, qa_i8, bq, cbq
        del k4_args, flag_args
        torch.cuda.empty_cache()
    # K5 at an odd width (codes a tensor map cannot take: the producer's
    # device-memory loads) and a wide one (the queries staged in two windows
    # of D; past 1,032 dimensions the plain version sums in float64)
    for d in K5_OTHER_DS:
        codes = torch.randint(0, 256, (MAIN_N // 2, d), dtype=torch.uint8,
                              device=dev)
        qa_i8 = torch.randint(-127, 128, (MAIN_Q, d), dtype=torch.int8,
                              device=dev)
        sqscale = 1e-4 * torch.rand(MAIN_Q, device=dev) + 1e-4
        sq_eff = 100.0 * torch.rand(MAIN_N // 2, device=dev)
        for nq in K5_QS:
            a5 = (qa_i8[:nq], sqscale[:nq], codes, sq_eff)
            got, want = sq8_i8_scan(*a5), sq8_i8_scan_plain(*a5)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"K5 is not bit-equal to its plain "
                                     f"version at D={d} Q={nq}")
        log(f"[sq8 kernels] N={MAIN_N // 2} D={d}: K5 bit-equal at Q="
            f"{', '.join(map(str, K5_QS))}")
        del codes, qa_i8, got, want
    return stats


@contextlib.contextmanager
def plain_kernels():
    """Within the block the composed scans of ops.select call the kernels'
    plain versions, on whatever device their tensors are."""
    from reindexer_tpu_torch.ops import scan, select
    plain = {"bf_scan": scan.bf_scan_plain, "bf_select": select.bf_select_plain,
             "sq8_scan": scan.sq8_scan_plain,
             "sq8_select": select.sq8_select_plain,
             "sq8_i8_scan": scan.sq8_i8_scan_plain}
    saved = {name: getattr(select, name) for name in plain}
    for name, fn in plain.items():
        setattr(select, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(select, name, fn)


def run_field(db, ns: str, field: str, queries) -> tuple[dict, dict, dict]:
    """The public-API run of one field with every counter set to 0 just
    before it: 64 single selects and knn_batch with 64, 100 and 256
    queries. Returns (results by entry point, qps, counts)."""
    from reindexer_tpu_torch import KnnSearchParams, Query
    from reindexer_tpu_torch.index.vector import brute_force
    from reindexer_tpu_torch.ops import scan, select
    counters = {"bf_scan": scan.launches, "bf_select": select.launches,
                "sq8_scan": scan.sq8_scan_launches,
                "sq8_select": select.sq8_select_launches,
                "sq8_i8_scan": scan.sq8_i8_scan_launches}
    counters.update((name, getattr(brute_force, name)) for name in (
        "sq8_cert_overflows", "sq8_fast_overflows", "approx_reruns",
        "overflow_reruns", "geometry_scans"))
    for c in counters.values():
        c.reset()
    params = KnnSearchParams(k=K)
    # the first select flushes the pending rows and quantizes them
    db.select(Query(ns).where_knn(field, queries[0], params))
    results, qps = {}, {}
    single = []
    t0 = time.perf_counter()
    for qi in range(64):
        res = db.select(Query(ns).where_knn(field, queries[qi], params))
        single.append(([d["id"] for d in res.docs()], res.ranks()))
    qps["select"] = 64 / (time.perf_counter() - t0)
    results["select"] = single
    for nq in (64, 100, 256):
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = db.knn_batch(ns, field, queries[:nq], params)
            secs.append(time.perf_counter() - t0)
            results.setdefault(f"knn_batch_{nq}", [
                ([d["id"] for d in r.docs()], r.ranks()) for r in out])
        qps[f"knn_batch_{nq}"] = nq / statistics.median(secs)
    torch.cuda.synchronize()
    return results, qps, {name: c.value for name, c in counters.items()}


def check_approx(db, ns: str, field: str, queries, results, dist,
                 dev) -> float:
    """approx: ids equal, up to ties of the quantized score, to the plain
    versions' composition of the same path run on the card. approx_rerank:
    ranks are the exact distances of the returned ids, sorted. Returns
    recall@K against the float64 oracle's top-K over every result."""
    ix = db.get_namespace(ns).get_index(field)
    hits = total = 0
    for name, res in results.items():
        if field == "approx":
            nq = 64 if name == "select" else int(name.rsplit("_", 1)[1])
            qd = torch.from_numpy(queries[:nq]).to(dev)
            with plain_kernels():
                s_p, i_p, _ = ix._dispatch_scan(qd, K)
            s_p, i_p = s_p.cpu().numpy(), i_p.cpu().numpy()
        for qi, (ids, ranks) in enumerate(res):
            if field == "approx":
                # an approx rank is the negated quantized score (L2)
                score = dict(zip(i_p[qi].tolist(), s_p[qi].tolist()))
                score.update(zip(ids, (-np.asarray(ranks)).tolist()))
                if tie_violations(ids, i_p[qi].tolist(), lambda i: score[i],
                                  float(s_p[qi, K - 1]), APPROX_TIE_RTOL):
                    raise AssertionError(
                        f"{ns}.{field} {name}: query {qi} ids disagree with "
                        "the plain composition beyond ties")
            elif not (np.allclose(ranks, dist[qi][ids], rtol=RANK_RTOL,
                                  atol=1e-3) and (np.diff(ranks) >= 0).all()):
                raise AssertionError(
                    f"{ns}.{field} {name}: query {qi} ranks are not the "
                    "exact distances, sorted")
            want = np.argsort(dist[qi], kind="stable")[:K]
            hits += len(set(ids) & set(want.tolist()))
            total += K
    return hits / total


def phase_sq8_main_path(card: str, dev) -> dict:
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     KnnSearchParams, QuantizationConfig,
                                     Query, Reindexer, VectorMetric)
    rng = np.random.default_rng(SEED + 2)
    base = rng.standard_normal((DOCS, MAIN_D), dtype=np.float32)
    queries = rng.standard_normal((256, MAIN_D), dtype=np.float32)
    cbase, cqueries = make_clustered(rng, DOCS, 256)
    modes = ("exact", "approx", "approx_rerank")
    alive = {}

    def sq8_field(name, mode):
        return IndexDef(name, "vec_bf", vector_opts=FloatVectorOpts(
            dims=MAIN_D, metric=VectorMetric.L2,
            quantization=QuantizationConfig(enabled=True, mode=mode)))

    t0 = time.perf_counter()
    db = Reindexer(device=dev)
    pk = IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True))
    db.open_namespace("sq8", [pk] + [sq8_field(m, m) for m in modes])
    db.open_namespace("sq8c", [pk, sq8_field("exact", "exact")])
    for ns, vecs, fields in (("sq8", base, modes), ("sq8c", cbase,
                                                     ("exact",))):
        rows = vecs.tolist()
        for i in range(DOCS):
            db.upsert(ns, {"id": i, **dict.fromkeys(fields, rows[i])})
        deleted = rng.choice(DOCS, size=DELETES, replace=False)
        for i in deleted.tolist():
            db.delete(ns, {"id": i})
        alive[ns] = np.ones(DOCS, dtype=bool)
        alive[ns][deleted] = False
    log(f"[sq8 main] set-up: {DOCS} upserts of 3 SQ8 fields + {DOCS} of 1 "
        f"clustered field + 2 x {DELETES} deletes in "
        f"{time.perf_counter() - t0:.1f} s")
    dist = {"sq8": oracle_distances(queries, base, alive["sq8"]),
            "sq8c": oracle_distances(cqueries, cbase, alive["sq8c"])}
    launches = dict.fromkeys(KERNELS, 0)
    runs = [("sq8", m, queries) for m in modes] + [("sq8c", "exact",
                                                   cqueries)]
    for ns, field, qs in runs:
        results, qps, counts = run_field(db, ns, field, qs)
        for name in launches:
            launches[name] += counts.get(name, 0)
        tag = f"{ns}.{field}"
        if field == "exact":
            for name, res in results.items():
                check_against_oracle(res, dist[ns], f"{tag} {name}")
            verdict = "match the float64 oracle"
        else:
            recall = check_approx(db, ns, field, qs, results, dist[ns], dev)
            if recall < APPROX_MIN_RECALL:
                raise AssertionError(f"{tag}: recall@{K} {recall:.4f} < "
                                     f"{APPROX_MIN_RECALL}")
            verdict = (f"match the plain composition on the card; "
                       f"recall@{K} vs the float64 oracle {recall:.4f}")
        log(f"[sq8 main] {tag}: select x64, knn_batch(64, 100, 256) "
            f"{verdict}")
        log(f"[sq8 main] {tag} counts over its run: " + ", ".join(
            f"{name} {v}" for name, v in counts.items()))
        log(f"[sq8 main] {tag} qps on {card} (host clock): " + ", ".join(
            f"{name} {v:.1f}" for name, v in qps.items()))
        params = KnnSearchParams(k=K)
        for entry, fn in (("knn_batch(64)", lambda: db.knn_batch(
                ns, field, qs[:64], params)),
                ("select", lambda: db.select(
                    Query(ns).where_knn(field, qs[0], params)))):
            busy, idle, top = device_profile(fn)
            log(f"[sq8 main] {tag} {entry}: device {busy:.4f} ms, idle "
                f"share {idle:.4f} ({top}) on {card}")
    missing = [name for name in ("sq8_scan", "sq8_select", "sq8_i8_scan")
               if launches[name] == 0]
    if missing:
        raise AssertionError(f"the SQ8 main path did not launch {missing}")
    return launches


def set_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def ivf_counters() -> dict:
    from reindexer_tpu_torch.index.vector import ivf
    from reindexer_tpu_torch.ops import ivf_kernels
    return {"ivf_seg_scan": ivf_kernels.seg_scan_launches,
            "segment_scans": ivf.segment_scans,
            "masked_sweeps": ivf.masked_sweeps,
            "gather_scans": ivf.gather_scans}


def make_ivf_data(n: int, d: int, n_q: int):
    """bench.py's IVF data (bench_ivf1m): 1,024 gaussian centers, rows at
    sigma 0.35 around them, isotropic queries; seed 12."""
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(1024, d)).astype(np.float32)
    assign = rng.integers(0, 1024, size=n)
    base = (centers[assign] + 0.35 * rng.normal(size=(n, d))).astype(
        np.float32)
    return base, rng.normal(size=(n_q, d)).astype(np.float32)


def phase_ivf_setup(dev):
    """BASELINE config #3 loaded as bench.py loads it. Returns (index,
    prepared queries)."""
    from reindexer_tpu_torch import FloatVectorOpts, IndexDef, VectorMetric
    from reindexer_tpu_torch.index.vector.ivf import IvfIndex
    t0 = time.perf_counter()
    base, queries = make_ivf_data(IVF_N, IVF_D, max(IVF_ROUTE_BATCHES))
    t1 = time.perf_counter()
    ix = IvfIndex(IndexDef("vec", "ivf", vector_opts=FloatVectorOpts(
        dims=IVF_D, metric=VectorMetric.COSINE, centroids_count=IVF_NLIST)),
        dev)
    ix.keeper.bulk_load(base)
    del base
    ix._grow(IVF_N)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ix._train()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ix._rebuild_csr()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    log(f"[ivf setup] {IVF_N} x {IVF_D} cosine, {IVF_NLIST} lists: data "
        f"{t1 - t0:.1f} s (host), bulk_load (bf16) {t2 - t1:.1f} s, train + "
        f"assign {t3 - t2:.2f} s, list-contiguous reorder {t4 - t3:.2f} s "
        f"({ix._d_reordered.shape[0]} rows, {len(ix._list_rows)} in lists)")
    check_assign(ix, "ivf setup")
    q = np.stack([ix.keeper.prepare_query(v) for v in queries])
    return ix, q


def check_assign(ix, tag: str) -> None:
    """The on-card list assignment against a float64 recomputation from the
    centroids: every valid row sits in the list of its nearest centroid
    (the metric's argmax), up to near-ties. The probed-set oracle reads the
    assignment, so this keeps a fault there from moving the oracle along."""
    from reindexer_tpu_torch import VectorMetric
    kp = ix.keeper
    c64 = ix.centroids.double()
    rows = np.flatnonzero(kp.valid)
    assign = ix._assign[rows].astype(np.int64)
    if (assign < 0).any():
        raise AssertionError(f"{tag}: {int((assign < 0).sum())} valid rows "
                             "are in no list")
    rows_d = torch.from_numpy(rows).to(kp.device)
    assign_d = torch.from_numpy(assign).to(kp.device)
    off = 0
    for lo in range(0, len(rows), 65536):
        s = kp.data[rows_d[lo:lo + 65536]].double() @ c64.T
        if ix.metric == VectorMetric.L2:
            s = 2.0 * s - (c64 * c64).sum(dim=1)[None, :]
        best = s.max(dim=1).values
        got = s.gather(1, assign_d[lo:lo + 65536, None])[:, 0]
        off += int((best - got > ASSIGN_TIE_RTOL
                    * best.abs().clamp_min(1.0)).sum())
    if off:
        raise AssertionError(f"{tag}: {off} of {len(rows)} rows are not in "
                             "the list of their float64-nearest centroid")
    log(f"[{tag}] all {len(rows)} rows sit in the list of their "
        "float64-nearest centroid (ties within 1e-5)")


def k6_bound(starts, qids, counts, qd, reordered, metric) -> torch.Tensor:
    """K6_ULPS fp32 ulps of the magnitude a score is summed from: sum |q_d
    b_d| (IP, cosine) or 2 sum |q_d b_d| + |b|^2 (L2); 0 on rows past
    counts, where both versions write the same sentinel."""
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.ivf_kernels import scan_segments_plain
    mag = scan_segments_plain(starts, qids, counts, qd.abs(),
                              reordered.abs(), VectorMetric.INNER_PRODUCT)
    if metric == VectorMetric.L2:
        mag = 2.0 * mag - scan_segments_plain(
            starts, qids, counts, torch.zeros_like(qd), reordered, metric)
    return K6_ULPS * torch.finfo(torch.float32).eps * mag.clamp_min(0.0)


def phase_ivf_kernel(ix, q, dev) -> dict:
    """K6 against its plain version on the index's own segment plans, in
    the index's metric (cosine) and in L2 on the same reorder."""
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.ivf_kernels import (SEG_BLK, scan_segments,
                                                     scan_segments_plain)
    stats = {"max_abs_err": 0.0}
    for n_b, nprobe in K6_POINTS:
        probes = ix._probe_host(q[:n_b], nprobe)
        starts, qids, counts = ix._segment_plan(probes)
        qd = torch.from_numpy(q[:n_b]).to(dev)
        args = (starts, qids, counts, qd, ix._d_reordered, ix.metric)
        for metric in (ix.metric, VectorMetric.L2):
            m_args = args[:5] + (metric,)
            got = scan_segments(*m_args)
            want = scan_segments_plain(*m_args)
            diff = (got - want).abs()
            worst = float((diff / k6_bound(*m_args).clamp_min(1e-30)).max())
            err = float(diff.max())
            log(f"[ivf kernel] batch {n_b} x nprobe {nprobe}, {metric.name}: "
                f"K6 err {err:.3g}, {worst * K6_ULPS:.3f} ulps of the "
                f"summed magnitude at worst (bound {K6_ULPS})")
            if worst > 1.0:
                raise AssertionError(
                    f"K6 disagrees with its plain version at batch {n_b} x "
                    f"nprobe {nprobe} ({metric.name}) by more than {K6_ULPS} "
                    "fp32 ulps of the summed magnitude")
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            del got, want, diff
        c = counts.cpu().numpy()
        ragged, padding = int(((c > 0) & (c < SEG_BLK)).sum()), int(
            (c == 0).sum())
        if not ragged or not padding:
            raise AssertionError("the segment plan has no ragged or no "
                                 "padding segment")
        t = device_ms3(lambda: scan_segments(*args))
        # CUDA events around bursts of calls: a second clock beside the
        # profiler's (launch overhead is far below a call here but at 1 x 8)
        ev = cuda_time_ms(lambda: scan_segments(*args), reps=5)
        plain_ms = device_ms(lambda: scan_segments_plain(*args), n=3)
        rows = float(c.sum())
        live = c > 0
        _, first = np.unique(starts.cpu().numpy()[live], return_index=True)
        uniq = float(c[live][first].sum())
        gb, gb_u = rows * IVF_D * 4 / 1e9, uniq * IVF_D * 4 / 1e9
        # the unique probed rows and the queries in, the plan (3 i32 a
        # segment) and the scores (128 a segment) out; a dot product a
        # query's probed row, three TF32 products a term (3xTF32, as K1):
        # no PyTorch call computes this segmented gather in one
        least = bound(4 * (uniq * IVF_D + n_b * IVF_D
                           + len(c) * (3 + SEG_BLK)),
                      3 * 2 * rows * IVF_D, "tf32")
        log(f"[ivf kernel] batch {n_b} x nprobe {nprobe}: {len(c)} segments "
            f"({ragged} ragged, {padding} padding), {gb:.4f} GB probed over "
            f"the queries, {gb_u:.4f} GB of unique rows; K6 device ms "
            f"{spread(t)} ({gb_u / t[1]:.2f} TB/s of unique rows, "
            f"{least['bound_ms'] / t[1]:.0%} of the bound); CUDA events "
            f"{ev:.4f} (plain {plain_ms:.4f}, bound {least['bound_ms']:.4f} "
            f"by {least['bound_by']})")
        if (n_b, nprobe) == (IVF_BATCH, 128):
            stats.update(ms=t[1], plain_ms=plain_ms, library_ms=None,
                         **least)
        del args, starts, qids, counts
    return stats


def probed_scores(ix, s64: torch.Tensor, probes: np.ndarray) -> torch.Tensor:
    """s64 f64[B, cap] (-inf on invalid rows) with -inf outside each
    query's probed lists."""
    dev = s64.device
    n_b = probes.shape[0]
    psel = torch.zeros((n_b, ix.centroids.shape[0]), dtype=torch.bool,
                       device=dev)
    psel[torch.arange(n_b, device=dev)[:, None],
         torch.from_numpy(probes.astype(np.int64)).to(dev)] = True
    a = torch.from_numpy(ix._assign[: s64.shape[1]].astype(np.int64)).to(dev)
    member = psel[:, a.clamp_min(0)] & (a >= 0)[None, :]
    return s64.masked_fill(~member, float("-inf"))


def oracle_s64(ix, q: np.ndarray) -> torch.Tensor:
    """float64 scores (cosine: q . b) of q against the keeper's stored rows,
    on the card, -inf on invalid rows."""
    kp = ix.keeper
    qd = torch.from_numpy(q).to(kp.device).double()
    s = torch.empty((len(q), kp.capacity), dtype=torch.float64,
                    device=kp.device)
    for lo in range(0, kp.capacity, 262144):
        s[:, lo:lo + 262144] = qd @ kp.data[lo:lo + 262144].double().T
    valid = torch.from_numpy(kp.valid).to(kp.device)
    return s.masked_fill(~valid[None, :], float("-inf"))


def check_ivf(results, masked: torch.Tensor, tag: str) -> None:
    """results: (ids, ranks) per query (cosine: rank = similarity), against
    masked f64[B, cap], the oracle's scores of the probed rows."""
    top_s, top_i = torch.topk(masked, K, dim=1)
    top_s, top_i = top_s.cpu().numpy(), top_i.cpu().numpy()
    for qi, (ids, ranks) in enumerate(results):
        if len(ids) != K:
            raise AssertionError(f"{tag}: query {qi} got {len(ids)} ids")
        got = masked[qi, torch.as_tensor(ids, device=masked.device)]
        got = got.cpu().numpy()
        if not np.isfinite(got).all():
            raise AssertionError(f"{tag}: query {qi} returned a row outside "
                                 "its probed lists or a deleted row")
        score = dict(zip(top_i[qi].tolist(), top_s[qi].tolist()))
        score.update(zip(ids, got.tolist()))
        if tie_violations(ids, top_i[qi].tolist(), lambda i: score[i],
                          float(top_s[qi, -1]), TIE_RTOL):
            raise AssertionError(f"{tag}: query {qi} ids disagree with the "
                                 "probed-set float64 oracle beyond ties")
        if not np.allclose(ranks, got, rtol=RANK_RTOL, atol=IVF_RANK_ATOL):
            raise AssertionError(f"{tag}: query {qi} ranks off by "
                                 f"{np.abs(np.asarray(ranks) - got).max()}")


def ids_ranks(res) -> tuple[list, np.ndarray]:
    return res.ids.tolist(), np.asarray(res.ranks)


def phase_ivf_main(card: str, ix, q) -> int:
    """The IVF main path on config #3. Returns K6's launches over it."""
    from reindexer_tpu_torch import IvfSearchParams
    counters = ivf_counters()
    for c in counters.values():
        c.reset()
    results = {}
    t0 = time.perf_counter()
    for route, env in IVF_ROUTES.items():
        set_env("RX_IVF_SEGMENTS", env)
        for nprobe in IVF_NPROBES:
            p = IvfSearchParams(k=K, nprobe=nprobe)
            results[route, "select_batch", nprobe] = [
                ids_ranks(r) for r in ix.select_batch(q, p)]
            results[route, "select", nprobe] = [
                ids_ranks(ix.select(v, p)) for v in q]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    set_env("RX_IVF_SEGMENTS", None)
    counts = {name: c.value for name, c in counters.items()}
    log(f"[ivf main] 3 routes x {len(IVF_NPROBES)} nprobe x (select_batch of "
        f"{IVF_BATCH} + {IVF_BATCH} selects) in {secs:.1f} s; counts: "
        + ", ".join(f"{n} {v}" for n, v in counts.items()))
    s64 = oracle_s64(ix, q)
    full = torch.topk(s64, K, dim=1).indices.cpu().numpy()
    prev = -1.0
    for nprobe in IVF_NPROBES:
        npb = min(nprobe, IVF_NLIST)
        masked = {"select_batch": probed_scores(ix, s64, ix._probe_host(
            q, npb))}
        single = np.concatenate([ix._probe_host(q[b:b + 1], npb)
                                 for b in range(len(q))])
        masked["select"] = probed_scores(ix, s64, single)
        recall = {}
        for (route, entry, np_), res in results.items():
            if np_ != nprobe:
                continue
            check_ivf(res, masked[entry], f"ivf {route} {entry} "
                      f"nprobe={nprobe}")
            recall[route, entry] = np.mean([
                len(set(ids) & set(full[b].tolist())) / K
                for b, (ids, _) in enumerate(res)])
        r = recall["router", "select_batch"]
        log(f"[ivf main] nprobe={nprobe}: every route and entry point "
            f"matches the probed-set float64 oracle; recall@{K} vs the full "
            f"oracle {r:.4f} (" + ", ".join(
                f"{a}/{b} {v:.4f}" for (a, b), v in recall.items()) + ")")
        if r < prev:
            raise AssertionError(f"recall@{K} fell from {prev:.4f} to "
                                 f"{r:.4f} at nprobe={nprobe}")
        prev = r
        del masked
    del s64
    if counts["ivf_seg_scan"] == 0 or counts["masked_sweeps"] == 0:
        raise AssertionError("the IVF main path did not run both routes")
    return counts["ivf_seg_scan"]


def device_profile(fn, n: int = 5) -> tuple[float, float, str]:
    """torch.profiler over n calls of fn: (device ms per call, idle share
    of the wall time, the three largest device items); NaN and NaN where
    no trace held device time."""
    per, wall_ms = profile_device(fn, n, host=True)
    if not per:
        return float("nan"), float("nan"), "not measured: no device trace"
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return busy, 1.0 - busy * n / wall_ms, "; ".join(
        f"{k[:40]} {v:.4f}" for k, v in top)


def phase_ivf_routes(card: str, ix, q) -> None:
    """Both stage-2 routes timed at every batch of IVF_ROUTE_BATCHES and
    every nprobe (CUDA events around bursts of _stage2 calls, host work
    included), the rows each reads, the whole select_batch on the host
    clock, and the route the router takes; at nprobe 8 and 128 also the
    device time and idle share of select_batch per route (torch.profiler)."""
    from reindexer_tpu_torch import IvfSearchParams
    from reindexer_tpu_torch.ops.ivf_kernels import SEG_BLK
    counters = ivf_counters()
    dev = ix.keeper.device
    log(f"[ivf routes] capacity {ix.keeper.capacity}, reorder "
        f"{ix._d_reordered.shape[0]} rows; {card}")
    for n_b in IVF_ROUTE_BATCHES:
        qd = torch.from_numpy(q[:n_b]).to(dev)
        for nprobe in IVF_NPROBES:
            seg_rows = int(ix._seg_blocks[ix._probe_host(q[:n_b], nprobe)]
                           .sum()) * SEG_BLK
            p = IvfSearchParams(k=K, nprobe=nprobe)
            row, prof = {}, []
            for route in ("segments", "sweep"):
                set_env("RX_IVF_SEGMENTS", IVF_ROUTES[route])
                row[route] = cuda_time_ms(
                    lambda: ix._stage2(qd, nprobe, K, q[:n_b]), reps=10,
                    burst=5)
                secs = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    ix.select_batch(q[:n_b], p)
                    secs.append(time.perf_counter() - t0)
                row[route + "_host"] = 1e3 * statistics.median(secs)
                if nprobe in (8, 128):
                    busy, idle, top = device_profile(
                        lambda: ix.select_batch(q[:n_b], p))
                    prof.append(f"{route}: device {busy:.4f} ms, idle share "
                                f"{idle:.4f} ({top})")
            set_env("RX_IVF_SEGMENTS", None)
            for c in counters.values():
                c.reset()
            ix.select_batch(q[:n_b], p)
            chosen = "segments" if counters["segment_scans"].value else \
                "sweep"
            log(f"[ivf routes] batch {n_b} nprobe {nprobe}: seg_rows "
                f"{seg_rows}; stage 2 ms segments {row['segments']:.4f}, "
                f"sweep {row['sweep']:.4f}; select_batch host ms segments "
                f"{row['segments_host']:.3f}, sweep {row['sweep_host']:.3f}"
                f"; router takes {chosen}")
            for line in prof:
                log(f"[ivf routes]     {line}")


def phase_ivf_api(card: str, dev) -> int:
    """The IVF public API at 100k x 128. Returns K6's launches over it."""
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     IvfSearchParams, Query, Reindexer,
                                     VectorMetric)
    base, queries = make_ivf_data(IVF_API_DOCS, IVF_API_D, 64)
    deleted = np.random.default_rng(SEED + 4).choice(
        IVF_API_DOCS, size=DELETES, replace=False)
    t0 = time.perf_counter()
    db = Reindexer(device=dev)
    db.open_namespace("ivf", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "ivf", vector_opts=FloatVectorOpts(
            dims=IVF_API_D, metric=VectorMetric.COSINE,
            centroids_count=IVF_NLIST))])
    rows = base.tolist()
    for i in range(IVF_API_DOCS):
        db.upsert("ivf", {"id": i, "vec": rows[i]})
    for i in deleted.tolist():
        db.delete("ivf", {"id": i})
    log(f"[ivf api] set-up: {IVF_API_DOCS} upserts + {DELETES} deletes in "
        f"{time.perf_counter() - t0:.1f} s")
    ix = db.get_namespace("ivf").get_index("vec")
    counters = ivf_counters()
    for c in counters.values():
        c.reset()

    def knn(qv, nprobe):
        return Query("ivf").where_knn("vec", qv, IvfSearchParams(
            k=K, nprobe=nprobe))

    def docs(res):
        return [d["id"] for d in res.docs()], np.asarray(res.ranks())

    t0 = time.perf_counter()
    db.select(knn(queries[0], 8))          # trains, assigns, reorders
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [docs(db.select(knn(v, 8))) for v in queries]
    qps = len(queries) / (time.perf_counter() - t0)
    batches = {nprobe: [docs(r) for r in db.knn_batch(
        "ivf", "vec", queries[:16], IvfSearchParams(k=K, nprobe=nprobe))]
        for nprobe in (8, 128)}
    vec = ", ".join(repr(float(x)) for x in queries[1])
    sql = [docs(db.select(f"SELECT * FROM ivf WHERE KNN(vec, [{vec}], "
                          f"k={K}, nprobe=8)"))]
    cent = ix.centroids
    check_assign(ix, "ivf api")
    q = np.stack([ix.keeper.prepare_query(v) for v in queries])
    s64 = oracle_s64(ix, q)
    one = [ix._probe_host(q[b:b + 1], 8) for b in range(len(q))]
    check_ivf(single, probed_scores(ix, s64, np.concatenate(one)),
              "ivf api select")
    check_ivf(sql, probed_scores(ix, s64[1:2], one[1]), "ivf api SQL")
    for nprobe, res in batches.items():
        check_ivf(res, probed_scores(ix, s64[:16], ix._probe_host(
            q[:16], nprobe)), f"ivf api knn_batch(16) nprobe={nprobe}")
    db.upsert("#config", {"type": "action", "action": {
        "command": "rebuild_ivf_index", "namespace": "ivf", "index": "vec"}})
    if ix.centroids is cent:
        raise AssertionError("rebuild_ivf_index did not retrain")
    check_assign(ix, "ivf api after rebuild_ivf_index")
    after = [docs(db.select(knn(queries[2], 8)))]
    check_ivf(after, probed_scores(ix, s64[2:3], ix._probe_host(
        q[2:3], 8)), "ivf api select after rebuild_ivf_index")
    torch.cuda.synchronize()
    counts = {name: c.value for name, c in counters.items()}
    log(f"[ivf api] 64 selects, knn_batch(16) at nprobe 8 and 128, SQL KNN, "
        f"rebuild_ivf_index + select: match the probed-set float64 oracle "
        f"(ids up to ties, ranks rtol 1e-4); first select (train + reorder) "
        f"{t_first:.2f} s, select {qps:.1f} qps on {card} (host clock); "
        "counts: " + ", ".join(f"{n} {v}" for n, v in counts.items()))
    if counts["ivf_seg_scan"] == 0:
        raise AssertionError("the IVF public-API path did not launch K6")
    p8 = IvfSearchParams(k=K, nprobe=8)
    for tag, fn in (("knn_batch(16)", lambda: db.knn_batch(
            "ivf", "vec", queries[:16], p8)),
            ("select", lambda: db.select(knn(queries[0], 8)))):
        fn()
        secs = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        busy, idle, top = device_profile(fn)
        log(f"[ivf api] {tag} nprobe 8 (router): host "
            f"{1e3 * statistics.median(secs):.3f} ms, device {busy:.4f} ms, "
            f"idle share {idle:.4f} ({top})")
    return counts["ivf_seg_scan"]


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
    stats.update(phase_sq8_kernels(dev))
    sq8_launches = phase_sq8_main_path(card, dev)
    launches.update((name, sq8_launches[name])
                    for name in ("sq8_scan", "sq8_select", "sq8_i8_scan"))
    ix, q = phase_ivf_setup(dev)
    stats["ivf_seg_scan"] = phase_ivf_kernel(ix, q, dev)
    launches["ivf_seg_scan"] = phase_ivf_main(card, ix, q[:IVF_BATCH])
    phase_ivf_routes(card, ix, q)
    del ix
    torch.cuda.empty_cache()
    launches["ivf_seg_scan"] += phase_ivf_api(card, dev)
    loaded = [m for m in ("jax", "reindexer_tpu") if m in sys.modules]
    if loaded:
        raise AssertionError(f"{' and '.join(loaded)} got imported")
    replaces = {"bf_scan": "reindexer_tpu/ops/pallas_scan.py:94",
                "bf_select": "reindexer_tpu/ops/pallas_select.py:574",
                "sq8_scan": "reindexer_tpu/ops/pallas_scan.py:311 + "
                            "reindexer_tpu/ops/pallas_select.py:247",
                "sq8_select": "reindexer_tpu/ops/pallas_select.py:948",
                "sq8_i8_scan": "reindexer_tpu/ops/pallas_select.py:1453",
                "ivf_seg_scan": "reindexer_tpu/ops/ivf_kernels.py:338"}
    kernels = [{"name": name, "route": "cuda",
                "source": f"reindexer_tpu_torch/csrc/{name}.cu",
                "replaces": replaces[name], "launches": launches[name],
                **{key: stats[name][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name in KERNELS]
    log(f"[timer] {TRACE_LOSSES[0]} of {TRACE_LOSSES[1]} profiler traces "
        "lost device events (their times per call are per-event means "
        "times launches per call)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
