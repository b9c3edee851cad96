"""Smoke run of reindexer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hnsw-build N   # phase 10 alone, at N rows

Phases, in order; any failure raises, so the exit code is not 0:
  0. identity: the card's name and power limit (nvidia-smi), torch, CUDA;
  1. build: the seven kernels (K1 bf_scan, K2 bf_select, K3 sq8_scan, K4
     sq8_select, K5 sq8_i8_scan, K6 ivf_seg_scan, K7 hnsw_beam) with nvcc
     from csrc/, one nvcc per source,
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
     nprobe grows. Then both stage-2 routes are timed at batch 1, 16, 64
     and 256 at each nprobe, with device time and idle share (the router
     table, PERF.md);
  9. the IVF public API: a 100,000 x 128 cosine IVF namespace with 1,024
     lists filled by db.upsert, 1,000 deletes; 64 db.select, knn_batch of
     16 at nprobe 8 and 128, one SQL KNN(..., nprobe=8), the
     rebuild_ivf_index action and a select after it, each against the
     probed-set oracle (the list assignment checked as in 6). K6 must have
     launched on the IVF paths; then host ms, device ms and idle share of
     knn_batch(16) and select;
 10. HNSW set-up, BASELINE config #2 cut in N (bench.py hnsw200k): 200,000
     x 96 inner product, M 16, efC 200, the Deep1M-like rows bench_deep1m
     makes (seed 11, 4,096 centres, sigma 0.35, normalized), loaded as it
     loads them (keeper.bulk_load, _grow, _pending, commit); the build's
     time (split into the host's enqueueing of the device work, its wait
     for the device and its linking), rows/s, levels, layer-0 degree and
     device memory;
 11. the card's graph loaded into a CPU index (the plain path): 16 queries
     at ef 64 give the same ids (near-ties aside), ranks within rtol 1e-4
     and the same beam steps on both;
 12. the HNSW main path: 64 queries, k=10, ef 32, 128 and 512, select_batch
     and 64 selects against a float64 oracle (ranks exact within rtol 1e-4,
     recall@10 >= 0.95 at ef 128, falling by no more than 0.005 as ef
     grows); per ef the host ms, device ms, idle share, beam steps and
     device launches per search (the descent and the beam, K7, one launch
     each a search);
 13. SQ8 HNSW on the same graph: the store active, recall@10 >= 0.9 at ef
     128, ranks exact after the fp32 rescore; then K7 against its plain
     twin on the card at the main path's shape (64 queries, ef 128): bit
     for bit (W, C, visited words, `it`) on 200,000 x 96 rows of small
     integers, fp32 and SQ8, IP and L2; on the deep-like graph, fp32 and
     SQ8, `it` equal, at most K7_SPLIT_MAX queries on another path (a
     near-tie), the rest with ids equal up to near-ties and scores within
     K7_SCORE_ATOL; K7's device ms, the eager twin's and K7's bound (rows
     scored, link rows and visited words over 3.35 TB/s); K7's launches
     from the main path on join the kernel line; the descent kernel
     against its plain twin (on the CPU) bit for bit on the same integer
     rows under four upper layers of 16 links (the top one all -1), then
     on the deep-like graph at the main path's shape (64 queries, 96
     dimensions, 16 links a row): entries equal to the twin's on the card
     for all but K7_SPLIT_MAX queries, its device ms, the twin's and its
     bound (the rows its hops scored and their link rows);
 14. the HNSW public API at bench_hnsw's size (20,000 x 96 IP, efC 128,
     db.upsert, 1,000 deletes): 64 selects, knn_batch(64) and an SQL KNN
     against the oracle with no deleted row, a streaming query (KNN with
     neither k nor radius, filtered by grp) and its offset page, an array
     field of 3 vectors a document (each document once, ranked by its best
     vector); then host ms, device ms and idle share of knn_batch(64) and
     select;
 15. full text, BASELINE config #4's shape on bench_ft1m's corpus (its
     Wikipedia corpus is not in the repository): 1,000,000 docs x 30
     zipf(1.3) words over 100,000, seed 4, FtFastConfig() defaults; the
     build (both C++ host lanes loaded), the device mirrors and the dense
     head, the commit-time warm;
     bench_ft1m's four cases (8 single-term, 32 rare 2-term, 4 frequent
     2-term queries, one process_batch of the 36) at the fitted routes,
     each answer equal to the host merge's, with host ms, device ms, idle
     share and the routes taken; every device route (sorted, dense, each
     single and batched) against the host merge on the same queries (every
     reference answer counted as a host merge; the largest rank difference
     of each route printed), and an overflowing dense query re-run on the
     host, counted; then the
     `[ft routes]` table (2-term gathers of ~2^14 to ~2^21 postings: host
     merge, device sorted, dense at batch 1, 8 and 36, the host's heap and
     dense merges), from which the route constants are fitted
     (tests/test_torch_ft.py ROUTE_TABLES);
 16. hybrid, BASELINE config #5 as bench_hybrid builds it: 100,000 docs, a
     grp field, a text index over 8 zipf(1.3) words of 5,000, a 128-dim L2
     vec_bf field, seed 13, on the card and on the CPU; grp < 5, match
     'w3 w7', KNN k=100, top 20, fused by RRF and by a linear rerank: the
     card's answer equals the CPU's, K1 and K2 launch (their launches join
     the kernel line's), with host ms, device ms and idle share; then the
     full-text public API on that namespace (Query.match, SQL, ft_batch,
     highlight / snippet);
 17. [persist], restart: hybrid config #5's namespace (its rows cut from
     100,000 to 25,000) and the HNSW API one (20,000 x 96) in a FileStorage
     database, the IVF API one (cut to 25,000 rows, 1,024 lists, 1,000
     deletes) in a sqlite:// database, every write through db.upsert;
     a flush; 1,000 upserts of existing rows, 500 deletes and 500 new rows
     a namespace in the WAL alone; the databases dropped without close()
     (a crash) and reopened with the ANN cache: every vec_bf KNN, match,
     hybrid, scalar and IVF answer equals the live database's (ties as
     sets, ranks rtol 1e-5), the HNSW links loaded equal the saved ones
     and its answers after the WAL reach the API's recall gate; K1, K2 and
     K6 must launch; the time to recover per namespace (parse and upsert,
     cache load, WAL replay, first query), bytes on disk, device memory;
 18. [server], the daemon path over that storage root: ReindexerServer +
     RpcServer in process (the manager rediscovers both databases with
     RX_TPU_DISABLE_ANN_CACHE=1: [persist]'s restart without the cache,
     held and timed as the one with it), HTTP DSL KNN, SQL and match and
     RPC KNN equal to the embedded answers, 8 RPC threads x 32 vec_bf
     selects equal to the serial answers (qps, host ms p50 / p99, device
     ms, idle share; K1 and K2 must launch), HNSW selects beside vec_bf
     selects; then python -m reindexer_tpu_torch.server (started at the
     crash) answers one HTTP KNN request and exits 0 on SIGTERM; the
     storage root is a tempfile.mkdtemp(), removed at the end;
 19. [replication], async leader -> follower on the card: R1 follows
     phase 16's hybrid database (100,000 docs) over an RpcLeaderChannel
     to an in-process RpcServer: a chunked force sync (seconds, docs/s,
     the first KNN and match after it), then the leader's writes ([persist]'s
     mix: 1,000 upserts of existing rows, 500 deletes, 500 new rows, a
     put_meta; a namespace dropped, one renamed and written to) replayed
     online by the replicator's thread, its vector rows uploaded once, at
     the next select; 64 selects, knn_batch(64) (k=100), a match and the
     hybrid RRF query (both text indexes rebuilt) equal the leader's, its
     namespaces, data hashes and meta too; the lag of 200 acknowledged
     writes until R1 returns them (p50 / p99); host ms, device ms and idle
     share of R1's knn_batch(64). R2 follows [server]'s sqlite database (the
     IVF namespace) over HttpLeaderChannel to [server]'s HTTP server: a
     force sync, 400 leader writes, data hashes equal; it trains its own
     lists, so its answers at nprobe 8 are held to the probed-set float64
     oracle of its lists and at nprobe 1,024 to the leader's; K1, K2 and
     K6 must launch;
 20. [cluster], the synchronous RAFT cluster: make_cluster(3) on the card,
     BF config #1's rows (128-dim L2 vec_bf with a pk), 20,000 upserts
     through the live nodes in turn (a follower proxies to the leader), the
     leader killed at write 10,000 and a new one elected; every
     acknowledged row read back from every live node, and from the revived
     node after it catches up; 64 KNN selects (k=100) on every node
     against the float64 oracle; then make_tcp_cluster(3) the same at
     2,000 writes over sockets; election seconds, acknowledged-write
     latency p50 / p99 and writes/s per transport, host ms, device ms and
     idle share of a node's select; K1 and K2 must launch;
 21. [sharding], ShardedReindexer over 4 port databases on the card (and
     the same 4 on the CPU), phase 16's documents sharded by grp: shard 0
     values 0-2, shard 1 values 3-5, shard 2 the range 6-7, shard 3 the
     default; pinned grp = 3 and distributed grp < 5 selects, 64
     distributed KNN (k=100) and count / sum / facet equal the unsharded
     database's; match and the hybrid RRF query (ranked per shard) equal
     the CPU's shards; host ms, device ms and idle share of a distributed
     select beside the single database's; then apply_sharding_config moves
     grp 8-9 to shard 2 while a writer upserts 500 rows (rows moved,
     seconds, every row where the new config puts it, 16 KNN equal the
     unsharded database's); K1 and K2 must launch;
 22. [mesh], mesh mode (Reindexer(mesh=make_mesh_context(S))): BF config
     #1 (phase 3's rows, 1,000 deletes) over 4 and 8 shards of cuda:0 (2
     shards cut for the phase's time), and over the distinct cards when
     there are several; 64 selects and a
     knn_batch(64) equal the one-device database's (ids up to ties, ranks
     rtol 1e-4), K1 and K2 launched once a shard a dispatch, no rerun, no
     plain scan; host ms, device ms and idle share of knn_batch(64) and
     select beside one device's. Over 4 shards: SQ8 approx and
     approx_rerank (K3 S mode + K2 a shard) equal to the same database
     through the kernels' plain versions; the IVF API's namespace (100,000
     x 128 cosine, 1,024 lists) at nprobe 1,024 against the float64
     oracle, by the probe-mask route (no K6); the HNSW API's namespace
     (20,000 x 96 IP, round-robin shards) at recall@10 >= 0.95 at ef 128;
     hybrid config #5 (text doc-sharded, KNN by K1 + K2) with RRF and
     linear ranks equal to one device's. Its K1, K2 and K3 launches join
     the kernel line's;
then one JSON line for the kernels (with each one's bound: the larger of
its bytes over 3.35 TB/s and its operations over the H100's peak for their
type) and, last, the result line.
There is no CPU path: without CUDA the script exits non-zero. The script
imports neither JAX nor the JAX package, and fails if either was loaded.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

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
# the router table (PERF.md); batches 32 and 128 cut for the script's time
IVF_ROUTE_BATCHES = (1, 16, 64, 256)
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


def profile_device(fn, n: int, host: bool = False,
                   launches: dict | None = None) -> tuple[dict, float]:
    """torch.profiler over n calls of fn: ({device item: ms per call},
    wall ms of the n calls). host=True also traces the host's operators;
    `launches`, when given, receives {device item: events per call}.
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
                if launches is not None:
                    launches[ev.key] = launches.get(ev.key, 0) + per_call
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
           "ivf_seg_scan", "hnsw_beam")


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


def bf_config1():
    """BF config #1's rows, queries and deletes (seed SEED + 1)."""
    rng = np.random.default_rng(SEED + 1)
    base = rng.standard_normal((DOCS, MAIN_D), dtype=np.float32)
    queries = rng.standard_normal((256, MAIN_D), dtype=np.float32)
    deleted = rng.choice(DOCS, size=DELETES, replace=False)
    return base, queries, deleted


def bf_db(base, deleted, fields=None, **kw):
    """BF config #1's namespace "bf" through db.upsert: one vec_bf field
    "vec", or `fields` (name -> QuantizationConfig) over the same rows;
    kw goes to Reindexer (device, mesh)."""
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     QuantizationConfig, Reindexer,
                                     VectorMetric)
    fields = fields or {"vec": QuantizationConfig()}
    db = Reindexer(**kw)
    db.open_namespace("bf", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True))] + [
        IndexDef(name, "vec_bf", vector_opts=FloatVectorOpts(
            dims=MAIN_D, metric=VectorMetric.L2, quantization=qc))
        for name, qc in fields.items()])
    rows = base.tolist()
    for i in range(len(rows)):
        db.upsert("bf", {"id": i, **{name: rows[i] for name in fields}})
    for i in deleted.tolist():
        db.delete("bf", {"id": i})
    return db


def phase_main_path(card: str):
    """The fp32 main path; returns (K1's and K2's launches, the
    database)."""
    from reindexer_tpu_torch import KnnSearchParams, Query
    from reindexer_tpu_torch.index.vector import brute_force
    from reindexer_tpu_torch.ops import scan, select
    base, queries, deleted = bf_config1()
    alive = np.ones(DOCS, dtype=bool)
    alive[deleted] = False

    t0 = time.perf_counter()
    db = bf_db(base, deleted, device="cuda")
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
    return {"bf_scan": k1, "bf_select": k2}, db


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


# --- HNSW (BASELINE config #2, cut in N) -----------------------------------

HNSW_N, HNSW_D, HNSW_M, HNSW_EFC = 200_000, 96, 16, 200  # bench.py hnsw200k
HNSW_CENTERS, HNSW_SIGMA, HNSW_SEED = 4096, 0.35, 11     # bench_deep1m data
HNSW_Q, HNSW_K = 64, 10
HNSW_EFS = (32, 128, 512)     # 64 and 256 cut for the script's time
HNSW_MIN_RECALL, HNSW_RECALL_EF = 0.95, 128   # recall@10 floor at ef 128
HNSW_RECALL_DROP = 0.005   # recall@10 may fall this much as ef grows, no more
HNSW_SQ8_MIN_RECALL = 0.9
HNSW_CPU_Q, HNSW_CPU_EF = 16, 64              # the CPU / card agreement
HNSW_API_N, HNSW_API_D, HNSW_API_EFC = 20_000, 96, 128   # bench_hnsw
HNSW_API_EF = 64
HNSW_API_MIN_RECALL = 0.9
HNSW_ARRAY_DOCS, HNSW_ARRAY_VECS = 2_000, 3
HNSW_K7_EF = 128          # K7 at the main path's beam width (ef 128)
# K7 on the deep-like graph against its plain twin: their fp32 sums run in
# another order (1-2 ulps of a score near 1), so a near-tie at a pop or a
# cut may send a query another way; the queries that keep the twin's path
# must match within K7_SCORE_ATOL (unit rows: 96 x 2^-24 of sum |q_d v_d|
# <= 1 is 6e-6; a TF32 or bf16 product is off by ~1e-3) and with ids equal
# up to near-ties, and no more than K7_SPLIT_MAX of 64 may split
K7_SCORE_ATOL = 1e-5
K7_SPLIT_MAX = 4


def hnsw_counters() -> dict:
    from reindexer_tpu_torch.ops import hnsw_kernels
    return {"beam_steps": hnsw_kernels.beam_steps}


def hnsw_def(name: str, dims: int, efc: int, quant: bool = False,
             is_array: bool = False):
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     QuantizationConfig, VectorMetric)
    return IndexDef(name, "hnsw", opts=IndexOpts(is_array=is_array),
                    vector_opts=FloatVectorOpts(
                        dims=dims, metric=VectorMetric.INNER_PRODUCT,
                        m=HNSW_M, ef_construction=efc,
                        quantization=QuantizationConfig(enabled=quant)))


def make_deep1m_like(n: int, d: int, n_q: int):
    """bench.py's Deep1M-like set (bench_deep1m): 4,096 gaussian centres,
    rows at sigma 0.35 around them, normalized; the queries drawn the same
    way after the rows; seed 11."""
    rng = np.random.default_rng(HNSW_SEED)
    centers = rng.normal(size=(HNSW_CENTERS, d)).astype(np.float32)
    assign = rng.integers(0, HNSW_CENTERS, size=n)
    base = (centers[assign]
            + HNSW_SIGMA * rng.normal(size=(n, d))).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries = (centers[rng.integers(0, HNSW_CENTERS, size=n_q)]
               + HNSW_SIGMA * rng.normal(size=(n_q, d))).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return base, queries


def phase_hnsw_setup(dev):
    """BASELINE config #2 at N = 200,000, loaded as bench_deep1m loads it
    (keeper.bulk_load, _grow, _pending, commit). Returns (index, base,
    queries)."""
    from reindexer_tpu_torch.index.vector.hnsw import HnswIndex
    t0 = time.perf_counter()
    base, queries = make_deep1m_like(HNSW_N, HNSW_D, HNSW_Q)
    t1 = time.perf_counter()
    ix = HnswIndex(hnsw_def("vec", HNSW_D, HNSW_EFC), dev)
    # host seconds in the build's two phases and in the linking itself:
    # _link_chunk's time less _connect_selected's is its wait on the device
    parts = dict.fromkeys(("_dispatch_chunks", "_link_chunk",
                           "_connect_selected"), 0.0)
    for name in parts:
        def timed(*args, _fn=getattr(ix, name), _name=name):
            t = time.perf_counter()
            out = _fn(*args)
            parts[_name] += time.perf_counter() - t
            return out
        setattr(ix, name, timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    ix.keeper.bulk_load(base)
    ix._grow(HNSW_N)
    ix._pending = dict(enumerate(base))
    ix.commit()
    ix._sync_device()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t2
    for name in parts:
        delattr(ix, name)
    deg = (ix._links0[:HNSW_N] >= 0).sum(axis=1)
    if deg.min() < 1:
        raise AssertionError(f"{int((deg < 1).sum())} rows have no layer-0 "
                             "link")
    layers = [int((u[:HNSW_N] >= 0).any(axis=1).sum()) for u in ix._upper]
    vec_mb = (ix.keeper.data.nbytes + ix.keeper.sq.nbytes) / 2 ** 20
    link_mb = (ix._d_links0.nbytes + (ix._d_upper.nbytes if ix._d_upper
                                      is not None else 0)) / 2 ** 20
    cut = ", bench.py hnsw200k: N cut from 1M" if HNSW_N < 1_000_000 else ""
    log(f"[hnsw setup] {HNSW_N} x {HNSW_D} IP, M {HNSW_M}, efC {HNSW_EFC} "
        f"(BASELINE config #2{cut}): data {t1 - t0:.1f} s (host); build {secs:.2f} s, {HNSW_N / secs:.0f} "
        f"rows/s (host: dispatch {parts['_dispatch_chunks']:.2f} s, wait "
        f"{parts['_link_chunk'] - parts['_connect_selected']:.2f} s, link "
        f"{parts['_connect_selected']:.2f} s); max level {ix._max_level}, "
        f"linked nodes per upper layer "
        f"(top first) {layers}; layer-0 degree mean {deg.mean():.2f} (min "
        f"{deg.min()}, max {deg.max()} of {ix.m0}); device memory: vectors "
        f"{vec_mb:.1f} MiB, link mirrors {link_mb:.1f} MiB, build peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return ix, base, queries


def agree(ref_res, got_res, tag: str) -> None:
    """(ids, ranks) lists: ranks within rtol 1e-4, ids equal except between
    near-ties at the k-th rank."""
    for qi, ((ids_r, ranks_r), (ids, ranks)) in enumerate(zip(ref_res,
                                                              got_res)):
        if len(ids) != len(ids_r) or not np.allclose(
                ranks, ranks_r, rtol=RANK_RTOL, atol=1e-6):
            raise AssertionError(f"{tag}: query {qi} ranks differ")
        rank_of = dict(zip(ids_r, ranks_r)) | dict(zip(ids, ranks))
        if tie_violations(ids, ids_r, lambda i: rank_of[i],
                          float(ranks_r[-1]), TIE_RTOL):
            raise AssertionError(f"{tag}: query {qi} ids differ beyond "
                                 "near-ties")


def phase_hnsw_cpu_agree(ix, queries) -> None:
    """The card's graph loaded into a CPU index (the plain path): the same
    ids up to near-ties, ranks within rtol 1e-4, the same beam steps."""
    from reindexer_tpu_torch import HnswSearchParams
    from reindexer_tpu_torch.index.vector.hnsw import HnswIndex
    cpu = HnswIndex(hnsw_def("vec", HNSW_D, HNSW_EFC), torch.device("cpu"))
    cpu.load_state_dict(ix.state_dict())
    p = HnswSearchParams(k=HNSW_K, ef=HNSW_CPU_EF)
    steps = hnsw_counters()["beam_steps"]
    out, n_steps, secs = [], [], []
    for index in (cpu, ix):
        steps.reset()
        t0 = time.perf_counter()
        out.append([ids_ranks(r) for r in index.select_batch(
            queries[:HNSW_CPU_Q], p)])
        secs.append(time.perf_counter() - t0)
        n_steps.append(steps.value)
    agree(out[0], out[1], "hnsw cpu/card")
    if n_steps[0] != n_steps[1]:
        raise AssertionError(f"beam steps differ: CPU {n_steps[0]}, card "
                             f"{n_steps[1]}")
    log(f"[hnsw cpu/card] {HNSW_CPU_Q} queries at ef {HNSW_CPU_EF}: the "
        f"card's graph searched on the CPU and on the card gives the same ids "
        f"(near-ties aside), ranks within rtol 1e-4, {n_steps[1]} beam steps "
        f"on both (CPU {secs[0]:.2f} s, card {secs[1]:.3f} s, host clock)")


def hnsw_oracle(base, queries, dev, alive=None):
    """float64 inner products f64[Q, N] on dev (-inf on deleted rows) and
    the top-HNSW_K ids per query."""
    s = torch.from_numpy(queries).to(dev).double() @ torch.from_numpy(
        base).to(dev).double().T
    if alive is not None:
        s[:, torch.from_numpy(~alive).to(dev)] = float("-inf")
    return s, torch.topk(s, HNSW_K, dim=1).indices.cpu().numpy()


def check_hnsw(results, s64, top, tag: str) -> float:
    """(ids, ranks) per query: ranks are the exact inner products (rtol
    1e-4), no deleted row, HNSW_K ids. Returns recall@K against top."""
    hits = 0
    for qi, (ids, ranks) in enumerate(results):
        if len(ids) != HNSW_K or len(set(ids)) != HNSW_K:
            raise AssertionError(f"{tag}: query {qi} got {len(ids)} ids")
        exact = s64[qi, torch.as_tensor(ids, device=s64.device)].cpu()
        exact = exact.numpy()
        if not np.isfinite(exact).all():
            raise AssertionError(f"{tag}: query {qi} returned a deleted row")
        if not np.allclose(ranks, exact, rtol=RANK_RTOL, atol=1e-6):
            raise AssertionError(f"{tag}: query {qi} ranks off by "
                                 f"{np.abs(ranks - exact).max()}")
        if list(ranks) != sorted(ranks, reverse=True):
            raise AssertionError(f"{tag}: query {qi} ranks out of order")
        hits += len(set(ids) & set(top[qi].tolist()))
    return hits / (HNSW_K * len(results))


def profile_launches(fn, n: int = 3) -> tuple[float, float, int]:
    """torch.profiler over n calls of fn (after one warm call): (device ms
    per call, idle share of the wall time, device events per call)."""
    fn()
    counts: dict = {}
    per, wall_ms = profile_device(fn, n, host=True, launches=counts)
    if not per:
        return float("nan"), float("nan"), 0
    busy = sum(per.values())
    return busy, 1.0 - busy * n / wall_ms, sum(counts.values())


def phase_hnsw_main(card: str, ix, base, queries) -> None:
    """The HNSW main path: select_batch(64) and 64 selects at every ef,
    against the float64 oracle; per ef the host and device ms, idle share,
    beam steps and device launches per search."""
    from reindexer_tpu_torch import HnswSearchParams
    counters = hnsw_counters()
    s64, top = hnsw_oracle(base, queries, ix.keeper.device)
    prev = {}
    for ef in HNSW_EFS:
        p = HnswSearchParams(k=HNSW_K, ef=ef)
        row = {}
        for entry in ("select_batch", "select"):
            for c in counters.values():
                c.reset()
            t0 = time.perf_counter()
            if entry == "select_batch":
                res = [ids_ranks(r) for r in ix.select_batch(queries, p)]
                searches = 1
            else:
                res = [ids_ranks(ix.select(v, p)) for v in queries]
                searches = len(queries)
            host_ms = 1e3 * (time.perf_counter() - t0) / searches
            recall = check_hnsw(res, s64, top, f"hnsw {entry} ef={ef}")
            if recall < prev.get(entry, 0.0) - HNSW_RECALL_DROP:
                raise AssertionError(f"hnsw {entry}: recall@{HNSW_K} fell "
                                     f"from {prev[entry]:.4f} to {recall:.4f}"
                                     f" at ef={ef}")
            if ef == HNSW_RECALL_EF and recall < HNSW_MIN_RECALL:
                raise AssertionError(f"hnsw {entry}: recall@{HNSW_K} "
                                     f"{recall:.4f} < {HNSW_MIN_RECALL} at "
                                     f"ef={ef}")
            prev[entry] = recall
            steps = counters["beam_steps"].value / searches
            fn = (lambda: ix.select_batch(queries, p)) \
                if entry == "select_batch" else (lambda: ix.select(
                    queries[0], p))
            busy, idle, events = profile_launches(fn)
            row[entry] = (f"{entry}: recall@{HNSW_K} {recall:.4f}, host "
                          f"{host_ms:.3f} ms, device {busy:.4f} ms, idle "
                          f"share {idle:.4f}, {steps:.1f} beam steps, "
                          f"{events} device launches per search")
        log(f"[hnsw main] ef {ef} (beam width {max(16, 1 << (ef - 1).bit_length())}"
            f"): " + "; ".join(row.values()) + f" on {card}")
    log(f"[hnsw main] select_batch({len(queries)}) and {len(queries)} "
        f"selects at ef {HNSW_EFS}: ranks are the float64 inner products "
        f"(rtol 1e-4), recall@{HNSW_K} >= {HNSW_MIN_RECALL} at ef "
        f"{HNSW_RECALL_EF} and falls by no more than {HNSW_RECALL_DROP}")


def phase_hnsw_sq8(card: str, ix, base, queries):
    """SQ8 HNSW on the same graph (the build reads the fp32 rows with or
    without quantization, so the graph is loaded from the fp32 index).
    Returns the SQ8 index."""
    from reindexer_tpu_torch import HnswSearchParams
    from reindexer_tpu_torch.index.vector.hnsw import HnswIndex
    sq = HnswIndex(hnsw_def("vec", HNSW_D, HNSW_EFC, quant=True),
                   ix.keeper.device)
    sq.load_state_dict(ix.state_dict())
    p = HnswSearchParams(k=HNSW_K, ef=HNSW_RECALL_EF)
    t0 = time.perf_counter()
    res = [ids_ranks(r) for r in sq.select_batch(queries, p)]
    first_s = time.perf_counter() - t0
    if not sq._quant.active or sq._quant.codes.dtype != torch.uint8:
        raise AssertionError("the SQ8 store is not active")
    s64, top = hnsw_oracle(base, queries, sq.keeper.device)
    recall = check_hnsw(res, s64, top, "hnsw sq8")
    if recall < HNSW_SQ8_MIN_RECALL:
        raise AssertionError(f"hnsw sq8: recall@{HNSW_K} {recall:.4f} < "
                             f"{HNSW_SQ8_MIN_RECALL} at ef {HNSW_RECALL_EF}")
    busy, idle, events = profile_launches(lambda: sq.select_batch(queries, p))
    log(f"[hnsw sq8] {HNSW_N} x {HNSW_D} u8 codes ({sq._quant.codes.nbytes / 2 ** 20:.1f}"
        f" MiB): select_batch({len(queries)}) at ef {HNSW_RECALL_EF}: "
        f"recall@{HNSW_K} {recall:.4f}, ranks exact after the fp32 rescore; "
        f"first call (quantize) {first_s:.2f} s; device {busy:.4f} ms, idle "
        f"share {idle:.4f}, {events} device launches per search on {card}")
    return sq


def phase_hnsw_api(card: str, dev) -> None:
    """The HNSW public API at bench_hnsw's size: 20,000 x 96 IP filled by
    db.upsert, 1,000 deletes; selects, knn_batch(64), SQL KNN, a streaming
    query and its page, and an array field of 3 vectors a document."""
    from reindexer_tpu_torch import (HnswSearchParams, IndexDef, IndexOpts,
                                     Query, Reindexer)
    rng = np.random.default_rng(1)
    base = rng.normal(size=(HNSW_API_N, HNSW_API_D)).astype(np.float32)
    queries = rng.normal(size=(64, HNSW_API_D)).astype(np.float32)
    deleted = np.random.default_rng(SEED + 5).choice(
        HNSW_API_N, size=DELETES, replace=False)
    alive = np.ones(HNSW_API_N, dtype=bool)
    alive[deleted] = False
    t0 = time.perf_counter()
    db = Reindexer(device=dev)
    db.open_namespace("hnsw", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("grp", "hash", "int"),
        hnsw_def("vec", HNSW_API_D, HNSW_API_EFC)])
    rows = base.tolist()
    for i in range(HNSW_API_N):
        db.upsert("hnsw", {"id": i, "grp": i % 3, "vec": rows[i]})
    for i in deleted.tolist():
        db.delete("hnsw", {"id": i})
    t_up = time.perf_counter() - t0
    p = HnswSearchParams(k=HNSW_K, ef=HNSW_API_EF)

    def knn(qv, params=p):
        return Query("hnsw").where_knn("vec", qv, params)

    def docs(res):
        return [d["id"] for d in res.docs()], np.asarray(res.ranks())

    t0 = time.perf_counter()
    db.select(knn(queries[0]))              # commits: builds the graph
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [docs(db.select(knn(v))) for v in queries]
    qps = len(queries) / (time.perf_counter() - t0)
    batch = [docs(r) for r in db.knn_batch("hnsw", "vec", queries, p)]
    vec = ", ".join(repr(float(x)) for x in queries[1])
    sql = [docs(db.select(f"SELECT * FROM hnsw WHERE KNN(vec, [{vec}], "
                          f"k={HNSW_K}, ef={HNSW_API_EF})"))]
    s64, top = hnsw_oracle(base, queries, dev, alive)
    recall = {"select": check_hnsw(single, s64, top, "hnsw api select"),
              "knn_batch(64)": check_hnsw(batch, s64, top,
                                          "hnsw api knn_batch")}
    check_hnsw(sql, s64[1:2], top[1:2], "hnsw api SQL")
    if sql[0][0] != single[1][0]:
        raise AssertionError("the SQL KNN differs from the same select")
    for tag, r in recall.items():
        if r < HNSW_API_MIN_RECALL:
            raise AssertionError(f"hnsw api {tag}: recall@{HNSW_K} {r:.4f} "
                                 f"< {HNSW_API_MIN_RECALL}")
    # streaming: KNN with neither k nor radius, post-filtered by grp
    streamed = HnswSearchParams()
    q_s = queries[2]
    full = db.select(Query("hnsw").where("grp", "=", 1).where_knn(
        "vec", q_s, streamed).limit(20))
    page = db.select(Query("hnsw").where("grp", "=", 1).where_knn(
        "vec", q_s, streamed).offset(5).limit(5))
    ten = db.select(Query("hnsw").where("grp", "=", 1).where_knn(
        "vec", q_s, streamed).limit(10))
    ids10 = [d["id"] for d in ten.docs()]
    ranks10 = [it.rank for it in ten]
    s2 = s64[2].cpu().numpy()
    want = [i for i in np.argsort(-s2, kind="stable").tolist()
            if i % 3 == 1 and alive[i]][:10]
    if (len(ids10) != 10 or any(i % 3 != 1 or not alive[i] for i in ids10)
            or ranks10 != sorted(ranks10, reverse=True)
            or len(set(ids10) & set(want)) < 8):
        raise AssertionError(f"hnsw api streaming: {ids10} against the "
                             f"filtered oracle {want}")
    if [d["id"] for d in page.docs()] != [d["id"] for d in full.docs()][5:10]:
        raise AssertionError("hnsw api streaming: offset(5).limit(5) is not "
                             "the page of limit(20)")
    arr = phase_hnsw_array(dev)
    log(f"[hnsw api] set-up: {HNSW_API_N} upserts + {DELETES} deletes in "
        f"{t_up:.1f} s, first select (the build) {t_build:.2f} s; 64 selects "
        f"(recall@{HNSW_K} {recall['select']:.4f}, {qps:.1f} qps, host clock)"
        f", knn_batch(64) (recall@{HNSW_K} {recall['knn_batch(64)']:.4f}) "
        f"and SQL KNN at ef {HNSW_API_EF}: ranks the float64 inner products, "
        f"no deleted row; streaming where(grp = 1).limit(10): "
        f"{len(set(ids10) & set(want))}/10 of the filtered oracle, its "
        f"offset(5).limit(5) page equal to limit(20)[5:10]; {arr}")
    for tag, fn in (("knn_batch(64)", lambda: db.knn_batch(
            "hnsw", "vec", queries, p)),
            ("select", lambda: db.select(knn(queries[0])))):
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        busy, idle, events = profile_launches(fn)
        log(f"[hnsw api] {tag} ef {HNSW_API_EF}: host "
            f"{1e3 * statistics.median(secs):.3f} ms, device {busy:.4f} ms, "
            f"idle share {idle:.4f}, {events} device launches per call on "
            f"{card}")


def phase_hnsw_array(dev) -> str:
    """An array HNSW field, 3 vectors a document: each document comes back
    once, ranked by its best vector. Returns the summary."""
    from reindexer_tpu_torch import (HnswSearchParams, IndexDef, IndexOpts,
                                     Query, Reindexer)
    rng = np.random.default_rng(SEED + 6)
    vecs = rng.normal(size=(HNSW_ARRAY_DOCS, HNSW_ARRAY_VECS,
                            HNSW_API_D)).astype(np.float32)
    queries = rng.normal(size=(16, HNSW_API_D)).astype(np.float32)
    db = Reindexer(device=dev)
    db.open_namespace("harr", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        hnsw_def("vec", HNSW_API_D, HNSW_API_EFC, is_array=True)])
    for i in range(HNSW_ARRAY_DOCS):
        db.upsert("harr", {"id": i, "vec": vecs[i].tolist()})
    best = np.einsum("nvd,qd->qnv", vecs.astype(np.float64),
                     queries.astype(np.float64)).max(axis=2)
    hits = 0
    for qi, q in enumerate(queries):
        res = db.select(Query("harr").where_knn("vec", q, HnswSearchParams(
            k=HNSW_K, ef=HNSW_API_EF)))
        ids = [d["id"] for d in res.docs()]
        if len(ids) != len(set(ids)) or not ids:
            raise AssertionError(f"hnsw array: query {qi} returned {ids}")
        if not np.allclose(res.ranks(), best[qi, ids], rtol=RANK_RTOL,
                           atol=1e-6):
            raise AssertionError(f"hnsw array: query {qi}: a document's rank "
                                 "is not its best vector's")
        hits += len(set(ids) & set(np.argsort(-best[qi])[:HNSW_K].tolist()))
    recall = hits / (HNSW_K * len(queries))
    if recall < HNSW_API_MIN_RECALL:
        raise AssertionError(f"hnsw array: document recall@{HNSW_K} "
                             f"{recall:.4f} < {HNSW_API_MIN_RECALL}")
    return (f"array field ({HNSW_ARRAY_DOCS} documents x {HNSW_ARRAY_VECS} "
            f"vectors): each document once, ranked by its best vector, "
            f"document recall@{HNSW_K} {recall:.4f}")


def k7(q, pack, links, entries, metric):
    """K7 on the card at ef HNSW_K7_EF, expand 2: (w_s, w_ids, c_s, c_ids,
    visited, it)."""
    from reindexer_tpu_torch.ops import hnsw_kernels as pk
    ef = HNSW_K7_EF
    return pk.hnsw_beam("layer", q, pack, links, (entries,), ef, 2, 2 * ef,
                        metric)


def k7_twin(q, pack, links, entries, metric):
    """K7's plain twin (_beam_plain, eager) on the same inputs: the same
    six tensors."""
    from reindexer_tpu_torch.ops import hnsw_kernels as pk
    ef = HNSW_K7_EF
    return pk._beam_plain("layer", q, pack, links, (entries,), ef, 2, 2 * ef,
                          metric)


def k7_and_twin(q, pack, links, entries, metric):
    got = k7(q, pack, links, entries, metric)
    want = k7_twin(q, pack, links, entries, metric)
    torch.cuda.synchronize()
    return got, want


def k7_exact(dev) -> str:
    """K7 bit for bit against its twin at the main path's shape (200,000 x
    96, 64 queries, 32 links a row, ef 128) on rows of small integers
    (fp32: -3..3; SQ8: codes 0..7, offsets -2..2, scales 1..2), so that
    every fp32 sum is exact in any order: W, C, the visited words and `it`
    equal. 5% of the rows have no links (deleted rows), -1 slots
    elsewhere, every third query zero (a padded batch)."""
    from reindexer_tpu_torch import VectorMetric
    from reindexer_tpu_torch.ops.hnsw_kernels import DataPack
    rng = np.random.default_rng(SEED + 20)
    n, d, m0 = HNSW_N, HNSW_D, 2 * HNSW_M
    links = rng.integers(-1, n, size=(n, m0)).astype(np.int32)
    links[rng.random(n) < 0.05] = -1
    q = rng.integers(-3, 4, size=(HNSW_Q, d)).astype(np.float32)
    q[::3] = 0
    ents = rng.integers(0, n, size=(HNSW_Q, 1)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    stack = rng.integers(-1, n, size=(4, n, HNSW_M)).astype(np.int32)
    stack[0] = -1
    stack[:, rng.random(n) < 0.05] = -1
    out = []
    for quant in (False, True):
        if quant:
            codes = rng.integers(0, 8, size=(n, d)).astype(np.uint8)
            lo = rng.integers(-2, 3, size=d).astype(np.float32)
            alpha = rng.integers(1, 3, size=d).astype(np.float32)
            deq = lo + alpha * codes.astype(np.float32)
            pack = DataPack(t(codes), t((deq * deq).sum(axis=1)), t(lo),
                            t(alpha))
        else:
            data = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
            pack = DataPack(t(data), t((data * data).sum(axis=1)))
        for metric in (VectorMetric.INNER_PRODUCT, VectorMetric.L2):
            got, want = k7_and_twin(t(q), pack, t(links), t(ents), metric)
            for name, a, b in zip(("w_s", "w_ids", "c_s", "c_ids", "visited",
                                   "it"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"[hnsw kernel] K7 differs from its twin in {name} "
                        f"on integer rows ({'SQ8' if quant else 'fp32'}, "
                        f"{metric.name})")
            moved = descend_exact(t(q), pack, t(stack), t(ents[:, 0]), metric)
            out.append(f"{'SQ8' if quant else 'fp32'} {metric.name} "
                       f"{int(got[5])} steps, descent {moved} of {HNSW_Q} "
                       "queries moved")
        del pack
    return ", ".join(out)


def descend_exact(q, pack, stack, ents, metric) -> int:
    """The descent kernel against its plain twin on the CPU, bit for bit
    (integer rows: exact sums, many ties); returns the queries that
    moved."""
    from reindexer_tpu_torch.ops import hnsw_kernels as pk
    got = pk.hnsw_descend(q, pack, stack, ents, 64, metric).cpu()
    cpu = pk.DataPack(*(None if x is None else x.cpu() for x in (
        pack.data, pack.data_sq, pack.lo, pack.alpha)))
    want = pk._descend_plain(q.cpu(), cpu, stack.cpu(), ents.cpu(), 64,
                             metric)
    if not torch.equal(got, want):
        raise AssertionError(
            f"[hnsw kernel] the descent differs from its twin in "
            f"{int((got != want).sum())} of {len(got)} entries on integer "
            f"rows ({'SQ8' if pack.quantized else 'fp32'}, {metric.name})")
    return int((got != ents.cpu()).sum())


def descend_real(tag: str, ix, queries, metric) -> tuple[dict, str]:
    """The descent kernel on the index's own upper layers against its
    plain twin on the card: entries equal for all but K7_SPLIT_MAX queries
    (fp32 sums in another order); then its device ms (and CUDA-event ms,
    launch included), the twin's, and its bound: the link rows and rows
    its hops read, over 3.35 TB/s. Returns (stats, summary)."""
    from reindexer_tpu_torch.ops import hnsw_kernels as pk
    dev = ix.keeper.device
    q = torch.from_numpy(np.stack([ix.keeper.prepare_query(v)
                                   for v in queries])).to(dev)
    pack = ix._pack(for_search=True)
    stack = ix._d_upper
    ents = torch.full((len(queries),), ix._entry, dtype=torch.int32,
                      device=dev)
    got = pk.hnsw_descend(q, pack, stack, ents, 64, metric)
    want = pk._descend_plain(q, pack, stack, ents, 64, metric)
    split = int((got != want).sum())
    if split > K7_SPLIT_MAX:
        raise AssertionError(f"[hnsw kernel] {tag}: the descent differs from"
                             f" its twin in {split} of {len(queries)} entries")
    # every query's hops: each that moved it and the one that ended a layer
    cur, cur_s = ents, pk._entry_scores(q, pack, ents, metric)
    hops = 0
    for links in stack:
        live = torch.ones_like(cur, dtype=torch.bool)
        for _ in range(64):
            cur, cur_s, imp = pk._descend_hop(q, pack, links, cur, cur_s,
                                              metric)
            hops += int(live.sum())
            live &= imp
            if not live.any():
                break
    m = stack.shape[2]
    # a hop reads a link row and its rows (inner product: no |v|^2)
    n_bytes = hops * m * (4 + HNSW_D * (1 if pack.quantized else 4))
    least = bound(n_bytes, 2.0 * hops * m * HNSW_D, "fp32")
    fn = lambda: pk.hnsw_descend(q, pack, stack, ents, 64, metric)
    ms = device_ms(fn, n=20)
    event_ms = cuda_time_ms(fn)
    plain_ms = device_ms(lambda: pk._descend_plain(q, pack, stack, ents, 64,
                                                   metric), n=2)
    stats = {"ms": ms, "event_ms": event_ms, "plain_ms": plain_ms, **least}
    return stats, (
        f"{tag} descent: {stack.shape[0]} upper layers of {m} links, {hops} "
        f"hops in all ({hops / len(queries):.2f} a query), {len(queries) - split}"
        f"/{len(queries)} entries the twin's; kernel {ms:.4f} ms device, "
        f"{event_ms:.4f} ms by CUDA events (launch included), the eager "
        f"twin {plain_ms:.4f} ms device, bound {least['bound_ms']:.6f} ms by "
        f"{least['bound_by']} ({least['bound_ms'] / ms:.2%})")


def k7_real(tag: str, ix, queries, metric) -> tuple[dict, str]:
    """K7 against its twin on the index's own graph and rows: `it` equal;
    per query the visited words equal (the same path) for all but
    K7_SPLIT_MAX queries, and on every query that kept the path W's and
    C's ids equal up to near-ties and their scores within K7_SCORE_ATOL.
    Then the device ms of K7 and of the twin, and K7's bound: the rows it
    scored (the visited bits), two link rows and 2 x M0 visited words a
    query and step, over 3.35 TB/s. Returns (stats, summary)."""
    from reindexer_tpu_torch.ops import hnsw_kernels as pk
    dev = ix.keeper.device
    q = torch.from_numpy(np.stack([ix.keeper.prepare_query(v)
                                   for v in queries])).to(dev)
    pack = ix._pack(for_search=True)
    ents = torch.full((len(queries),), ix._entry, dtype=torch.int32,
                      device=dev)
    if ix._max_level > 0:
        ents = pk.greedy_descend(q, pack, ix._d_upper, ents, metric)
    ents = ents[:, None]
    links = ix._d_links0
    got, want = k7_and_twin(q, pack, links, ents, metric)
    if int(got[5]) != int(want[5]):
        raise AssertionError(f"[hnsw kernel] {tag}: K7 ran {int(got[5])} "
                             f"steps, its twin {int(want[5])}")
    same_path = (got[4] == want[4]).all(dim=1).cpu().numpy()
    if (~same_path).sum() > K7_SPLIT_MAX:
        raise AssertionError(f"[hnsw kernel] {tag}: {(~same_path).sum()} of "
                             f"{len(queries)} queries visited other rows")
    err = 0.0
    for s_i, i_i in ((0, 1), (2, 3)):
        gs, gi = got[s_i].cpu().numpy(), got[i_i].cpu().numpy()
        ws, wi = want[s_i].cpu().numpy(), want[i_i].cpu().numpy()
        for r in np.flatnonzero(same_path):
            fin = np.isfinite(ws[r])
            if not np.array_equal(np.isfinite(gs[r]), fin):
                raise AssertionError(f"[hnsw kernel] {tag}: query {r} "
                                     "holds another count of rows")
            score = dict(zip(wi[r].tolist(), ws[r].tolist()))
            score |= dict(zip(gi[r].tolist(), gs[r].tolist()))
            kth = float(ws[r][fin][-1]) if fin.any() else 0.0
            if tie_violations(gi[r][fin].tolist(), wi[r][fin].tolist(),
                              lambda i: score[i], kth, TIE_RTOL):
                raise AssertionError(f"[hnsw kernel] {tag}: query {r}'s "
                                     "ids differ beyond near-ties")
            both = fin & (gi[r] == wi[r])
            if both.any():
                err = max(err, float(np.abs(gs[r][both] - ws[r][both]).max()))
    if err > K7_SCORE_ATOL:
        raise AssertionError(f"[hnsw kernel] {tag}: scores differ by {err:.3g}"
                             f" > {K7_SCORE_ATOL}")
    steps = int(got[5])
    rows = int(np.unpackbits(got[4].cpu().numpy().view(np.uint8)).sum())
    code_bytes = 1 if pack.quantized else 4
    m0 = links.shape[1]
    n_bytes = (rows * HNSW_D * code_bytes
               + len(queries) * steps * (2 * m0 * 4 + 2 * m0 * 4))
    least = bound(n_bytes, 2.0 * rows * HNSW_D, "fp32")
    ms = device_ms(lambda: k7(q, pack, links, ents, metric), n=10)
    plain_ms = device_ms(lambda: k7_twin(q, pack, links, ents, metric), n=2)
    stats = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "library_ms": None, **least}
    return stats, (
        f"{tag}: {steps} steps, {int(same_path.sum())}/{len(queries)} "
        f"queries on the twin's path, max score err {err:.3g}; {rows} rows "
        f"scored ({n_bytes / 1e6:.1f} MB with links and visited words); K7 "
        f"{ms:.4f} ms ({1e3 * ms / steps:.2f} us a step), the eager twin "
        f"{plain_ms:.2f} ms, bound {least['bound_ms']:.4f} ms by "
        f"{least['bound_by']} ({least['bound_ms'] / ms:.1%})")


def phase_hnsw_kernel(card: str, ix, sq, queries) -> dict:
    """K7 hnsw_beam against its plain twin on the card: bit for bit on
    integer rows at the main path's shape, then on the deep-like graph,
    fp32 and SQ8, with times. Returns K7's stats (fp32, the main path)."""
    exact = k7_exact(ix.keeper.device)
    log(f"[hnsw kernel] K7 = its twin bit for bit on {HNSW_N} x {HNSW_D} "
        f"integer rows, {HNSW_Q} queries, ef {HNSW_K7_EF}: {exact}")
    stats = None
    for tag, index in (("fp32", ix), ("SQ8", sq)):
        st, summary = k7_real(tag, index, queries, index.metric)
        log(f"[hnsw kernel] {HNSW_N} x {HNSW_D} graph, {HNSW_Q} queries, ef "
            f"{HNSW_K7_EF}, {summary} on {card}")
        stats = stats or st
        _, summary = descend_real(tag, index, queries, index.metric)
        log(f"[hnsw kernel] {HNSW_N} x {HNSW_D} graph, {HNSW_Q} queries, "
            f"{summary} on {card}")
    return stats


def phase_hnsw(card: str, dev) -> tuple[dict, int]:
    """The HNSW phases; returns (K7's stats, its launches from the main
    path's run on)."""
    from reindexer_tpu_torch.ops import hnsw_kernels
    ix, base, queries = phase_hnsw_setup(dev)
    phase_hnsw_cpu_agree(ix, queries)
    hnsw_kernels.hnsw_beam_launches.reset()
    phase_hnsw_main(card, ix, base, queries)
    sq = phase_hnsw_sq8(card, ix, base, queries)
    launches = hnsw_kernels.hnsw_beam_launches.value
    stats = phase_hnsw_kernel(card, ix, sq, queries)
    del ix, sq
    torch.cuda.empty_cache()
    hnsw_kernels.hnsw_beam_launches.reset()
    phase_hnsw_api(card, dev)
    launches += hnsw_kernels.hnsw_beam_launches.value
    if not launches:
        raise AssertionError("the HNSW phases launched no K7")
    return stats, launches


# --- full text (BASELINE config #4's shape) and hybrid (config #5) --------

FT_DOCS, FT_VOCAB, FT_WORDS, FT_SEED = 1_000_000, 100_000, 30, 4  # bench_ft1m
FT_TOP = 20
# ranks 0-255: fp32 rounding of the host merge's factorized A + idf * B
# against the direct formula; the largest difference of a device route
# from the host merge at 1M docs reads 6.1e-5 (4 ulps at 255) on an H100
FT_RANK_ATOL = 1e-4
FT_ROUTE_LOG2 = range(14, 22)   # 2-term gathers of ~2^14 .. ~2^21 postings
FT_ROUTE_BATCHES = (1, 8, 36)
HYB_DOCS, HYB_D, HYB_SEED = 100_000, 128, 13                   # bench_hybrid


def ft_counters() -> dict:
    from reindexer_tpu_torch.ft import selector
    return {k: getattr(selector, k) for k in (
        "host_merges", "sorted_scores", "dense_scores", "fielded_scores",
        "dense_overflows", "native_fallbacks")}


def counts_str(counters: dict) -> str:
    return ", ".join(f"{k} {c.value}" for k, c in counters.items())


@contextlib.contextmanager
def ft_route(route: str | None):
    """Pins the selector to one route: "host" (the C++ merge for every
    gather), "sorted" (the device sorted path), "dense" (the dense route for
    every resident query), "runs" / "hostdense" (the host's heap or dense
    merge); None leaves the fitted constants."""
    from reindexer_tpu_torch.ft import device_dense as dd
    from reindexer_tpu_torch.ft.selector import FtSelector
    saved = (dd.DEVICE_MIN, dd.DEVICE_MIN_SINGLE,
             FtSelector.HOST_SCORE_MAX, FtSelector.DENSE_MIN)
    try:
        if route in ("host", "runs", "hostdense", "sorted"):
            dd.DEVICE_MIN = dd.DEVICE_MIN_SINGLE = 1 << 40
            FtSelector.HOST_SCORE_MAX = -1 if route == "sorted" else 1 << 40
            if route == "runs":
                FtSelector.DENSE_MIN = 1 << 40
            elif route == "hostdense":
                FtSelector.DENSE_MIN = 0
        elif route == "dense":
            dd.DEVICE_MIN = dd.DEVICE_MIN_SINGLE = 1
        yield
    finally:
        (dd.DEVICE_MIN, dd.DEVICE_MIN_SINGLE,
         FtSelector.HOST_SCORE_MAX, FtSelector.DENSE_MIN) = saved


def ft_host_answers(sel, qs: list) -> list:
    """The host merge's answers to qs, each counted as a host merge: a
    reference answered elsewhere (a C++ lane that did not build) fails."""
    counters = ft_counters()
    for c in counters.values():
        c.reset()
    with ft_route("host"):
        want = [sel.process(q) for q in qs]
    if counters["host_merges"].value != len(qs) or any(
            c.value for k, c in counters.items() if k != "host_merges"):
        raise AssertionError(f"ft reference: {len(qs)} queries, "
                             f"{counts_str(counters)}")
    return want


def ft_agree(want, got, tag: str) -> float:
    """Two FtSelectResults of one query: as many results, ranks within
    FT_RANK_ATOL position by position, ids equal except near-ties at the
    cut (compared as sets). Returns the largest rank difference."""
    if len(got.ids) != len(want.ids):
        raise AssertionError(f"{tag}: {len(got.ids)} results, want "
                             f"{len(want.ids)}")
    if not len(want.ids):
        return 0.0
    if not np.allclose(got.ranks, want.ranks, rtol=0, atol=FT_RANK_ATOL):
        bad = int(np.argmax(np.abs(got.ranks - want.ranks)))
        raise AssertionError(f"{tag}: rank {bad} is {got.ranks[bad]}, want "
                             f"{want.ranks[bad]}")
    kth = float(want.ranks[-1])
    score = dict(zip(want.ids.tolist(), want.ranks.tolist()))
    score.update(zip(got.ids.tolist(), got.ranks.tolist()))
    off = [i for i in set(want.ids.tolist()) ^ set(got.ids.tolist())
           if abs(score[i] - kth) > FT_RANK_ATOL]
    if off:
        raise AssertionError(f"{tag}: ids {off[:5]} differ away from the cut")
    return float(np.max(np.abs(got.ranks - want.ranks)))


def median_ms(fn, reps: int = 5) -> float:
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(secs)


def ft_device(fn, n: int = 3) -> str:
    """Device ms and idle share of fn under torch.profiler, or the note that
    its trace held no device event (a host route launches nothing)."""
    per, wall_ms = profile_device(fn, n, host=True)
    if not per:
        return "device 0 (no device event in the trace)"
    busy = sum(per.values())
    return f"device {busy:.4f} ms, idle share {1.0 - busy * n / wall_ms:.4f}"


def phase_ft_setup(card: str, dev):
    """BASELINE config #4's shape on bench_ft1m's corpus: the build, the
    device mirrors, the commit-time warm."""
    from reindexer_tpu_torch.ft import dataholder
    from reindexer_tpu_torch.ft.config import FtFastConfig
    from reindexer_tpu_torch.ft.dataholder import FtDataHolder
    from reindexer_tpu_torch.ft.selector import FtSelector
    # the build's tokenizer, the typo dictionary and the host merge are C++
    # lanes: a lane that fails to build would quietly take a slower route
    for lane in (dataholder._native_module, dataholder._typos_native_module):
        if lane() is None:
            raise AssertionError(f"ft: {lane.__name__} did not build")
    t0 = time.perf_counter()
    rng = np.random.default_rng(FT_SEED)
    vocab = np.array([f"w{i}" for i in range(FT_VOCAB)], dtype=object)
    zipf = np.minimum(rng.zipf(1.3, size=(FT_DOCS, FT_WORDS)) - 1,
                      FT_VOCAB - 1)
    docs = [(i, [" ".join(vocab[row])]) for i, row in enumerate(zipf)]
    t_data = time.perf_counter() - t0
    cfg = FtFastConfig()
    holder = FtDataHolder(cfg, ["text"], dev)
    t0 = time.perf_counter()
    holder.build(docs, FT_DOCS)
    t_build = time.perf_counter() - t0
    del docs
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mirrors = holder.device_arrays()
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    sel = FtSelector(holder, cfg)
    t0 = time.perf_counter()
    warmed = sel.warm_frequent_singles(cfg.warmup_frequent_words)
    t_warm = time.perf_counter() - t0
    dd = sel._device_dense()
    t0 = time.perf_counter()
    resident = dd.ensure_built()
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    mib = sum(t.nbytes for k, t in mirrors.items() if k != "cap") / 2 ** 20
    dense_mib = (dd.S.nbytes + dd.M.nbytes) / 2 ** 20 if resident else 0.0
    log(f"[ft setup] {FT_DOCS} docs x {FT_WORDS} zipf(1.3) words over "
        f"{FT_VOCAB} (bench_ft1m, seed {FT_SEED}; BASELINE config #4's shape, "
        f"its corpus not in the repository): data {t_data:.1f} s (host), "
        f"build {t_build:.2f} s, {holder.num_postings} postings, "
        f"{len(holder.words)} words; device mirrors {mib:.1f} MiB (cap "
        f"{mirrors['cap']}, postings padded to {mirrors['post_doc'].shape[0]}"
        f") uploaded in {t_up:.2f} s; dense head {len(dd.wid2slot)} words, "
        f"{dense_mib:.1f} MiB, built in {t_dense:.2f} s; commit-time warm "
        f"{warmed} words in {t_warm:.2f} s; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"on {card}")
    return sel, rng


def phase_ft_cases(card: str, sel, rng) -> None:
    """bench_ft1m's four cases at the fitted routes: 8 single-term queries,
    32 rare 2-term queries, 4 frequent 2-term queries, one process_batch of
    the 36; each answer held against the host merge's, with host ms, device
    ms and idle share and the routes taken."""
    counters = ft_counters()
    singles = [f"w{i}" for i in range(8)]
    rare = [f"w{rng.integers(5_000, 50_000)} w{rng.integers(5_000, 50_000)}"
            for _ in range(32)]
    freq = [f"w{rng.integers(0, 5)} w{rng.integers(5, 20)}"
            for _ in range(4)]
    mixed = rare + freq
    want = dict(zip(singles + mixed, ft_host_answers(sel, singles + mixed)))
    cases = (("single-term x8", singles, False),
             ("rare 2-term x32", rare, False),
             ("frequent 2-term x4", freq, False),
             ("process_batch(36)", mixed, True))
    for tag, qs, batch in cases:
        if batch:
            def run():
                return sel.process_batch(qs)
        else:
            def run():
                return [sel.process(q) for q in qs]
        run()                                   # warm shapes and caches
        for c in counters.values():
            c.reset()
        got = run()
        routes = counts_str(counters)
        if counters["native_fallbacks"].value:
            raise AssertionError(f"ft {tag}: {routes}")
        diff = max(ft_agree(want[q], g, f"ft {tag} {q!r}")
                   for q, g in zip(qs, got))
        ms = median_ms(run, 3) / len(qs)
        log(f"[ft cases] {tag}: host {ms:.3f} ms a query (host clock), "
            f"{ft_device(run)}; routes: {routes}; answers equal the host "
            f"merge's (largest rank difference {diff:.3g}, limit "
            f"{FT_RANK_ATOL}); {card}")


def phase_ft_check_routes(card: str, sel, dev) -> None:
    """Every device route against the host merge on the same queries, and
    the overflow fallback counted."""
    from reindexer_tpu_torch.ft.config import FtFastConfig
    from reindexer_tpu_torch.ft.dataholder import FtDataHolder
    from reindexer_tpu_torch.ft.selector import FtSelector
    counters = ft_counters()
    qs = ["w0 w1", "w0 w7", "w3 w12", "w20 w40", "+w1 +w9", "w2 -w5",
          "w4 w6 w8", '"w0 w1"']
    want = ft_host_answers(sel, qs)
    for route, batch, counter in (("sorted", False, "sorted_scores"),
                                  ("sorted", True, "sorted_scores"),
                                  ("dense", False, "dense_scores"),
                                  ("dense", True, "dense_scores")):
        for c in counters.values():
            c.reset()
        with ft_route(route):
            got = (sel.process_batch(qs) if batch
                   else [sel.process(q) for q in qs])
        tag = f"{route}{' batch' if batch else ''}"
        diff = max(ft_agree(w, g, f"ft route {tag} {q!r}")
                   for q, w, g in zip(qs, want, got))
        if counters[counter].value != len(qs):
            raise AssertionError(f"ft route {tag} did not answer all "
                                 f"{len(qs)}: {counts_str(counters)}")
        log(f"[ft check] {tag}: {len(qs)} queries equal the host merge's "
            f"(ids, near-ties at the cut as sets; largest rank difference "
            f"{diff:.3g}, limit {FT_RANK_ATOL}); {counts_str(counters)}")
    # every candidate tied and merge_limit 8: the prune cannot certify the
    # cut, the query re-runs on the host, counted
    cfg = FtFastConfig()
    cfg.merge_limit = 8
    h = FtDataHolder(cfg, ["text"], dev)
    h.build([(i, ["w0 w1 w0"]) for i in range(4096)], 4096)
    tied = FtSelector(h, cfg)
    for c in counters.values():
        c.reset()
    with ft_route("dense"):
        from reindexer_tpu_torch.ft import device_dense as dd
        saved, dd.DENSE_MIN_COUNT = dd.DENSE_MIN_COUNT, 1
        try:
            ids = tied.process("w0 w1").ids.tolist()
        finally:
            dd.DENSE_MIN_COUNT = saved
    if ids != list(range(8)) or counters["dense_overflows"].value != 1:
        raise AssertionError(f"ft overflow: {ids}, {counts_str(counters)}")
    log(f"[ft check] overflow: 4,096 tied docs, merge_limit 8: the dense "
        f"prune flagged the query, the host merge answered docs 0-7; "
        f"{counts_str(counters)}")


def phase_ft_routes(card: str, sel) -> list:
    """The `[ft routes]` table: 2-term queries of two words of about equal
    frequency, their gathers G from ~2^14 to ~2^21 postings; per row the
    host merge, the device sorted path and the dense route at batch 1, 8
    and 36 (ms a query, host clock), and the host's heap and dense merges.
    Returns the rows (a table of tests/test_torch_ft.py ROUTE_TABLES)."""
    from reindexer_tpu_torch.ft.dsl import parse_ft_dsl
    counters = ft_counters()
    h = sel.holder
    counts = np.diff(h.word_start)
    order = np.argsort(-counts, kind="stable")
    rows = []
    log(f"[ft routes] G, host ms, sorted ms, dense ms at batch "
        f"{'/'.join(map(str, FT_ROUTE_BATCHES))} (a query's share), host "
        f"heap ms, host dense ms (None: the route does not take it); "
        f"{card}")
    for k in FT_ROUTE_LOG2:
        i = int(np.argmin(np.abs(counts[order] - (1 << (k - 1)))))
        i = min(i, len(order) - 2)
        q = f"{h.word_of(int(order[i]))} {h.word_of(int(order[i + 1]))}"
        G = sel._prepare(parse_ft_dsl(q))["G"]
        row = [G]
        for route in ("host", "sorted"):
            with ft_route(route):
                row.append(median_ms(lambda: sel.process(q)))
        dense, notes = [], []
        with ft_route("dense"):
            for b in FT_ROUTE_BATCHES:
                for c in counters.values():
                    c.reset()
                if b == 1:
                    ms = median_ms(lambda: sel.process(q), 3)
                else:
                    ms = median_ms(lambda: sel.process_batch([q] * b), 3) / b
                took = counters["dense_scores"].value
                ovf = counters["dense_overflows"].value
                dense.append(ms if took and not ovf else None)
                if ovf or not took:
                    notes.append(f"b{b}: {'overflow' if ovf else 'not resident'}")
        row += dense
        for route in ("runs", "hostdense"):
            applies = route == "runs" or G >= h.total_docs // 4
            with ft_route(route):
                row.append(median_ms(lambda: sel.process(q), 3)
                           if applies else None)
        with ft_route("sorted"):
            prof = f"sorted {ft_device(lambda: sel.process(q))}"
        if dense[0] is not None:
            with ft_route("dense"):
                prof += f"; dense {ft_device(lambda: sel.process(q))}"
        rows.append(tuple(round(x, 4) if isinstance(x, float) else x
                          for x in row))
        log(f"[ft routes] {q!r}: {rows[-1]}; {prof}"
            f"{'; ' + ', '.join(notes) if notes else ''}")
    log(f"[ft routes] ROUTE_TABLE = {rows}")
    return rows


def phase_ft(card: str, dev) -> None:
    sel, rng = phase_ft_setup(card, dev)
    phase_ft_cases(card, sel, rng)
    phase_ft_check_routes(card, sel, dev)
    phase_ft_routes(card, sel)
    del sel
    torch.cuda.empty_cache()


def hybrid_db(dev, mesh=None):
    """bench_hybrid's namespace: 100,000 docs, grp, a text index over 8
    zipf(1.3) words of 5,000, a 128-dim L2 vec_bf field; seed 13; on a
    mesh (parallel.context.MeshContext) of dev's type when one is given."""
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     IndexType, Reindexer, VectorMetric)
    rng = np.random.default_rng(HYB_SEED)
    db = Reindexer(device=dev, mesh=mesh)
    db.open_namespace("h", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("grp", "hash", "int"),
        IndexDef("ft", "text", "string", json_paths=("title",)),
        IndexDef("vec", IndexType.VEC_BF, vector_opts=FloatVectorOpts(
            dims=HYB_D, metric=VectorMetric.L2))])
    vocab = [f"w{i}" for i in range(5000)]
    zipf = np.minimum(rng.zipf(1.3, size=(HYB_DOCS, 8)) - 1, len(vocab) - 1)
    base = rng.normal(size=(HYB_DOCS, HYB_D)).astype(np.float32)
    rows = base.tolist()
    tx = db.new_transaction("h")
    for i in range(HYB_DOCS):
        tx.upsert({"id": i, "grp": i % 10,
                   "title": " ".join(vocab[j] for j in zipf[i]),
                   "vec": rows[i]})
    tx.commit()
    return db, rng.normal(size=(HYB_D,)).astype(np.float32)


def phase_hybrid(card: str, dev):
    """BASELINE config #5 as bench_hybrid builds it, on the card and on the
    CPU: the RRF query and a linear rerank, the full-text public API on the
    same namespace. Returns K1's and K2's launches over the card's run, the
    card's database (the leader of [replication], the data of [sharding])
    and the CPU's (the one-device answers of [mesh]'s hybrid check)."""
    from reindexer_tpu_torch import BruteForceSearchParams, Query
    from reindexer_tpu_torch.ops import scan, select
    t0 = time.perf_counter()
    gpu, qv = hybrid_db(dev)
    cpu, _ = hybrid_db(torch.device("cpu"))
    t_setup = time.perf_counter() - t0

    def hyb(sort):
        return (Query("h").where("grp", "<", 5).match("ft", "w3 w7")
                .where_knn("vec", qv, BruteForceSearchParams(k=100))
                .sort(sort, desc=True).limit(FT_TOP))

    def answer(db, q):
        res = db.select(q)
        return [d["id"] for d in res.docs()], np.asarray(res.ranks())

    sorts = {"RRF": "RRF()", "linear": "10 * rank(ft) + 2 * rank(vec, 50.0)"}
    t0 = time.perf_counter()
    gpu.select(hyb(sorts["RRF"]))           # commits: the FT build, the flush
    t_first = time.perf_counter() - t0
    counters = (scan.launches, select.launches)
    for c in counters:
        c.reset()
    got = {tag: answer(gpu, hyb(s)) for tag, s in sorts.items()}
    launches = {"bf_scan": scan.launches.value,
                "bf_select": select.launches.value}
    for tag, s in sorts.items():
        ids, ranks = answer(cpu, hyb(s))
        if not ids or got[tag][0] != ids or not np.allclose(
                got[tag][1], ranks, rtol=1e-5, atol=0):
            raise AssertionError(f"hybrid {tag}: the card's {got[tag]} "
                                 f"differs from the CPU's {(ids, ranks)}")
    if not all(launches.values()):
        raise AssertionError(f"the hybrid path did not launch K1 and K2: "
                             f"{launches}")
    log(f"[hybrid] {HYB_DOCS} docs x {HYB_D} L2 + text (bench_hybrid, seed "
        f"{HYB_SEED}, BASELINE config #5): set-up of the card's and the CPU's "
        f"namespaces {t_setup:.1f} s, first select (FT build, flush) "
        f"{t_first:.2f} s; grp < 5, match 'w3 w7', KNN k=100, top {FT_TOP}: "
        f"RRF and linear rerank equal the port on the CPU (ids; ranks rtol "
        f"1e-5); K1 {launches['bf_scan']}, K2 {launches['bf_select']} "
        f"launches over the two selects")
    for tag, s in sorts.items():
        q = hyb(s)
        log(f"[hybrid] {tag}: host {median_ms(lambda: gpu.select(q), 7):.3f} "
            f"ms a select (host clock), {ft_device(lambda: gpu.select(q), 5)}"
            f" on {card}")
    phase_ft_api(gpu)
    return launches, gpu, cpu


def phase_ft_api(db) -> None:
    """The full-text public API on the hybrid namespace: Query.match, SQL,
    ft_batch and highlight / snippet give the selector's answer."""
    from reindexer_tpu_torch import Query
    idx = db.get_namespace("h").get_index("ft")
    qs = ["w3 w7", "+w1 -w2", "w10* w20", '"w0 w1"']
    for dsl in qs:
        want = idx._selector.process(dsl)
        res = db.select(Query("h").match("ft", dsl).limit(FT_TOP))
        ids = [d["id"] for d in res.docs()]
        if ids != want.ids[:FT_TOP].tolist() or not np.allclose(
                res.ranks(), want.ranks[:FT_TOP], rtol=0, atol=1e-4):
            raise AssertionError(f"ft api match {dsl!r}: {ids}")
        sql = db.select(f"SELECT * FROM h WHERE ft = '{dsl}' LIMIT {FT_TOP}")
        if [d["id"] for d in sql.docs()] != ids:
            raise AssertionError(f"ft api SQL {dsl!r} differs from match")
    batch = db.ft_batch("h", "ft", qs)
    for dsl, res in zip(qs, batch):
        if [d["id"] for d in res.docs()][:FT_TOP] != \
                idx._selector.process(dsl).ids[:FT_TOP].tolist():
            raise AssertionError(f"ft api ft_batch {dsl!r} differs")
    hl = db.select(Query("h").match("ft", "w3").limit(5).functions(
        "title = highlight(<b>,</b>)"))
    sn = db.select(Query("h").match("ft", "w7").limit(5).functions(
        "title = snippet(<b>,</b>,2,2)"))
    if not all("<b>w3</b>" in d["title"] for d in hl.docs()) or not all(
            "<b>w7</b>" in d["title"] for d in sn.docs()):
        raise AssertionError("ft api highlight / snippet")
    stored = db.select(Query("h").where("id", "=", hl.docs()[0]["id"]))
    if "<b>" in stored.docs()[0]["title"]:
        raise AssertionError("ft api: highlight changed the stored document")
    log(f"[ft api] Query.match, SQL WHERE ft = '...', ft_batch of {len(qs)} "
        "and highlight / snippet give the selector's answers; the stored "
        "documents stay as they were")



# --- persistence and the server plane (ROADMAP A11, A13) ------------------

# the persisted namespaces keep their configs' widths; hybrid config #5's
# and the IVF API one are cut from 100,000 rows each to fit the script's
# time (PERF.md §4: restarting them at full size took 464 s of the phases)
PERSIST_HYB_DOCS, PERSIST_IVF_DOCS = 25_000, 25_000
PERSIST_UPDATES, PERSIST_DELETES, PERSIST_NEW = 1_000, 500, 500
PERSIST_Q, PERSIST_K = 16, 100
PERSIST_RTOL, PERSIST_ATOL = 1e-5, 1e-6     # fp32 rounding, as the tests
SERVER_THREADS, SERVER_SELECTS = 8, 32
SERVER_TIMEOUT_S = 300


def kernel_counters() -> dict:
    from reindexer_tpu_torch.ops import hnsw_kernels, ivf_kernels, scan, select
    return {"bf_scan": scan.launches, "bf_select": select.launches,
            "ivf_seg_scan": ivf_kernels.seg_scan_launches,
            "hnsw_beam": hnsw_kernels.hnsw_beam_launches}


class PersistRows:
    """One namespace's rows as the database should hold them: vectors by
    id (ids 0..n-1 plus the new ones) and an alive mask."""

    def __init__(self, vecs: np.ndarray, extra):
        self.vecs = vecs
        self.alive = np.ones(len(vecs), dtype=bool)
        self.extra = extra          # id -> the document's other fields

    def doc(self, i: int) -> dict:
        return {"id": i, **self.extra(i), "vec": self.vecs[i].tolist()}


def persist_sets():
    """The three namespaces: hybrid config #5's (bench_hybrid's rows, seed
    13, cut to PERSIST_HYB_DOCS), the HNSW API one (bench_hnsw's size) and
    the IVF API one (bench_ivf's API rows cut to PERSIST_IVF_DOCS, 1,024
    lists, 1,000 deletes)."""
    rng = np.random.default_rng(HYB_SEED)
    vocab = [f"w{i}" for i in range(5000)]
    zipf = np.minimum(rng.zipf(1.3, size=(PERSIST_HYB_DOCS, 8)) - 1,
                      len(vocab) - 1)
    titles = [" ".join(vocab[j] for j in row) for row in zipf]
    hyb = PersistRows(rng.normal(size=(PERSIST_HYB_DOCS, HYB_D)).astype(
        np.float32),
                      lambda i: {"grp": i % 10, "title": titles[i]})
    hyb.titles, hyb.vocab = titles, vocab
    rng = np.random.default_rng(1)
    hn = PersistRows(rng.normal(size=(HNSW_API_N, HNSW_API_D)).astype(
        np.float32), lambda i: {"grp": i % 3})
    base, _ = make_ivf_data(PERSIST_IVF_DOCS, IVF_API_D, 1)
    ivf = PersistRows(base, lambda i: {})
    return {"h": hyb, "hnsw": hn, "ivf": ivf}


def persist_defs(name: str):
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     IndexType, VectorMetric)
    pk = IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True))
    if name == "h":
        return [pk, IndexDef("grp", "hash", "int"),
                IndexDef("ft", "text", "string", json_paths=("title",)),
                IndexDef("vec", IndexType.VEC_BF, vector_opts=FloatVectorOpts(
                    dims=HYB_D, metric=VectorMetric.L2))]
    if name == "hnsw":
        return [pk, IndexDef("grp", "hash", "int"),
                hnsw_def("vec", HNSW_API_D, HNSW_API_EFC)]
    return [pk, IndexDef("vec", "ivf", vector_opts=FloatVectorOpts(
        dims=IVF_API_D, metric=VectorMetric.COSINE,
        centroids_count=IVF_NLIST))]


def persist_after_flush(db, name: str, rows: PersistRows, rng) -> None:
    """PERSIST_UPDATES upserts of existing rows (new vectors; new titles on
    the hybrid namespace), PERSIST_DELETES deletes, PERSIST_NEW new rows;
    all after the flush, so they live in the WAL alone."""
    alive = np.flatnonzero(rows.alive)
    pick = rng.choice(alive, size=PERSIST_UPDATES + PERSIST_DELETES,
                      replace=False)
    upd, dele = pick[:PERSIST_UPDATES], pick[PERSIST_UPDATES:]
    n0, d = len(rows.vecs), rows.vecs.shape[1]
    rows.vecs = np.concatenate([rows.vecs, rng.normal(
        size=(PERSIST_NEW, d)).astype(np.float32)])
    rows.alive = np.concatenate([rows.alive, np.ones(PERSIST_NEW, bool)])
    if name == "h":
        extra = rows.extra
        new_titles = {int(i): " ".join(rng.choice(rows.vocab[:50], size=8))
                      for i in upd.tolist() + list(range(n0, n0 + PERSIST_NEW))}
        rows.extra = lambda i: ({"grp": i % 10, "title": new_titles[i]}
                                if i in new_titles else extra(i))
    rows.vecs[upd] = rng.normal(size=(len(upd), d)).astype(np.float32)
    for i in upd.tolist() + list(range(n0, n0 + PERSIST_NEW)):
        db.upsert(name, rows.doc(i))
    for i in dele.tolist():
        db.delete(name, {"id": i})
    rows.alive[dele] = False


def persist_queries(rows: dict, rng) -> dict:
    return {name: rng.normal(size=(PERSIST_Q, r.vecs.shape[1])).astype(
        np.float32) for name, r in rows.items()}


def answer_of(res) -> tuple[list, np.ndarray]:
    """(ids, ranks) of a select's results."""
    return [d["id"] for d in res.docs()], np.asarray(res.ranks(), float)


def persist_answers(fdb, sdb, qs: dict) -> dict:
    """{tag: [(ids, ranks)]}: 16 vec_bf KNN, a match, the hybrid RRF query
    and a scalar query on the hybrid namespace; 16 HNSW KNN and a scalar
    query on the HNSW one; 16 IVF KNN at nprobe 8 and at nprobe 1,024
    (all lists)."""
    from reindexer_tpu_torch import (BruteForceSearchParams,
                                     HnswSearchParams, IvfSearchParams,
                                     KnnSearchParams, Query)
    return {
        "h knn": [answer_of(fdb.select(Query("h").where_knn(
            "vec", q, KnnSearchParams(k=PERSIST_K)))) for q in qs["h"]],
        "h match": [answer_of(fdb.select(Query("h").match("ft", "w3 w7")
                                         .limit(FT_TOP)))],
        "h hybrid": [answer_of(fdb.select(
            Query("h").where("grp", "<", 5).match("ft", "w3 w7")
            .where_knn("vec", qs["h"][0], BruteForceSearchParams(k=100))
            .sort("RRF()", desc=True).limit(FT_TOP)))],
        "h scalar": [answer_of(fdb.select(Query("h").where("grp", "=", 3)
                                          .sort("id").limit(100)))],
        "hnsw knn": [answer_of(fdb.select(Query("hnsw").where_knn(
            "vec", q, HnswSearchParams(k=HNSW_K, ef=HNSW_API_EF))))
            for q in qs["hnsw"]],
        "hnsw scalar": [answer_of(fdb.select(
            Query("hnsw").where("grp", "=", 1).sort("id").limit(100)))],
        "ivf knn": [answer_of(sdb.select(Query("ivf").where_knn(
            "vec", q, IvfSearchParams(k=PERSIST_K, nprobe=8))))
            for q in qs["ivf"]],
        "ivf knn all lists": [answer_of(sdb.select(Query("ivf").where_knn(
            "vec", q, IvfSearchParams(k=PERSIST_K, nprobe=IVF_NLIST))))
            for q in qs["ivf"]]}


def same_answer(want, got, tag: str, rtol: float = PERSIST_RTOL,
                atol: float = PERSIST_ATOL) -> None:
    """ids equal up to permutations of tied ranks and near-ties at the
    k-th rank; ranks within rtol / atol (PERSIST_RTOL / PERSIST_ATOL); a
    query without ranks (scalar) gives the same ids in the same order."""
    (ids_w, r_w), (ids_g, r_g) = want, got
    if len(ids_w) != len(ids_g) or not np.allclose(
            r_g, r_w, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(f"{tag}: {ids_g[:8]} {r_g[:8]} against "
                             f"{ids_w[:8]} {r_w[:8]}")
    if np.isnan(r_w).all():
        if ids_g != ids_w:
            raise AssertionError(f"{tag}: {ids_g[:8]} against {ids_w[:8]}")
        return
    rank_w, rank_g = dict(zip(ids_w, r_w)), dict(zip(ids_g, r_g))
    edge = r_w[-1] if len(r_w) else 0.0
    for i in set(ids_w) ^ set(ids_g):
        r = rank_w.get(i, rank_g.get(i))
        if abs(r - edge) > rtol * abs(edge) + atol:
            raise AssertionError(f"{tag}: id {i} (rank {r}) is in one answer "
                                 f"only and not tied at the k-th {edge}")
    for i in set(ids_w) & set(ids_g):
        if abs(rank_w[i] - rank_g[i]) > rtol * abs(rank_w[i]) + atol:
            raise AssertionError(f"{tag}: id {i} ranks {rank_g[i]} against "
                                 f"{rank_w[i]}")


def same_answers(want: dict, got: dict, tags, why: str) -> None:
    for tag in tags:
        for j, (w, g) in enumerate(zip(want[tag], got[tag], strict=True)):
            same_answer(w, g, f"[persist] {why}: {tag}[{j}]")


def hnsw_recall(rows: PersistRows, qs, answers, dev) -> float:
    """recall@10 of the HNSW answers against the float64 oracle over the
    live rows; ranks the exact inner products, no deleted row."""
    s64, top = hnsw_oracle(rows.vecs, qs, dev, rows.alive)
    return check_hnsw(answers, s64, top, "[persist] hnsw")


@contextlib.contextmanager
def ann_load_spy():
    """Keeps each HNSW index's layer-0 links as loaded from the ANN cache
    (before the WAL replays over them): {(namespace, index): links0}."""
    from reindexer_tpu_torch.storage import ann_cache
    orig, seen = ann_cache.AnnStorageCache.load, {}

    def load(self, ns_name, index, items_count):
        ok = orig(self, ns_name, index, items_count)
        if ok and hasattr(index, "_links0"):
            seen[(ns_name, index.name)] = index._links0.copy()
        return ok
    ann_cache.AnnStorageCache.load = load
    try:
        yield seen
    finally:
        ann_cache.AnnStorageCache.load = orig


def disk_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def restart_answers(fdb, sdb, qs: dict, opens: str):
    """The answers of two reopened databases and the time to recover: ({
    namespace: time split}, the answers, a note of the opens and the other
    answers). The split: the open's parse and upsert, cache load (upload)
    and WAL replay (the storage's load report), then the namespace's first
    query apart from the answers that follow (on the hybrid namespace also
    its first match, the full-text rebuild)."""
    from reindexer_tpu_torch import (HnswSearchParams, IvfSearchParams,
                                     KnnSearchParams, Query)
    firsts = {"h": lambda: fdb.select(Query("h").where_knn(
        "vec", qs["h"][0], KnnSearchParams(k=PERSIST_K))),
        "h match": lambda: fdb.select(Query("h").match("ft", "w3 w7")),
        "hnsw": lambda: fdb.select(Query("hnsw").where_knn(
            "vec", qs["hnsw"][0], HnswSearchParams(k=HNSW_K,
                                                   ef=HNSW_API_EF))),
        "ivf": lambda: sdb.select(Query("ivf").where_knn(
            "vec", qs["ivf"][0], IvfSearchParams(k=PERSIST_K, nprobe=8)))}
    first = {}
    for tag, fn in firsts.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers = persist_answers(fdb, sdb, qs)
    t_rest = time.perf_counter() - t0
    split = {ns: {**{k: rep[k] for k in ("snapshot_s", "ann_cache_s",
                                         "wal_s", "ann_applied")},
                  "first_query_s": first[ns]}
             for db in (fdb, sdb)
             for ns, rep in db.storage.load_report.items()}
    split["h"]["first_match_s"] = first["h match"]
    return split, answers, f"{opens}; the other answers {t_rest:.2f} s"


def split_str(split: dict) -> str:
    parts = []
    for ns, s in split.items():
        rec = (s["snapshot_s"] + s["ann_cache_s"] + s["wal_s"]
               + s["first_query_s"])
        parts.append(
            f"{ns}: {rec:.2f} s = parse + upsert {s['snapshot_s']:.2f}, "
            f"cache load {s['ann_cache_s']:.3f} (applied "
            f"{s['ann_applied'] or 'none'}), WAL replay {s['wal_s']:.2f}, "
            f"first query {s['first_query_s']:.3f}"
            + (f", first match (FT rebuild) {s['first_match_s']:.2f}"
               if "first_match_s" in s else ""))
    return "; ".join(parts)


def phase_persist(card: str, dev, root: str, daemon: "Daemon"):
    """[persist]: restart at full size, storage under `root`, with the ANN
    cache (the restart without it is the [server] manager's); `daemon`
    starts at the crash, to load beside the restarts. Returns (the live
    answers, the restarted ones, the query vectors, the rows, K1/K2/K6
    launches of the restarted run)."""
    from reindexer_tpu_torch import Reindexer
    rng = np.random.default_rng(SEED + 9)
    rows = persist_sets()
    n_fill = sum(len(r.vecs) for r in rows.values())
    fdsn = os.path.join(root, "fdb")
    sdsn = "sqlite://" + os.path.join(root, "sdb")
    t0 = time.perf_counter()
    fdb = Reindexer(fdsn, device=dev)
    sdb = Reindexer(sdsn, device=dev)
    for name, db in (("h", fdb), ("hnsw", fdb), ("ivf", sdb)):
        db.open_namespace(name, persist_defs(name))
        r = rows[name]
        for i in range(len(r.vecs)):
            db.upsert(name, r.doc(i))
    for i in np.random.default_rng(SEED + 4).choice(
            PERSIST_IVF_DOCS, size=DELETES, replace=False).tolist():
        sdb.delete("ivf", {"id": i})
        rows["ivf"].alive[i] = False
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    fdb.flush()                  # builds the HNSW graph, writes its cache
    sdb.flush()                  # trains the IVF lists, writes their cache
    t_flush = time.perf_counter() - t0
    saved_links = fdb.get_namespace("hnsw").get_index("vec").state_dict()[
        "links0"]
    for name, db in (("h", fdb), ("hnsw", fdb), ("ivf", sdb)):
        persist_after_flush(db, name, rows[name], rng)
    qs = persist_queries(rows, rng)
    live = persist_answers(fdb, sdb, qs)
    live_recall = hnsw_recall(rows["hnsw"], qs["hnsw"], live["hnsw knn"], dev)
    disk = {"fdb": disk_bytes(fdsn), "sdb": disk_bytes(sdsn[9:])}
    log(f"[persist] set-up: {n_fill} db.upserts in {t_fill:.1f} s (hybrid "
        f"config #5 cut to {PERSIST_HYB_DOCS} x {HYB_D} L2 + text and HNSW "
        f"{HNSW_API_N} x {HNSW_API_D} IP efC {HNSW_API_EFC} in a FileStorage"
        f" database, IVF {PERSIST_IVF_DOCS} x "
        f"{IVF_API_D} cosine {IVF_NLIST} lists - {DELETES} deletes in a "
        f"sqlite one), flush {t_flush:.1f} s; then per namespace "
        f"{PERSIST_UPDATES} upserts of existing rows, {PERSIST_DELETES} "
        f"deletes, {PERSIST_NEW} new rows in the WAL alone; on disk "
        f"{disk['fdb']} B (FileStorage) + {disk['sdb']} B (sqlite)")
    del fdb, sdb                 # a crash: no close(), no flush
    gc.collect()
    torch.cuda.empty_cache()
    daemon.start()
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    with ann_load_spy() as loaded:
        t0 = time.perf_counter()
        fdb = Reindexer(fdsn, device=dev)
        t_f = time.perf_counter() - t0
        t0 = time.perf_counter()
        sdb = Reindexer(sdsn, device=dev)
        t_s = time.perf_counter() - t0
    split, got, rest = restart_answers(
        fdb, sdb, qs, f"Reindexer(dsn) {t_f:.2f} s (FileStorage), {t_s:.2f}"
        " s (sqlite)")
    torch.cuda.synchronize()
    launches = {n: c.value for n, c in counters.items()}
    mem = torch.cuda.memory_allocated()
    exact = [t for t in live if not t.startswith("hnsw knn")]
    same_answers(live, got, exact, "with the ANN cache")
    if not np.array_equal(loaded.get(("hnsw", "vec")), saved_links):
        raise AssertionError("[persist] the HNSW links loaded from the ANN "
                             "cache differ from the saved ones")
    recall = hnsw_recall(rows["hnsw"], qs["hnsw"], got["hnsw knn"], dev)
    overlap = np.mean([len(set(a[0]) & set(b[0])) / HNSW_K for a, b in zip(
        live["hnsw knn"], got["hnsw knn"])])
    if recall < HNSW_API_MIN_RECALL:
        raise AssertionError(f"[persist] hnsw recall@{HNSW_K} {recall:.4f}")
    if not all(split[ns]["ann_applied"] == ["vec"] for ns in split):
        raise AssertionError(f"[persist] an ANN cache was not applied: "
                             f"{split}")
    if not all(launches.values()):
        raise AssertionError(f"[persist] the restarted path did not launch "
                             f"K1, K2 and K6: {launches}")
    log(f"[persist] restart with the ANN cache on {card}: {split_str(split)}"
        f"; {rest}; device memory after the reload {mem} B")
    log(f"[persist] with the ANN cache: every vec_bf KNN (16 x k={PERSIST_K}"
        f"), match, hybrid RRF, scalar and IVF KNN (nprobe 8 and all lists) "
        f"equals the live database's (ids, ties as sets; ranks rtol "
        f"{PERSIST_RTOL}); the HNSW links loaded equal the saved ones row for "
        f"row, its answers after the WAL recall@{HNSW_K} {recall:.4f} "
        f"(live {live_recall:.4f}; overlap with the live answers "
        f"{overlap:.4f}); launches " +
        ", ".join(f"{n} {v}" for n, v in launches.items()))
    del fdb, sdb
    gc.collect()
    torch.cuda.empty_cache()
    return live, got, qs, rows, launches


def http_json(port_no: int, method: str, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port_no}{path}",
                                 data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVER_TIMEOUT_S) as resp:
        return json.loads(resp.read().decode())


def phase_server(card: str, dev, root: str, live: dict, restarted: dict,
                 qs: dict, rows: dict, daemon) -> dict:
    """[server]: the daemon path over the [persist] storage root. The
    in-process manager rediscovers the databases with
    RX_TPU_DISABLE_ANN_CACHE=1: that is [persist]'s restart without the
    cache, held as the one with it was. The daemon, which loads with the
    cache, must answer as [persist]'s restart with it did (`restarted`).
    Returns K1's and K2's launches over the concurrent RPC run and the
    servers, still running ([replication] follows the sqlite database over
    their HTTP; `stop_servers` ends them)."""
    from reindexer_tpu_torch import (HnswSearchParams, IvfSearchParams,
                                     KnnSearchParams, Query)
    from reindexer_tpu_torch.net.rpc_client import RpcReindexer
    from reindexer_tpu_torch.net.rpc_server import RpcServer
    from reindexer_tpu_torch.query.dsl import to_dsl
    from reindexer_tpu_torch.server.http import ReindexerServer
    os.environ["RX_TPU_DISABLE_ANN_CACHE"] = "1"
    t0 = time.perf_counter()
    try:
        httpd = ReindexerServer(port=0, storage_root=root, device=dev)
    finally:
        del os.environ["RX_TPU_DISABLE_ANN_CACHE"]
    rpcd = RpcServer(mgr=httpd.mgr, port=0)
    httpd.start()
    rpcd.start()
    t_start = time.perf_counter() - t0
    daemon_checks = []
    try:
        if httpd.mgr.names() != ["fdb", "sdb"]:
            raise AssertionError(f"[server] the manager found "
                                 f"{httpd.mgr.names()}")
        fdb, sdb = httpd.mgr.get("fdb"), httpd.mgr.get("sdb")
        if type(sdb.storage).__name__ != "SqliteStorage":
            raise AssertionError("[server] sdb did not reopen as sqlite://")
        split, got, rest = restart_answers(
            fdb, sdb, qs, f"ReindexerServer(storage_root) {t_start:.2f} s")
        mem = torch.cuda.memory_allocated()
        same_answers(live, got, [t for t in live if t not in (
            "hnsw knn", "ivf knn")], "without the ANN cache")
        recall = hnsw_recall(rows["hnsw"], qs["hnsw"], got["hnsw knn"], dev)
        if recall < HNSW_API_MIN_RECALL:
            raise AssertionError(f"[persist] rebuilt hnsw recall@{HNSW_K} "
                                 f"{recall:.4f}")
        log(f"[persist] restart with RX_TPU_DISABLE_ANN_CACHE=1 (the server's"
            f" manager) on {card}: {split_str(split)}; {rest} (the IVF lists "
            f"retrain at the first query); device memory {mem} B; exact "
            f"answers as the live database's (IVF over all lists), rebuilt "
            f"HNSW recall@{HNSW_K} {recall:.4f}")
        knn = {"h": Query("h").where_knn("vec", qs["h"][0], KnnSearchParams(
            k=PERSIST_K)),
            "hnsw": Query("hnsw").where_knn("vec", qs["hnsw"][0],
                                            HnswSearchParams(
                                                k=HNSW_K, ef=HNSW_API_EF)),
            "ivf": Query("ivf").where_knn("vec", qs["ivf"][0],
                                          IvfSearchParams(k=PERSIST_K,
                                                          nprobe=8))}
        dbname = {"h": "fdb", "hnsw": "fdb", "ivf": "sdb"}
        sqls = {"h": ["SELECT * FROM h WHERE grp = 3 ORDER BY id LIMIT 100",
                      f"SELECT * FROM h WHERE ft = 'w3 w7' LIMIT {FT_TOP}"]}
        # HTTP: DSL KNN on every namespace, SQL scalar and match
        for ns, q in knn.items():
            got = http_json(httpd.port, "POST",
                            f"/api/v1/db/{dbname[ns]}/query", to_dsl(q))
            want = httpd.mgr.get(dbname[ns]).select(q).docs()
            if got["items"] != json.loads(json.dumps(want)):
                raise AssertionError(f"[server] HTTP DSL KNN on {ns}")
        for sql in sqls["h"]:
            got = http_json(httpd.port, "GET", "/api/v1/db/fdb/query?q="
                            + urllib.parse.quote(sql))
            if got["items"] != json.loads(json.dumps(fdb.select(sql).docs())):
                raise AssertionError(f"[server] HTTP {sql}")
        # RPC: the same KNN selects, ids and ranks
        for ns, q in knn.items():
            c = RpcReindexer("127.0.0.1", rpcd.port, dbname[ns])
            try:
                got = c.select(q)
            finally:
                c.close()
            want = httpd.mgr.get(dbname[ns]).select(q)
            if [d["id"] for d in got.docs()] != [d["id"] for d in
                                                  want.docs()] or not \
                    np.allclose(got.ranks(), want.ranks(), rtol=PERSIST_RTOL,
                                atol=0):
                raise AssertionError(f"[server] RPC KNN on {ns}")
        res = fdb.select(knn["h"])
        same_answer(live["h knn"][0], ([d["id"] for d in res.docs()],
                                       np.asarray(res.ranks())),
                    "[server] the rediscovered database against the live one")
        daemon_checks = [("GET", "/api/v1/db", None,
                          {"items": ["fdb", "sdb"], "total_items": 2})] + [
            ("POST", f"/api/v1/db/{dbname[ns]}/query", to_dsl(q),
             restarted[f"{ns} knn"][0][0]) for ns, q in knn.items()]
        daemon.stop(daemon_checks)
        # 8 RPC client threads x 32 vec_bf selects
        sq = np.random.default_rng(SEED + 11).normal(
            size=(SERVER_SELECTS, HYB_D)).astype(np.float32)
        sel = [Query("h").where_knn("vec", v, KnnSearchParams(k=PERSIST_K))
               for v in sq]
        serial = [[d["id"] for d in fdb.select(q).docs()] for q in sel]
        counters = kernel_counters()
        for c in counters.values():
            c.reset()
        lat, wall = rpc_threads(rpcd.port, [sel] * SERVER_THREADS,
                                [serial] * SERVER_THREADS, "vec_bf")
        torch.cuda.synchronize()
        launches = {n: counters[n].value for n in ("bf_scan", "bf_select")}
        if not all(launches.values()):
            raise AssertionError(f"[server] the RPC selects did not launch K1 "
                                 f"and K2: {launches}")
        n_req = SERVER_THREADS * SERVER_SELECTS
        p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
        per, wall_ms = profile_device(lambda: rpc_threads(
            rpcd.port, [sel] * SERVER_THREADS, [serial] * SERVER_THREADS,
            "vec_bf"), 1, host=True)
        busy = sum(per.values())
        # HNSW selects (a descent's CUDA graph replayed, then one K7 launch)
        # beside vec_bf selects (K1 + K2), half the threads each
        hq = [Query("hnsw").where_knn("vec", v, HnswSearchParams(
            k=HNSW_K, ef=HNSW_API_EF)) for v in qs["hnsw"]]
        hserial = [[d["id"] for d in fdb.select(q).docs()] for q in hq]
        half = SERVER_THREADS // 2
        _, mixed_wall = rpc_threads(
            rpcd.port, [hq] * half + [sel] * half,
            [hserial] * half + [serial] * half, "mixed HNSW + vec_bf")
        log(f"[server] ReindexerServer + RpcServer over the storage root on "
            f"{card}: started (both databases rediscovered and reopened "
            f"without the cache) in {t_start:.2f} s; HTTP DSL KNN (h, hnsw, ivf), SQL and match, "
            f"RPC KNN equal the embedded answers; {SERVER_THREADS} RPC "
            f"threads x {SERVER_SELECTS} vec_bf selects (k={PERSIST_K}) equal "
            f"the serial answers: {n_req / wall:.1f} qps, host ms a request "
            f"p50 {p50:.3f} p99 {p99:.3f}; under torch.profiler device "
            f"{busy / n_req:.4f} ms a request, idle share "
            f"{1.0 - busy / wall_ms:.4f}; launches K1 {launches['bf_scan']},"
            f" K2 {launches['bf_select']}; {half} threads x {len(hq)} HNSW "
            f"selects beside {half} x {len(sel)} vec_bf selects equal the "
            f"serial answers ({mixed_wall:.2f} s)")
    except BaseException:
        stop_servers((httpd, rpcd))
        raise
    daemon.join(card, len(daemon_checks))
    return launches, (httpd, rpcd)


def stop_servers(servers) -> None:
    """Stop [server]'s HTTP and RPC servers without closing their
    databases: their storage stays as the daemon read it, and the daemon's
    exit flushes it."""
    httpd, rpcd = servers
    rpcd.stop()
    httpd.httpd.shutdown()
    httpd.httpd.server_close()
    httpd._thread.join(timeout=SERVER_TIMEOUT_S)
    gc.collect()
    torch.cuda.empty_cache()


def rpc_threads(port_no: int, per_thread: list, want: list, tag: str):
    """One RpcReindexer a thread, each running its list of queries on the
    database `fdb`; every answer's ids must equal `want`'s. Returns (the
    host seconds of each request, the wall seconds of the run)."""
    from reindexer_tpu_torch.net.rpc_client import RpcReindexer
    clients = [RpcReindexer("127.0.0.1", port_no, "fdb", conns=1)
               for _ in per_thread]
    lat, errors, wrong = [], [], []

    def worker(t):
        try:
            for i, q in enumerate(per_thread[t]):
                t1 = time.perf_counter()
                ids = [d["id"] for d in clients[t].select(q).docs()]
                lat.append(time.perf_counter() - t1)
                if ids != want[t][i]:
                    wrong.append((t, i))
        except Exception as e:       # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(per_thread))]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVER_TIMEOUT_S)
    finally:
        for cl in clients:
            cl.close()
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads) or errors or wrong:
        raise AssertionError(f"[server] {tag} RPC threads: errors {errors}, "
                             f"answers other than the serial ones at "
                             f"(thread, query) {wrong[:8]}")
    return lat, wall


class Daemon:
    """python -m reindexer_tpu_torch.server over a storage root on `dev`:
    `start` launches it, `finish` sends one HTTP KNN request and SIGTERM
    and requires exit code 0, `kill` ends it whatever its state."""

    def __init__(self, dev, root: str):
        self.dev, self.root, self.proc = dev, root, None

    def start(self) -> None:
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (here, os.environ.get("PYTHONPATH")) if p))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "reindexer_tpu_torch.server",
             "--http-port", "0", "--rpc-port", "0", "--storage", self.root,
             "--device", str(self.dev)],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.watchdog = threading.Timer(SERVER_TIMEOUT_S, self.proc.kill)
        self.watchdog.daemon = True
        self.watchdog.start()

    def kill(self) -> None:
        if self.proc is None or self.proc.stdout.closed:
            return
        self.watchdog.cancel()
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()
        self.proc.stderr.close()

    def stop(self, checks: list) -> None:
        """Wait for the daemon's start line, then send each check (method,
        path, body, the ids or the JSON it must answer) over HTTP, then
        SIGTERM: its exit flushes both databases while the caller goes
        on."""
        try:
            line = self.proc.stdout.readline()
            if f"device={self.dev}" not in line:
                raise AssertionError(f"[server] the daemon said {line!r}: "
                                     f"{self.proc.stderr.read()[-2000:]}")
            self.t_up = time.perf_counter() - self.t0
            http_port = int(line.split("http://127.0.0.1:")[1].split()[0])
            t0 = time.perf_counter()
            for method, path, body, want in checks:
                got = http_json(http_port, method, path, body)
                if got.get("items") and isinstance(got["items"][0], dict):
                    got = [d["id"] for d in got["items"]]
                if got != want:
                    raise AssertionError(f"[server] the daemon answered "
                                         f"{str(got)[:200]} to {path}")
            self.t_req = time.perf_counter() - t0
            self.t_term = time.perf_counter()
            self.proc.send_signal(signal.SIGTERM)
        except BaseException:
            self.kill()
            raise

    def join(self, card: str, n_checks: int) -> None:
        try:
            rc = self.proc.wait(timeout=SERVER_TIMEOUT_S)
            t_term = time.perf_counter() - self.t_term
        finally:
            self.kill()
        if rc != 0:
            raise AssertionError(f"[server] the daemon exited {rc}")
        log(f"[server] python -m reindexer_tpu_torch.server --device "
            f"{self.dev} (started at the [persist] crash, loading beside "
            f"the restarts): up {self.t_up:.2f} s after its start; "
            f"{n_checks} HTTP requests (the databases it found, a DSL KNN on "
            f"each) answered as the embedded databases in "
            f"{1e3 * self.t_req:.1f} ms; SIGTERM -> exit 0 in {t_term:.2f} s "
            f"(its close flushes both databases, beside the RPC runs) on "
            f"{card}")


# --- replication, the RAFT cluster and sharding (ROADMAP A13b) -------------

REPL_UPDATES, REPL_DELETES, REPL_NEW = 1_000, 500, 500    # as [persist]'s
REPL_Q, REPL_LAG_WRITES, REPL_POLL_S = 64, 200, 0.005
REPL_IVF_UPDATES, REPL_IVF_DELETES, REPL_IVF_NEW, REPL_IVF_Q = 200, 100, 100, 16
CLUSTER_N, CLUSTER_TCP_N, CLUSTER_D, CLUSTER_Q = 20_000, 2_000, 128, 64
CLUSTER_WAIT_S = 60.0        # an election takes 0.15-0.3 s; a loaded host
SHARD_WRITES = 500
SHARD_SEED = SEED + 31


def hyb_queries():
    """The hybrid namespace's queries: a KNN (k=100), the match and the
    RRF hybrid of phase_hybrid."""
    from reindexer_tpu_torch import (BruteForceSearchParams, KnnSearchParams,
                                     Query)

    def knn(v):
        return Query("h").where_knn("vec", v, KnnSearchParams(k=K))

    def hybrid(v):
        return (Query("h").where("grp", "<", 5).match("ft", "w3 w7")
                .where_knn("vec", v, BruteForceSearchParams(k=100))
                .sort("RRF()", desc=True).limit(FT_TOP))
    return knn, Query("h").match("ft", "w3 w7").limit(FT_TOP), hybrid


def live_docs(db, ns: str) -> int:
    return sum(d is not None for d in db.get_namespace(ns).items)


def data_hashes(db) -> dict:
    return {n: db.get_namespace(n).data_hash for n in db.namespace_names()}


def timed(fn):
    """(fn(), seconds) with the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_and_device(fn) -> str:
    """Host ms (median of 7 after a warm-up), device ms and idle share of
    fn (torch.profiler)."""
    fn()
    host = median_ms(fn, 7)
    busy, idle, top = device_profile(fn)
    return (f"host {host:.3f} ms, device {busy:.4f} ms, idle share "
            f"{idle:.4f} ({top})")


def leader_writes(leader, rng) -> tuple[int, list]:
    """[persist]'s mix on the hybrid namespace (upserts of existing rows
    with new vectors, deletes, new rows), a put_meta, and two small
    namespaces: x1 dropped, x2 renamed to x3 and written to. Returns the
    number of writes and the ids of the upserted rows."""
    from reindexer_tpu_torch import IndexDef, IndexOpts, Query
    pick = rng.choice(HYB_DOCS, size=REPL_UPDATES + REPL_DELETES,
                      replace=False)
    for i in pick[:REPL_UPDATES].tolist():
        doc = dict(leader.select(Query("h").where("id", "=", i)).docs()[0])
        doc["vec"] = rng.normal(size=HYB_D).astype(np.float32).tolist()
        leader.upsert("h", doc)
    for i in pick[REPL_UPDATES:].tolist():
        leader.delete("h", {"id": i})
    words = np.minimum(rng.zipf(1.3, size=(REPL_NEW, 8)) - 1, 4999)
    for j in range(REPL_NEW):
        leader.upsert("h", {
            "id": HYB_DOCS + j, "grp": j % 10,
            "title": " ".join(f"w{w}" for w in words[j]),
            "vec": rng.normal(size=HYB_D).astype(np.float32).tolist()})
    leader.put_meta("h", "replicated", "yes")
    idx = [IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
           IndexDef("grp", "hash", "int")]
    for name in ("x1", "x2"):
        leader.open_namespace(name, idx)
        for i in range(10):
            leader.upsert(name, {"id": i, "grp": i % 3})
    leader.drop_namespace("x1")
    leader.rename_namespace("x2", "x3")
    leader.upsert("x3", {"id": 99, "grp": 1})
    return (REPL_UPDATES + REPL_DELETES + REPL_NEW + 26,
            pick[:REPL_UPDATES].tolist())


def replica_rpc(card: str, dev, leader, port_no: int) -> dict:
    """R1: a port follower of the hybrid database over the binary RPC; a
    chunked force sync, the leader's writes replayed online, its answers
    held to the leader's, the lag of 200 acknowledged writes. Returns K1's
    and K2's launches over the checks."""
    from reindexer_tpu_torch import KnnSearchParams, Query, Reindexer
    from reindexer_tpu_torch.replication import (AsyncReplicator,
                                                 RpcLeaderChannel)
    knn, match, hybrid = hyb_queries()
    rng = np.random.default_rng(SEED + 21)
    qs = rng.normal(size=(REPL_Q, HYB_D)).astype(np.float32)
    f = Reindexer(device=dev)
    repl = AsyncReplicator(f, RpcLeaderChannel("127.0.0.1", port_no, "hyb"),
                           poll_interval=REPL_POLL_S)
    try:
        _, t_sync = timed(repl.sync_once)
        n_sync = live_docs(f, "h")
        if repl.force_syncs != 1 or n_sync != live_docs(leader, "h"):
            raise AssertionError(f"[replication] R1's force sync: "
                                 f"{repl.stats()}, {n_sync} documents")
        _, t_knn = timed(lambda: f.select(knn(qs[0])))
        _, t_match = timed(lambda: f.select(match))
        state = leader._replication_state
        n_writes, updated = leader_writes(leader, rng)
        kp = f.get_namespace("h").get_index("vec").keeper
        version = kp.version
        t0 = time.perf_counter()
        repl.start()
        if not repl.wait_sync(state, timeout=SERVER_TIMEOUT_S):
            raise AssertionError(f"[replication] R1 did not catch up: "
                                 f"{repl.stats()}")
        t_replay = time.perf_counter() - t0
        if kp.version != version:
            raise AssertionError("[replication] the replay uploaded rows to "
                                 "the card before any select")
        counters = kernel_counters()
        for c in counters.values():
            c.reset()
        for qi, v in enumerate(qs):
            same_answer(answer_of(leader.select(knn(v))),
                        answer_of(f.select(knn(v))),
                        f"[replication] R1 select {qi}")
        if kp.version != version + 1:
            raise AssertionError("[replication] the replayed rows took "
                                 f"{kp.version - version} uploads, not one")
        params = KnnSearchParams(k=K)
        for qi, (w, g) in enumerate(zip(leader.knn_batch("h", "vec", qs,
                                                          params),
                                        f.knn_batch("h", "vec", qs,
                                                    params))):
            same_answer(answer_of(w), answer_of(g),
                        f"[replication] R1 knn_batch({REPL_Q}) [{qi}]")
        # a text index's ranks depend on its history of commits (a build,
        # then incremental steps: ROADMAP C), and the leader's and R1's
        # differ (one bulk load against chunks and a replay): both rebuild
        # over their documents, which are the same
        for db in (leader, f):
            db.get_namespace("h").get_index("ft")._full_dirty = True
        same_answer(answer_of(leader.select(match)),
                    answer_of(f.select(match)), "[replication] R1 match")
        same_answer(answer_of(leader.select(hybrid(qs[0]))),
                    answer_of(f.select(hybrid(qs[0]))),
                    "[replication] R1 hybrid RRF")
        torch.cuda.synchronize()
        launches = {n: counters[n].value for n in ("bf_scan", "bf_select")}
        if not all(launches.values()):
            raise AssertionError(f"[replication] R1's selects did not "
                                 f"launch K1 and K2: {launches}")
        if sorted(f.namespace_names()) != sorted(leader.namespace_names()) \
                or data_hashes(f) != data_hashes(leader) \
                or f.get_meta("h", "replicated") != "yes":
            raise AssertionError(f"[replication] R1 {data_hashes(f)} against "
                                 f"the leader's {data_hashes(leader)}")
        lag = []
        for j, i in enumerate(updated[:REPL_LAG_WRITES]):
            doc = dict(leader.select(Query("h").select("vectors()").where(
                "id", "=", i)).docs()[0], rev=j)
            leader.upsert("h", doc)
            t_ack = time.perf_counter()
            while True:
                got = f.select(Query("h").where("id", "=", i)).docs()
                if got and got[0].get("rev") == j:
                    break
                if time.perf_counter() - t_ack > SERVER_TIMEOUT_S:
                    raise AssertionError(f"[replication] R1 never returned "
                                         f"the write of id {i}")
                time.sleep(0.0002)
            lag.append(time.perf_counter() - t_ack)
        if not repl.wait_sync(state, timeout=SERVER_TIMEOUT_S) or \
                data_hashes(f) != data_hashes(leader):
            raise AssertionError("[replication] R1 diverged after the lag "
                                 "writes")
        p50, p99 = np.percentile(np.asarray(lag) * 1e3, [50, 99])
        stats = repl.stats()
    finally:
        repl.stop()
        repl.channel._client.close()
    log(f"[replication] R1 (RpcLeaderChannel over an in-process RpcServer, "
        f"hybrid config #5, {n_sync} docs) on {card}: chunked force sync "
        f"{t_sync:.2f} s ({n_sync / t_sync:.0f} docs/s, "
        f"{repl.force_sync_chunks} chunks); first select {1e3 * t_knn:.1f} "
        f"ms (the upload of {n_sync} rows), first match {1e3 * t_match:.1f}"
        f" ms (the full-text build); {n_writes} leader writes (updates, "
        f"deletes, new rows, meta, a dropped and a renamed namespace) "
        f"replayed online in {t_replay:.2f} s, the rows uploaded once at "
        f"the next select; {REPL_Q} selects, knn_batch({REPL_Q}) (k={K}), "
        f"match and hybrid RRF (both text indexes rebuilt) equal the "
        f"leader's (ids, ties as sets; ranks rtol {PERSIST_RTOL}); "
        f"namespaces {sorted(f.namespace_names())}, "
        f"data hashes and meta equal; launches K1 {launches['bf_scan']}, K2 "
        f"{launches['bf_select']}; stats {stats}")
    log(f"[replication] R1 lag of an acknowledged write until the follower "
        f"returns it (poll {1e3 * REPL_POLL_S:.0f} ms, {len(lag)} writes): "
        f"p50 {p50:.2f} ms, p99 {p99:.2f} ms")
    log(f"[replication] R1 knn_batch({REPL_Q}): " + host_and_device(
        lambda: f.knn_batch("h", "vec", qs, params)) + f" on {card}")
    del f
    return launches


def replica_http(card: str, dev, httpd, ivf_rows) -> int:
    """R2: a port follower of [server]'s sqlite database (the IVF API
    namespace) over HttpLeaderChannel. Its IVF lists are its own (it trains
    them), so its answers are held to the probed-set oracle of its lists,
    and at nprobe = all lists to the leader's. Returns K6's launches."""
    from reindexer_tpu_torch import IvfSearchParams, Query, Reindexer
    from reindexer_tpu_torch.replication import (AsyncReplicator,
                                                 HttpLeaderChannel)
    sdb = httpd.mgr.get("sdb")
    rng = np.random.default_rng(SEED + 22)
    f = Reindexer(device=dev)
    repl = AsyncReplicator(f, HttpLeaderChannel(
        f"http://127.0.0.1:{httpd.port}", "sdb"))
    _, t_sync = timed(repl.sync_once)
    n_sync = live_docs(f, "ivf")
    if repl.force_syncs != 1 or n_sync != live_docs(sdb, "ivf"):
        raise AssertionError(f"[replication] R2's force sync: "
                             f"{repl.stats()}, {n_sync} documents")
    alive = np.flatnonzero(ivf_rows.alive)
    pick = rng.choice(alive, size=REPL_IVF_UPDATES + REPL_IVF_DELETES,
                      replace=False)
    for i in pick[:REPL_IVF_UPDATES].tolist():
        sdb.upsert("ivf", {"id": i, "vec": rng.normal(
            size=IVF_API_D).astype(np.float32).tolist()})
    for i in pick[REPL_IVF_UPDATES:].tolist():
        sdb.delete("ivf", {"id": i})
    n0 = len(ivf_rows.vecs)
    for j in range(REPL_IVF_NEW):
        sdb.upsert("ivf", {"id": n0 + j, "vec": rng.normal(
            size=IVF_API_D).astype(np.float32).tolist()})
    _, t_replay = timed(repl.sync_once)
    if data_hashes(f) != data_hashes(sdb) or repl.force_syncs != 1:
        raise AssertionError(f"[replication] R2 {data_hashes(f)} against "
                             f"{data_hashes(sdb)}, {repl.stats()}")
    qs = rng.normal(size=(REPL_IVF_Q, IVF_API_D)).astype(np.float32)

    def knn(v, nprobe):
        return Query("ivf").where_knn("vec", v, IvfSearchParams(
            k=K, nprobe=nprobe))
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    _, t_first = timed(lambda: f.select(knn(qs[0], 8)))   # trains its lists
    ns = f.get_namespace("ivf")
    row_of = {d["id"]: r for r, d in enumerate(ns.items) if d is not None}
    got = [([row_of[i] for i in ids], ranks) for ids, ranks in (
        answer_of(f.select(knn(v, 8))) for v in qs)]     # ids as rows
    ix = ns.get_index("vec")
    check_assign(ix, "[replication] R2")
    q = np.stack([ix.keeper.prepare_query(v) for v in qs])
    check_ivf(got, probed_scores(ix, oracle_s64(ix, q), ix._probe_host(q, 8)),
              "[replication] R2 select nprobe 8")
    for qi, v in enumerate(qs):
        same_answer(answer_of(sdb.select(knn(v, IVF_NLIST))),
                    answer_of(f.select(knn(v, IVF_NLIST))),
                    f"[replication] R2 select over all lists [{qi}]")
    torch.cuda.synchronize()
    k6 = counters["ivf_seg_scan"].value
    if not k6:
        raise AssertionError("[replication] R2's IVF selects did not launch "
                             "K6")
    log(f"[replication] R2 (HttpLeaderChannel to [server]'s HTTP, the sqlite "
        f"database's IVF namespace, {n_sync} docs x {IVF_API_D} cosine, "
        f"{IVF_NLIST} lists) on {card}: chunked force sync {t_sync:.2f} s "
        f"({n_sync / t_sync:.0f} docs/s, {repl.force_sync_chunks} chunks); "
        f"{REPL_IVF_UPDATES + REPL_IVF_DELETES + REPL_IVF_NEW} leader writes "
        f"replayed in {t_replay:.2f} s, data hashes equal; first select "
        f"{1e3 * t_first:.1f} ms (trains its {IVF_NLIST} lists); "
        f"{REPL_IVF_Q} selects at nprobe 8 equal the probed-set float64 "
        f"oracle of its own lists, at nprobe {IVF_NLIST} the leader's "
        f"answers; K6 launches {k6}")
    del f
    return k6


def phase_replication(card: str, dev, leader, servers, ivf_rows) -> dict:
    """[replication]: R1 follows the hybrid database (served by an
    in-process RpcServer), R2 the [server] sqlite database over HTTP.
    Returns K1's, K2's and K6's launches."""
    from reindexer_tpu_torch.net.rpc_server import RpcServer
    from reindexer_tpu_torch.server.http import DBManager
    mgr = DBManager(device=dev)
    mgr.dbs["hyb"] = leader
    rpcd = RpcServer(mgr=mgr, port=0)
    rpcd.start()
    try:
        launches = replica_rpc(card, dev, leader, rpcd.port)
    finally:
        rpcd.stop()
    launches["ivf_seg_scan"] = replica_http(card, dev, servers[0], ivf_rows)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def cluster_rows(node, base: np.ndarray, tag: str) -> None:
    """node holds exactly the rows 0..len(base)-1 with base's vectors."""
    from reindexer_tpu_torch import Query
    docs = sorted(node.select(Query("bf").select("vectors()").limit(
        10 ** 9)).docs(), key=lambda d: d["id"])
    if [d["id"] for d in docs] != list(range(len(base))) or not \
            np.array_equal(np.asarray([d["vec"] for d in docs], np.float32),
                           base):
        raise AssertionError(f"[cluster] {tag}: node {node.server_id} holds "
                             f"{len(docs)} rows, not the acknowledged ones")


def cluster_run(card: str, tag: str, nodes, n: int) -> dict:
    """BF config #1's shape on a started 3-node cluster: n upserts through
    the live nodes in turn (a failed write is retried until acknowledged),
    the leader killed at n / 2; every acknowledged row read back from every
    live node and, after it catches up, from the revived one; 64 KNN
    selects (k=100) on every node against the float64 oracle. Returns K1's
    and K2's launches over the selects."""
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     KnnSearchParams, Query, ReindexerError,
                                     VectorMetric)
    from reindexer_tpu_torch.cluster import wait_leader
    rng = np.random.default_rng(SEED + 41)
    base = rng.standard_normal((n, CLUSTER_D), dtype=np.float32)
    rows = base.tolist()
    t0 = time.perf_counter()
    leader = wait_leader(nodes, CLUSTER_WAIT_S)
    if leader is None:
        raise AssertionError(f"[cluster] {tag}: no leader elected")
    t_first = time.perf_counter() - t0
    leader.open_namespace("bf", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        IndexDef("vec", "vec_bf", vector_opts=FloatVectorOpts(
            dims=CLUSTER_D, metric=VectorMetric.L2))])
    lat, retries = [], [0]

    def write(lo, hi):
        for i in range(lo, hi):
            live = [nd for nd in nodes if nd.alive]
            node = live[i % len(live)]
            while True:
                t1 = time.perf_counter()
                try:
                    node.upsert("bf", {"id": i, "vec": rows[i]})
                except ReindexerError:
                    retries[0] += 1
                    if retries[0] > 100:
                        raise
                    continue
                lat.append(time.perf_counter() - t1)
                break

    t0 = time.perf_counter()
    write(0, n // 2)
    t_kill = time.perf_counter()
    leader.kill()
    new = wait_leader([nd for nd in nodes if nd.alive], CLUSTER_WAIT_S)
    t_elect = time.perf_counter() - t_kill
    if new is None or new is leader:
        raise AssertionError(f"[cluster] {tag}: no new leader after the kill")
    t1 = time.perf_counter()
    write(n // 2, n)
    t_writes = (t_kill - t0) + (time.perf_counter() - t1)
    for node in nodes:
        if node.alive:
            cluster_rows(node, base, tag)
    leader.revive()
    t0 = time.perf_counter()
    while live_docs(leader.db, "bf") != n:
        if time.perf_counter() - t0 > CLUSTER_WAIT_S:
            raise AssertionError(f"[cluster] {tag}: the revived node holds "
                                 f"{live_docs(leader.db, 'bf')} rows")
        time.sleep(0.01)
    t_catch = time.perf_counter() - t0
    cluster_rows(leader, base, tag + " revived")
    if wait_leader(nodes, CLUSTER_WAIT_S) is None:
        raise AssertionError(f"[cluster] {tag}: no leader after the revive")
    qs = rng.standard_normal((CLUSTER_Q, CLUSTER_D), dtype=np.float32)
    dist = oracle_distances(qs, base, np.ones(n, dtype=bool))
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    params = KnnSearchParams(k=K)
    for node in nodes:
        check_against_oracle(
            [answer_of(node.select(Query("bf").where_knn("vec", v, params)))
             for v in qs], dist, f"[cluster] {tag} node {node.server_id}")
    torch.cuda.synchronize()
    launches = {m: counters[m].value for m in ("bf_scan", "bf_select")}
    if not all(launches.values()):
        raise AssertionError(f"[cluster] {tag}: the selects did not launch "
                             f"K1 and K2: {launches}")
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    log(f"[cluster] {tag} on {card}: 3 nodes, {n} upserts of {CLUSTER_D}-dim "
        f"L2 rows through the live nodes (quorum 2): {n / t_writes:.1f} "
        f"writes/s, acknowledged-write latency p50 {p50:.3f} ms p99 "
        f"{p99:.3f} ms ({retries[0]} retried); first election "
        f"{t_first:.2f} s; the leader killed at write {n // 2}, a new one "
        f"elected in {t_elect:.3f} s; every acknowledged row read back from "
        f"every live node, and from the revived one after its catch-up "
        f"({t_catch:.2f} s for {n - n // 2} records); {CLUSTER_Q} KNN "
        f"selects (k={K}) on each node equal the float64 oracle; launches "
        f"K1 {launches['bf_scan']}, K2 {launches['bf_select']}")
    node = nodes[0]
    log(f"[cluster] {tag} a node's select: " + host_and_device(
        lambda: node.select(Query("bf").where_knn("vec", qs[0], params))))
    return launches


def phase_cluster(card: str, dev) -> dict:
    """[cluster]: make_cluster(3) in process at CLUSTER_N writes, then
    make_tcp_cluster(3) over sockets at CLUSTER_TCP_N. Returns K1's and
    K2's launches."""
    from reindexer_tpu_torch.cluster import make_cluster
    from reindexer_tpu_torch.net.cluster_transport import make_tcp_cluster
    nodes = make_cluster(3, device=dev)
    try:
        launches = cluster_run(card, "in-process", nodes, CLUSTER_N)
    finally:
        for node in nodes:
            node.stop()
    nodes, servers = make_tcp_cluster(3, device=dev)
    try:
        for name, v in cluster_run(card, "TCP", nodes, CLUSTER_TCP_N).items():
            launches[name] += v
    finally:
        for node in nodes:
            node.stop()
        for srv in servers:
            srv.stop()
    del nodes, servers
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def shard_config(hi: int):
    """grp (i % 10): shard 0 values 0-2, shard 1 values 3-5, shard 2 the
    range 6..hi, shard 3 the default."""
    from reindexer_tpu_torch.sharding import (NamespaceShardingConfig,
                                              ShardKeyRange, ShardSpec)
    return NamespaceShardingConfig(
        namespace="h", index="grp", shards=(
            ShardSpec(0, values=(0, 1, 2)), ShardSpec(1, values=(3, 4, 5)),
            ShardSpec(2, ranges=(ShardKeyRange(6, hi),))), default_shard=3)


def phase_sharding(card: str, dev, leader) -> dict:
    """[sharding]: ShardedReindexer over 4 port databases on the card, and
    the same 4 on the CPU, holding the hybrid database's documents (after
    [replication]'s writes) sharded by grp. Exact answers (pinned and
    distributed scalar selects, KNN, aggregations) equal the unsharded
    database's; full text and hybrid (ranked per shard) equal the CPU's
    sharded set. Then a reshard moving grp 8-9 to shard 2 while a writer
    runs. Returns K1's and K2's launches."""
    from reindexer_tpu_torch import KnnSearchParams, Query, Reindexer
    from reindexer_tpu_torch.sharding import ShardedReindexer
    knn, match, hybrid = hyb_queries()
    defs = leader.get_namespace("h").index_defs()
    rows = leader.select(Query("h").select("vectors()").sort("id").limit(
        10 ** 9)).docs()

    def build(device):
        sr = ShardedReindexer([Reindexer(device=device) for _ in range(4)],
                              [shard_config(7)])
        sr.open_namespace("h", defs)
        for doc in rows:
            sr.upsert("h", doc)
        return sr

    rng = np.random.default_rng(SHARD_SEED)
    qs = rng.normal(size=(REPL_Q, HYB_D)).astype(np.float32)
    sr, t_card = timed(lambda: build(dev))
    cpu, t_cpu = timed(lambda: build(torch.device("cpu")))
    try:
        sizes = [live_docs(sh, "h") for sh in sr.shards]
        _, t_first = timed(lambda: sr.select(knn(qs[0])))
        _, t_first_match = timed(lambda: sr.select(match))
        counters = kernel_counters()
        for c in counters.values():
            c.reset()
        pinned = Query("h").where("grp", "=", 3).sort("id").limit(200)
        spread = Query("h").where("grp", "<", 5).sort("id").offset(50).limit(
            100)
        if sr._pinned_shard(pinned) != 1 or sr._pinned_shard(spread) is not \
                None:
            raise AssertionError("[sharding] pinned / distributed routing")
        for tag, q in (("pinned grp = 3", pinned), ("distributed grp < 5",
                                                    spread)):
            if answer_of(sr.select(q))[0] != answer_of(leader.select(q))[0]:
                raise AssertionError(f"[sharding] {tag} differs from the "
                                     "unsharded database")
        for qi, v in enumerate(qs):
            same_answer(answer_of(leader.select(knn(v))),
                        answer_of(sr.select(knn(v))),
                        f"[sharding] distributed KNN {qi}")
        same_answer(answer_of(cpu.select(match)), answer_of(sr.select(match)),
                    "[sharding] match against the CPU's shards",
                    rtol=0.0, atol=FT_RANK_ATOL)
        same_answer(answer_of(cpu.select(hybrid(qs[0]))),
                    answer_of(sr.select(hybrid(qs[0]))),
                    "[sharding] hybrid RRF against the CPU's shards")
        aggs = {"count": Query("h").where("grp", "<", 7).req_total_count()
                .limit(0),
                "sum": Query("h").aggregate_sum("grp"),
                "facet": Query("h").aggregate_facet("grp")}

        def agg_of(db, q):
            res = db.select(q)
            return (res.total_count, [(a.value, sorted(
                (f.values, f.count) for f in a.facets))
                for a in res.aggregations])
        for tag, q in aggs.items():
            if agg_of(sr, q) != agg_of(leader, q):
                raise AssertionError(f"[sharding] {tag}: {agg_of(sr, q)} "
                                     f"against {agg_of(leader, q)}")
        torch.cuda.synchronize()
        launches = {m: counters[m].value for m in ("bf_scan", "bf_select")}
        if not all(launches.values()):
            raise AssertionError(f"[sharding] the distributed selects did not"
                                 f" launch K1 and K2: {launches}")
        log(f"[sharding] ShardedReindexer over 4 port databases on {card}, "
            f"{len(rows)} hybrid documents by grp (shard sizes {sizes}): "
            f"set-up by sr.upsert {t_card:.1f} s (the CPU's 4 shards "
            f"{t_cpu:.1f} s), first select {1e3 * t_first:.1f} ms, first "
            f"match (4 full-text builds) {1e3 * t_first_match:.1f} ms; pinned "
            f"grp = 3 and distributed grp < 5, {REPL_Q} distributed KNN "
            f"(k={K}), count / sum / facet equal the unsharded database's; "
            f"match and hybrid RRF (ranked per shard) equal the CPU's shards;"
            f" launches K1 {launches['bf_scan']}, K2 {launches['bf_select']}")
        log(f"[sharding] a distributed KNN select: " + host_and_device(
            lambda: sr.select(knn(qs[0]))) + "; the unsharded database's: "
            + host_and_device(lambda: leader.select(knn(qs[0]))))
        wrng = np.random.default_rng(SHARD_SEED + 1)
        new = [{"id": 10_000_000 + j, "grp": j % 10,
                "title": f"w3 w7 w{j % 5000}", "vec": wrng.normal(
                    size=HYB_D).astype(np.float32).tolist()}
               for j in range(SHARD_WRITES)]
        errors = []

        def writer():
            try:
                for doc in new:
                    sr.upsert("h", doc)
                    leader.upsert("h", doc)
            except Exception as e:     # re-raised below, in the main thread
                errors.append(e)

        th = threading.Thread(target=writer)
        th.start()
        moved, t_reshard = timed(lambda: sr.apply_sharding_config(
            [shard_config(9)]))
        th.join(timeout=SERVER_TIMEOUT_S)
        if th.is_alive() or errors:
            raise AssertionError(f"[sharding] the writer: {errors}")
        stragglers = sr.apply_sharding_config([shard_config(9)])
        want = shard_config(9)
        from reindexer_tpu_torch.sharding import Locator
        loc, seen = Locator(want), set()
        for sid, sh in enumerate(sr.shards):
            for d in sh.select(Query("h").limit(10 ** 9)).docs():
                if loc.shard_of(d["grp"]) != sid or d["id"] in seen:
                    raise AssertionError(f"[sharding] after the reshard row "
                                         f"{d['id']} (grp {d['grp']}) is on "
                                         f"shard {sid}")
                seen.add(d["id"])
        if len(seen) != len(rows) + SHARD_WRITES:
            raise AssertionError(f"[sharding] {len(seen)} rows after the "
                                 "reshard")
        for qi, v in enumerate(qs[:16]):
            same_answer(answer_of(leader.select(knn(v))),
                        answer_of(sr.select(knn(v))),
                        f"[sharding] distributed KNN after the reshard {qi}")
        log(f"[sharding] apply_sharding_config moving grp 8-9 to shard 2 "
            f"beside {SHARD_WRITES} writes: {moved['h']} rows moved in "
            f"{t_reshard:.2f} s, {stragglers['h']} written during the move "
            f"re-routed by a second apply; every row on the shard the new "
            f"config names, none lost; 16 distributed KNN equal the "
            f"unsharded database's; shard sizes "
            f"{[live_docs(sh, 'h') for sh in sr.shards]}")
    finally:
        sr.close()
        cpu.close()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# shards of cuda:0 for BF config #1; S = 2 is cut for the phase's time
# (with it the phase took 170.8 s on an H100, above its 150 s share)
MESH_SHARDS = (4, 8)
MESH_S = 4                  # shards for SQ8, IVF, HNSW and hybrid
MESH_Q = 64                 # single selects per BF run (+ one knn_batch(64))
MESH_SQ8_Q = 16             # single selects per SQ8 field
MESH_SQ8 = ("approx", "approx_rerank")


def mesh_answers(db, ns: str, field: str, queries, params, n_single: int):
    """(answers of n_single selects and of one knn_batch over queries,
    host seconds of the run)."""
    from reindexer_tpu_torch import Query
    t0 = time.perf_counter()
    out = [answer_of(db.select(Query(ns).where_knn(field, v, params)))
           for v in queries[:n_single]]
    out += [answer_of(r) for r in db.knn_batch(ns, field, queries, params)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_same(want: list, got: list, tag: str, rtol: float,
              atol: float) -> None:
    for j, (w, g) in enumerate(zip(want, got, strict=True)):
        same_answer(w, g, f"{tag} [{j}]", rtol=rtol, atol=atol)


def mesh_db(dev, ctx, base, deleted, ivf_base=None):
    """BF config #1's namespace "bf" on a mesh through db.upsert: the fp32
    field "vec"; with ivf_base also the SQ8 fields of MESH_SQ8 over the
    same rows and the IVF API's rows as "iv" (cosine, 1,024 lists), one
    set-up for the 4-shard checks."""
    from reindexer_tpu_torch import (FloatVectorOpts, IndexDef, IndexOpts,
                                     QuantizationConfig, Reindexer,
                                     VectorMetric)
    defs = [IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
            IndexDef("vec", "vec_bf", vector_opts=FloatVectorOpts(
                dims=MAIN_D, metric=VectorMetric.L2))]
    if ivf_base is not None:
        defs += [IndexDef(m, "vec_bf", vector_opts=FloatVectorOpts(
            dims=MAIN_D, metric=VectorMetric.L2,
            quantization=QuantizationConfig(enabled=True, mode=m)))
            for m in MESH_SQ8]
        defs.append(IndexDef("iv", "ivf", vector_opts=FloatVectorOpts(
            dims=IVF_API_D, metric=VectorMetric.COSINE,
            centroids_count=IVF_NLIST)))
    db = Reindexer(device=dev, mesh=ctx)
    db.open_namespace("bf", defs)
    rows = base.tolist()
    iv = ivf_base.tolist() if ivf_base is not None else None
    for i in range(len(rows)):
        doc = {"id": i, "vec": rows[i]}
        if iv is not None:
            doc.update({m: rows[i] for m in MESH_SQ8}, iv=iv[i])
        db.upsert("bf", doc)
    for i in deleted.tolist():
        db.delete("bf", {"id": i})
    return db


def mesh_bf(card: str, dev, main_db, launches: dict):
    """BF config #1 over S shards of cuda:0 (and over the distinct cards
    when there are several): ids equal the one-device database's, K1 and
    K2 launched once a shard a dispatch. Returns the MESH_S database,
    which also holds the SQ8 and IVF fields."""
    from reindexer_tpu_torch import KnnSearchParams, Query
    from reindexer_tpu_torch.index.vector import brute_force
    from reindexer_tpu_torch.parallel.context import make_mesh_context
    base, queries, deleted = bf_config1()
    ivf_base, _ = make_ivf_data(DOCS, IVF_API_D, 16)
    qs = queries[:MESH_Q]
    params = KnnSearchParams(k=K)
    want, t_one = mesh_answers(main_db, "bf", "vec", qs, params, MESH_Q)
    one = {tag: host_and_device(fn) for tag, fn in (
        ("knn_batch(64)", lambda: main_db.knn_batch("bf", "vec", qs,
                                                    params)),
        ("select", lambda: main_db.select(
            Query("bf").where_knn("vec", qs[0], params))))}
    log(f"[mesh] BF config #1 on one device ({card}): {MESH_Q} selects + "
        f"knn_batch(64) {t_one:.2f} s; knn_batch(64) {one['knn_batch(64)']};"
        f" select {one['select']}")
    meshes = [(f"{n} shards of cuda:0", make_mesh_context(n, ["cuda:0"]))
              for n in MESH_SHARDS]
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes.append((f"{n_cards} cards", make_mesh_context(n_cards)))
    else:
        log("[mesh] one card: the distinct-cards mesh is not run")
    counters = kernel_counters()
    kept = None
    for tag, ctx in meshes:
        S = ctx.n_shards
        full = S == MESH_S and kept is None
        t0 = time.perf_counter()
        db = mesh_db(dev, ctx, base, deleted, ivf_base if full else None)
        t_set = time.perf_counter() - t0
        db.select(Query("bf").where_knn("vec", qs[0], params))  # the flush
        for c in (*counters.values(), brute_force.overflow_reruns,
                  brute_force.geometry_scans):
            c.reset()
        got, t_run = mesh_answers(db, "bf", "vec", qs, params, MESH_Q)
        k1, k2 = counters["bf_scan"].value, counters["bf_select"].value
        reruns = brute_force.overflow_reruns.value
        geo = brute_force.geometry_scans.value
        mesh_same(want, got, f"[mesh] BF {tag}", RANK_RTOL, 1e-3)
        # one K1 and one K2 a shard a dispatch: MESH_Q selects and one
        # knn_batch(64), one group of 64 queries
        expect = S * (MESH_Q + 1)
        if k1 != expect or k2 != expect or reruns or geo:
            raise AssertionError(f"[mesh] BF {tag}: K1 {k1}, K2 {k2} "
                                 f"launches, {reruns} reruns, {geo} plain "
                                 f"scans; expected {expect} launches each")
        launches["bf_scan"] += k1
        launches["bf_select"] += k2
        kp = db.get_namespace("bf").get_index("vec").keeper
        rows = sorted({sh.data.shape[0] for sh in kp.shards})
        devs = sorted({str(sh.data.device) for sh in kp.shards})
        log(f"[mesh] BF {tag}: set-up {t_set:.1f} s"
            f"{' (with the SQ8 and IVF fields)' if full else ''}, "
            f"{len(kp.shards)} shards of {rows} rows on {devs}; {MESH_Q} "
            f"selects + knn_batch(64) {t_run:.2f} s equal the one-device "
            f"answers (ids up to ties, ranks rtol {RANK_RTOL}); K1 {k1}, K2 "
            f"{k2} launches ({S} a dispatch)")
        for what, fn in (("knn_batch(64)", lambda: db.knn_batch(
                "bf", "vec", qs, params)), ("select", lambda: db.select(
                    Query("bf").where_knn("vec", qs[0], params)))):
            log(f"[mesh] BF {tag} {what}: {host_and_device(fn)}; one "
                f"device: {one[what]} on {card}")
        if full:
            kept = db
        del db
        gc.collect()
        torch.cuda.empty_cache()
    return kept


def mesh_sq8(card: str, db, launches: dict) -> None:
    """SQ8 approx and approx_rerank over MESH_S shards (the fields of
    mesh_bf's database): K3 (S mode) + K2 a shard, equal to the same
    database through the kernels' plain versions."""
    from reindexer_tpu_torch import KnnSearchParams
    from reindexer_tpu_torch.ops import scan, select
    _, queries, _ = bf_config1()
    qs = queries[:MESH_Q]
    params = KnnSearchParams(k=K)
    for m in MESH_SQ8:
        mesh_answers(db, "bf", m, qs[:1], params, 1)   # flush, quantize
        for c in (scan.sq8_scan_launches, select.launches):
            c.reset()
        got, t_run = mesh_answers(db, "bf", m, qs, params, MESH_SQ8_Q)
        k3, k2 = scan.sq8_scan_launches.value, select.launches.value
        with plain_kernels():
            want, _ = mesh_answers(db, "bf", m, qs, params, MESH_SQ8_Q)
        mesh_same(want, got, f"[mesh] SQ8 {m}", APPROX_TIE_RTOL, 1e-3)
        expect = MESH_S * (MESH_SQ8_Q + 1)
        if k3 != expect or k2 != expect:
            raise AssertionError(f"[mesh] SQ8 {m}: K3 {k3}, K2 {k2} "
                                 f"launches, expected {expect} each")
        launches["sq8_scan"] += k3
        launches["bf_select"] += k2
        st = db.get_namespace("bf").get_index(m)._quant
        log(f"[mesh] SQ8 {m} over {MESH_S} shards of cuda:0 "
            f"({len(st.shard_codes)} u8 code blocks of "
            f"{st.shard_codes[0].shape[0]} rows): {MESH_SQ8_Q} selects + "
            f"knn_batch(64) {t_run:.2f} s equal the plain versions' answers "
            f"(ids up to ties, ranks rtol {APPROX_TIE_RTOL}); K3 {k3}, K2 "
            f"{k2} launches; knn_batch(64) "
            f"{host_and_device(lambda: db.knn_batch('bf', m, qs, params))}"
            f" on {card}")


def mesh_ivf(card: str, db) -> None:
    """The IVF API's rows (100,000 x 128 cosine, 1,024 lists; the "iv"
    field of mesh_bf's database, as many rows as BF config #1's, with its
    1,000 deletes) over MESH_S shards, every list probed: exact against
    the float64 oracle."""
    from reindexer_tpu_torch import IvfSearchParams
    from reindexer_tpu_torch.index.vector import ivf
    from reindexer_tpu_torch.ops import ivf_kernels
    base, queries = make_ivf_data(DOCS, IVF_API_D, 16)
    _, _, deleted = bf_config1()
    params = IvfSearchParams(k=K, nprobe=IVF_NLIST)
    t0 = time.perf_counter()
    mesh_answers(db, "bf", "iv", queries[:1], params, 1)   # trains
    t_train = time.perf_counter() - t0
    ivf.mesh_sweeps.reset()
    ivf_kernels.seg_scan_launches.reset()
    got, t_run = mesh_answers(db, "bf", "iv", queries, params, 4)
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    sim = qn.astype(np.float64) @ bn.astype(np.float64).T
    sim[:, deleted] = -np.inf
    for j, (ids, ranks) in enumerate(got):
        row = sim[j if j < 4 else j - 4]
        top = np.argsort(-row, kind="stable")[:K]
        if len(ids) != K or tie_violations(ids, top.tolist(),
                                           lambda i: float(row[i]),
                                           float(row[top[-1]]), TIE_RTOL):
            raise AssertionError(f"[mesh] IVF answer {j} differs from the "
                                 "float64 oracle beyond ties")
        if not np.allclose(ranks, row[ids], rtol=0, atol=IVF_RANK_ATOL):
            raise AssertionError(f"[mesh] IVF answer {j}: ranks off by "
                                 f"{np.abs(ranks - row[ids]).max()}")
    if ivf.mesh_sweeps.value != 5 or ivf_kernels.seg_scan_launches.value:
        raise AssertionError(f"[mesh] IVF: {ivf.mesh_sweeps.value} sharded "
                             f"sweeps, {ivf_kernels.seg_scan_launches.value}"
                             " K6 launches")
    log(f"[mesh] IVF over {MESH_S} shards of cuda:0, {DOCS} x "
        f"{IVF_API_D} cosine, {IVF_NLIST} lists, nprobe {IVF_NLIST}: "
        f"training {t_train:.2f} s; 4 selects + knn_batch(16) {t_run:.2f} s "
        f"equal the float64 oracle (ids up to ties, ranks atol "
        f"{IVF_RANK_ATOL}, no deleted row); the probe-mask route, no K6; "
        f"knn_batch(16) "
        f"{host_and_device(lambda: db.knn_batch('bf', 'iv', queries, params))}"
        f" on {card}")


def mesh_hnsw(card: str, dev) -> None:
    """The HNSW API's namespace (20,000 x 96 IP) over MESH_S round-robin
    shards: recall@10 >= HNSW_MIN_RECALL at ef 128 against the oracle."""
    from reindexer_tpu_torch import (HnswSearchParams, IndexDef, IndexOpts,
                                     Reindexer)
    from reindexer_tpu_torch.parallel.context import make_mesh_context
    rng = np.random.default_rng(1)
    base = rng.normal(size=(HNSW_API_N, HNSW_API_D)).astype(np.float32)
    queries = rng.normal(size=(64, HNSW_API_D)).astype(np.float32)
    t0 = time.perf_counter()
    db = Reindexer(device=dev, mesh=make_mesh_context(MESH_S, ["cuda:0"]))
    db.open_namespace("hnsw", [
        IndexDef("id", "hash", "int", opts=IndexOpts(is_pk=True)),
        hnsw_def("vec", HNSW_API_D, HNSW_API_EFC)])
    rows = base.tolist()
    for i in range(HNSW_API_N):
        db.upsert("hnsw", {"id": i, "vec": rows[i]})
    params = HnswSearchParams(k=HNSW_K, ef=128)
    mesh_answers(db, "hnsw", "vec", queries[:1], params, 1)  # the builds
    t_set = time.perf_counter() - t0
    got, t_run = mesh_answers(db, "hnsw", "vec", queries, params, 16)
    s64, top = hnsw_oracle(base, queries, dev)
    rec = check_hnsw(got[16:], s64, top, "[mesh] HNSW knn_batch(64)")
    rec1 = check_hnsw(got[:16], s64[:16], top[:16], "[mesh] HNSW select")
    if min(rec, rec1) < HNSW_MIN_RECALL:
        raise AssertionError(f"[mesh] HNSW recall@{HNSW_K} {rec:.4f} / "
                             f"{rec1:.4f} < {HNSW_MIN_RECALL}")
    subs = db.get_namespace("hnsw").get_index("vec")._mesh_shards
    fn = lambda: db.knn_batch("hnsw", "vec", queries, params)  # noqa: E731
    fn()
    host = median_ms(fn, 3)
    # one call under torch.profiler, the device alone: the beam's many
    # small launches make a long trace to process
    per, wall_ms = profile_device(fn, 1)
    busy = sum(per.values()) if per else float("nan")
    log(f"[mesh] HNSW over {MESH_S} round-robin shards of cuda:0 "
        f"({[sh.keeper.count for sh in subs]} rows), {HNSW_API_N} x "
        f"{HNSW_API_D} IP: set-up and builds {t_set:.1f} s; recall@{HNSW_K} "
        f"at ef 128 {rec:.4f} (knn_batch(64)), {rec1:.4f} (16 selects), "
        f"ranks exact; 16 selects + knn_batch(64) {t_run:.2f} s; "
        f"knn_batch(64) host {host:.3f} ms, device {busy:.4f} ms, idle "
        f"share {1.0 - busy / wall_ms:.4f} on {card}")
    del db
    gc.collect()
    torch.cuda.empty_cache()


def mesh_hybrid(card: str, dev, one, launches: dict) -> None:
    """Hybrid config #5's namespace over MESH_S shards: RRF and linear
    ranks equal one device's (full text doc-sharded, KNN by K1 + K2). The
    one-device database is [hybrid]'s on the CPU, which [hybrid] held
    equal to the card's."""
    from reindexer_tpu_torch import BruteForceSearchParams, Query
    from reindexer_tpu_torch.ft import selector
    from reindexer_tpu_torch.parallel.context import make_mesh_context
    t0 = time.perf_counter()
    mesh, qv = hybrid_db(dev, make_mesh_context(MESH_S, ["cuda:0"]))
    t_set = time.perf_counter() - t0
    sorts = {"RRF": "RRF()", "linear": "10 * rank(ft) + 2 * rank(vec, 50.0)"}

    def hyb(sort):
        return (Query("h").where("grp", "<", 5).match("ft", "w3 w7")
                .where_knn("vec", qv, BruteForceSearchParams(k=100))
                .sort(sort, desc=True).limit(FT_TOP))

    text = (selector.sharded_scores, selector.dense_scores)
    for c in text:
        c.reset()
    for db in (mesh, one):
        db.select(hyb(sorts["RRF"]))      # the FT builds, the flushes
        if db is mesh:
            # the match's one scoring (the index caches its answer)
            sharded, dense = (c.value for c in text)
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    got = {tag: answer_of(mesh.select(hyb(q))) for tag, q in sorts.items()}
    k1, k2 = counters["bf_scan"].value, counters["bf_select"].value
    for tag, q in sorts.items():
        same_answer(answer_of(one.select(hyb(q))), got[tag],
                    f"[mesh] hybrid {tag}", rtol=1e-5, atol=0.0)
    # the KNN of each select launches K1 and K2 once a shard a dispatch;
    # the text was scored on the mesh (doc-sharded or the dense head)
    if not k1 or k1 % MESH_S or k2 != k1 or sharded + dense != 1:
        raise AssertionError(f"[mesh] hybrid: K1 {k1}, K2 {k2}, text "
                             f"scored sharded {sharded}, dense {dense}")
    launches["bf_scan"] += k1
    launches["bf_select"] += k2
    log(f"[mesh] hybrid config #5 over {MESH_S} shards of cuda:0: set-up "
        f"{t_set:.1f} s; RRF and linear equal one"
        f" device's (ids, ranks rtol 1e-5); the text scored doc-sharded "
        f"({sharded} queries) or by the sharded dense head ({dense}); K1 "
        f"{k1}, K2 {k2} launches; RRF {host_and_device(lambda: mesh.select(hyb('RRF()')))}"
        f" on {card}")
    del mesh
    gc.collect()
    torch.cuda.empty_cache()


def phase_mesh(card: str, dev, main_db, hyb_cpu) -> dict:
    """[mesh]: Reindexer(mesh=make_mesh_context(S)) on the card. BF config
    #1 over MESH_SHARDS shards of cuda:0 (and the distinct cards, when
    there are several) equal to the one-device database; over 4 shards
    SQ8 approx / approx_rerank, IVF over every list, HNSW and hybrid config
    #5 (against [hybrid]'s CPU database). Returns the kernels' launches
    over the phase."""
    launches = {"bf_scan": 0, "bf_select": 0, "sq8_scan": 0}
    marks = [time.perf_counter()]
    db4 = None

    def bf():
        nonlocal db4
        db4 = mesh_bf(card, dev, main_db, launches)

    for name, fn in (("BF", bf),
                     ("SQ8", lambda: mesh_sq8(card, db4, launches)),
                     ("IVF", lambda: mesh_ivf(card, db4)),
                     ("HNSW", lambda: mesh_hnsw(card, dev)),
                     ("hybrid", lambda: mesh_hybrid(card, dev, hyb_cpu,
                                                    launches))):
        fn()
        marks.append(time.perf_counter())
        log(f"[mesh] {name}: {marks[-1] - marks[-2]:.1f} s")
    del db4
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    global HNSW_N
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a GPU", file=sys.stderr)
        return 1
    card, kind = phase_identity()
    if sys.argv[1:2] == ["--hnsw-build"]:
        HNSW_N = int(sys.argv[2])
        phase_hnsw_setup(torch.device("cuda", 0))
        return 0
    marks = [time.perf_counter()]

    def mark(name: str) -> None:
        marks.append(time.perf_counter())
        log(f"[time] {name}: {marks[-1] - marks[-2]:.1f} s (at "
            f"{marks[-1] - marks[0]:.1f} s)")

    phase_build()
    dev = torch.device("cuda", 0)
    stats = phase_kernels(dev)
    launches, main_db = phase_main_path(card)
    mark("build, K1/K2, fp32 main path")
    stats.update(phase_sq8_kernels(dev))
    sq8_launches = phase_sq8_main_path(card, dev)
    launches.update((name, sq8_launches[name])
                    for name in ("sq8_scan", "sq8_select", "sq8_i8_scan"))
    mark("SQ8")
    ix, q = phase_ivf_setup(dev)
    stats["ivf_seg_scan"] = phase_ivf_kernel(ix, q, dev)
    launches["ivf_seg_scan"] = phase_ivf_main(card, ix, q[:IVF_BATCH])
    mark("IVF set-up, K6, main path")
    phase_ivf_routes(card, ix, q)
    del ix
    torch.cuda.empty_cache()
    mark("IVF routes")
    launches["ivf_seg_scan"] += phase_ivf_api(card, dev)
    mark("IVF API")
    stats["hnsw_beam"], launches["hnsw_beam"] = phase_hnsw(card, dev)
    mark("HNSW")
    phase_ft(card, dev)
    mark("full text")
    hyb_launches, hyb, hyb_cpu = phase_hybrid(card, dev)
    for name, n in hyb_launches.items():
        launches[name] += n
    mark("hybrid")

    def count(phase_launches: dict) -> None:
        for name, n in phase_launches.items():
            launches[name] += n

    root = tempfile.mkdtemp(prefix="rx_persist_")
    daemon = Daemon(dev, root)
    servers = None
    try:
        live, restarted, qs, rows, persist_launches = phase_persist(
            card, dev, root, daemon)
        count(persist_launches)
        mark("persist")
        server_launches, servers = phase_server(card, dev, root, live,
                                                restarted, qs, rows, daemon)
        count(server_launches)
        mark("server")
        count(phase_replication(card, dev, hyb, servers, rows["ivf"]))
        mark("replication")
    finally:
        if servers is not None:
            stop_servers(servers)
        daemon.kill()
        shutil.rmtree(root, ignore_errors=True)
    count(phase_cluster(card, dev))
    mark("cluster")
    count(phase_sharding(card, dev, hyb))
    mark("sharding")
    del hyb
    count(phase_mesh(card, dev, main_db, hyb_cpu))
    mark("mesh")
    loaded = [m for m in ("jax", "reindexer_tpu") if m in sys.modules]
    if loaded:
        raise AssertionError(f"{' and '.join(loaded)} got imported")
    replaces = {"bf_scan": "reindexer_tpu/ops/pallas_scan.py:94",
                "bf_select": "reindexer_tpu/ops/pallas_select.py:574",
                "sq8_scan": "reindexer_tpu/ops/pallas_scan.py:311 + "
                            "reindexer_tpu/ops/pallas_select.py:247",
                "sq8_select": "reindexer_tpu/ops/pallas_select.py:948",
                "sq8_i8_scan": "reindexer_tpu/ops/pallas_select.py:1453",
                "ivf_seg_scan": "reindexer_tpu/ops/ivf_kernels.py:338",
                "hnsw_beam": "none (lax.while_loop, "
                             "reindexer_tpu/ops/hnsw_kernels.py _beam_loop)"}
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
