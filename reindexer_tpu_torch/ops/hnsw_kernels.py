"""HNSW graph-search device ops in PyTorch (port of
reindexer_tpu/ops/hnsw_kernels.py): batched beam search, greedy descent,
the neighbor-selection heuristic and the exact-candidate build step.

The JAX module is plain jitted XLA, with no Pallas kernel. On the card the
beam search is one hand-written kernel, K7 (`csrc/hnsw_beam.cu`); the rest
is ordinary PyTorch. Scores are "higher is better" (L2 negated), as in
ops/distance.py.

What the port keeps, and how:

  - The batch-wide stop. The JAX beam is one device program, a
    `lax.while_loop` whose body runs for every query of the batch while any
    query is active and `it < max_iters`. On the card K7 runs that whole
    loop in one launch: after each step its blocks vote on the stop across
    the grid, and it writes `it` beside the results, so the host reads no
    stop flag. On the CPU the plain twin (_beam_program) steps with a
    device flag `go`, the loop condition evaluated on the state; when it is
    false the step leaves every tensor as it was and `it` does not move.
    The host reads the flag once every SYNC_EVERY steps, so a search makes
    about iters / SYNC_EVERY + 1 host syncs, and the extra steps after the
    stop change nothing. `it` is the JAX loop's count exactly, on both.
  - Greedy descent per layer stops, as in JAX, when no query of the batch
    improved at a hop or after max_hops hops. A hop leaves a query that did
    not improve where it is, so hops past that stop change nothing: each
    layer runs a budget of hops, one host read checks every layer's stop
    at once, and a layer that was still moving runs again from its start
    with twice the budget.
  - A CUDA graph for the descent on the card. Its hops are one small
    kernel after another, so the host's launch cost is most of a descent.
    Each device keeps a cache of captured graphs (_GraphCtx), keyed by all
    a graph bakes in (_graph_key): the shapes, the metric, the pack kind,
    the hop budget, and the address and layout of the tensors read in
    place. A descent of a key seen before copies its inputs into the
    entry's buffers and replays the graph of its first pass; the host read
    of its stop flags follows the replay. An entry is captured once on a
    miss, and released when a tensor its key names is gone (a rebuilt link
    table, a grown keeper, new SQ8 codes) or past CACHE_ENTRIES. The graphs
    share the device's pool: everything a graph writes that outlives its
    replay is in the entry's own buffers. The CPU runs the same code
    eagerly.
  - Ties. `lax.top_k` ranks equal values by the lower index first, and
    `jnp.argsort` is stable; here both are a stable sort (`_top_k`,
    `torch.argsort(stable=True)`), and K7 places equal scores in the order
    of that sort.
  - The visited bitset is int32 words (torch has little uint32): bit 31 is
    INT_MIN, and as the bits one step adds are distinct and unset,
    `scatter_add_` is a bitwise OR with no overflow. Its bits equal the JAX
    uint32 words' through a numpy view.

`beam_steps` counts the beam iterations (the JAX loop's `iters`, summed):
the beam returns `it` beside its results, and its caller adds it once the
copy of its results reaches the host. `host_syncs` counts the host reads of
a loop's or a descent's stop flag, `graph_captures` the descent's CUDA
graphs captured (one on a miss, none on a hit), `kernels.hnsw_beam` K7's
launches. While tracing is on, each stop-flag read is an `hnsw.stop_read`
span.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

import torch

from . import _build
from .. import tracing
from ..core.type_consts import VectorMetric
from .scan import _cuda_or_cpu

NEG_INF = float("-inf")
_F32_LOWEST = float(torch.finfo(torch.float32).min)
_GRAPH_CTX: dict = {}   # device index -> _GraphCtx
SYNC_EVERY = 8          # plain beam steps between two host reads of the stop
DESCENT_HOPS = 8        # greedy hops a layer runs before its stop is read
CACHE_ENTRIES = 16      # cached descent graphs a device keeps


# beam iterations run (the JAX loop's iters)
beam_steps = tracing.counter("hnsw.beam_steps")
# host reads of a loop's or a descent's stop flag
host_syncs = tracing.counter("hnsw.host_syncs")
# CUDA graphs captured: a descent's first pass
graph_captures = tracing.counter("hnsw.graph_captures")
# K7 launches: one a beam search on the card
hnsw_beam_launches = tracing.counter("kernels.hnsw_beam")


def _score_gathered(q: torch.Tensor, vecs: torch.Tensor, vec_sq: torch.Tensor,
                    metric: VectorMetric) -> torch.Tensor:
    """q [Q, D], vecs [Q, K, D], vec_sq [Q, K] -> scores [Q, K]
    (higher-better)."""
    dots = torch.einsum("qkd,qd->qk", vecs, q)
    if metric == VectorMetric.L2:
        return 2.0 * dots - vec_sq - (q * q).sum(dim=1, keepdim=True)
    return dots


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` along dim 1: the k largest, best first, equal values by
    the lower index first."""
    s, i = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


class DataPack:
    """Vector storage handed to the graph ops: fp32 rows or SQ8 codes
    (reference: HierarchicalNSWImpl templated over float/uint8 storage,
    hnswalg.h)."""

    def __init__(self, data: torch.Tensor, data_sq: torch.Tensor,
                 lo: Optional[torch.Tensor] = None,
                 alpha: Optional[torch.Tensor] = None):
        self.data = data          # f32[N, D] or u8[N, D] codes
        self.data_sq = data_sq    # f32[N] exact |v|^2 (L2 correction)
        self.lo = lo              # f32[D] quantization offsets (codes only)
        self.alpha = alpha        # f32[D] quantization scales (codes only)

    @property
    def quantized(self) -> bool:
        return self.lo is not None


def _score_ids(q: torch.Tensor, pack: DataPack, ids: torch.Tensor,
               metric: VectorMetric) -> torch.Tensor:
    """Gather and score rows `ids` [Q, K] against q [Q, D] (higher-better);
    callers mask invalid ids themselves. SQ8 packs dequantize in the
    contraction (v ~ lo + alpha * code)."""
    idx = ids.long()
    if not pack.quantized:
        return _score_gathered(q, pack.data[idx], pack.data_sq[idx], metric)
    codes = pack.data[idx].to(torch.float32)             # [Q, K, D]
    dots = torch.einsum("qkd,qd->qk", codes, q * pack.alpha[None, :])
    dots = dots + (q @ pack.lo)[:, None]
    if metric == VectorMetric.L2:
        return (2.0 * dots - pack.data_sq[idx]
                - (q * q).sum(dim=1, keepdim=True))
    return dots


def _bits(ids: torch.Tensor) -> torch.Tensor:
    """The visited-bitset bit of each id, as int32 (bit 31 is INT_MIN)."""
    return 1 << (ids & 31)


def _beam_init(queries, pack, n_rows: int, entry_ids, ef: int, fcap: int,
               metric: VectorMetric):
    """Initial beam state from entry points: result set W, frontier C
    (sorted best-first), visited bitset with the entry bits set."""
    Q = queries.shape[0]
    dev = queries.device
    n_words = (n_rows + 31) // 32
    e0 = entry_ids.shape[1]
    entry_valid = entry_ids >= 0
    safe_entry = torch.where(entry_valid, entry_ids, 0)
    entry_scores = _score_ids(queries, pack, safe_entry, metric)
    entry_scores = entry_scores.masked_fill(~entry_valid, NEG_INF)
    ent = torch.where(entry_valid, entry_ids, -1).to(torch.int32)

    w_ids = torch.full((Q, ef), -1, dtype=torch.int32, device=dev)
    w_s = torch.full((Q, ef), NEG_INF, dtype=torch.float32, device=dev)
    w_ids[:, :e0] = ent
    w_s[:, :e0] = entry_scores
    c_ids = torch.full((Q, fcap), -1, dtype=torch.int32, device=dev)
    c_s = torch.full((Q, fcap), NEG_INF, dtype=torch.float32, device=dev)
    c_ids[:, :e0] = ent
    c_s[:, :e0] = entry_scores
    # the frontier stays sorted best-first (a pop reads its head)
    c_s, cpos = _top_k(c_s, fcap)
    c_ids = torch.gather(c_ids, 1, cpos)

    visited = torch.zeros((Q, n_words), dtype=torch.int32, device=dev)
    visited.scatter_add_(1, (safe_entry >> 5).long(), torch.where(
        entry_valid, _bits(safe_entry), 0))
    return w_s, w_ids, c_s, c_ids, visited


def _active(w_s, c_s, ef: int, it, max_iters: int) -> torch.Tensor:
    """The JAX loop's condition on the device: it < max_iters and some
    query's best frontier node can still improve its worst result (a
    finite one: an empty frontier's -inf beats nothing)."""
    c_best = c_s[:, 0]
    active = c_best >= w_s[:, ef - 1].clamp_min(_F32_LOWEST)
    return active.any() & (it < max_iters)


def _beam_step(queries, pack, links, w_s, w_ids, c_s, c_ids, visited, go,
               pop, earlier, expand: int, metric: VectorMetric):
    """One iteration of the JAX loop's body for every query. Updates
    `visited` in place. W and C have the same width ef, sorted best-first
    with -1 ids at -inf; when the device flag `go` is false nothing is
    popped and nothing is new, so the stable merge returns W and C as they
    were. pop: bool[1, ef], the `expand` head columns; earlier: bool[K, K],
    i < j."""
    Q = queries.shape[0]
    K = earlier.shape[0]            # gathered candidates per query
    ef = w_s.shape[1]
    # pop the best `expand` frontier entries (the frontier is sorted)
    head = c_s[:, :expand] > NEG_INF
    sel_ids = torch.where(head, c_ids[:, :expand], 0)
    nbrs = links[sel_ids.long()]                      # [Q, expand, M]
    nbrs = torch.where((head & go)[:, :, None], nbrs, -1).reshape(Q, K)

    # dedup within the step: an id already at an earlier position
    dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(dim=2)
    # visited test, then set (add == or: the bits are distinct and unset)
    safe = nbrs.clamp_min(0)
    word = (safe >> 5).long()
    bit = _bits(safe)
    seen = (torch.gather(visited, 1, word) & bit) != 0
    fresh = (nbrs >= 0) & ~(dup | seen)
    visited.scatter_add_(1, word, bit * fresh)

    scores = _score_ids(queries, pack, safe, metric).masked_fill(
        ~fresh, NEG_INF)
    new_ids = torch.where(fresh, nbrs, -1)
    # W = top-ef of (W u new) and C = top-ef of (C - popped u new), both
    # best-first, merged in one sort
    rest = pop & go
    ms = torch.cat([torch.stack([w_s, c_s.masked_fill(rest, NEG_INF)]),
                    scores.expand(2, Q, K)], dim=2)
    mi = torch.cat([torch.stack([w_ids, c_ids.masked_fill(rest, -1)]),
                    new_ids.expand(2, Q, K)], dim=2)
    s2, pos = torch.sort(ms, dim=2, descending=True, stable=True)
    s2 = s2[:, :, :ef]
    i2 = torch.gather(mi, 2, pos[:, :, :ef])
    i2 = torch.where(s2 > NEG_INF, i2, -1)
    return s2[0], i2[0], s2[1], i2[1]


class _GraphCtx:
    """Per device: the side stream graphs are captured on, the memory pool
    they share, the newest graph, the cache of entries (key -> _Entry,
    least recently used first) and a lock. A descent on the card holds the
    lock from the copy of its inputs into an entry to the copy of its
    results out of it, and enqueues all of it on the device's current
    stream, so one descent at a time runs graphs of the pool and uses an
    entry's buffers."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.last = None
        self.entries: OrderedDict = OrderedDict()
        self.lock = threading.Lock()


def _graph_ctx(device: torch.device) -> _GraphCtx:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    ctx = _GRAPH_CTX.get(idx)
    if ctx is None:
        ctx = _GRAPH_CTX.setdefault(idx, _GraphCtx(device))
    return ctx


def _capture(fn, ctx: _GraphCtx, device: torch.device):
    """A CUDA graph of fn's kernels (captured, not run) in ctx's pool."""
    graph = torch.cuda.CUDAGraph()
    ctx.stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(ctx.stream):
        graph.capture_begin(pool=ctx.pool, capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(ctx.stream)
    # a pool whose graphs are all gone takes no new capture: the newest
    # graph keeps it alive when the cache releases the others
    ctx.last = graph
    graph_captures.add()
    return graph


def _graphs(ctx: _GraphCtx, device: torch.device, *fns) -> list:
    """CUDA graphs of fns, after one run of the first on the capture
    stream: what a kernel sets up at its first use (its module, a library
    handle's workspace) is set up outside a capture."""
    ctx.stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(ctx.stream):
        fns[0]()
    return [_capture(fn, ctx, device) for fn in fns]


def _shapes(*tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _graph_key(kind: str, sizes: tuple, metric: VectorMetric,
               pack: DataPack, *tensors) -> tuple:
    """Everything a graph of `kind` bakes in: its sizes (the shapes of the
    inputs it copies in, and its integer arguments), the metric, the pack
    kind, DESCENT_HOPS, and the identity (device, dtype, address, shape,
    strides) of every read-only tensor it reads in place: the pack's and
    `tensors`."""
    ident = tuple(None if t is None else
                  (str(t.device), t.dtype, t.data_ptr(), tuple(t.shape),
                   t.stride())
                  for t in (pack.data, pack.data_sq, pack.lo, pack.alpha,
                            *tensors))
    return (kind, sizes, metric, pack.quantized, DESCENT_HOPS) + ident


class _Entry:
    """One key's graphs and the static buffers they read (ins) and write
    (outs), allocated outside any graph pool. Of the tensors its key names
    it keeps weak references only: once one of them is gone, the entry is
    stale."""

    def __init__(self, tensors, ins, outs, graphs):
        self.refs = [weakref.ref(t) for t in tensors if t is not None]
        self.ins, self.outs = ins, outs
        self.graphs = graphs

    def stale(self) -> bool:
        return any(r() is None for r in self.refs)


def _entry(ctx: _GraphCtx, key: tuple, build) -> _Entry:
    """key's entry, made by build() on a miss; ctx.lock is held. Stale
    entries are released first, and past CACHE_ENTRIES the least recently
    used."""
    for k in [k for k, e in ctx.entries.items() if e.stale()]:
        del ctx.entries[k]
    e = ctx.entries.pop(key, None)
    if e is None:
        e = build()
    ctx.entries[key] = e
    while len(ctx.entries) > CACHE_ENTRIES:
        ctx.entries.popitem(last=False)
    return e


def _beam_program(kind: str, ins: list, pack, links, ef: int, expand: int,
                  max_iters: int, metric: VectorMetric):
    """K7's plain twin: the beam loop's state [w_s, w_ids, c_s, c_ids,
    visited, it, go], made from ins = [queries, *inputs], and a function
    that runs SYNC_EVERY steps of it in place. The inputs are the entry ids
    ("layer") or W and C, both ef wide, and the visited bitset
    ("resume"); they are not modified."""
    dev = ins[0].device
    K = expand * links.shape[1]
    pop = torch.zeros((1, ef), dtype=torch.bool, device=dev)
    pop[:, :expand] = True
    earlier = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
    if kind == "layer":
        state = list(_beam_init(ins[0], pack, links.shape[0], ins[1], ef, ef,
                                metric))
    else:
        state = [x.clone() for x in ins[1:]]
    it = torch.zeros((), dtype=torch.int32, device=dev)
    state += [it, _active(state[0], state[2], ef, it, max_iters)]

    def block():
        w_s, w_ids, c_s, c_ids, visited, it, go = state
        for _ in range(SYNC_EVERY):
            w_s, w_ids, c_s, c_ids = _beam_step(
                ins[0], pack, links, w_s, w_ids, c_s, c_ids, visited, go,
                pop, earlier, expand, metric)
            it += go
            go = _active(w_s, c_s, ef, it, max_iters)
        for dst, src in zip(state, (w_s, w_ids, c_s, c_ids)):
            dst.copy_(src)
        state[6].copy_(go)

    return state, block


def _run_blocks(state: list, block) -> None:
    """Run block, then again while the device flag `go` says so, with one
    host read of the stop flag after each."""
    block()
    last_it = -1
    while True:
        host_syncs.add()
        flag = tracing.device_read(
            torch.stack([state[6].to(torch.int32), state[5]]),
            "hnsw.stop_read")
        if not flag[0]:
            return
        if int(flag[1]) <= last_it:
            # a live block always moves `it`; a block that did not would
            # loop here for ever
            raise RuntimeError(f"beam loop stalled at step {last_it}")
        last_it = int(flag[1])
        block()


def hnsw_beam(kind: str, queries, pack, links, inputs: tuple, ef: int,
              expand: int, max_iters: int, metric: VectorMetric):
    """K7 (`csrc/hnsw_beam.cu`): the whole beam loop of `kind` in one launch
    on the card. Returns (w_s, w_ids, c_s, c_ids, visited, it) as the plain
    twin's state holds them when its loop ends, `it` an int32 tensor.
    inputs: the entry ids i32[Q, E0], E0 <= ef ("layer"), or W and C, both
    [Q, ef], and the visited bitset ("resume"); they are not modified.
    Every ef runs: where a block's arrays outgrow its shared memory, they
    spill to a scratch tensor (`hnsw_beam_spill_bytes`)."""
    dev = queries.device
    n_q, d = queries.shape
    m0 = links.shape[1]
    if not 1 <= expand <= ef:
        raise ValueError(f"hnsw_beam takes 1 <= expand <= ef, got expand "
                         f"{expand}, ef {ef}")
    lib = _build.load("hnsw_beam")
    code_type = torch.uint8 if pack.quantized else torch.float32
    if (queries.dtype != torch.float32 or pack.data.dtype != code_type
            or pack.data.shape[1:] != (d,) or links.dtype != torch.int32):
        raise ValueError(
            f"hnsw_beam expects f32 queries [Q, D], {code_type} rows [N, D] "
            f"and i32 links, got {queries.dtype} {tuple(queries.shape)}, "
            f"{pack.data.dtype} {tuple(pack.data.shape)}, {links.dtype}")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    w_s, c_s = torch.empty((n_q, ef), **f32), torch.empty((n_q, ef), **f32)
    w_i, c_i = torch.empty((n_q, ef), **i32), torch.empty((n_q, ef), **i32)
    ctl = torch.zeros(8, **i32)     # barrier, stop votes, `it` at [5]
    with torch.cuda.device(dev):
        n_spill = lib.hnsw_beam_spill_bytes(n_q, d, expand * m0, ef,
                                            int(pack.quantized))
    if n_spill < 0:
        raise RuntimeError("hnsw_beam: the launch's shape query failed")
    spill = (torch.empty(n_spill, dtype=torch.uint8, device=dev)
             if n_spill else None)
    if kind == "layer":
        entry, resume = inputs[0].to(torch.int32), (None,) * 5
        visited = torch.empty((n_q, (links.shape[0] + 31) // 32), **i32)
    else:
        entry = None
        resume = tuple(x if x.dtype == torch.float32 else x.to(torch.int32)
                       for x in inputs)
        if any(x.shape != (n_q, ef) for x in resume[:4]) or \
                resume[4].shape[0] != n_q:
            raise ValueError(
                f"hnsw_beam resumes from W and C [{n_q}, {ef}] and a visited "
                f"bitset [{n_q}, n_words], got "
                f"{[tuple(x.shape) for x in resume]}")
        visited = torch.empty(resume[4].shape, **i32)
    # contiguous, and held here until the launch is queued
    args = [None if t is None else t.contiguous() for t in (
        queries, pack.data, pack.data_sq, pack.lo, pack.alpha, links, entry,
        *resume, w_s, w_i, c_s, c_i, visited, ctl, spill)]
    e0 = 0 if entry is None else entry.shape[1]
    with torch.cuda.device(dev):
        code = lib.hnsw_beam_launch(
            *(None if t is None else t.data_ptr() for t in args), n_q, d, m0,
            e0, ef, expand, max_iters, visited.shape[1],
            int(metric == VectorMetric.L2), int(pack.quantized),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "hnsw_beam", code)
    hnsw_beam_launches.add()
    return w_s, w_i, c_s, c_i, visited, ctl[5]


def _beam_loop(kind: str, queries, pack, links, inputs: tuple, ef: int,
               expand: int, max_iters: int, metric: VectorMetric):
    """The best-first expansion loop of one-shot ("layer") and streaming
    ("resume") searches, W and C both ef wide. Returns (w_s, w_ids, c_s,
    c_ids, visited, it), `it` the iteration count (an int32 tensor, which
    the caller adds to `beam_steps` once its copy is on the host); the
    inputs are not modified. On the card it is K7, one launch; on the CPU
    the plain twin, in blocks of SYNC_EVERY steps with one host read of the
    stop flag after each."""
    if _cuda_or_cpu("hnsw_beam", queries.device):
        return hnsw_beam(kind, queries, pack, links, inputs, ef, expand,
                         max_iters, metric)
    state, block = _beam_program(kind, [queries, *inputs], pack, links, ef,
                                 expand, max_iters, metric)
    _run_blocks(state, block)
    return tuple(state[:6])


def beam_search_layer(
    queries: torch.Tensor,      # f32[Q, D]
    pack: DataPack,             # fp32 rows or SQ8 codes
    links: torch.Tensor,        # i32[N, M]  (-1 = empty slot)
    entry_ids: torch.Tensor,    # i32[Q, E0] starting beam (-1 pad)
    ef: int, expand: int, max_iters: int, metric: VectorMetric,
):
    """Batched best-first beam search on one graph layer (reference
    searchBaseLayerST, hnswalg.h:967): a result set W of size ef and a
    separate unexpanded frontier C; each iteration expands the `expand`
    best frontier nodes of every query at once.

    Returns (w_scores f32[Q, ef], w_ids i32[Q, ef], iters) best-first;
    empty slots are (-inf, -1); iters is the loop's count, an int32 tensor
    for the caller to add to `beam_steps`."""
    w_s, w_ids, _, _, _, it = _beam_loop("layer", queries, pack, links,
                                         (entry_ids,), ef, expand, max_iters,
                                         metric)
    return w_s, w_ids, it


def beam_begin_stream(
    queries: torch.Tensor,      # f32[Q, D]
    pack: DataPack,
    entry_ids: torch.Tensor,    # i32[Q, E0] layer-0 entries (-1 pad)
    n_rows: int, fcap: int, metric: VectorMetric,
):
    """BeginStreamingSearch analog (reference hnswalg.h:1865): score the
    entry points and build the initial frontier and visited bitset. The
    entry scores come back as the first batch's W seed.

    Returns (seed_s, seed_i, c_s, c_ids, visited)."""
    e0 = entry_ids.shape[1]
    return _beam_init(queries, pack, n_rows, entry_ids, e0, fcap, metric)


def _fit_width(s, i, width: int):
    """Pad or best-first-truncate a (scores, ids) pair to `width` columns."""
    if s.shape[1] < width:
        pad = width - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    elif s.shape[1] > width:
        s, pos = _top_k(s, width)
        i = torch.gather(i, 1, pos)
    return s, i


def beam_search_resume(
    queries: torch.Tensor,      # f32[Q, D]
    pack: DataPack,
    links: torch.Tensor,        # i32[N, M]
    w_seed_s: torch.Tensor,     # f32[Q, S] scored-but-unreturned seeds
    w_seed_i: torch.Tensor,     # i32[Q, S] (entry points on the 1st batch)
    c_s: torch.Tensor,          # f32[Q, F] saved frontier (best-first)
    c_ids: torch.Tensor,        # i32[Q, F]
    visited: torch.Tensor,      # i32[Q, n_words] saved visited bitset
    ef: int, expand: int, max_iters: int, metric: VectorMetric,
):
    """Continue a streaming beam search (reference ContinueStreamingSearch,
    hnswalg.h:1945) from a saved frontier and visited bitset, collecting the
    next `ef` nearest nodes not visited yet; successive batches are disjoint
    by construction. The inputs are not modified.

    Returns (w_s, w_ids, c_s, c_ids, visited, iters)."""
    w_s, w_ids = _fit_width(w_seed_s, w_seed_i, ef)
    c_s, c_ids = _fit_width(c_s, c_ids, ef)
    return _beam_loop("resume", queries, pack, links,
                      (w_s, w_ids, c_s, c_ids, visited), ef, expand,
                      max_iters, metric)


def exact_rescore(queries: torch.Tensor, data: torch.Tensor,
                  data_sq: torch.Tensor, ids: torch.Tensor,
                  scores_in: torch.Tensor, metric: VectorMetric,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank quantized results exactly: gather the K returned rows of the
    fp32 `data` [N, D] for each query, score them exactly, sort best first.

    queries f32[Q, D]; data_sq f32[N] (|b|^2, read for L2 only); ids i32[Q,
    K] (-1 pad); scores_in f32[Q, K] (their quantized scores, read only to
    mask padding). Returns (scores f32[Q, K], ids i32[Q, K]), -inf / -1
    padded."""
    q = queries.to(torch.float32)
    valid = (ids >= 0) & (scores_in > NEG_INF)
    safe = torch.where(valid, ids, 0).to(torch.int64)
    s = _score_gathered(q, data[safe], data_sq[safe], metric)
    s = torch.where(valid, s, NEG_INF)
    s2, pos = torch.topk(s, s.shape[1], dim=1)
    ids2 = torch.gather(ids, 1, pos)
    ids2 = torch.where(s2 > NEG_INF, ids2, -1).to(torch.int32)
    return s2, ids2


def _descend_layer(queries, pack, links, cur, cur_s, hops: int,
                   metric: VectorMetric):
    """`hops` greedy hops on one layer for every query. Returns (cur, cur_s,
    moved): moved is a device bool, true when some query improved at the
    last hop (the JAX loop would have gone on)."""
    imp = None
    for _ in range(hops):
        nbrs = links[cur.long()]                          # [Q, m]
        v = nbrs >= 0
        s = _score_ids(queries, pack, torch.where(v, nbrs, 0), metric)
        s = s.masked_fill(~v, NEG_INF)
        best_s, best_pos = s.max(dim=1)
        best_i = torch.gather(nbrs, 1, best_pos[:, None])[:, 0]
        imp = best_s > cur_s
        cur = torch.where(imp, best_i, cur)
        cur_s = torch.where(imp, best_s, cur_s)
    return cur, cur_s, imp.any()


def _entry_scores(queries, pack, cur, metric: VectorMetric):
    v = cur >= 0
    return _score_ids(queries, pack, torch.where(v, cur, 0)[:, None],
                      metric)[:, 0].masked_fill(~v, NEG_INF)


def _descent_pass(queries, pack, links_stack, entry, hops: int,
                  metric: VectorMetric):
    """`hops` hops on each layer of links_stack from the entries. Returns
    (cur, cur_s, moved), moved a list of each layer's device flag."""
    cur, cur_s, moved = entry, _entry_scores(queries, pack, entry, metric), []
    for layer in range(links_stack.shape[0]):
        cur, cur_s, m = _descend_layer(queries, pack, links_stack[layer],
                                       cur, cur_s, hops, metric)
        moved.append(m)
    return cur, cur_s, moved


def _descend_from(queries, pack, links_stack, cur, cur_s, first: int,
                  hops: int, max_hops: int, metric: VectorMetric):
    """The descent's loop from layer `first` (greedy_descend)."""
    Lu = links_stack.shape[0]
    while first < Lu:
        starts, moved = [], []
        for layer in range(first, Lu):
            starts.append((cur, cur_s))
            cur, cur_s, m = _descend_layer(queries, pack, links_stack[layer],
                                           cur, cur_s, hops, metric)
            moved.append(m)
        if hops >= max_hops:
            break
        host_syncs.add()
        moved = tracing.device_read(torch.stack(moved), "hnsw.stop_read")
        if not moved.any():
            break
        j = int(moved.to(torch.int8).argmax())
        first += j
        cur, cur_s = starts[j]
        hops = min(2 * hops, max_hops)
    return cur


def _descend_graphed(queries, pack, links_stack, entry, hops: int,
                     read: bool, metric: VectorMetric):
    """The descent's first pass on the card, a replay of the device's
    cache entry for its key; with `read`, its moved flags read on the host.
    Returns (cur, moved or None)."""
    dev = queries.device
    ctx = _graph_ctx(dev)
    key = _graph_key("descent", _shapes(queries, entry) + (hops,), metric,
                     pack, links_stack)

    def build() -> _Entry:
        ins = [queries.clone(), entry.clone()]
        outs = [torch.empty_like(entry),
                torch.empty(links_stack.shape[0], dtype=torch.bool,
                            device=dev)]

        def run():
            cur, _, moved = _descent_pass(ins[0], pack, links_stack, ins[1],
                                          hops, metric)
            outs[0].copy_(cur)
            outs[1].copy_(torch.stack(moved))
        return _Entry((pack.data, pack.data_sq, pack.lo, pack.alpha,
                       links_stack), ins, outs, _graphs(ctx, dev, run))

    with ctx.lock:
        e = _entry(ctx, key, build)
        for dst, src in zip(e.ins, (queries, entry)):
            dst.copy_(src)
        e.graphs[0].replay()
        cur = e.outs[0].clone()
        if not read:
            return cur, None
        host_syncs.add()
        return cur, tracing.device_read(e.outs[1], "hnsw.stop_read")


def greedy_descend(
    queries: torch.Tensor,      # f32[Q, D]
    pack: DataPack,             # fp32 rows or SQ8 codes
    links_stack: torch.Tensor,  # i32[Lu, N, m] upper layers, TOP first
    entry: torch.Tensor,        # i32[Q]
    metric: VectorMetric, max_hops: int = 64,
) -> torch.Tensor:
    """Greedy descent through the upper layers (reference: the level > 0
    loop of searchKnn, hnswalg.h:1988). On each layer every query takes the
    best neighbor while it improves; the layer ends when no query improved
    at a hop, or after max_hops hops. Returns i32[Q] layer-0 entries.

    Each layer runs DESCENT_HOPS hops (hops after a query stopped leave it
    where it is), then one host read checks every layer; from the first
    layer where some query still moved, the descent runs again with twice
    the hops, up to max_hops, where the JAX loop stops anyway. On the card
    the first pass replays a graph of the device's cache; a pass again
    runs as it is, from where the first pass entered that layer."""
    hops = min(DESCENT_HOPS, max_hops)
    if queries.device.type != "cuda":
        return _descend_from(queries, pack, links_stack, entry,
                             _entry_scores(queries, pack, entry, metric), 0,
                             hops, max_hops, metric)
    if links_stack.shape[0] == 0:
        return entry
    cur, moved = _descend_graphed(queries, pack, links_stack, entry, hops,
                                  hops < max_hops, metric)
    if moved is None or not moved.any():
        return cur
    j = int(moved.to(torch.int8).argmax())
    cur, cur_s, _ = _descent_pass(queries, pack, links_stack[:j], entry,
                                  hops, metric)
    return _descend_from(queries, pack, links_stack, cur, cur_s, j,
                         min(2 * hops, max_hops), max_hops, metric)


def heuristic_select(
    cand_ids: torch.Tensor,     # i32[B, C] sorted best-first (-1 pad)
    cand_scores: torch.Tensor,  # f32[B, C] higher-better scores to the query
    cand_vecs: torch.Tensor,    # f32[B, C, D]
    m: int, metric: VectorMetric,
) -> torch.Tensor:
    """Batched neighbor-selection heuristic (reference:
    getNeighborsByHeuristic2, hnswalg.h:978): walk the candidates
    best-first, keep one iff it is closer to the query than to every
    candidate kept before it. Returns i32[B, m] kept ids (-1 pad).

    The JAX `lax.scan` over the C candidates is a loop of C steps with no
    host sync."""
    B, C = cand_ids.shape
    dots = torch.einsum("bcd,bed->bce", cand_vecs, cand_vecs)
    if metric == VectorMetric.L2:
        sq = (cand_vecs * cand_vecs).sum(dim=2)
        pair = 2.0 * dots - sq[:, :, None] - sq[:, None, :]
    else:
        pair = dots
    # beats[b, i, j]: candidate j, if kept, rules candidate i out
    beats = pair > cand_scores[:, :, None]
    valid = cand_ids >= 0
    kept = torch.zeros((B, C), dtype=torch.bool, device=cand_ids.device)
    kept_cnt = torch.zeros((B,), dtype=torch.int32, device=cand_ids.device)
    for i in range(C):
        conflict = (kept & beats[:, i, :]).any(dim=1)
        take = valid[:, i] & ~conflict & (kept_cnt < m)
        kept[:, i] = take
        kept_cnt += take.to(torch.int32)
    # compact the kept ids to the left, best first
    key = torch.where(kept, -cand_scores, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)[:, :m]
    sel = torch.gather(cand_ids, 1, order)
    return torch.where(torch.gather(kept, 1, order), sel, -1)


def _sorted_candidates(all_s, all_i):
    """Candidates best-first, -inf / -1 where there is none."""
    all_s = torch.where(all_i >= 0, all_s, NEG_INF)
    srt_s, pos = _top_k(all_s, all_s.shape[1])
    srt_i = torch.gather(all_i, 1, pos)
    return srt_s, torch.where(srt_s > NEG_INF, srt_i, -1)


def insert_layer(
    queries: torch.Tensor,             # f32[Q, D] new points
    pack: DataPack,                    # vector storage (fp32 during build)
    links: torch.Tensor,               # i32[N, M] this layer
    entry_ids: torch.Tensor,           # i32[Q]
    cand_extra_ids: torch.Tensor,      # i32[Q, KC] chunk-internal cands
    cand_extra_scores: torch.Tensor,   # f32[Q, KC]
    ef: int, expand: int, max_iters: int, m: int, metric: VectorMetric,
):
    """One insertion step for a batch on one layer: efC beam search, merge
    of the batch-internal candidates, neighbor-selection heuristic (the
    analog of the reference's per-point addPoint, hnswalg.h:1402).

    Returns (selected i32[Q, m] best-first (-1 pad), next_entries i32[Q])."""
    bs, bi, it = beam_search_layer(queries, pack, links, entry_ids[:, None],
                                   ef, expand, max_iters, metric)
    beam_steps.add(int(it))
    next_ents = torch.where(bi[:, 0] >= 0, bi[:, 0], entry_ids)
    srt_s, srt_i = _sorted_candidates(
        torch.cat([bs, cand_extra_scores], dim=1),
        torch.cat([bi, cand_extra_ids.to(torch.int32)], dim=1))
    safe = torch.where(srt_i >= 0, srt_i, 0).long()
    if pack.quantized:
        cand_vecs = (pack.lo[None, None, :] + pack.alpha[None, None, :]
                     * pack.data[safe].to(torch.float32))
    else:
        cand_vecs = pack.data[safe]
    return heuristic_select(srt_i, srt_s, cand_vecs, m, metric), next_ents


def exact_build_layer(
    queries: torch.Tensor,      # f32[Q, D] new points (zero rows = pad)
    pack: DataPack,             # fp32 vector storage
    levels_d: torch.Tensor,     # i32[N] per-row level (-1 = not in graph)
    deleted_d: torch.Tensor,    # bool[N]
    lc: int,                    # the layer being connected
    row_arr: torch.Tensor,      # i64[Q] row id per chunk member (-1 pad)
    q_lvl_ok: torch.Tensor,     # bool[Q] member eligible at this layer
    k: int, kc: int, m: int, metric: VectorMetric,
    use_heuristic: bool = True,
) -> torch.Tensor:
    """Exact-candidate batched insertion for one layer: the efConstruction
    candidates of each new point are an exact top-k scan of the layer's
    current population (ops/distance.knn_scan, the plain chunked scan) in
    place of the reference's graph walk (addPoint's searchBaseLayer,
    hnswalg.h:1402), plus the top-kc of the chunk's own members; the
    neighbor heuristic then prunes them to m.

    Returns sel i32[Q, m] (-1 pad), best-first."""
    from .distance import knn_scan

    qf = queries.to(torch.float32)
    Q = qf.shape[0]
    valid_l = (levels_d >= lc) & ~deleted_d
    bs, bi = knn_scan(qf, pack.data, valid_l, pack.data_sq, k, metric)
    if kc > 0:
        dots = qf @ qf.T
        if metric == VectorMetric.L2:
            sq = (qf * qf).sum(dim=1)
            cs = 2.0 * dots - sq[None, :] - sq[:, None]
        else:
            cs = dots
        eye = torch.eye(Q, dtype=torch.bool, device=qf.device)
        bad = eye | ~q_lvl_ok[None, :] | (row_arr < 0)[None, :]
        cm_sc, nn = _top_k(cs.masked_fill(bad, NEG_INF), kc)
        cm_ids = torch.where(cm_sc > NEG_INF, row_arr[nn], -1)
        srt_s, srt_i = _sorted_candidates(
            torch.cat([bs, cm_sc], dim=1),
            torch.cat([bi, cm_ids.to(torch.int32)], dim=1))
    else:
        srt_s, srt_i = _sorted_candidates(bs, bi)
    if not use_heuristic:
        # ablation (RX_HNSW_NO_HEURISTIC=1): the plain top-m, no diversity
        # pruning
        return srt_i[:, :m]
    safe = torch.where(srt_i >= 0, srt_i, 0).long()
    return heuristic_select(srt_i, srt_s, pack.data[safe], m, metric)
