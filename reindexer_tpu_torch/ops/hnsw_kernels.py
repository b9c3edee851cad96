"""HNSW graph-search device ops in PyTorch (port of
reindexer_tpu/ops/hnsw_kernels.py): batched beam search, greedy descent,
the neighbor-selection heuristic and the exact-candidate build step.

The JAX module is plain jitted XLA, with no Pallas kernel. On the card the
beam search and the greedy descent are hand-written kernels
(`csrc/hnsw_beam.cu`): K7 and, beside it, the descent, which scores a row
with K7's code; the rest is ordinary PyTorch. Scores are "higher is
better" (L2 negated), as in ops/distance.py.

What the port keeps, and how:

  - The batch-wide stop. The JAX beam is one device program, a
    `lax.while_loop` whose body runs for every query of the batch while any
    query is active and `it < max_iters`. On the card K7 runs that whole
    loop in one launch: after each step its blocks vote on the stop across
    the grid, and it writes `it` beside the results, so the host reads no
    stop flag. On the CPU the plain twin (_beam_plain) is that loop written
    out, its condition read on the host before each step. `it` is the JAX
    loop's count exactly, on both.
  - Greedy descent per layer stops, as in JAX, when no query of the batch
    improved at a hop or after max_hops hops. The card's kernel stops each
    query at its own first hop without a move, which gives the same
    entries: a query that did not improve finds the same links at the next
    hop. The plain twin (_descend_plain) is the JAX loop written out.
  - Ties. `lax.top_k` ranks equal values by the lower index first, and
    `jnp.argsort` is stable; here both are a stable sort (`_top_k`,
    `torch.argsort(stable=True)`), and K7 places equal scores in the order
    of that sort. A descent hop takes the lowest link slot among equal
    best scores (`jnp.argmax`, `torch.max`, the kernel alike).
  - The visited bitset is int32 words (torch has little uint32): bit 31 is
    INT_MIN, and as the bits one step adds are distinct and unset,
    `scatter_add_` is a bitwise OR with no overflow. Its bits equal the JAX
    uint32 words' through a numpy view.

`beam_steps` counts the beam iterations (the JAX loop's `iters`, summed):
the beam returns `it` beside its results, and its caller adds it once the
copy of its results reaches the host. `kernels.hnsw_beam` and
`kernels.hnsw_descend` count the two kernels' launches, one each a search
on the card. While tracing is on, each host read of a plain loop's
condition is an `hnsw.stop_read` span.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .. import tracing
from ..core.type_consts import VectorMetric
from .scan import _cuda_or_cpu

NEG_INF = float("-inf")
_F32_LOWEST = float(torch.finfo(torch.float32).min)


# beam iterations run (the JAX loop's iters)
beam_steps = tracing.counter("hnsw.beam_steps")
# registered only, never added to: h100bench's hnsw_captures_per_dispatch
# probes it, and a probe that finds no counter fails the run
graph_captures = tracing.counter("hnsw.graph_captures")
# K7 launches: one a beam search on the card
hnsw_beam_launches = tracing.counter("kernels.hnsw_beam")
# descent kernel launches: one a greedy descent on the card
hnsw_descend_launches = tracing.counter("kernels.hnsw_descend")


def _capture() -> None:
    """Never called: h100bench's `graph_capture` span probe wraps this
    name (its readers leave captures out of the window), and a probe that
    finds no target fails the run."""


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


def _active(w_s, c_s, ef: int) -> torch.Tensor:
    """The JAX loop's condition on the state, as a device bool: some
    query's best frontier node can still improve its worst result (a
    finite one: an empty frontier's -inf beats nothing)."""
    c_best = c_s[:, 0]
    return (c_best >= w_s[:, ef - 1].clamp_min(_F32_LOWEST)).any()


def _beam_step(queries, pack, links, w_s, w_ids, c_s, c_ids, visited, pop,
               earlier, expand: int, metric: VectorMetric):
    """One iteration of the JAX loop's body for every query. Updates
    `visited` in place. W and C have the same width ef, sorted best-first
    with -1 ids at -inf. pop: bool[1, ef], the `expand` head columns;
    earlier: bool[K, K], i < j."""
    Q = queries.shape[0]
    K = earlier.shape[0]            # gathered candidates per query
    ef = w_s.shape[1]
    # pop the best `expand` frontier entries (the frontier is sorted)
    head = c_s[:, :expand] > NEG_INF
    sel_ids = torch.where(head, c_ids[:, :expand], 0)
    nbrs = links[sel_ids.long()]                      # [Q, expand, M]
    nbrs = torch.where(head[:, :, None], nbrs, -1).reshape(Q, K)

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
    ms = torch.cat([torch.stack([w_s, c_s.masked_fill(pop, NEG_INF)]),
                    scores.expand(2, Q, K)], dim=2)
    mi = torch.cat([torch.stack([w_ids, c_ids.masked_fill(pop, -1)]),
                    new_ids.expand(2, Q, K)], dim=2)
    s2, pos = torch.sort(ms, dim=2, descending=True, stable=True)
    s2 = s2[:, :, :ef]
    i2 = torch.gather(mi, 2, pos[:, :, :ef])
    i2 = torch.where(s2 > NEG_INF, i2, -1)
    return s2[0], i2[0], s2[1], i2[1]


def _beam_plain(kind: str, queries, pack, links, inputs: tuple, ef: int,
                expand: int, max_iters: int, metric: VectorMetric):
    """K7's plain twin: the JAX loop written out. The state starts from the
    entry ids ("layer") or from copies of W and C, both ef wide, and the
    visited bitset ("resume"); then, while `it < max_iters` and the loop's
    condition holds (read on the host), one step. Returns (w_s, w_ids, c_s,
    c_ids, visited, it), `it` an int32 tensor; the inputs are not
    modified."""
    dev = queries.device
    K = expand * links.shape[1]
    pop = torch.zeros((1, ef), dtype=torch.bool, device=dev)
    pop[:, :expand] = True
    earlier = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
    if kind == "layer":
        w_s, w_ids, c_s, c_ids, visited = _beam_init(
            queries, pack, links.shape[0], inputs[0], ef, ef, metric)
    else:
        w_s, w_ids, c_s, c_ids, visited = (x.clone() for x in inputs)
    it = 0
    while it < max_iters and tracing.device_read(_active(w_s, c_s, ef),
                                                 "hnsw.stop_read"):
        w_s, w_ids, c_s, c_ids = _beam_step(
            queries, pack, links, w_s, w_ids, c_s, c_ids, visited, pop,
            earlier, expand, metric)
        it += 1
    return (w_s, w_ids, c_s, c_ids, visited,
            torch.tensor(it, dtype=torch.int32, device=dev))


def _check_graph_inputs(name: str, queries, pack, links) -> None:
    """Raise unless the kernels take these dtypes and shapes."""
    code_type = torch.uint8 if pack.quantized else torch.float32
    if (queries.dtype != torch.float32 or pack.data.dtype != code_type
            or pack.data.shape[1:] != queries.shape[1:]
            or links.dtype != torch.int32):
        raise ValueError(
            f"{name} expects f32 queries [Q, D], {code_type} rows [N, D] "
            f"and i32 links, got {queries.dtype} {tuple(queries.shape)}, "
            f"{pack.data.dtype} {tuple(pack.data.shape)}, {links.dtype}")


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
    _check_graph_inputs("hnsw_beam", queries, pack, links)
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
    the plain twin."""
    if _cuda_or_cpu("hnsw_beam", queries.device):
        return hnsw_beam(kind, queries, pack, links, inputs, ef, expand,
                         max_iters, metric)
    return _beam_plain(kind, queries, pack, links, inputs, ef, expand,
                       max_iters, metric)


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


def _descend_hop(queries, pack, links, cur, cur_s, metric: VectorMetric):
    """One greedy hop on one layer for every query: the JAX loop's body.
    Returns (cur, cur_s, imp), imp: bool[Q], the queries that moved."""
    nbrs = links[cur.long()]                              # [Q, m]
    v = nbrs >= 0
    s = _score_ids(queries, pack, torch.where(v, nbrs, 0), metric)
    s = s.masked_fill(~v, NEG_INF)
    best_s, best_pos = s.max(dim=1)
    best_i = torch.gather(nbrs, 1, best_pos[:, None])[:, 0]
    imp = best_s > cur_s
    return (torch.where(imp, best_i, cur), torch.where(imp, best_s, cur_s),
            imp)


def _entry_scores(queries, pack, cur, metric: VectorMetric):
    v = cur >= 0
    return _score_ids(queries, pack, torch.where(v, cur, 0)[:, None],
                      metric)[:, 0].masked_fill(~v, NEG_INF)


def _descend_plain(queries, pack, links_stack, entry, max_hops: int,
                   metric: VectorMetric) -> torch.Tensor:
    """The descent kernel's plain twin: the JAX loop written out. On each
    layer, up to max_hops hops, until a hop moves no query (read on the
    host)."""
    cur, cur_s = entry, _entry_scores(queries, pack, entry, metric)
    for links in links_stack:
        for _ in range(max_hops):
            cur, cur_s, imp = _descend_hop(queries, pack, links, cur, cur_s,
                                           metric)
            if not tracing.device_read(imp.any(), "hnsw.stop_read"):
                break
    return cur


def hnsw_descend(queries, pack, links_stack, entry, max_hops: int,
                 metric: VectorMetric) -> torch.Tensor:
    """The descent kernel (`csrc/hnsw_beam.cu`, beside K7): the whole
    greedy descent in one launch on the card, each query stopping at its
    own first hop without a move. Returns i32[Q]; entry: i32[Q] valid
    rows."""
    dev = queries.device
    n_q, d = queries.shape
    n_layers, n_rows, m = links_stack.shape
    lib = _build.load("hnsw_beam")
    _check_graph_inputs("hnsw_descend", queries, pack, links_stack)
    if entry.shape != (n_q,):
        raise ValueError(f"hnsw_descend takes entries [{n_q}], got "
                         f"{tuple(entry.shape)}")
    out = torch.empty(n_q, dtype=torch.int32, device=dev)
    n_spill = lib.hnsw_descend_spill_bytes(n_q, d, m)
    spill = (torch.empty(n_spill, dtype=torch.uint8, device=dev)
             if n_spill else None)
    # contiguous, and held here until the launch is queued
    args = [None if t is None else t.contiguous() for t in (
        queries, pack.data, pack.data_sq, pack.lo, pack.alpha, links_stack,
        entry.to(torch.int32), out, spill)]
    with torch.cuda.device(dev):
        code = lib.hnsw_descend_launch(
            *(None if t is None else t.data_ptr() for t in args), n_q, d, m,
            n_layers, n_rows, max_hops, int(metric == VectorMetric.L2),
            int(pack.quantized), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "hnsw_beam", code)
    hnsw_descend_launches.add()
    return out


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
    at a hop, or after max_hops hops. Returns i32[Q] layer-0 entries. On
    the card it is the descent kernel, one launch; on the CPU the plain
    twin."""
    if _cuda_or_cpu("hnsw_descend", queries.device):
        return hnsw_descend(queries, pack, links_stack, entry, max_hops,
                            metric)
    return _descend_plain(queries, pack, links_stack, entry, max_hops,
                          metric)


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
