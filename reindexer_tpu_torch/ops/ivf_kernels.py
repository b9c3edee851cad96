"""IVF device ops (port of reindexer_tpu/ops/ivf_kernels.py).

Plain PyTorch, as the JAX versions are plain XLA:
  kmeans_l2 / assign_lists     Lloyd training and nearest-centroid assignment
  probe_centroids              stage 1 on the device: top-nprobe centroids
  expand_probes +              the gather route of stage 2: probed inverted
  scan_lists_batch             lists expanded to candidate rows and scored
  scan_reordered_masked        the masked sweep: every row of the
                               list-contiguous reorder, masked per 128-row
                               block by the probe set
  segment_topk                 folds segment scores to per-query top-k

K6 `ivf_seg_scan` (kernel source csrc/ivf_seg_scan.cu; port of
ivf_kernels.py::scan_segments, the one Pallas kernel of the IVF engine):
scores exactly the probed 128-row blocks of the reorder,

    out[i, r] = max(2 q.b_r - |b_r|^2 (L2) or q.b_r, -1e30)   r < counts[i]
    out[i, r] = -1e30                                         otherwise

with b_r row r of block starts[i] and q row qids[i] of the queries.
`scan_segments` launches K6 for CUDA tensors and runs `scan_segments_plain`
for CPU tensors; any other device raises. `seg_scan_launches` counts the
kernel's launches only. Scores are "higher is better"; the rank-invariant
-|q|^2 of L2 is added by segment_topk.
"""
from __future__ import annotations

import torch

from reindexer_tpu.core.type_consts import VectorMetric

from . import _build
from .scan import SENT, SENT_HALF, _cuda_or_cpu

SEG_BLK = 128          # rows per segment block (list starts align to this)
NEG_INF = float("-inf")

seg_scan_launches = _build.Counter()     # K6 ivf_seg_scan


def _l2_scores(dots: torch.Tensor, base_sq: torch.Tensor,
               q_sq: torch.Tensor) -> torch.Tensor:
    return 2.0 * dots - base_sq - q_sq


def kmeans_l2(train: torch.Tensor, init_centroids: torch.Tensor,
              iters: int) -> torch.Tensor:
    """Lloyd iterations with L2 assignment. train f32[T, D], init f32[K, D]
    -> centroids f32[K, D]. Ties go to the lowest centroid; an empty
    cluster keeps its previous centroid."""
    cent = init_centroids.to(torch.float32)
    n_c = cent.shape[0]
    ones = torch.ones(train.shape[0], dtype=torch.float32,
                      device=train.device)
    for _ in range(iters):
        c_sq = (cent * cent).sum(dim=1)
        assign = torch.argmax(2.0 * (train @ cent.T) - c_sq[None, :], dim=1)
        sums = torch.zeros_like(cent).index_add_(0, assign, train)
        counts = torch.zeros(n_c, dtype=torch.float32,
                             device=train.device).index_add_(0, assign, ones)
        new = sums / counts.clamp_min(1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent


def _centroid_scores(x: torch.Tensor, centroids: torch.Tensor,
                     metric: VectorMetric) -> torch.Tensor:
    dots = x @ centroids.T
    if metric == VectorMetric.L2:
        return 2.0 * dots - (centroids * centroids).sum(dim=1)[None, :]
    return dots


def assign_lists(vecs: torch.Tensor, centroids: torch.Tensor,
                 metric: VectorMetric, chunk: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment of vecs f32[N, D] -> i32[N], in chunks of
    `chunk` rows so the [N, nlist] score matrix is never whole."""
    out = torch.empty(vecs.shape[0], dtype=torch.int32, device=vecs.device)
    for start in range(0, vecs.shape[0], chunk):
        s = _centroid_scores(vecs[start:start + chunk], centroids, metric)
        out[start:start + chunk] = torch.argmax(s, dim=1).to(torch.int32)
    return out


def probe_centroids(queries: torch.Tensor, centroids: torch.Tensor,
                    nprobe: int, metric: VectorMetric) -> torch.Tensor:
    """Stage 1: the top-nprobe centroid ids per query, i32[Q, nprobe]."""
    s = _centroid_scores(queries, centroids, metric)
    _, idx = torch.topk(s, min(nprobe, centroids.shape[0]), dim=1)
    return idx.to(torch.int32)


def expand_probes(probes: torch.Tensor, list_start: torch.Tensor,
                  list_rows: torch.Tensor, cmax: int,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the probed inverted lists' CSR ranges on the device.

    probes i32[B, P] centroid ids; list_start int[nlist + 1]; list_rows
    i32[>= rows]. Returns (cand i32[B, cmax], ok bool[B, cmax]): each slot
    finds its probe by a search over the per-probe cumulative lengths."""
    p = probes.to(torch.int64)
    ls = list_start.to(torch.int64)
    starts = ls[p]
    lens = ls[p + 1] - starts
    cum = torch.cumsum(lens, dim=1)
    prev = cum - lens
    n_b, n_p = p.shape
    pos = torch.arange(cmax, dtype=torch.int64,
                       device=p.device)[None, :].expand(n_b, cmax).contiguous()
    j = torch.searchsorted(cum, pos, right=True).clamp_max(n_p - 1)
    src = starts.gather(1, j) + pos - prev.gather(1, j)
    ok = pos < cum[:, -1:]
    src = torch.where(ok, src, 0)
    return list_rows[src].to(torch.int32), ok


def scan_lists_batch(queries: torch.Tensor, data: torch.Tensor,
                     data_sq: torch.Tensor, valid: torch.Tensor,
                     cand: torch.Tensor, cand_ok: torch.Tensor, k: int,
                     metric: VectorMetric, chunk: int = 65536,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather route of stage 2: queries f32[B, D]; cand i32[B, C] rows
    of data f32[N, D]; cand_ok bool[B, C]; data_sq f32[N] (read for L2);
    valid bool[N]. Returns (scores f32[B, kk], ids i32[B, kk]), best first,
    -inf / -1 padded, kk = min(k, C) (min(k, chunk) above `chunk`
    candidates, which are scanned `chunk` at a time with a running top-k,
    so the [B, C, D] gather never holds more than [B, chunk, D])."""
    q_sq = (queries * queries).sum(dim=1, keepdim=True)

    def score_block(cnd, okm):
        c = cnd.to(torch.int64)
        dots = torch.einsum("bd,bcd->bc", queries, data[c])
        s = (_l2_scores(dots, data_sq[c], q_sq)
             if metric == VectorMetric.L2 else dots)
        return s.masked_fill(~(okm & valid[c]), NEG_INF)

    def top(cnd, okm, kk):
        s, pos = torch.topk(score_block(cnd, okm), min(kk, cnd.shape[1]),
                            dim=1)
        return s, torch.where(s > NEG_INF, cnd.gather(1, pos), -1)

    n_b, n_c = cand.shape
    if n_c <= chunk:
        s, i = top(cand, cand_ok, k)
        return s, i.to(torch.int32)
    kk = min(k, chunk)
    best_s = torch.full((n_b, kk), NEG_INF, device=queries.device)
    best_i = torch.full((n_b, kk), -1, dtype=torch.int32,
                        device=queries.device)
    for lo in range(0, n_c, chunk):
        loc_s, loc_i = top(cand[:, lo:lo + chunk], cand_ok[:, lo:lo + chunk],
                           kk)
        best_s, sel = torch.topk(torch.cat([best_s, loc_s], dim=1), kk, dim=1)
        best_i = torch.cat([best_i, loc_i.to(torch.int32)], dim=1).gather(
            1, sel)
    return best_s, best_i


def scan_reordered_masked(queries: torch.Tensor, reordered: torch.Tensor,
                          reordered_sq: torch.Tensor, perm: torch.Tensor,
                          bmask: torch.Tensor, k: int, metric: VectorMetric,
                          chunk: int = 262144,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The masked sweep over the list-contiguous reorder: every row is
    scored by a chunked matmul and masked by the per-block probe table.

    queries f32[B, D]; reordered f32[Npad, D] (pad rows zero);
    reordered_sq f32[Npad] (read for L2); perm i32[Npad] (original row, -1
    on padding); bmask bool[B, Npad / 128]. Returns (scores f32[B, k], ids
    i32[B, k]) with original row ids, best first, -inf / -1 padded."""
    q = queries.to(torch.float32)
    n_b = q.shape[0]
    npad = reordered.shape[0]
    nc = max(npad // chunk, 1)
    csz = npad // nc
    nbc = csz // SEG_BLK
    kk = min(k, csz)
    q_sq = (q * q).sum(dim=1, keepdim=True)
    best_s = torch.full((n_b, kk), NEG_INF, device=q.device)
    best_i = torch.full((n_b, kk), -1, dtype=torch.int64, device=q.device)
    for c in range(nc):
        lo, hi = c * csz, (c + 1) * csz
        dots = q @ reordered[lo:hi].T
        s = (_l2_scores(dots, reordered_sq[None, lo:hi], q_sq)
             if metric == VectorMetric.L2 else dots)
        ok = (bmask[:, c * nbc:(c + 1) * nbc].repeat_interleave(SEG_BLK, 1)
              & (perm[None, lo:hi] >= 0))
        loc_s, loc_pos = torch.topk(s.masked_fill(~ok, NEG_INF), kk, dim=1)
        best_s, sel = torch.topk(torch.cat([best_s, loc_s], dim=1), kk, dim=1)
        best_i = torch.cat([best_i, loc_pos + lo], dim=1).gather(1, sel)
    ids = perm[best_i.clamp_min(0)]
    ids = torch.where((best_i >= 0) & (best_s > SENT_HALF), ids, -1)
    best_s = torch.where(ids >= 0, best_s, NEG_INF)
    return _pad_k(best_s, ids.to(torch.int32), k)


def _pad_k(s: torch.Tensor, i: torch.Tensor, k: int,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    if s.shape[1] < k:
        pad = k - s.shape[1]
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    return s, i


def _check_segments(starts: torch.Tensor, qids: torch.Tensor,
                    counts: torch.Tensor, queries: torch.Tensor,
                    reordered: torch.Tensor) -> None:
    """Shapes, dtypes and devices of K6's operands."""
    nseg = starts.shape[0] if starts.dim() == 1 else -1
    for name, x in (("starts", starts), ("qids", qids), ("counts", counts)):
        if x.dim() != 1 or x.shape[0] != nseg or x.dtype != torch.int32:
            raise ValueError(f"ivf_seg_scan expects starts, qids and counts "
                             f"i32[NSEG], got {name} {x.dtype} "
                             f"{tuple(x.shape)}")
    if (queries.dim() != 2 or reordered.dim() != 2
            or queries.shape[1] != reordered.shape[1]
            or reordered.shape[0] % SEG_BLK):
        raise ValueError(f"ivf_seg_scan expects queries [B, D] and reordered "
                         f"[Npad, D] with Npad % {SEG_BLK} == 0, got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(reordered.shape)}")
    for name, x in (("queries", queries), ("reordered", reordered),
                    ("starts", starts), ("qids", qids), ("counts", counts)):
        if x.device != reordered.device:
            raise ValueError(f"ivf_seg_scan: {name} is on {x.device}, "
                             f"reordered on {reordered.device}")
    for name, x in (("queries", queries), ("reordered", reordered)):
        if x.dtype != torch.float32:
            raise ValueError(f"ivf_seg_scan: {name} must be float32, got "
                             f"{x.dtype}")


def scan_segments_plain(starts: torch.Tensor, qids: torch.Tensor,
                        counts: torch.Tensor, queries: torch.Tensor,
                        reordered: torch.Tensor, metric: VectorMetric,
                        chunk: int = 2048) -> torch.Tensor:
    """Plain PyTorch K6: a gather of the blocks and a batched dot, `chunk`
    segments at a time so the gathered [chunk, 128, D] tiles stay bounded.
    Returns f32[NSEG, 128]."""
    d = reordered.shape[1]
    blocks = reordered.view(-1, SEG_BLK, d)
    rows = torch.arange(SEG_BLK, device=reordered.device)
    out = torch.empty((starts.shape[0], SEG_BLK), dtype=torch.float32,
                      device=reordered.device)
    for lo in range(0, starts.shape[0], chunk):
        hi = lo + chunk
        tiles = blocks[starts[lo:hi].to(torch.int64)]          # [S, 128, D]
        dots = torch.einsum("srd,sd->sr", tiles,
                            queries[qids[lo:hi].to(torch.int64)])
        s = (2.0 * dots - (tiles * tiles).sum(dim=2)
             if metric == VectorMetric.L2 else dots)
        live = rows[None, :] < counts[lo:hi, None]
        out[lo:hi] = torch.where(live, s.clamp_min(SENT), SENT)
    return out


def scan_segments(starts: torch.Tensor, qids: torch.Tensor,
                  counts: torch.Tensor, queries: torch.Tensor,
                  reordered: torch.Tensor, metric: VectorMetric,
                  ) -> torch.Tensor:
    """K6: scores f32[NSEG, 128] of the probed segments. starts i32[NSEG] =
    block index (row / 128) into reordered f32[Npad, D]; qids i32[NSEG] =
    query row per segment; counts i32[NSEG] = valid rows of each block (0 on
    a padding segment); queries f32[B, D]; all on one device."""
    _check_segments(starts, qids, counts, queries, reordered)
    if not _cuda_or_cpu("ivf_seg_scan", reordered.device):
        return scan_segments_plain(starts, qids, counts, queries, reordered,
                                   metric)
    nseg = starts.shape[0]
    out = torch.empty((nseg, SEG_BLK), dtype=torch.float32,
                      device=reordered.device)
    starts, qids, counts = (starts.contiguous(), qids.contiguous(),
                            counts.contiguous())
    queries, reordered = queries.contiguous(), reordered.contiguous()
    lib = _build.load("ivf_seg_scan")
    with torch.cuda.device(reordered.device):
        code = lib.ivf_seg_scan_launch(
            starts.data_ptr(), qids.data_ptr(), counts.data_ptr(),
            queries.data_ptr(), reordered.data_ptr(), out.data_ptr(), nseg,
            reordered.shape[0] // SEG_BLK, queries.shape[0],
            reordered.shape[1], int(metric == VectorMetric.L2),
            torch.cuda.current_stream(reordered.device).cuda_stream)
    _build.check_launch(lib, "ivf_seg_scan", code)
    seg_scan_launches.add()
    return out


def segment_topk(seg_scores: torch.Tensor, starts: torch.Tensor,
                 perm: torch.Tensor, queries: torch.Tensor, k: int,
                 metric: VectorMetric) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold seg_scores f32[B * S_q, 128] (query-major, S_q segments per
    query) to the per-query top-k with original row ids. starts as in
    scan_segments; perm i32[Npad] maps a reordered row to its original row
    (-1 on padding). Returns (scores f32[B, k], ids i32[B, k]), -inf / -1
    padded."""
    n_b = queries.shape[0]
    s_q = seg_scores.shape[0] // n_b
    width = s_q * SEG_BLK
    top_s, top_p = torch.topk(seg_scores.reshape(n_b, width), min(k, width),
                              dim=1)
    seg_of = (top_p // SEG_BLK
              + (torch.arange(n_b, device=top_p.device) * s_q)[:, None])
    pos = starts.to(torch.int64)[seg_of] * SEG_BLK + top_p % SEG_BLK
    ids = perm[pos]
    if metric == VectorMetric.L2:
        top_s = top_s - (queries * queries).sum(dim=1, keepdim=True)
    ids = torch.where(top_s > SENT_HALF, ids, -1)
    top_s = torch.where(ids >= 0, top_s, NEG_INF)
    return _pad_k(top_s, ids.to(torch.int32), k)
