"""The selection kernels and the scans composed from the kernels.

K2 `bf_select`: exact top-k from a scan's scores and block maxima (port of
reindexer_tpu/ops/pallas_select.py::select_sweep and the selection phase of
::onesweep_select / ::pipelined_select; kernel source csrc/bf_select.cu).

K4 `sq8_select`: exact top-k from K3's quantized block maxima, scoring the
admitted blocks' rows from the fp32 base (port of
pallas_select.py::twinsweep_select_sq8; kernel source csrc/sq8_select.cu).

Selection contract, per query:
  tau   = kk-th largest block max among valid blocks (bmax > -5e29), minus
          eps[q]; -inf when fewer than kk blocks are valid. K2: kk = k, as
          its bmax holds the very scores it gathers. K4: kk = min(k + 4, G),
          MARGIN = 4 blocks absorbing the rounding between the codes product
          (bmax) and the fp32 product (scores);
  admit = valid blocks with bmax >= tau (a superset of the true top-k);
  flag  = 1 when more than S_SLOTS = 128 blocks are admitted (mass ties, or
          an eps too wide for the data): the result is then unspecified and
          the caller reruns the query;
  out   = top k of the admitted blocks' scores, best first; scores
          <= -5e29 come out as -inf / -1.

The composed scans, each over groups of <= 64 queries:
  knn_scan_fused       K1 + K2, exact fp32 (replaces knn_scan_fused_v2/v3/v4)
  knn_scan_sq8         K3 (bmax only) + K4, exact at SQ8 threshold cost, eps
                       by the cert or fast bound (knn_scan_sq8_v2/v3)
  knn_scan_fused_sq8   K3 (S) + K2, top-k of the fp32 x codes scores
                       (pallas_scan.py::knn_scan_fused_sq8)
  knn_scan_approx_sq8  K5 + K2, top-k of the int8 x int8 scores
                       (knn_scan_approx_sq8_v4)

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version (`*_plain`) for CPU tensors; any other device raises.
`launches` (K2) and `sq8_select_launches` (K4) count kernel launches only.
"""
from __future__ import annotations

import torch

from reindexer_tpu.core.type_consts import VectorMetric

from . import _build
from .scan import (BLK, SENT_HALF, _cuda_or_cpu, bf_scan, score_factor,
                   sq8_i8_scan, sq8_scan)

S_SLOTS = 128          # admitted-block capacity; also the largest k
MARGIN = 4             # K4's extra blocks: the largest k there is 124
GROUP = 64             # queries per scan + select pair (bounds S to 64 x N)
FAST_EPS_SIGMA = 12.0  # tail multiplier of the "fast" eps bound

launches = _build.Counter()              # K2 bf_select
sq8_select_launches = _build.Counter()   # K4 sq8_select


def _topk_of_admitted(cand: torch.Tensor, k: int,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of cand f32[Q, N] (-inf outside the admitted blocks), scores
    <= -5e29 as -inf / -1, padded to k columns."""
    neg_inf = float("-inf")
    top_s, top_i = torch.topk(cand, min(k, cand.shape[1]), dim=1)
    ok = top_s > SENT_HALF
    top_s = torch.where(ok, top_s, neg_inf)
    top_i = torch.where(ok, top_i, -1).to(torch.int32)
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=neg_inf)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, top_i


def bf_select_plain(s: torch.Tensor, bmax: torch.Tensor, eps: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: (scores f32[Q, k], ids i32[Q, k], flag f32[Q])."""
    n_q, n = s.shape
    n_blocks = bmax.shape[1]
    valid = bmax > SENT_HALF
    neg_inf = torch.tensor(float("-inf"), device=s.device)
    kth = torch.topk(torch.where(valid, bmax, neg_inf), min(k, n_blocks),
                     dim=1).values[:, -1]
    tau = torch.where(valid.sum(dim=1) >= k, kth - eps, neg_inf)
    admit = valid & (bmax >= tau[:, None])
    flag = (admit.sum(dim=1) > S_SLOTS).to(torch.float32)
    cand = torch.where(admit[:, :, None], s.view(n_q, n_blocks, BLK),
                       neg_inf).view(n_q, n)
    return (*_topk_of_admitted(cand, k), flag)


def _check(s: torch.Tensor, bmax: torch.Tensor, eps: torch.Tensor,
           k: int) -> None:
    n_q, n = s.shape
    if n % BLK or bmax.shape != (n_q, n // BLK) or eps.shape != (n_q,):
        raise ValueError(f"bf_select expects S [Q, N], bmax [Q, N/{BLK}], "
                         f"eps [Q], got {tuple(s.shape)}, "
                         f"{tuple(bmax.shape)}, {tuple(eps.shape)}")
    if not 1 <= k <= S_SLOTS:
        raise ValueError(f"bf_select takes 1 <= k <= {S_SLOTS}, got {k}")
    for name, x in (("S", s), ("bmax", bmax), ("eps", eps)):
        if x.dtype != torch.float32 or x.device != s.device:
            raise ValueError(f"bf_select: {name} must be float32 on "
                             f"{s.device}, got {x.dtype} on {x.device}")


def bf_select(s: torch.Tensor, bmax: torch.Tensor, eps: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (scores f32[Q, k], ids i32[Q, k], flag f32[Q])."""
    _check(s, bmax, eps, k)
    if not _cuda_or_cpu("bf_select", s.device):
        return bf_select_plain(s, bmax, eps, k)
    s, bmax, eps = s.contiguous(), bmax.contiguous(), eps.contiguous()
    lib = _build.load("bf_select")
    n_q, n = s.shape
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=s.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=s.device)
    flag = torch.empty((n_q,), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        code = lib.bf_select_launch(
            s.data_ptr(), bmax.data_ptr(), eps.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), flag.data_ptr(), n_q, n, k,
            torch.cuda.current_stream(s.device).cuda_stream)
    _build.check_launch(lib, "bf_select", code)
    launches.add()
    return out_s, out_i, flag


def sq8_select_plain(bmax: torch.Tensor, eps: torch.Tensor, q: torch.Tensor,
                     base: torch.Tensor, sq_eff: torch.Tensor, k: int,
                     metric: VectorMetric,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: (scores f32[Q, k], ids i32[Q, k], flag f32[Q])."""
    n_q, n_blocks = bmax.shape
    kk = min(k + MARGIN, n_blocks)
    valid = bmax > SENT_HALF
    neg_inf = torch.tensor(float("-inf"), device=bmax.device)
    kth = torch.topk(torch.where(valid, bmax, neg_inf), kk,
                     dim=1).values[:, -1]
    tau = torch.where(valid.sum(dim=1) >= kk, kth - eps, neg_inf)
    admit = valid & (bmax >= tau[:, None])
    flag = (admit.sum(dim=1) > S_SLOTS).to(torch.float32)
    exact = score_factor(metric) * (q @ base.T) - sq_eff[None, :]
    cand = torch.where(admit.repeat_interleave(BLK, dim=1), exact, neg_inf)
    return (*_topk_of_admitted(cand, k), flag)


def _check_sq8_select(bmax, eps, q, base, sq_eff, k) -> None:
    n_q, d = q.shape
    n = base.shape[0]
    if (base.dim() != 2 or base.shape[1] != d or n % BLK
            or bmax.shape != (n_q, n // BLK) or eps.shape != (n_q,)
            or sq_eff.shape != (n,)):
        raise ValueError(f"sq8_select expects bmax [Q, N/{BLK}], eps [Q], "
                         f"q [Q, D], base [N, D], sq_eff [N], got "
                         f"{tuple(bmax.shape)}, {tuple(eps.shape)}, "
                         f"{tuple(q.shape)}, {tuple(base.shape)}, "
                         f"{tuple(sq_eff.shape)}")
    if not 1 <= k <= S_SLOTS - MARGIN:
        raise ValueError(f"sq8_select takes 1 <= k <= {S_SLOTS - MARGIN}, "
                         f"got {k}")
    for name, x in (("bmax", bmax), ("eps", eps), ("q", q), ("base", base),
                    ("sq_eff", sq_eff)):
        if x.dtype != torch.float32 or x.device != base.device:
            raise ValueError(f"sq8_select: {name} must be float32 on "
                             f"{base.device}, got {x.dtype} on {x.device}")


def sq8_select(bmax: torch.Tensor, eps: torch.Tensor, q: torch.Tensor,
               base: torch.Tensor, sq_eff: torch.Tensor, k: int,
               metric: VectorMetric,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: (scores f32[Q, k], ids i32[Q, k], flag f32[Q]) for bmax f32[Q,
    N/64] (K3's, shifted), eps f32[Q], q f32[Q, D], base f32[N, D], sq_eff
    f32[N]; 1 <= k <= 124. Scores are fac * q.b - sq_eff (L2 lacks -|q|^2)."""
    _check_sq8_select(bmax, eps, q, base, sq_eff, k)
    if not _cuda_or_cpu("sq8_select", base.device):
        return sq8_select_plain(bmax, eps, q, base, sq_eff, k, metric)
    bmax, eps, q = bmax.contiguous(), eps.contiguous(), q.contiguous()
    base, sq_eff = base.contiguous(), sq_eff.contiguous()
    lib = _build.load("sq8_select")
    n_q, d = q.shape
    n = base.shape[0]
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=base.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=base.device)
    flag = torch.empty((n_q,), dtype=torch.float32, device=base.device)
    with torch.cuda.device(base.device):
        code = lib.sq8_select_launch(
            bmax.data_ptr(), eps.data_ptr(), q.data_ptr(), base.data_ptr(),
            sq_eff.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            flag.data_ptr(), n_q, n, d, k, score_factor(metric),
            torch.cuda.current_stream(base.device).cuda_stream)
    _build.check_launch(lib, "sq8_select", code)
    sq8_select_launches.add()
    return out_s, out_i, flag


def _in_groups(n_q: int, step) -> tuple[torch.Tensor, ...]:
    """step(rows) -> (scores, ids, flag) for each slice of <= GROUP query
    rows, concatenated along the queries."""
    outs = [step(slice(g0, g0 + GROUP)) for g0 in range(0, n_q, GROUP)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _complete(top_s: torch.Tensor, ids: torch.Tensor, corr: torch.Tensor,
              ) -> torch.Tensor:
    """Valid scores plus the per-query rank-invariant completion corr
    f32[Q]; -inf where ids are -1."""
    return torch.where(ids >= 0, top_s + corr[:, None], float("-inf"))


def _neg_sq(q: torch.Tensor, metric: VectorMetric) -> torch.Tensor:
    """-|q|^2 for L2 (the term that completes an L2 score), 0 otherwise."""
    if metric == VectorMetric.L2:
        return -(q * q).sum(dim=1)
    return torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)


def knn_scan_fused(q: torch.Tensor, base: torch.Tensor, sq_eff: torch.Tensor,
                   k: int, metric: VectorMetric,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k by K1 + K2 over groups of <= 64 queries.

    q f32[Q, D]; base f32[N, D] (N % 64 == 0); sq_eff f32[N] as in
    ops.scan; 1 <= k <= 128. Returns (scores f32[Q, k], ids i32[Q, k],
    flag f32[Q]): complete higher-is-better scores (L2 negated), best
    first, -inf / -1 padded; flag[q] > 0 means that query overflowed the
    slot capacity and must be rerun (ops.distance.knn_scan)."""
    q = q.to(torch.float32)
    zeros = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)

    def step(rows):
        s, bmax = bf_scan(q[rows], base, sq_eff, metric)
        return bf_select(s, bmax, zeros[rows], k)

    top_s, ids, flag = _in_groups(q.shape[0], step)
    return _complete(top_s, ids, _neg_sq(q, metric)), ids, flag


def knn_scan_sq8(q: torch.Tensor, codes: torch.Tensor, lo: torch.Tensor,
                 alpha: torch.Tensor, err_dims: torch.Tensor,
                 ms_dims: torch.Tensor, sq_eff: torch.Tensor,
                 base: torch.Tensor, k: int, metric: VectorMetric,
                 eps_mode: str = "cert",
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k at SQ8 threshold cost: K3 in bmax-only mode over the
    codes, shifted by fac * q.lo onto the exact scores' scale, then K4,
    over groups of <= 64 queries (port of knn_scan_sq8_v3 / _v2).

    codes u8[N, D] on the grid x ~ lo + alpha * code; err_dims / ms_dims
    f32[D] the per-dimension max and mean-square dequantization error over
    valid rows; base f32[N, D] the exact vectors; 1 <= k <= 124. eps_mode
    "cert" widens the threshold by fac * sum_d |q_d| err_d, a certified bound
    (the kept set provably holds the exact top-k); "fast" by FAST_EPS_SIGMA *
    fac * sqrt(sum_d q_d^2 ms_d), which holds the top-k with overwhelming
    probability and overflows far less. Candidates are scored exactly either
    way. Returns (scores, ids, flag) as knn_scan_fused."""
    q = q.to(torch.float32)
    fac = score_factor(metric)
    q_alpha = q * alpha[None, :]
    shift = fac * (q @ lo)
    if eps_mode == "fast":
        eps = FAST_EPS_SIGMA * fac * torch.sqrt(
            (q * q * ms_dims[None, :]).sum(dim=1))
    elif eps_mode == "cert":
        eps = fac * (q.abs() * err_dims[None, :]).sum(dim=1)
    else:
        raise ValueError(f"eps_mode must be 'cert' or 'fast', got "
                         f"{eps_mode!r}")

    def step(rows):
        _, bmax = sq8_scan(q_alpha[rows], codes, sq_eff, shift[rows], metric,
                           with_s=False)
        return sq8_select(bmax, eps[rows], q[rows], base, sq_eff, k, metric)

    top_s, ids, flag = _in_groups(q.shape[0], step)
    return _complete(top_s, ids, _neg_sq(q, metric)), ids, flag


def knn_scan_fused_sq8(q: torch.Tensor, codes: torch.Tensor, lo: torch.Tensor,
                       alpha: torch.Tensor, sq_eff: torch.Tensor, k: int,
                       metric: VectorMetric,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k of the quantized scores fac * (q.lo + q_alpha.codes) - |b|^2 -
    |q|^2 (L2) or q.lo + q_alpha.codes (IP/cosine), by K3 (S mode) + K2 over
    groups of <= 64 queries (port of pallas_scan.py::knn_scan_fused_sq8);
    1 <= k <= 128. Returns (scores, ids, flag) as knn_scan_fused."""
    q = q.to(torch.float32)
    fac = score_factor(metric)
    q_alpha = q * alpha[None, :]
    zeros = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)

    def step(rows):
        s, bmax = sq8_scan(q_alpha[rows], codes, sq_eff, zeros[rows], metric)
        return bf_select(s, bmax, zeros[rows], k)

    top_s, ids, flag = _in_groups(q.shape[0], step)
    corr = fac * (q @ lo) + _neg_sq(q, metric)
    return _complete(top_s, ids, corr), ids, flag


def knn_scan_approx_sq8(q: torch.Tensor, codes: torch.Tensor,
                        lo: torch.Tensor, alpha: torch.Tensor,
                        sq_eff: torch.Tensor, k: int, metric: VectorMetric,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k of the int8 x int8 quantized scores by K5 + K2 over groups of
    <= 64 queries (port of pallas_select.py::knn_scan_approx_sq8_v4). The
    query quantizes per query exactly as there: qa = q * alpha, s_q =
    max(max|qa|, 1e-30) / 127, qa_i8 = round(qa / s_q); K5 ranks by
    fac * s_q * (qa_i8 . (codes - 128)) - sq_eff, and the returned scores add
    fac * (q.lo + 128 * s_q * sum(qa_i8)) (and -|q|^2 for L2), the
    dequantized approximate score. 1 <= k <= 128. Returns (scores, ids,
    flag) as knn_scan_fused."""
    q = q.to(torch.float32)
    qa_i8, sqscale, corr = quantize_queries(q, lo, alpha, metric)
    zeros = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)

    def step(rows):
        s, bmax = sq8_i8_scan(qa_i8[rows], sqscale[rows], codes, sq_eff)
        return bf_select(s, bmax, zeros[rows], k)

    top_s, ids, flag = _in_groups(q.shape[0], step)
    return _complete(top_s, ids, corr), ids, flag


def quantize_queries(q: torch.Tensor, lo: torch.Tensor, alpha: torch.Tensor,
                     metric: VectorMetric,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's operands for queries q f32[Q, D] (knn_scan_approx_sq8_v4's
    query quantization): (qa_i8 i8[Q, D], sqscale f32[Q], corr f32[Q]),
    where corr completes a K5 score into the dequantized score."""
    fac = score_factor(metric)
    qa = q * alpha[None, :]
    s_q = qa.abs().amax(dim=1).clamp_min(1e-30) / 127.0
    qa_i8 = torch.round(qa / s_q[:, None]).to(torch.int8)
    corr = fac * (q @ lo + 128.0 * s_q * qa_i8.to(torch.float32).sum(dim=1))
    return qa_i8, fac * s_q, corr + _neg_sq(q, metric)
