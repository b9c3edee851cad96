"""K2 `bf_select`: exact top-k from K1's scores and block maxima (port of
reindexer_tpu/ops/pallas_select.py::select_sweep and the selection phase of
::onesweep_select / ::pipelined_select; kernel source csrc/bf_select.cu),
and `knn_scan_fused`, the composed K1 + K2 scan that replaces the JAX
package's knn_scan_fused_v2/v3/v4 family.

Selection contract, per query:
  tau   = k-th largest block max among valid blocks (bmax > -5e29), minus
          eps[q]; -inf when fewer than k blocks are valid;
  admit = valid blocks with bmax >= tau (a superset of the true top-k);
  flag  = 1 when more than S_SLOTS = 128 blocks are admitted (mass ties):
          the result is then unspecified and the caller reruns the query;
  out   = top k of the admitted blocks' scores, best first; scores
          <= -5e29 come out as -inf / -1.

`bf_select` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version `bf_select_plain` for CPU tensors; any other device raises.
`launches` counts kernel launches only.
"""
from __future__ import annotations

import torch

from reindexer_tpu.core.type_consts import VectorMetric

from . import _build
from .scan import BLK, SENT_HALF, bf_scan

S_SLOTS = 128          # admitted-block capacity; also the largest k
GROUP = 64             # queries per K1 + K2 pair (bounds S to 64 x N)

launches = _build.Counter()


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
    top_s, top_i = torch.topk(cand, min(k, n), dim=1)
    ok = top_s > SENT_HALF
    top_s = torch.where(ok, top_s, neg_inf)
    top_i = torch.where(ok, top_i, -1).to(torch.int32)
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=float("-inf"))
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, top_i, flag


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
    if s.device.type == "cpu":
        return bf_select_plain(s, bmax, eps, k)
    if s.device.type != "cuda":
        raise ValueError(f"bf_select runs on cuda or cpu, not {s.device}")
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
    outs = []
    for g0 in range(0, q.shape[0], GROUP):
        qg = q[g0:g0 + GROUP]
        s, bmax = bf_scan(qg, base, sq_eff, metric)
        eps = torch.zeros((qg.shape[0],), dtype=torch.float32,
                          device=q.device)
        outs.append(bf_select(s, bmax, eps, k))
    top_s = torch.cat([o[0] for o in outs])
    ids = torch.cat([o[1] for o in outs])
    flag = torch.cat([o[2] for o in outs])
    if metric == VectorMetric.L2:
        top_s = top_s - (q * q).sum(dim=1, keepdim=True)
    top_s = torch.where(ids >= 0, top_s, float("-inf"))
    return top_s, ids, flag
