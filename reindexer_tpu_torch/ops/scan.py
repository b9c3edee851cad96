"""K1 `bf_scan`: partial scores and 64-row block maxima of the exact
brute-force scan (port of reindexer_tpu/ops/pallas_scan.py::_pass1 and
pallas_select.py::sweep_bmax; kernel source csrc/bf_scan.cu).

    S[q, n]    = fac * (q . b_n) - sq_eff[n]    fac = 2 for L2, 1 otherwise
    bmax[q, g] = max(S[q, 64g : 64g + 64])

sq_eff is |b|^2 (L2) or 0 (IP/cosine) for a valid row and SQ_EFF_BIG for an
invalid one, so validity rides sq_eff alone: an invalid row scores about
-1e30 whatever its data. The -|q|^2 that completes an L2 score is
rank-invariant and added by the caller.

`bf_scan` launches the CUDA kernel for CUDA tensors and runs the plain
PyTorch version `bf_scan_plain` for CPU tensors; any other device raises.
`launches` counts kernel launches only.
"""
from __future__ import annotations

import torch

from reindexer_tpu.core.type_consts import VectorMetric

from . import _build

SQ_EFF_BIG = 1e30     # sq_eff of an invalid row
SENT_HALF = -5e29     # scores at or below are invalid
BLK = 64              # rows per block max

launches = _build.Counter()


def score_factor(metric: VectorMetric) -> float:
    return 2.0 if metric == VectorMetric.L2 else 1.0


def bf_scan_plain(q: torch.Tensor, base: torch.Tensor, sq_eff: torch.Tensor,
                  metric: VectorMetric) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: (S f32[Q, N], bmax f32[Q, N/64])."""
    s = score_factor(metric) * (q @ base.T) - sq_eff[None, :]
    return s, s.view(q.shape[0], -1, BLK).amax(dim=2)


def _check(q: torch.Tensor, base: torch.Tensor, sq_eff: torch.Tensor) -> None:
    if q.dim() != 2 or base.dim() != 2 or q.shape[1] != base.shape[1]:
        raise ValueError(f"bf_scan expects q [Q, D] and base [N, D], got "
                         f"{tuple(q.shape)} and {tuple(base.shape)}")
    if sq_eff.shape != (base.shape[0],):
        raise ValueError(f"bf_scan expects sq_eff [{base.shape[0]}], got "
                         f"{tuple(sq_eff.shape)}")
    if base.shape[0] % BLK or q.shape[0] == 0:
        raise ValueError(f"bf_scan needs N % {BLK} == 0 and Q > 0, got "
                         f"N={base.shape[0]}, Q={q.shape[0]}")
    for name, x in (("q", q), ("base", base), ("sq_eff", sq_eff)):
        if x.dtype != torch.float32 or x.device != base.device:
            raise ValueError(f"bf_scan: {name} must be float32 on "
                             f"{base.device}, got {x.dtype} on {x.device}")


def bf_scan(q: torch.Tensor, base: torch.Tensor, sq_eff: torch.Tensor,
            metric: VectorMetric) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: (S f32[Q, N], bmax f32[Q, N/64]) for q f32[Q, D], base f32[N, D],
    sq_eff f32[N], all on one device."""
    _check(q, base, sq_eff)
    if base.device.type == "cpu":
        return bf_scan_plain(q, base, sq_eff, metric)
    if base.device.type != "cuda":
        raise ValueError(f"bf_scan runs on cuda or cpu, not {base.device}")
    q, base, sq_eff = q.contiguous(), base.contiguous(), sq_eff.contiguous()
    lib = _build.load("bf_scan")
    n_q, d = q.shape
    n = base.shape[0]
    s = torch.empty((n_q, n), dtype=torch.float32, device=base.device)
    bmax = torch.empty((n_q, n // BLK), dtype=torch.float32,
                       device=base.device)
    with torch.cuda.device(base.device):
        code = lib.bf_scan_launch(
            q.data_ptr(), base.data_ptr(), sq_eff.data_ptr(), s.data_ptr(),
            bmax.data_ptr(), n_q, n, d, score_factor(metric),
            torch.cuda.current_stream(base.device).cuda_stream)
    _build.check_launch(lib, "bf_scan", code)
    launches.add()
    return s, bmax
