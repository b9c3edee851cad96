"""The scan kernels: partial scores and 64-row block maxima.

K1 `bf_scan`, the exact fp32 scan (port of reindexer_tpu/ops/pallas_scan.py::
_pass1 and pallas_select.py::sweep_bmax; kernel source csrc/bf_scan.cu):

    S[q, n]    = fac * (q . b_n) - sq_eff[n]    fac = 2 for L2, 1 otherwise
    bmax[q, g] = max(S[q, 64g : 64g + 64])

K3 `sq8_scan`, the same over uint8 codes with q_alpha = q * alpha (port of
pallas_scan.py::_pass1_sq8 and pallas_select.py::sweep_bmax_sq8; kernel
source csrc/sq8_scan.cu):

    S[q, n] = max(fac * (q_alpha[q] . codes[n]) - sq_eff[n] + shift[q], -1e30)

K5 `sq8_i8_scan`, int8 query x signed codes (the scoring of
pallas_select.py::pipelined_select_sq8; kernel source csrc/sq8_i8_scan.cu):

    S[q, n] = max(float(qa_i8[q] . (codes[n] - 128)) * sqscale[q] - sq_eff[n],
                  -1e30)

sq_eff is |b|^2 (L2) or 0 (IP/cosine) for a valid row and SQ_EFF_BIG for an
invalid one, so validity rides sq_eff alone: an invalid row scores about
-1e30 whatever its data. The per-query terms that complete a score (-|q|^2
for L2, the grid offset q.lo for SQ8) are rank-invariant and added by the
caller.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (`*_plain`) for CPU tensors; any other device raises. Each
kernel's counter (`launches`, `sq8_scan_launches`, `sq8_i8_scan_launches`)
counts its launches only.
"""
from __future__ import annotations

import torch

from ..core.type_consts import VectorMetric

from . import _build
from .. import tracing

SQ_EFF_BIG = 1e30     # sq_eff of an invalid row
SENT = -1e30          # the SQ8 scans clamp scores here
SENT_HALF = -5e29     # scores at or below are invalid
BLK = 64              # rows per block max
SQ8_I8_MAX_D = 132000  # K5's |sum| <= D * 127 * 128 stays below 2^31

launches = tracing.counter("kernels.bf_scan")                # K1
sq8_scan_launches = tracing.counter("kernels.sq8_scan")       # K3
sq8_i8_scan_launches = tracing.counter("kernels.sq8_i8_scan")  # K5


def score_factor(metric: VectorMetric) -> float:
    return 2.0 if metric == VectorMetric.L2 else 1.0


def bf_scan_plain(q: torch.Tensor, base: torch.Tensor, sq_eff: torch.Tensor,
                  metric: VectorMetric) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: (S f32[Q, N], bmax f32[Q, N/64])."""
    s = score_factor(metric) * (q @ base.T) - sq_eff[None, :]
    return s, s.view(q.shape[0], -1, BLK).amax(dim=2)


def _check(kernel: str, q: torch.Tensor, base: torch.Tensor,
           sq_eff: torch.Tensor, q_dtype: torch.dtype,
           base_dtype: torch.dtype, **per_query: torch.Tensor) -> None:
    """Shapes, dtypes and devices of a scan's operands: q [Q, D] of q_dtype,
    base [N, D] of base_dtype with N % 64 == 0, sq_eff f32[N], and f32[Q]
    for each per-query operand; all on base's device."""
    if q.dim() != 2 or base.dim() != 2 or q.shape[1] != base.shape[1]:
        raise ValueError(f"{kernel} expects q [Q, D] and base [N, D], got "
                         f"{tuple(q.shape)} and {tuple(base.shape)}")
    if sq_eff.shape != (base.shape[0],):
        raise ValueError(f"{kernel} expects sq_eff [{base.shape[0]}], got "
                         f"{tuple(sq_eff.shape)}")
    if base.shape[0] % BLK or q.shape[0] == 0:
        raise ValueError(f"{kernel} needs N % {BLK} == 0 and Q > 0, got "
                         f"N={base.shape[0]}, Q={q.shape[0]}")
    for name, x in per_query.items():
        if x.shape != (q.shape[0],):
            raise ValueError(f"{kernel} expects {name} [{q.shape[0]}], got "
                             f"{tuple(x.shape)}")
    operands = {"q": (q, q_dtype), "base": (base, base_dtype),
                "sq_eff": (sq_eff, torch.float32)}
    operands.update((name, (x, torch.float32))
                    for name, x in per_query.items())
    for name, (x, dtype) in operands.items():
        if x.dtype != dtype or x.device != base.device:
            raise ValueError(f"{kernel}: {name} must be {dtype} on "
                             f"{base.device}, got {x.dtype} on {x.device}")


def _cuda_or_cpu(kernel: str, device: torch.device) -> bool:
    """True for a CUDA device, False for the CPU; raises for any other."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel} runs on cuda or cpu, not {device}")
    return device.type == "cuda"


def bf_scan(q: torch.Tensor, base: torch.Tensor, sq_eff: torch.Tensor,
            metric: VectorMetric) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: (S f32[Q, N], bmax f32[Q, N/64]) for q f32[Q, D], base f32[N, D],
    sq_eff f32[N], all on one device."""
    _check("bf_scan", q, base, sq_eff, torch.float32, torch.float32)
    if not _cuda_or_cpu("bf_scan", base.device):
        return bf_scan_plain(q, base, sq_eff, metric)
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


def sq8_scan_plain(q_alpha: torch.Tensor, codes: torch.Tensor,
                   sq_eff: torch.Tensor, shift: torch.Tensor,
                   metric: VectorMetric, with_s: bool = True,
                   ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch K3: (S f32[Q, N] or None, bmax f32[Q, N/64])."""
    s = (score_factor(metric) * (q_alpha @ codes.to(torch.float32).T)
         - sq_eff[None, :] + shift[:, None]).clamp_min(SENT)
    return (s if with_s else None,
            s.view(q_alpha.shape[0], -1, BLK).amax(dim=2))


def bf16_limbs(x: torch.Tensor,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's split of an fp32 q_alpha into three bf16 limbs (the kernel makes
    the same split on the card, csrc/sq8_scan.cu): hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even.
    Every difference is exact in fp32 and the limbs hold x's 24 significant
    bits, so hi + mid + lo == x for 2^-110 <= |x| < 2^128 - 2^119 (where
    bf16 rounds to infinity); below, lo falls into bf16's subnormals and
    the sum is off by at most 2^-134."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    return hi, mid, (r1 - mid.to(torch.float32)).to(torch.bfloat16)


def sq8_scan(q_alpha: torch.Tensor, codes: torch.Tensor, sq_eff: torch.Tensor,
             shift: torch.Tensor, metric: VectorMetric, with_s: bool = True,
             ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """K3: (S f32[Q, N] or None, bmax f32[Q, N/64]) for q_alpha f32[Q, D],
    codes u8[N, D], sq_eff f32[N], shift f32[Q], all on one device.
    with_s=False is the bmax-only mode: no S is computed or written."""
    _check("sq8_scan", q_alpha, codes, sq_eff, torch.float32, torch.uint8,
           shift=shift)
    if not _cuda_or_cpu("sq8_scan", codes.device):
        return sq8_scan_plain(q_alpha, codes, sq_eff, shift, metric, with_s)
    q_alpha, codes = q_alpha.contiguous(), codes.contiguous()
    sq_eff, shift = sq_eff.contiguous(), shift.contiguous()
    lib = _build.load("sq8_scan")
    n_q, d = q_alpha.shape
    n = codes.shape[0]
    s = (torch.empty((n_q, n), dtype=torch.float32, device=codes.device)
         if with_s else None)
    bmax = torch.empty((n_q, n // BLK), dtype=torch.float32,
                       device=codes.device)
    with torch.cuda.device(codes.device):
        code = lib.sq8_scan_launch(
            q_alpha.data_ptr(), codes.data_ptr(), sq_eff.data_ptr(),
            shift.data_ptr(), s.data_ptr() if with_s else None,
            bmax.data_ptr(), n_q, n, d, score_factor(metric),
            torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check_launch(lib, "sq8_scan", code)
    sq8_scan_launches.add()
    return s, bmax


def sq8_i8_dots_exact_in_f32(d: int) -> bool:
    """Whether an int8 x int8 dot over d dimensions is exact in an fp32
    matmul: every partial sum is an integer below 2^24 while
    d * 127 * 128 < 2^24 (d <= 1032)."""
    return d * 127 * 128 < 2 ** 24


def sq8_i8_scan_plain(qa_i8: torch.Tensor, sqscale: torch.Tensor,
                      codes: torch.Tensor, sq_eff: torch.Tensor,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5: (S f32[Q, N], bmax f32[Q, N/64]). The integer dots
    are formed in fp32 where that is exact (d <= 1032, TF32 off) and in
    float64 above, then rounded once to fp32 as the kernel's int32 sums."""
    dt = (torch.float32 if sq8_i8_dots_exact_in_f32(codes.shape[1])
          else torch.float64)
    dots = (qa_i8.to(dt) @ (codes.to(dt) - 128).T).to(torch.float32)
    s = (dots * sqscale[:, None] - sq_eff[None, :]).clamp_min(SENT)
    return s, s.view(qa_i8.shape[0], -1, BLK).amax(dim=2)


def sq8_i8_scan(qa_i8: torch.Tensor, sqscale: torch.Tensor,
                codes: torch.Tensor, sq_eff: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: (S f32[Q, N], bmax f32[Q, N/64]) for qa_i8 i8[Q, D], sqscale
    f32[Q], codes u8[N, D], sq_eff f32[N], all on one device."""
    _check("sq8_i8_scan", qa_i8, codes, sq_eff, torch.int8, torch.uint8,
           sqscale=sqscale)
    if not _cuda_or_cpu("sq8_i8_scan", codes.device):
        return sq8_i8_scan_plain(qa_i8, sqscale, codes, sq_eff)
    n_q, d = qa_i8.shape
    if d >= SQ8_I8_MAX_D:
        raise ValueError(f"sq8_i8_scan: D = {d}; its int32 sums are exact "
                         f"only for D < {SQ8_I8_MAX_D}")
    qa_i8, codes = qa_i8.contiguous(), codes.contiguous()
    sqscale, sq_eff = sqscale.contiguous(), sq_eff.contiguous()
    lib = _build.load("sq8_i8_scan")
    n = codes.shape[0]
    s = torch.empty((n_q, n), dtype=torch.float32, device=codes.device)
    bmax = torch.empty((n_q, n // BLK), dtype=torch.float32,
                       device=codes.device)
    with torch.cuda.device(codes.device):
        code = lib.sq8_i8_scan_launch(
            qa_i8.data_ptr(), sqscale.data_ptr(), codes.data_ptr(),
            sq_eff.data_ptr(), s.data_ptr(), bmax.data_ptr(), n_q, n, d,
            torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check_launch(lib, "sq8_i8_scan", code)
    sq8_i8_scan_launches.add()
    return s, bmax
