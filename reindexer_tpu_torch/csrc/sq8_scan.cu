// K3 `sq8_scan`: partial scores and 64-row block maxima of the SQ8 scan over
// uint8 codes, for Hopper (sm_90a).
//
// Replaces (reindexer_tpu/ops):
//   - pallas_scan.py::_pass1_sq8        partial scores [Q, N] + block maxima
//                                       (S mode, feeding K2 bf_select.cu)
//   - pallas_select.py::sweep_bmax_sq8  shifted block maxima only, and the
//                                       codes sweep (phase 0) of
//                                       ::twinsweep_select_sq8 (bmax-only
//                                       mode, feeding K4 sq8_select.cu)
//
// Contract: with q_alpha = q * alpha (the per-dimension grid step folded into
// the query), fac = 2 for L2 and 1 for IP/cosine,
//   S[q, n]    = max(fac * (q_alpha[q] . codes[n]) - sq_eff[n] + shift[q],
//                    -1e30)
//   bmax[q, g] = max of S[q, 64g .. 64g+63]
// sq_eff is the exact |b|^2 of the original vector (L2) or 0 (IP/cosine) for
// a valid row, 1e30 for an invalid one. S is written only when the S pointer
// is not null (S mode, shift 0: the caller adds fac * q.lo - |q|^2 to the
// winners). The bmax-only mode takes shift = fac * q.lo, which puts the block
// maxima on the scale of the exact fp32 scores for K4's eps-widened
// threshold; it writes no S, so it reads one byte per code element instead
// of K1's four.
//
// What bounds it on the H100: the codes are N*D bytes (16.8 MB at 131072 x
// 128: 5 us at 3.35 TB/s), while the products are 2*Q*N*D fp32 FLOP, as many
// as K1's (2.1 GFLOP at Q = 64: 32 us at the 67 TFLOP/s fp32 peak). So this
// design is bound by its fp32 FMAs, like K1, and the byte saving shows only
// in the bmax-only mode's missing S writes and in memory held.
// What the design does about it: K1's structure (one CTA per 64-row block x
// 64-query group, D slabs of 32 staged through shared memory, a 4x4 register
// tile of fp32 FMAs a thread); the codes are converted to float as they are
// staged (integers 0..255 are exact in fp32). No TF32. The block maximum is
// taken from the very values written to S, so K2 needs no margin.
// Later work: an integer or bf16 tensor-core product (codes are exact in
// bf16; q_alpha needs a hi/lo split, as the TPU's _dot2 does).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;        // base rows per CTA: one block-max block
constexpr int BQ = 64;        // queries per CTA
constexpr int DK = 32;        // D slab staged per step
constexpr int THREADS = 256;  // 16 row lanes x 16 query lanes, 4x4 each
constexpr float SENT = -1e30f;

__global__ void __launch_bounds__(THREADS)
sq8_scan_kernel(const float* __restrict__ q_alpha,
                const uint8_t* __restrict__ codes,
                const float* __restrict__ sq_eff,
                const float* __restrict__ shift, float* __restrict__ S,
                float* __restrict__ bmax, int Q, int N, int D, float fac) {
  __shared__ float bs[DK][BR + 1];
  __shared__ float qs[DK][BQ + 1];

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int t = threadIdx.x;
  const int tx = t & 15;   // rows tx + 16 i of the block
  const int ty = t >> 4;   // queries q0 + ty + 16 j
  const size_t row0 = (size_t)g * BR;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = t; e < BR * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, d = d0 + c;
      bs[c][r] = d < D ? (float)codes[(row0 + r) * D + d] : 0.f;
    }
    for (int e = t; e < BQ * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, d = d0 + c;
      qs[c][r] =
          (d < D && q0 + r < Q) ? q_alpha[(size_t)(q0 + r) * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = bs[c][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = qs[c][ty + 16 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(a[j], b[i], acc[j][i]);
    }
    __syncthreads();
  }

  float sqe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sqe[i] = sq_eff[row0 + tx + 16 * i];
  const int G = N / BR;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qq = q0 + ty + 16 * j;
    const float sh = qq < Q ? shift[qq] : 0.f;
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // (fac * dot - sq_eff) + shift, in that order, as the plain version
      const float s = fmaxf(fac * acc[j][i] - sqe[i] + sh, SENT);
      m = fmaxf(m, s);
      if (S != nullptr && qq < Q) S[(size_t)qq * N + row0 + tx + 16 * i] = s;
    }
    // the 16 lanes that share ty hold the block's 64 rows for query qq
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tx == 0 && qq < Q) bmax[(size_t)qq * G + g] = m;
  }
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() (0 on success).
// q_alpha f32[Q, D], codes u8[N, D], sq_eff f32[N], shift f32[Q] in; S
// f32[Q, N] (or null: bmax-only mode), bmax f32[Q, N/64] out. All contiguous
// on one device; N % 64 == 0.
extern "C" int sq8_scan_launch(const void* q_alpha, const void* codes,
                               const void* sq_eff, const void* shift, void* S,
                               void* bmax, int Q, int N, int D, float fac,
                               void* stream) {
  if (Q <= 0 || N <= 0 || N % BR != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BR, (Q + BQ - 1) / BQ);
  sq8_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q_alpha, (const uint8_t*)codes, (const float*)sq_eff,
      (const float*)shift, (float*)S, (float*)bmax, Q, N, D, fac);
  return (int)cudaGetLastError();
}

extern "C" const char* sq8_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
