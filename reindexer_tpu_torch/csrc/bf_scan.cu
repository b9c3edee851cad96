// K1 `bf_scan`: partial scores and 64-row block maxima of the exact
// brute-force KNN scan, for Hopper (sm_90a).
//
// Replaces (reindexer_tpu/ops):
//   - pallas_scan.py::_pass1          partial scores [Q, N] + block maxima
//   - pallas_select.py::sweep_bmax    block maxima only
//   - the sweep phase of pallas_select.py::onesweep_select and
//     ::pipelined_select, which park every tile's scores in VMEM.
// On the H100 the scores go to device memory instead: at the main shape
// (64 queries x 131072 rows) S is 33.5 MB and stays in the 50 MB L2 for K2
// (bf_select.cu), which reads it right after.
//
// Contract: S[q, n] = fac * (q . b_n) - sq_eff[n], fac = 2 for L2 and 1 for
// IP/cosine (the rank-invariant -|q|^2 of L2 is added by the caller), and
// bmax[q, g] = max of S[q, 64g .. 64g+63]. sq_eff = |b|^2 (L2) or 0 for a
// valid row and 1e30 for an invalid one, so invalid rows score about -1e30.
//
// What bounds it on the H100: each base row is read once (N*D*4 bytes, 67 MB
// at 131072 x 128: 20 us at 3.35 TB/s), S is written once (Q*N*4 bytes), and
// the products are 2*Q*N*D fp32 FLOP (2.1 GFLOP at Q=64: 32 us at the 67
// TFLOP/s fp32 peak). At Q=64 it sits near the balance of both.
// What the design does about it: one CTA per (64-row base block, 64-query
// group) reads its base block once and reuses it for all 64 queries; the two
// operands are staged through shared memory in D-slabs of 32, so any D works
// (the D % 128 gate of the TPU kernels was Mosaic's); each thread keeps a 4x4
// register tile of fp32 FMAs. No TF32 and no bf16: a reduced-precision
// product breaks the exact top-k contract. The block maximum is taken, with
// warp shuffles, from the very values written to S, so K2 thresholds and
// gathers the same numbers bit for bit.
// Later work: wgmma with a 3xTF32 split, TMA staging, fusing K1 into K2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BR = 64;        // base rows per CTA: one block-max block
constexpr int BQ = 64;        // queries per CTA
constexpr int DK = 32;        // D slab staged per step
constexpr int THREADS = 256;  // 16 row lanes x 16 query lanes, 4x4 each

__global__ void __launch_bounds__(THREADS)
bf_scan_kernel(const float* __restrict__ q, const float* __restrict__ base,
               const float* __restrict__ sq_eff, float* __restrict__ S,
               float* __restrict__ bmax, int Q, int N, int D, float fac) {
  // [slab column][row]: the +1 pad keeps the transposing stores and the
  // row-lane loads free of bank conflicts
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
      bs[c][r] = d < D ? base[(row0 + r) * D + d] : 0.f;
    }
    for (int e = t; e < BQ * DK; e += THREADS) {
      const int r = e / DK, c = e % DK, d = d0 + c;
      qs[c][r] = (d < D && q0 + r < Q) ? q[(size_t)(q0 + r) * D + d] : 0.f;
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
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = fac * acc[j][i] - sqe[i];
      m = fmaxf(m, s);
      if (qq < Q) S[(size_t)qq * N + row0 + tx + 16 * i] = s;
    }
    // the 16 lanes that share ty hold the block's 64 rows for query qq
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (tx == 0 && qq < Q) bmax[(size_t)qq * G + g] = m;
  }
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// q f32[Q, D], base f32[N, D], sq_eff f32[N] in; S f32[Q, N], bmax
// f32[Q, N/64] out. All contiguous on one device; N % 64 == 0.
extern "C" int bf_scan_launch(const void* q, const void* base,
                              const void* sq_eff, void* S, void* bmax, int Q,
                              int N, int D, float fac, void* stream) {
  if (Q <= 0 || N <= 0 || N % BR != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BR, (Q + BQ - 1) / BQ);
  bf_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)base, (const float*)sq_eff, (float*)S,
      (float*)bmax, Q, N, D, fac);
  return (int)cudaGetLastError();
}

extern "C" const char* bf_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
