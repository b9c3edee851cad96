// K5 `sq8_i8_scan`: partial scores and 64-row block maxima of the approximate
// SQ8 scan, int8 query x int8 codes, for Hopper (sm_90a).
//
// Replaces (reindexer_tpu/ops): the scoring half of
// pallas_select.py::pipelined_select_sq8 (its _kernel with sq8=True,
// pallas_select.py:1292-1300), whose selection half is K2 (bf_select.cu)
// unchanged.
//
// Contract: with qa_i8 the per-query int8 quantization of q * alpha (scale
// s_q), sqscale[q] = fac * s_q, and codes - 128 the signed codes,
//   S[q, n]    = max(float(sum_d qa_i8[q, d] * (codes[n, d] - 128))
//                    * sqscale[q] - sq_eff[n], -1e30)
//   bmax[q, g] = max of S[q, 64g .. 64g+63]
// The integer sum is exact: |sum| <= D * 127 * 128 < 2^31 for any D up to
// 132,000. The float conversion, product and difference are each rounded
// once, in that order (no fused multiply-add), so the plain version in
// ops/scan.py gives the same bits. The block maximum is taken from the very
// values written to S, so K2's selection is exact for these scores with no
// margin: the top-k of the quantized scores (the reference's approximate
// SQ8 semantics).
//
// What bounds it on the H100: the codes are N*D bytes (16.8 MB at 131072 x
// 128: 5 us at 3.35 TB/s) and S is Q*N*4 bytes written (33.5 MB at Q = 64:
// 10 us); the products are Q*N*D int8 multiply-adds, 4 per __dp4a (268 M
// dp4a at Q = 64). So S's writes and the dp4a issue rate bound it, not the
// codes.
// What the design does about it: K1's tiling (one CTA per 64-row block x
// 64-query group, 4x4 register tile a thread), with D staged in slabs of 32
// bytes as 8 packed words a row, so one __dp4a does four multiply-adds. The
// codes are made signed in registers (x ^ 0x80 per byte == x - 128 as int8),
// so only the uint8 codes are stored. Later work: int8 mma.sync / wgmma
// (1,979 TOP/s dense on the H100) and fusing K2's selection so S never
// leaves the SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;        // base rows per CTA: one block-max block
constexpr int BQ = 64;        // queries per CTA
constexpr int DW = 8;         // 4-byte words of D staged per step (32 bytes)
constexpr int THREADS = 256;  // 16 row lanes x 16 query lanes, 4x4 each
constexpr float SENT = -1e30f;

// Word w (bytes 4w .. 4w+3) of a row of D bytes, bytes past D set to `pad`.
__device__ __forceinline__ uint32_t row_word(const uint8_t* __restrict__ p,
                                             int w, int D, uint32_t pad) {
  const int d = 4 * w;
  if ((D & 3) == 0) return __ldg(reinterpret_cast<const uint32_t*>(p) + w);
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    x |= (d + b < D ? (uint32_t)p[d + b] : pad) << (8 * b);
  return x;
}

__global__ void __launch_bounds__(THREADS)
sq8_i8_scan_kernel(const int8_t* __restrict__ qa_i8,
                   const float* __restrict__ sqscale,
                   const uint8_t* __restrict__ codes,
                   const float* __restrict__ sq_eff, float* __restrict__ S,
                   float* __restrict__ bmax, int Q, int N, int D) {
  __shared__ int bs[DW][BR + 1];
  __shared__ int qs[DW][BQ + 1];

  const int g = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int t = threadIdx.x;
  const int tx = t & 15;   // rows tx + 16 i of the block
  const int ty = t >> 4;   // queries q0 + ty + 16 j
  const size_t row0 = (size_t)g * BR;
  const int n_words = (D + 3) / 4;

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int w0 = 0; w0 < n_words; w0 += DW) {
    for (int e = t; e < BR * DW; e += THREADS) {
      const int r = e / DW, c = e % DW, w = w0 + c;
      // code bytes past D pad with 0x80 (0 once signed); their query bytes
      // are 0 anyway
      bs[c][r] = w < n_words
                     ? (int)(row_word(codes + (row0 + r) * D, w, D, 0x80u) ^
                             0x80808080u)
                     : 0;
    }
    for (int e = t; e < BQ * DW; e += THREADS) {
      const int r = e / DW, c = e % DW, w = w0 + c;
      qs[c][r] = (w < n_words && q0 + r < Q)
                     ? (int)row_word(reinterpret_cast<const uint8_t*>(qa_i8) +
                                         (size_t)(q0 + r) * D,
                                     w, D, 0u)
                     : 0;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < DW; ++c) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = bs[c][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = qs[c][ty + 16 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = __dp4a(a[j], b[i], acc[j][i]);
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
    const float sc = qq < Q ? sqscale[qq] : 0.f;
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = fmaxf(
          __fsub_rn(__fmul_rn(__int2float_rn(acc[j][i]), sc), sqe[i]), SENT);
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

// Launches K5 on `stream`; returns cudaGetLastError() (0 on success).
// qa_i8 i8[Q, D], sqscale f32[Q], codes u8[N, D], sq_eff f32[N] in; S
// f32[Q, N], bmax f32[Q, N/64] out. All contiguous on one device (rows of
// qa_i8 and codes start 4-byte aligned when D % 4 == 0); N % 64 == 0.
extern "C" int sq8_i8_scan_launch(const void* qa_i8, const void* sqscale,
                                  const void* codes, const void* sq_eff,
                                  void* S, void* bmax, int Q, int N, int D,
                                  void* stream) {
  if (Q <= 0 || N <= 0 || N % BR != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BR, (Q + BQ - 1) / BQ);
  sq8_i8_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)qa_i8, (const float*)sqscale, (const uint8_t*)codes,
      (const float*)sq_eff, (float*)S, (float*)bmax, Q, N, D);
  return (int)cudaGetLastError();
}

extern "C" const char* sq8_i8_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
