// K2 `bf_select`: exact top-k from the scores and block maxima of K1
// (bf_scan.cu), for Hopper (sm_90a). One CTA per query.
//
// Replaces (reindexer_tpu/ops):
//   - pallas_select.py::select_sweep  threshold over (bmax, eps), compaction
//                                     of the kept blocks, fine stage, top-k
//   - the selection phase of pallas_select.py::onesweep_select and
//     ::pipelined_select (radix threshold, one-hot compaction, bitonic tail).
//
// Steps, per query:
//   1. Threshold. tau = the k-th largest block max among valid blocks
//      (bmax > -5e29), found by an 8-bit-a-pass radix select over the
//      monotone uint32 image of the floats (the TPU's _key_i32 bisection,
//      pallas_select.py:109). bmax streams from device memory through a
//      shared-memory histogram, so G = N/64 is unbounded. With fewer than k
//      valid blocks every valid block is admitted. tau is then widened by
//      eps[q] (0 on every path that calls K2 today; K4, sq8_select.cu,
//      thresholds the quantized block maxima with a real eps).
//   2. Admit the valid blocks with bmax >= tau. Every row of the true top-k
//      lies in such a block: a row whose block max is below tau is beaten by
//      the k rows that carry the k largest block maxima. The TPU kernels add
//      MARGIN = 4 blocks (pallas_select.py:105) because their block maxima and
//      their candidate scores come from two separately rounded products. Here
//      K1 wrote bmax from the very values it wrote to S, and K2 gathers those
//      same values, so tau at exactly the k-th block max is already a superset
//      and no margin is needed.
//   3. Overflow. More than S_SLOTS = 128 admitted blocks (mass ties) sets
//      flag[q]; the first 128 are used and the caller reruns the query
//      through the plain scan.
//   4. Gather the admitted blocks' scores (<= 8192) into shared memory as
//      64-bit keys (score key << 32 | ~row), bitonic-sort them descending and
//      emit the top k. Ties order by the smaller row first, so the result does
//      not depend on the order in which blocks were admitted. Scores <= -5e29
//      (invalid rows, padding) come out as -inf / -1.
//
// What bounds it on the H100: latency, not bytes. It reads 4 + 1 passes of
// G floats of bmax and at most 8192 floats of S per query, all from L2 right
// after K1; the time goes to the chain of __syncthreads between the radix
// passes and the 91 stages of the 8192-wide bitonic network.
// What the design does about it: 1024 threads per query keep each pass to a
// few loads a thread, the histogram bin is found by one warp-wide scan, and
// the sort runs on shared memory only. At 64 queries it fills 64 of the 132
// SMs; more queries per CTA or a persistent grid is later work.
//
// Steps 1, 2 and the sort of step 4 live in select_common.cuh, shared with
// K4 (sq8_select.cu); only the source of a candidate's score is K2's own.

#include "select_common.cuh"

namespace {

using namespace rxsel;

__global__ void __launch_bounds__(THREADS)
bf_select_kernel(const float* __restrict__ S, const float* __restrict__ bmax,
                 const float* __restrict__ eps, float* __restrict__ out_s,
                 int* __restrict__ out_i, float* __restrict__ flag, int N,
                 int k) {
  extern __shared__ unsigned long long cand[];   // MAX_CAND keys
  __shared__ SelectShared sh;

  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const int G = N / BLK;
  const float* bq = bmax + (size_t)qi * G;
  const float* sq = S + (size_t)qi * N;

  // 1-2. threshold at the k-th largest valid block max, admit
  const float tau = block_threshold(bq, G, k, eps[qi], sh);
  const int count = admit_blocks(bq, G, tau, sh);

  // 3. overflow flag
  if (t == 0) flag[qi] = count > S_SLOTS ? 1.f : 0.f;
  const int n_cand = min(count, S_SLOTS) * BLK;

  // 4. gather, sort, emit
  for (int c = t; c < n_cand; c += THREADS) {
    const uint32_t row = (uint32_t)sh.slots[c / BLK] * BLK + (c % BLK);
    cand[c] = cand_key(sq[row], row);
  }
  sort_emit(cand, n_cand, k, out_s + (size_t)qi * k, out_i + (size_t)qi * k);
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 on success).
// S f32[Q, N], bmax f32[Q, N/64], eps f32[Q] in; out_s f32[Q, k], out_i
// i32[Q, k], flag f32[Q] out. All contiguous on one device; N % 64 == 0,
// 1 <= k <= 128.
extern "C" int bf_select_launch(const void* S, const void* bmax,
                                const void* eps, void* out_s, void* out_i,
                                void* flag, int Q, int N, int k,
                                void* stream) {
  if (Q <= 0 || N <= 0 || N % BLK != 0 || k <= 0 || k > S_SLOTS)
    return (int)cudaErrorInvalidValue;
  const int smem = MAX_CAND * (int)sizeof(unsigned long long);
  const cudaError_t e = cudaFuncSetAttribute(
      bf_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bf_select_kernel<<<Q, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)bmax, (const float*)eps, (float*)out_s,
      (int*)out_i, (float*)flag, N, k);
  return (int)cudaGetLastError();
}

extern "C" const char* bf_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
