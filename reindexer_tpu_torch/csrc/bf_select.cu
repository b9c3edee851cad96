// K2 `bf_select`: exact top-k from the scores and block maxima of K1
// (bf_scan.cu), for Hopper (sm_90a). One CTA of 1024 threads per query.
//
// Replaces (reindexer_tpu/ops):
//   - pallas_select.py::select_sweep  threshold over (bmax, eps), compaction
//                                     of the kept blocks, fine stage, top-k
//   - the selection phase of pallas_select.py::onesweep_select and
//     ::pipelined_select (radix threshold, one-hot compaction, bitonic tail).
//
// Steps, per query:
//   1. Stage. The query's G = N/64 block maxima are copied once into shared
//      memory (8 KB at N = 131072, 64 KB at N = 1,048,576); above STAGE_G
//      blocks the passes below read them from device memory instead.
//   2. Threshold. tau = the k-th largest block max among valid blocks
//      (bmax > -5e29), by a radix select over the monotone uint32 image of
//      the floats (the TPU's _key_i32 bisection, pallas_select.py:109) in
//      three passes of 11, 11 and 10 bits, each a shared-memory histogram
//      filled with warp-aggregated atomics and scanned by one warp. With
//      fewer than k valid blocks every valid block is admitted (tau = -inf).
//      tau is then widened by eps[q] (0 on every path that calls K2 today).
//   3. Admit the valid blocks with bmax >= tau. Every row of the true top-k
//      lies in such a block: a row whose block max is below tau is beaten by
//      the k rows that carry the k largest block maxima. The TPU kernels add
//      MARGIN = 4 blocks (pallas_select.py:105) because their block maxima and
//      their candidate scores come from two separately rounded products. Here
//      K1 wrote bmax from the very values it wrote to S, and K2 reads those
//      same values, so tau at exactly the k-th block max is already a superset
//      and no margin is needed. More than S_SLOTS = 128 admitted blocks (mass
//      ties) sets flag[q]; the first 128 are used and the caller reruns the
//      query through the plain scan.
//   4. Filter. Only a row with S >= tau can be in the top k, and at least k
//      rows pass: each of the k blocks whose max is >= tau holds one. So the
//      k-th best score is >= tau (eps > 0 only lowers tau). The passing rows
//      of the admitted blocks are compacted into shared memory as 64-bit
//      keys (score key << 32 | ~row) with a warp-aggregated counter:
//      typically a few hundred of the <= 8192 gathered rows.
//   5. Order only those, descending by key, and emit the top k: up to 1024
//      of them by rank (each thread counts the keys above its own), more by
//      a bitonic sort of the next power of two of their count
//      (select_common.cuh's sort_emit). Ties order by the smaller row
//      first, so the result does not depend on the order in which blocks
//      were admitted. Scores <= -5e29 (invalid rows, padding) come out as
//      -inf / -1.
//
// What bounds it on the H100: latency, not bytes. It reads G floats of bmax
// once and at most 8192 floats of S per query, from L2 right after K1
// (about 0.7 us of bytes at 64 queries); the time is the chain of
// __syncthreads between the steps. The first K2 streamed bmax from device
// memory through four 8-bit radix passes and sorted all <= 8192 gathered
// scores in 91 stages: 0.09 ms at 64 x 131072.
// What the design does about it: bmax is read from device memory once, the
// threshold takes three passes instead of four, each bin pick is spread over
// all 32 warps, and the filtered rows are ranked in one step instead of
// sorted. One query gets one SM: at 64 queries K2 fills 64 of the 132 SMs,
// and a single select uses one.
//
// The threshold, the append, the rank and the sort live in
// select_common.cuh, shared with K4 (sq8_select.cu).

#include "select_common.cuh"

namespace {

using namespace rxsel;

constexpr int STAGE_G = 16384;   // block maxima staged in shared memory

__global__ void __launch_bounds__(THREADS, 1)
    bf_select_kernel(const float* __restrict__ S,
                     const float* __restrict__ bmax,
                     const float* __restrict__ eps, float* __restrict__ out_s,
                     int* __restrict__ out_i, float* __restrict__ flag, int N,
                     int k) {
  // MAX_CAND keys, then (G <= STAGE_G) the staged block maxima
  extern __shared__ unsigned long long cand[];
  __shared__ SelectShared sh;

  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const int G = N / BLK;
  const float* bq = bmax + (size_t)qi * G;
  const float* sq = S + (size_t)qi * N;

  // 1. stage the block maxima
  if (G <= STAGE_G) {
    float* staged = reinterpret_cast<float*>(cand + MAX_CAND);
    for (int g = t; g < G; g += THREADS) staged[g] = bq[g];
    bq = staged;
  }
  if (t == 0) sh.count = sh.n_pass = 0;
  __syncthreads();

  // 2. threshold at the k-th largest valid block max
  const float tau = wide_threshold(bq, G, k, eps[qi], sh);

  // 3. admit the valid blocks at or above tau
  for (int g0 = 0; g0 < G; g0 += THREADS) {   // uniform trip count
    const int g = g0 + t;
    const float v = g < G ? bq[g] : -INFINITY;
    warp_append(v > SENT_HALF && v >= tau, &sh.count, g, sh.slots, S_SLOTS);
  }
  __syncthreads();
  const int count = sh.count;
  if (t == 0) flag[qi] = count > S_SLOTS ? 1.f : 0.f;
  const int n_rows = min(count, S_SLOTS) * BLK;

  // 4. filter S >= tau into the candidate keys
  for (int c0 = 0; c0 < n_rows; c0 += THREADS) {   // uniform trip count
    const int c = c0 + t;
    bool pred = false;
    unsigned long long key = 0;
    if (c < n_rows) {
      const uint32_t row = (uint32_t)sh.slots[c / BLK] * BLK + (c % BLK);
      const float s = sq[row];
      pred = s >= tau;
      key = cand_key(s, row);
    }
    warp_append(pred, &sh.n_pass, key, cand, MAX_CAND);
  }
  __syncthreads();

  // 5. rank or sort the passing rows, emit the top k
  emit_top_k(cand, sh.n_pass, k, out_s + (size_t)qi * k,
             out_i + (size_t)qi * k);
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
  const int G = N / BLK;
  const int smem = MAX_CAND * (int)sizeof(unsigned long long) +
                   (G <= STAGE_G ? G * (int)sizeof(float) : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      bf_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_CAND * (int)sizeof(unsigned long long) +
          STAGE_G * (int)sizeof(float));
  if (e != cudaSuccess) return (int)e;
  bf_select_kernel<<<Q, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)S, (const float*)bmax, (const float*)eps, (float*)out_s,
      (int*)out_i, (float*)flag, N, k);
  return (int)cudaGetLastError();
}

extern "C" const char* bf_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
