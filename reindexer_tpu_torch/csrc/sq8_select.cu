// K4 `sq8_select`: exact top-k from K3's quantized block maxima (sq8_scan.cu,
// bmax-only mode) and the fp32 base, for Hopper (sm_90a). One CTA per query.
//
// Replaces (reindexer_tpu/ops): pallas_select.py::twinsweep_select_sq8 after
// its codes sweep (the eps-widened threshold, the fp32 sweep that compacts
// the kept blocks' exact scores, the fine stage and the emit), and the role
// of ::select_sweep with a real eps in the two-kernel
// knn_scan_sq8_v2 (sweep_bmax_sq8 + select_sweep).
//
// Steps, per query:
//   1. Threshold. tau = the min(k + 4, G)-th largest valid quantized block
//      max, minus eps[q]; -inf when fewer blocks are valid. eps bounds the
//      real-arithmetic difference between a quantized score and the exact
//      one (cert: fac * sum_d |q_d| err_d; fast: a 12-sigma bound). The
//      MARGIN of 4 extra blocks (pallas_select.py:105, :870) stays: the
//      block maxima come from the codes product and the candidate scores
//      from the fp32 product, two separately rounded sums, so, unlike K2,
//      this kernel does not gather the values its threshold was taken on.
//   2. Admit the valid blocks with bmax >= tau. More than S_SLOTS = 128 sets
//      flag[q] (the caller climbs its eps ladder: cert -> fast -> fp32).
//   3. Score exactly the rows of the admitted blocks only (<= 8192):
//      fac * (q . b) - sq_eff, in fp32 FMAs from the fp32 base, one warp a
//      row. This gather replaces the TPU's second full fp32 sweep with
//      one-hot compaction (pallas_select.py:904-935): gathers are cheap
//      here and slow there.
//   4. Sort and emit the top k, best first, ties to the smaller row, -inf /
//      -1 padding (select_common.cuh, shared with K2).
//
// What bounds it on the H100: the gather of step 3. At least k + 4 blocks of
// 64 rows are admitted, so at k = 100 and D = 128 a query reads >= 6,656 rows
// x 512 B = 3.4 MB of the base, and 64 queries read ~218 MB where the blocks
// they admit do not overlap (65 us at 3.35 TB/s), more than one full fp32
// sweep (67 MB). Then the 91-stage bitonic network of the 8192 keys.
// What the design does about it: nothing clever yet. One CTA of 1024 threads
// per query, each warp scores rows with coalesced lane-strided loads and a
// shuffle reduction; the query row stays in L1. Sharing admitted blocks
// between the queries of a group (or a TMA gather into shared memory) is
// later work.

#include "select_common.cuh"

namespace {

using namespace rxsel;

constexpr int MARGIN = 4;      // extra blocks absorbing cross-product rounding

__global__ void __launch_bounds__(THREADS)
sq8_select_kernel(const float* __restrict__ bmax,
                  const float* __restrict__ eps, const float* __restrict__ q,
                  const float* __restrict__ base,
                  const float* __restrict__ sq_eff, float* __restrict__ out_s,
                  int* __restrict__ out_i, float* __restrict__ flag, int N,
                  int D, int k, float fac) {
  extern __shared__ unsigned long long cand[];   // MAX_CAND keys
  __shared__ SelectShared sh;

  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const int G = N / BLK;
  const float* bq = bmax + (size_t)qi * G;
  const float* qv = q + (size_t)qi * D;

  // 1-2. threshold at the (k + MARGIN)-th largest valid block max, widened
  // by eps, and admit
  const float tau = block_threshold(bq, G, min(k + MARGIN, G), eps[qi], sh);
  const int count = admit_blocks(bq, G, tau, sh);
  if (t == 0) flag[qi] = count > S_SLOTS ? 1.f : 0.f;
  const int n_cand = min(count, S_SLOTS) * BLK;

  // 3. exact fp32 scores of the admitted rows, one warp a row
  const int lane = t & 31;
  for (int c = t >> 5; c < n_cand; c += THREADS / 32) {
    const uint32_t row = (uint32_t)sh.slots[c / BLK] * BLK + (c % BLK);
    const float* b = base + (size_t)row * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(qv[d], b[d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) cand[c] = cand_key(fac * acc - sq_eff[row], row);
  }

  // 4. sort, emit
  sort_emit(cand, n_cand, k, out_s + (size_t)qi * k, out_i + (size_t)qi * k);
}

}  // namespace

// Launches K4 on `stream`; returns cudaGetLastError() (0 on success).
// bmax f32[Q, N/64], eps f32[Q], q f32[Q, D], base f32[N, D], sq_eff f32[N]
// in; out_s f32[Q, k], out_i i32[Q, k], flag f32[Q] out. All contiguous on
// one device; N % 64 == 0, 1 <= k <= 124.
extern "C" int sq8_select_launch(const void* bmax, const void* eps,
                                 const void* q, const void* base,
                                 const void* sq_eff, void* out_s, void* out_i,
                                 void* flag, int Q, int N, int D, int k,
                                 float fac, void* stream) {
  if (Q <= 0 || N <= 0 || N % BLK != 0 || D <= 0 || k <= 0 ||
      k + MARGIN > S_SLOTS)
    return (int)cudaErrorInvalidValue;
  const int smem = MAX_CAND * (int)sizeof(unsigned long long);
  const cudaError_t e = cudaFuncSetAttribute(
      sq8_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sq8_select_kernel<<<Q, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)bmax, (const float*)eps, (const float*)q,
      (const float*)base, (const float*)sq_eff, (float*)out_s, (int*)out_i,
      (float*)flag, N, D, k, fac);
  return (int)cudaGetLastError();
}

extern "C" const char* sq8_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
