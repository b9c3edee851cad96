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
//      eps[q] (0 on the exact fp32 path; the SQ8 path will pass its margin).
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 64;                      // rows per block max
constexpr int S_SLOTS = 128;                 // admitted block capacity
constexpr int MAX_CAND = S_SLOTS * BLK;      // 8192 candidate scores
constexpr int THREADS = 1024;
constexpr float SENT_HALF = -5e29f;          // at or below: invalid
constexpr unsigned FULL = 0xffffffffu;

// monotone float -> uint32 map: float order == unsigned order
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Warp 0: over the 256 bins counted from the top, find the bin holding the
// kk-th largest key. Writes the bin (or -1 when fewer than kk keys were
// counted) and the count of keys in the bins above it.
__device__ void pick_bin(const int* hist, int kk, int* out_bin,
                         int* out_above) {
  const int lane = threadIdx.x & 31;
  const int top = 255 - 8 * lane;            // this lane: bins top .. top-7
  int local = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) local += hist[top - i];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - local;
  const unsigned hit = __ballot_sync(FULL, excl < kk && kk <= incl);
  if (hit == 0) {
    if (lane == 0) *out_bin = -1;
    return;
  }
  if (lane == __ffs(hit) - 1) {
    int cum = excl;
    for (int i = 0; i < 8; ++i) {
      const int h = hist[top - i];
      if (cum + h >= kk) {
        *out_bin = top - i;
        *out_above = cum;
        break;
      }
      cum += h;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bf_select_kernel(const float* __restrict__ S, const float* __restrict__ bmax,
                 const float* __restrict__ eps, float* __restrict__ out_s,
                 int* __restrict__ out_i, float* __restrict__ flag, int N,
                 int k) {
  extern __shared__ unsigned long long cand[];   // MAX_CAND keys
  __shared__ int hist[256];
  __shared__ int slots[S_SLOTS];
  __shared__ int sh_bin, sh_above, sh_count;

  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const int G = N / BLK;
  const float* bq = bmax + (size_t)qi * G;
  const float* sq = S + (size_t)qi * N;

  // 1. threshold: radix select of the k-th largest valid block max
  uint32_t prefix = 0, mask = 0;
  int kk = k;
  bool admit_all = false;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = t; b < 256; b += THREADS) hist[b] = 0;
    __syncthreads();
    for (int g = t; g < G; g += THREADS) {
      const float v = bq[g];
      if (v > SENT_HALF) {
        const uint32_t u = key_of(v);
        if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255], 1);
      }
    }
    __syncthreads();
    if (t < 32) pick_bin(hist, kk, &sh_bin, &sh_above);
    __syncthreads();
    const int bin = sh_bin;
    if (bin < 0) {          // fewer than k valid blocks (first pass only)
      admit_all = true;
      break;
    }
    kk -= sh_above;
    prefix |= (uint32_t)bin << shift;
    mask |= 255u << shift;
    __syncthreads();        // everyone has read sh_bin before the next pass
  }
  const float tau = admit_all ? -INFINITY : float_of(prefix) - eps[qi];

  // 2. admit the valid blocks at or above tau
  if (t == 0) sh_count = 0;
  __syncthreads();
  for (int g = t; g < G; g += THREADS) {
    const float v = bq[g];
    if (v > SENT_HALF && v >= tau) {
      const int s = atomicAdd(&sh_count, 1);
      if (s < S_SLOTS) slots[s] = g;
    }
  }
  __syncthreads();
  const int count = sh_count;

  // 3. overflow flag
  if (t == 0) flag[qi] = count > S_SLOTS ? 1.f : 0.f;
  const int n_cand = min(count, S_SLOTS) * BLK;

  // 4. gather, sort, emit
  int P = 2 * BLK;          // >= k, so the emit below stays in range
  while (P < n_cand) P <<= 1;
  const unsigned long long pad =
      (unsigned long long)key_of(-INFINITY) << 32;   // row ~0 = -1
  for (int c = t; c < P; c += THREADS) {
    unsigned long long kv = pad;
    if (c < n_cand) {
      const uint32_t row = (uint32_t)slots[c / BLK] * BLK + (c % BLK);
      kv = ((unsigned long long)key_of(sq[row]) << 32) | (uint32_t)~row;
    }
    cand[c] = kv;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < P / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = cand[lo], b = cand[hi];
        if ((a < b) == desc) {
          cand[lo] = b;
          cand[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int r = t; r < k; r += THREADS) {
    const unsigned long long kv = cand[r];
    const float s = float_of((uint32_t)(kv >> 32));
    const bool ok = s > SENT_HALF;
    out_s[(size_t)qi * k + r] = ok ? s : -INFINITY;
    out_i[(size_t)qi * k + r] = ok ? (int)~(uint32_t)kv : -1;
  }
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
