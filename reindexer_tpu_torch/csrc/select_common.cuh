// The block-threshold selection shared by K2 `bf_select` (bf_select.cu) and
// K4 `sq8_select` (sq8_select.cu), for Hopper (sm_90a). One CTA of THREADS
// threads selects for one query.
//
//   block_threshold  tau = the kk-th largest valid block max (bmax > -5e29),
//                    by an 8-bit-a-pass radix select over the monotone
//                    uint32 image of the floats (the TPU's _key_i32
//                    bisection, pallas_select.py:109), minus eps; -inf when
//                    fewer than kk blocks are valid. bmax streams from device
//                    memory through a shared-memory histogram, so G is
//                    unbounded.
//   admit_blocks     the valid blocks with bmax >= tau, by an atomic slot
//                    counter; the first S_SLOTS = 128 land in the slots, the
//                    count says whether more were admitted (overflow).
//   sort_emit        a bitonic sort, in shared memory, of the caller's
//                    candidates as 64-bit keys (score key << 32 | ~row),
//                    descending, and the top k out: ties order by the
//                    smaller row, and scores <= -5e29 come out as -inf / -1.
//
// The callers differ only in where a candidate's score comes from: K2 reads
// it from K1's S, K4 computes it from the fp32 base.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rxsel {

constexpr int BLK = 64;                      // rows per block max
constexpr int S_SLOTS = 128;                 // admitted block capacity
constexpr int MAX_CAND = S_SLOTS * BLK;      // 8192 candidate scores
constexpr int THREADS = 1024;
constexpr float SENT_HALF = -5e29f;          // at or below: invalid
constexpr unsigned FULL = 0xffffffffu;

// shared state of one selecting CTA (static shared memory)
struct SelectShared {
  int hist[256];
  int slots[S_SLOTS];
  int bin, above, count;
};

// monotone float -> uint32 map: float order == unsigned order
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// candidate key: score in the high word, ~row in the low word, so that of
// two equal scores the smaller row sorts first in descending order
__device__ __forceinline__ unsigned long long cand_key(float s, uint32_t row) {
  return ((unsigned long long)key_of(s) << 32) | (uint32_t)~row;
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

// tau for one query's block maxima bq[0..G): the kk-th largest valid one
// minus eps, or -inf when fewer than kk are valid. Called by all threads.
__device__ float block_threshold(const float* __restrict__ bq, int G, int kk,
                                 float eps, SelectShared& sh) {
  const int t = threadIdx.x;
  uint32_t prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = t; b < 256; b += THREADS) sh.hist[b] = 0;
    __syncthreads();
    for (int g = t; g < G; g += THREADS) {
      const float v = bq[g];
      if (v > SENT_HALF) {
        const uint32_t u = key_of(v);
        if ((u & mask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255], 1);
      }
    }
    __syncthreads();
    if (t < 32) pick_bin(sh.hist, kk, &sh.bin, &sh.above);
    __syncthreads();
    const int bin = sh.bin;
    if (bin < 0) return -INFINITY;   // fewer than kk valid (first pass only)
    kk -= sh.above;
    prefix |= (uint32_t)bin << shift;
    mask |= 255u << shift;
    __syncthreads();        // everyone has read sh.bin before the next pass
  }
  return float_of(prefix) - eps;
}

// Admit the valid blocks at or above tau into sh.slots; returns how many
// were admitted (more than S_SLOTS means overflow). Called by all threads.
__device__ int admit_blocks(const float* __restrict__ bq, int G, float tau,
                            SelectShared& sh) {
  const int t = threadIdx.x;
  if (t == 0) sh.count = 0;
  __syncthreads();
  for (int g = t; g < G; g += THREADS) {
    const float v = bq[g];
    if (v > SENT_HALF && v >= tau) {
      const int s = atomicAdd(&sh.count, 1);
      if (s < S_SLOTS) sh.slots[s] = g;
    }
  }
  __syncthreads();
  return sh.count;
}

// cand[0..n_cand) holds the caller's keys (written before the call, not yet
// synchronised). Pads to a power of two >= 128 (>= k, so the emit below stays
// in range), sorts descending and writes the top k to out_s / out_i.
__device__ void sort_emit(unsigned long long* cand, int n_cand, int k,
                          float* __restrict__ out_s, int* __restrict__ out_i) {
  const int t = threadIdx.x;
  int P = 2 * BLK;
  while (P < n_cand) P <<= 1;
  const unsigned long long pad =
      (unsigned long long)key_of(-INFINITY) << 32;   // row ~0 = -1
  for (int c = n_cand + t; c < P; c += THREADS) cand[c] = pad;
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
    out_s[r] = ok ? s : -INFINITY;
    out_i[r] = ok ? (int)~(uint32_t)kv : -1;
  }
}

}  // namespace rxsel
