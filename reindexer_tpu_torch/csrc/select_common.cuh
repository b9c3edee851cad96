// The block-threshold selection shared by K2 `bf_select` (bf_select.cu) and
// K4 `sq8_select` (sq8_select.cu), for Hopper (sm_90a). One CTA of THREADS
// threads thresholds, admits and emits for one query.
//
//   wide_threshold  tau = the kk-th largest valid block max (bmax > -5e29),
//                   by a radix select over the monotone uint32 image of the
//                   floats (the TPU's _key_i32 bisection,
//                   pallas_select.py:109) in three passes of 11, 11 and 10
//                   bits, each a shared-memory histogram filled with
//                   warp-aggregated atomics and scanned by all 32 warps,
//                   minus eps; -inf when fewer than kk blocks are valid.
//   warp_append     one atomic a warp appends the lanes where a predicate
//                   holds (admitted blocks, passing candidates).
//   rank_emit       the top k of up to THREADS distinct candidate keys by
//                   rank (each thread counts the keys above its own).
//   sort_emit       a bitonic sort, in shared memory, of the candidates as
//                   64-bit keys, descending, and the top k out.
// Candidate keys are score key << 32 | ~row: ties order by the smaller row,
// and scores <= -5e29 come out as -inf / -1.
//
// The callers differ in where a candidate's score comes from: K2 reads it
// from K1's S, K4 computes it from the fp32 base.

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
constexpr int NB = 2048;                     // bins of the widest radix pass
constexpr uint32_t NO_BIN = 0xffffffffu;

// shared state of one selecting CTA (static shared memory)
struct SelectShared {
  int hist[NB];
  int slots[S_SLOTS];
  int run[32];                       // a warp's run of bins, summed
  int bin, above, run_sel, run_above, count, n_pass;
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

// Over nb bins counted from the top, the bin holding the kk-th largest
// key: sh.bin (-1 when fewer than kk keys were counted) and sh.above, the
// count of keys in the bins above it. Warp w sums the w-th run of nb/32
// bins from the top (each lane one or two bins), warp 0 scans the 32 run
// totals, and the warp whose run holds the key scans its own bins. Called
// by all threads; ends synchronized.
__device__ void pick_bin_wide(const int* hist, int nb, int kk,
                              SelectShared& sh) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int lp = nb / 32 / 32;                 // bins a lane: 1 or 2
  const int top = nb - 1 - (w * 32 + lane) * lp;   // this lane's first bin
  int local = 0;
  for (int i = 0; i < lp; ++i) local += hist[top - i];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sh.run[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int v = sh.run[lane];
    int rincl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, rincl, off);
      if (lane >= off) rincl += u;
    }
    const unsigned hit = __ballot_sync(FULL, rincl - v < kk && kk <= rincl);
    if (lane == 0) sh.run_sel = hit ? __ffs(hit) - 1 : -1;
    if (hit && lane == __ffs(hit) - 1) sh.run_above = rincl - v;
  }
  __syncthreads();
  const int sel = sh.run_sel;
  if (sel < 0) {
    if (t == 0) sh.bin = -1;
  } else if (w == sel) {
    const int need = kk - sh.run_above;   // the need-th key of this run
    const unsigned hit =
        __ballot_sync(FULL, incl - local < need && need <= incl);
    if (lane == __ffs(hit) - 1) {
      int cum = sh.run_above + incl - local;
      for (int i = 0; i < lp; ++i) {
        const int h = hist[top - i];
        if (cum + h >= kk) {
          sh.bin = top - i;
          sh.above = cum;
          break;
        }
        cum += h;
      }
    }
  }
  __syncthreads();
}

// tau over the block maxima bq[0..G) (shared or device memory): the kk-th
// largest valid one minus eps, or -inf when fewer than kk are valid. Three
// radix passes of 11, 11 and 10 bits. Called by all threads.
__device__ float wide_threshold(const float* bq, int G, int kk, float eps,
                                SelectShared& sh) {
  const int t = threadIdx.x, lane = t & 31;
  uint32_t prefix = 0, mask = 0;
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const int shift = p == 0 ? 21 : p == 1 ? 10 : 0;
    const int nb = p == 2 ? 1024 : 2048;
    for (int b = t; b < nb; b += THREADS) sh.hist[b] = 0;
    __syncthreads();
    for (int g0 = 0; g0 < G; g0 += THREADS) {   // uniform trip count
      const int g = g0 + t;
      uint32_t bin = NO_BIN;
      if (g < G) {
        const float v = bq[g];
        const uint32_t u = key_of(v);
        if (v > SENT_HALF && (u & mask) == prefix)
          bin = (u >> shift) & (uint32_t)(nb - 1);
      }
      // one atomic per distinct bin of the warp: the top bins are crowded
      const unsigned peers = __match_any_sync(FULL, bin);
      if (bin != NO_BIN && lane == __ffs(peers) - 1)
        atomicAdd(&sh.hist[bin], __popc(peers));
    }
    __syncthreads();
    pick_bin_wide(sh.hist, nb, kk, sh);
    const int bin = sh.bin;
    if (bin < 0) return -INFINITY;   // fewer than kk valid (first pass only)
    kk -= sh.above;
    prefix |= (uint32_t)bin << shift;
    mask |= (uint32_t)(nb - 1) << shift;
    __syncthreads();   // everyone has read sh.bin before the next pass
  }
  return float_of(prefix) - eps;
}

// Appends `value` where `pred` holds to out[*counter ...] (the first `cap`
// of them) with one atomic a warp. Called by every lane of the warp.
template <class T>
__device__ __forceinline__ void warp_append(bool pred, int* counter, T value,
                                            T* out, int cap) {
  const int lane = threadIdx.x & 31;
  const unsigned votes = __ballot_sync(FULL, pred);
  if (votes == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(counter, __popc(votes));
  base = __shfl_sync(FULL, base, 0);
  const int pos = base + __popc(votes & ((1u << lane) - 1));
  if (pred && pos < cap) out[pos] = value;
}

// The top k of cand[0..n) (n <= THREADS distinct keys) by rank: thread i
// counts the keys above its own, all threads reading the same key at once,
// and writes its key to that rank if it is below k; ranks past n are padded.
// The same output as sort_emit, without the sort's log^2 barriers.
__device__ void rank_emit(const unsigned long long* cand, int n, int k,
                          float* __restrict__ out_s,
                          int* __restrict__ out_i) {
  const int t = threadIdx.x;
  if (t < n) {
    const unsigned long long mine = cand[t];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += cand[j] > mine;
    if (rank < k) {
      const float s = float_of((uint32_t)(mine >> 32));
      const bool ok = s > SENT_HALF;
      out_s[rank] = ok ? s : -INFINITY;
      out_i[rank] = ok ? (int)~(uint32_t)mine : -1;
    }
  } else if (t < k) {
    out_s[t] = -INFINITY;
    out_i[t] = -1;
  }
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

// the top k of the n distinct keys cand[0..n) (written and synchronised
// before the call): by rank when they fit one thread each, else sorted
__device__ __forceinline__ void emit_top_k(unsigned long long* cand, int n,
                                           int k, float* __restrict__ out_s,
                                           int* __restrict__ out_i) {
  if (n <= THREADS)
    rank_emit(cand, n, k, out_s, out_i);
  else
    sort_emit(cand, n, k, out_s, out_i);
}

}  // namespace rxsel
