// K4 `sq8_select`: exact top-k from K3's quantized block maxima (sq8_scan.cu,
// bmax-only mode) and the fp32 base, for Hopper (sm_90a). Three kernels on
// one stream: admit (a CTA a query), score (persistent CTAs over the admitted
// blocks), emit (a CTA a query).
//
// Replaces (reindexer_tpu/ops): pallas_select.py::twinsweep_select_sq8 after
// its codes sweep (the eps-widened threshold, the fp32 sweep that compacts
// the kept blocks' exact scores, the fine stage and the emit), and the role
// of ::select_sweep with a real eps in the two-kernel
// knn_scan_sq8_v2 (sweep_bmax_sq8 + select_sweep).
//
// Contract, per query (ops/select.py):
//   tau   = the min(k + 4, G)-th largest valid quantized block max, minus
//           eps[q]; -inf when fewer blocks are valid. eps bounds the
//           real-arithmetic difference between a quantized score and the
//           exact one (cert: fac * sum_d |q_d| err_d; fast: a 12-sigma
//           bound). The MARGIN of 4 extra blocks (pallas_select.py:105, :870)
//           absorbs the rounding between the codes product (bmax) and the
//           fp32 product (the scores), two separately rounded sums.
//   admit = the valid blocks with bmax >= tau; more than S_SLOTS = 128 sets
//           flag[q] (the caller climbs its eps ladder: cert -> fast -> fp32)
//           and the query's result is -inf / -1.
//   out   = the top k of the admitted blocks' exact scores fac * (q . b) -
//           sq_eff, best first, ties to the smaller row, -inf / -1 padding.
//
// Steps:
//   1. Admit (sq8_admit_kernel, a CTA of 1024 threads a query): K2's
//      threshold machinery (select_common.cuh: the block maxima staged in
//      shared memory, 11/11/10-bit radix passes, an all-warp bin pick), the
//      admitted blocks appended with warp-aggregated atomics. A flagged
//      query writes -inf / -1 and its flag and stops. Every other query
//      writes its admitted blocks (its slots), each block's slot, and its
//      bit into the admitted blocks' query masks (a uint64 word per 64
//      queries); the first query to admit a block lists it.
//   2. Score (sq8_score_kernel, persistent CTAs): each listed block's 64
//      fp32 rows (in slices of RB rows where D is wide) arrive once, as 2D
//      TMA boxes of 32 columns with the 128-byte swizzle, in a 2-stage
//      mbarrier ring, and are scored in fp32 FMA against every query whose
//      mask bit is set, a thread a (query, row). Each score is stored at its
//      row's place in its query's dense array of admitted scores (slot * 64
//      + row in block): no atomics, no compaction.
//   3. Emit (sq8_emit_kernel, a CTA a query): the block maxima of those
//      scores; tau2 = the k-th largest (k blocks each hold a row at or above
//      it, so the k-th best row is too); the rows at or above tau2 (a few
//      hundred where eps admits thousands) ranked, or sorted past 1,024.
//      With fewer than k admitted blocks every admitted row is ordered. The
//      result is the exact top k of the admitted rows in every case, so a
//      rounding that beats MARGIN costs nothing here.
//
// What bounds it on the H100: the bytes of the admitted blocks' rows. Read
// once per block, whatever the number of queries admitting it: at the
// clustered main shape (64 queries from 18 clusters of 112 blocks, 131072 x
// 128) about 2,000 unique blocks, 64 MB, 19 us at 3.35 TB/s, against 235 MB
// when every query gathers its own (the first K4, one CTA a query). The fp32
// products (2 x 64 x 112 x 64 x 128 FLOP, 1.8 us at 67 TFLOP/s), the 1.8 MB
// of scores written and read back, and the selection's barriers come after.
// What the design does about it: step 2 spreads the blocks over every SM,
// so one query's 112 blocks use 112 SMs; a block's slabs are a few TMA
// copies, in flight while the last block is scored; a flagged query costs
// the admit step only; and step 3 orders k rows and their ties, not the
// thousands of admitted rows within eps of the threshold.

#include "select_common.cuh"
#include "tma_wgmma.cuh"

namespace {

using namespace rxsel;
using rxtc::mbar_expect_tx;
using rxtc::mbar_init;
using rxtc::mbar_wait;
using rxtc::sm_count;

constexpr int MARGIN = 4;            // extra blocks absorbing the rounding
constexpr int STAGE_G = 16384;       // block maxima staged in shared memory
constexpr int SCORE_THREADS = 256;
constexpr int SCORE_STAGES = 2;
constexpr int SCORE_SMEM = 100 * 1024;       // two scoring CTAs an SM
constexpr int SCORE_SMEM_MAX = 200 * 1024;   // or one
constexpr int QS_BYTES = 64 * 1024;          // queries staged up to this
constexpr int SCORE_CHUNK = 64;              // items' metadata staged at once

// The scratch: one buffer the wrapper allocates (sq8_select_scratch_bytes)
// and the launcher carves. Its head, which the launcher zeroes: mask
// u64[G * W], listed i32[G], n_list i32[1]. The rest: scores f32[Q *
// MAX_CAND], slots i32[Q * S_SLOTS], list i32[G], n_adm i32[Q], slot_of
// u8[G * Q].
struct Scratch {
  unsigned long long* mask;   // block g's admitting queries, W words
  int* listed;                // block g is in the list
  int* n_list;                // listed blocks
  float* scores;              // a query's admitted rows' exact scores, by
                              // admitted slot: [slot * 64 + row in block]
  int* slots;                 // a query's admitted blocks
  int* list;                  // the blocks some query admits
  int* n_adm;                 // a query's admitted blocks
  uint8_t* slot_of;           // [g * Q + q]: block g's slot in q's list
};

long long zeroed_bytes(int G, int W) {   // rounded up to 16 bytes
  return (8LL * G * W + 4LL * G + 4 + 15) / 16 * 16;
}

long long scratch_bytes(int Q, int G) {
  return zeroed_bytes(G, (Q + 63) / 64) + 4LL * Q * MAX_CAND +
         4LL * ((long long)Q * S_SLOTS + G + Q) + (long long)G * Q;
}

Scratch carve(void* scratch, int Q, int G, int W) {
  Scratch s;
  s.mask = (unsigned long long*)scratch;
  s.listed = (int*)(s.mask + (size_t)G * W);
  s.n_list = s.listed + G;
  s.scores = (float*)((char*)scratch + zeroed_bytes(G, W));
  s.slots = (int*)(s.scores + (size_t)Q * MAX_CAND);
  s.list = s.slots + (size_t)Q * S_SLOTS;
  s.n_adm = s.list + G;
  s.slot_of = (uint8_t*)(s.n_adm + Q);
  return s;
}

// 1. threshold and admit, a CTA a query
__global__ void __launch_bounds__(THREADS, 1)
    sq8_admit_kernel(const float* __restrict__ bmax,
                     const float* __restrict__ eps, float* __restrict__ out_s,
                     int* __restrict__ out_i, float* __restrict__ flag,
                     Scratch s, int Q, int G, int W, int k) {
  extern __shared__ float staged[];   // G <= STAGE_G: the block maxima
  __shared__ SelectShared sh;
  const int qi = blockIdx.x;
  const int t = threadIdx.x;
  const float* bq = bmax + (size_t)qi * G;
  if (G <= STAGE_G) {
    for (int g = t; g < G; g += THREADS) staged[g] = bq[g];
    bq = staged;
  }
  if (t == 0) sh.count = 0;
  __syncthreads();

  const float tau = wide_threshold(bq, G, min(k + MARGIN, G), eps[qi], sh);
  for (int g0 = 0; g0 < G; g0 += THREADS) {   // uniform trip count
    const int g = g0 + t;
    const float v = g < G ? bq[g] : -INFINITY;
    warp_append(v > SENT_HALF && v >= tau, &sh.count, g, sh.slots, S_SLOTS);
  }
  __syncthreads();
  const int count = sh.count;
  if (count > S_SLOTS) {   // flagged: the caller reruns this query
    if (t == 0) flag[qi] = 1.f;
    for (int r = t; r < k; r += THREADS) {
      out_s[(size_t)qi * k + r] = -INFINITY;
      out_i[(size_t)qi * k + r] = -1;
    }
    return;
  }
  if (t == 0) {
    flag[qi] = 0.f;
    s.n_adm[qi] = count;
  }
  const unsigned long long bit = 1ull << (qi & 63);
  for (int i = t; i < count; i += THREADS) {
    const int g = sh.slots[i];
    s.slots[(size_t)qi * S_SLOTS + i] = g;
    s.slot_of[(size_t)g * Q + qi] = (uint8_t)i;
    atomicOr(&s.mask[(size_t)g * W + (qi >> 6)], bit);
    if (atomicExch(&s.listed[g], 1) == 0) s.list[atomicAdd(s.n_list, 1)] = g;
  }
}

struct ScoreArgs {
  CUtensorMap map_base;   // boxes of 32 columns x RB rows, 128-byte swizzle
  const float* q;
  const float* base;
  const float* sq_eff;
  Scratch s;
  int Q, D, W, RB, n_slabs, P;   // P: the row stride of a plain slice
  int chunk;                     // items whose metadata is staged at once
  float fac;
};

// 2. score the listed blocks. An item is a slice of RB rows of a listed
// block. ASYNC (D % 4 == 0, 16-byte aligned base and q, RB % 8 == 0) brings
// it by 2D TMA boxes of 32 columns (slabs) with the 128-byte swizzle: 16-byte
// unit u of slice row r sits at unit u ^ (r % 8) of its 128-byte slab row,
// so the 8 rows that 8 threads read at once lie on 8 bank groups while all
// of them read the same query floats. Otherwise the CTA loads the slice
// itself into rows P floats apart (P odd). A CTA stages (QS: Q x D fits
// QS_BYTES) every query's vector once, and its items' blocks, query masks
// and slots a chunk of items at a time, in one round trip each, so that an
// item waits on nothing but its copy. A score goes to its query's dense row
// of admitted scores, at its block's slot: no atomics.
template <bool ASYNC, bool QS>
__global__ void __launch_bounds__(SCORE_THREADS, 2)
    sq8_score_kernel(const __grid_constant__ ScoreArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - (rxtc::smem_u32(smem_raw) & 1023)) & 1023));
  const int slice = ASYNC ? a.n_slabs * a.RB * 32 : a.RB * a.P;
  // then: queries f32[Q][D] (QS), masks u64[chunk][W], qlist i32[Q], qslot
  // i32[Q], gs i32[chunk], slot bytes u8[chunk][Q]
  float* q_s = ring + SCORE_STAGES * slice;
  unsigned long long* ms = reinterpret_cast<unsigned long long*>(
      q_s + (QS ? (size_t)a.Q * a.D : 0));
  int* qlist = reinterpret_cast<int*>(ms + (size_t)a.chunk * a.W);
  int* qslot = qlist + a.Q;
  int* gs = qslot + a.Q;
  uint8_t* sl = reinterpret_cast<uint8_t*>(gs + a.chunk);
  __shared__ unsigned long long full[SCORE_STAGES];
  const Scratch& s = a.s;
  const int t = threadIdx.x;
  const int RB = a.RB, D = a.D, W = a.W, Q = a.Q;
  const int per_block = BLK / RB;
  const int n_items = *s.n_list * per_block;
  const int my_items =
      (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (my_items <= 0) return;

  auto item_of = [&](int j) { return (int)blockIdx.x + j * (int)gridDim.x; };
  auto issue = [&](int j, int g) {   // one thread: item j's slabs
    const int slot = j % SCORE_STAGES;
    const int row0 = g * BLK + (item_of(j) % per_block) * RB;
    mbar_expect_tx(&full[slot], (uint32_t)(a.n_slabs * RB * 32 * 4));
    for (int c = 0; c < a.n_slabs; ++c)
      rxtc::tma_load(ring + slot * slice + c * RB * 32, &a.map_base, 32 * c,
                     row0, &full[slot]);
  };
  if (ASYNC && t == 0) {
    for (int i = 0; i < SCORE_STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(SCORE_STAGES, my_items); ++j)
      issue(j, s.list[item_of(j) / per_block]);
  }
  if (QS) {
#pragma unroll 8
    for (int e = t; e < Q * D / 4; e += SCORE_THREADS)
      reinterpret_cast<float4*>(q_s)[e] =
          __ldg(reinterpret_cast<const float4*>(a.q) + e);
  }

  const int r = t % RB;   // this thread's row of every slice (RB | 256)
  for (int j = 0; j < my_items; ++j) {
    const int jc = j % a.chunk;   // item j's place in the staged chunk
    if (jc == 0) {   // stage items j .. j + chunk - 1
      const int n = min(a.chunk, my_items - j);
      for (int i = t; i < n; i += SCORE_THREADS)
        gs[i] = s.list[item_of(j + i) / per_block];
      __syncthreads();   // gs written (the first time: barriers initialised)
      for (int e = t; e < n * W; e += SCORE_THREADS)
        ms[e] = s.mask[(size_t)gs[e / W] * W + e % W];
      // every query's byte: those of queries that do not admit the block
      // are never read
      for (int e = t; e < n * Q; e += SCORE_THREADS)
        sl[e] = s.slot_of[(size_t)gs[e / Q] * Q + e % Q];
      __syncthreads();
    }
    // thread 0: the block of item j + SCORE_STAGES, loaded while j is scored
    const int g_next = ASYNC && t == 0 && j + SCORE_STAGES < my_items
                           ? __ldg(&s.list[item_of(j + SCORE_STAGES) /
                                           per_block])
                           : 0;
    const int slot = j % SCORE_STAGES;
    const int h = item_of(j) % per_block;
    const int row0 = gs[jc] * BLK + h * RB;
    const float sq_r = a.sq_eff[row0 + r];
    // the block's admitting queries, in order, their slots, how many
    const unsigned long long* mw = ms + (size_t)jc * W;
    int n_q = 0;
    for (int w = 0; w < W; ++w) n_q += __popcll(mw[w]);
    for (int qq = t; qq < Q; qq += SCORE_THREADS) {
      const unsigned long long m = mw[qq >> 6];
      if ((m >> (qq & 63)) & 1ull) {
        int pos = __popcll(m & ((1ull << (qq & 63)) - 1));
        for (int w = 0; w < (qq >> 6); ++w) pos += __popcll(mw[w]);
        qlist[pos] = qq;
        qslot[pos] = sl[(size_t)jc * Q + qq];
      }
    }
    float* rows = ring + slot * slice;
    if (ASYNC) {
      mbar_wait(&full[slot], (uint32_t)((j / SCORE_STAGES) & 1));
    } else {
      for (int e = t; e < RB * D; e += SCORE_THREADS)
        rows[(e / D) * a.P + e % D] = a.base[(size_t)row0 * D + e];
    }
    __syncthreads();   // qlist (and a plain slice) written

    for (int p = t; p < n_q * RB; p += SCORE_THREADS) {
      const int qi = qlist[p / RB];
      const float* qv = (QS ? q_s : a.q) + (size_t)qi * D;
      float acc0 = 0.f, acc1 = 0.f;   // two chains of FMAs
      if (ASYNC) {
        for (int c = 0; c < a.n_slabs; ++c) {
          const float* br = rows + c * RB * 32 + r * 32;
          const int units = min(8, (D - 32 * c) >> 2);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (u < units) {
              const float4 x =
                  *reinterpret_cast<const float4*>(&br[(u ^ (r & 7)) * 4]);
              const float4* yp =
                  reinterpret_cast<const float4*>(&qv[32 * c + 4 * u]);
              const float4 y = QS ? *yp : __ldg(yp);
              float& acc = (u & 1) ? acc1 : acc0;
              acc = fmaf(y.x, x.x, acc);
              acc = fmaf(y.y, x.y, acc);
              acc = fmaf(y.z, x.z, acc);
              acc = fmaf(y.w, x.w, acc);
            }
          }
        }
      } else {
        const float* br = rows + r * a.P;
        for (int d = 0; d < D; ++d) acc0 = fmaf(__ldg(&qv[d]), br[d], acc0);
      }
      s.scores[(size_t)qi * MAX_CAND + qslot[p / RB] * BLK + h * RB + r] =
          a.fac * (acc0 + acc1) - sq_r;
    }
    __syncthreads();   // the slot, qlist and the staged chunk are read
    if (ASYNC && t == 0 && j + SCORE_STAGES < my_items)
      issue(j + SCORE_STAGES, g_next);
  }
}

// 3. a query's top k from its admitted rows' exact scores. Each thread
// holds up to MAX_CAND / THREADS of them, a warp 32 consecutive rows of one
// block: the block maxima by warp shuffles and a shared-memory atomic max;
// tau2 = the k-th largest block max (when k blocks are admitted); only the
// rows at or above tau2 (at least k: one in each of k blocks) are ranked, or
// sorted when more than 1,024 are.
__global__ void __launch_bounds__(THREADS, 1)
    sq8_emit_kernel(const float* __restrict__ flag, float* __restrict__ out_s,
                    int* __restrict__ out_i, Scratch s, int k) {
  extern __shared__ unsigned long long cand[];   // MAX_CAND keys
  __shared__ unsigned int bbest[S_SLOTS];        // block max keys
  __shared__ unsigned int tau2;
  __shared__ int n_sel;
  const int qi = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  if (flag[qi] > 0.f) return;   // written by the admit step
  const int n_adm = s.n_adm[qi];
  const int n = n_adm * BLK;
  const float* sc = s.scores + (size_t)qi * MAX_CAND;
  const int* slots = s.slots + (size_t)qi * S_SLOTS;
  if (t < S_SLOTS) bbest[t] = 0u;
  if (t == 0) {
    tau2 = 0u;
    n_sel = 0;
  }
  constexpr int PER = MAX_CAND / THREADS;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = t + i * THREADS;
    v[i] = c < n ? sc[c] : -INFINITY;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float m = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    const int c0 = (t & ~31) + i * THREADS;   // the warp's first row
    if (lane == 0 && c0 < n) atomicMax(&bbest[c0 / BLK], key_of(m));
  }
  __syncthreads();
  if (n_adm >= k && t < n_adm) {   // the k-th largest, ties by slot
    const unsigned int b = bbest[t];
    int rank = 0;
    for (int i = 0; i < n_adm; ++i)
      rank += bbest[i] > b || (bbest[i] == b && i < t);
    if (rank == k - 1) tau2 = b;
  }
  __syncthreads();
  const unsigned int kth = tau2;
#pragma unroll
  for (int i = 0; i < PER; ++i) {   // every lane, every i: warp_append
    const int c = t + i * THREADS;
    const bool pred = c < n && key_of(v[i]) >= kth;
    const uint32_t row = pred ? (uint32_t)slots[c / BLK] * BLK + c % BLK : 0u;
    warp_append(pred, &n_sel, cand_key(v[i], row), cand, MAX_CAND);
  }
  __syncthreads();
  emit_top_k(cand, n_sel, k, out_s + (size_t)qi * k, out_i + (size_t)qi * k);
}

}  // namespace

// The bytes of K4's scratch for Q queries over N rows (Scratch above).
extern "C" long long sq8_select_scratch_bytes(int Q, int N) {
  return scratch_bytes(Q, N / BLK);
}

// Launches K4's three kernels on `stream`; returns the first CUDA error
// (0 on success). bmax f32[Q, N/64], eps f32[Q], q f32[Q, D], base f32[N,
// D], sq_eff f32[N] in; out_s f32[Q, k], out_i i32[Q, k], flag f32[Q] out;
// `scratch` sq8_select_scratch_bytes(Q, N) bytes, 16-byte aligned. All
// contiguous on one device; N % 64 == 0, 1 <= k <= 124.
extern "C" int sq8_select_launch(const void* bmax, const void* eps,
                                 const void* q, const void* base,
                                 const void* sq_eff, void* out_s, void* out_i,
                                 void* flag, void* scratch, int Q, int N,
                                 int D, int k, float fac, void* stream) {
  const int G = N / BLK, W = (Q + 63) / 64;
  if (Q <= 0 || N <= 0 || N % BLK != 0 || D <= 0 || k <= 0 ||
      k + MARGIN > S_SLOTS || (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = carve(scratch, Q, G, W);
  cudaError_t e = cudaMemsetAsync(scratch, 0, zeroed_bytes(G, W), st);
  if (e != cudaSuccess) return (int)e;

  // 1. admit
  const int smem_a = G <= STAGE_G ? G * (int)sizeof(float) : 0;
  e = cudaFuncSetAttribute(
      sq8_admit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STAGE_G * (int)sizeof(float));
  if (e != cudaSuccess) return (int)e;
  sq8_admit_kernel<<<Q, THREADS, smem_a, st>>>(
      (const float*)bmax, (const float*)eps, (float*)out_s, (int*)out_i,
      (float*)flag, s, Q, G, W, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 2. score: the widest slice of a block whose ring and query list fit
  ScoreArgs b = {};
  b.q = (const float*)q;
  b.base = (const float*)base;
  b.sq_eff = (const float*)sq_eff;
  b.s = s;
  b.Q = Q, b.D = D, b.W = W, b.fac = fac;
  b.n_slabs = (D + 31) / 32;
  const rxtc::EncodeTiled enc = rxtc::encode_tiled();
  const bool vec_ok = enc != nullptr && D % 4 == 0 &&
                      (uintptr_t)base % 16 == 0 && (uintptr_t)q % 16 == 0;
  b.RB = BLK;
  while (b.RB > 8 && SCORE_STAGES * b.n_slabs * b.RB * 128 + Q * 8 + 1024 >
                         SCORE_SMEM)
    b.RB >>= 1;
  const bool async_ok =
      vec_ok &&
      SCORE_STAGES * b.n_slabs * b.RB * 128 + Q * 8 + 1024 <=
          SCORE_SMEM_MAX &&
      rxtc::make_map_2d(enc, &b.map_base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        base, N, D, 32, b.RB, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!async_ok) {
    b.P = D | 1;
    b.RB = BLK;
    while (b.RB > 1 && SCORE_STAGES * b.RB * b.P * 4 + Q * 8 + 1024 >
                           SCORE_SMEM)
      b.RB >>= 1;
  }
  const bool qs = async_ok && Q * D * 4 <= QS_BYTES;
  void (*score)(const ScoreArgs) =
      !async_ok ? sq8_score_kernel<false, false>
                : qs ? sq8_score_kernel<true, true>
                     : sq8_score_kernel<true, false>;
  // the grid from the occupancy of the ring and the queries, then the chunk
  // of items whose metadata is staged at once: a CTA's share of the most
  // blocks the queries can list (S_SLOTS a query), at most SCORE_CHUNK
  const int slice = async_ok ? b.n_slabs * b.RB * 32 : b.RB * b.P;
  const int ring_b = 1024 + SCORE_STAGES * 4 * slice + (qs ? Q * D * 4 : 0);
  const int est = min(ring_b + 8 * Q + 4096, SCORE_SMEM_MAX);
  e = cudaFuncSetAttribute(score, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           est);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score,
                                                    SCORE_THREADS, est);
  if (e != cudaSuccess) return (int)e;
  const int grid = max(1, per_sm) * sm_count();
  const long long listed = min((long long)G, (long long)Q * S_SLOTS);
  const int per_item = 8 * W + 4 + Q;
  b.chunk = (int)min((long long)SCORE_CHUNK,
                     (listed * (BLK / b.RB) + grid - 1) / grid);
  b.chunk = min(b.chunk, (SCORE_SMEM_MAX - ring_b - 8 * Q) / per_item);
  if (b.chunk < 1) return (int)cudaErrorInvalidValue;   // Q past ~10,000
  const int smem_b = ring_b + 8 * Q + b.chunk * per_item;
  if (smem_b > est) {
    e = cudaFuncSetAttribute(
        score, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
    if (e != cudaSuccess) return (int)e;
  }
  score<<<grid, SCORE_THREADS, smem_b, st>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // 3. emit
  const int smem_c = MAX_CAND * (int)sizeof(unsigned long long);
  e = cudaFuncSetAttribute(
      sq8_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_c);
  if (e != cudaSuccess) return (int)e;
  sq8_emit_kernel<<<Q, THREADS, smem_c, st>>>(
      (const float*)flag, (float*)out_s, (int*)out_i, s, k);
  return (int)cudaGetLastError();
}

extern "C" const char* sq8_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
