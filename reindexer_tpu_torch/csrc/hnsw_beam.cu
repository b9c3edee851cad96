// K7 `hnsw_beam`: the whole batched HNSW beam search of one graph layer in
// one persistent, cooperatively launched kernel, for Hopper (sm_90a); and
// beside it `hnsw_descend`, the greedy descent through the upper layers
// that picks the beam's entries (at the end of this file's kernels).
//
// Replaces no TPU kernel: the JAX package's beam is plain XLA, the
// `lax.while_loop` of reindexer_tpu/ops/hnsw_kernels.py::_beam_loop. Its
// plain PyTorch twin is ops/hnsw_kernels.py::_beam_plain (one step,
// `_beam_step`, is ~60 small kernels), which the CPU runs and the tests
// hold this kernel to, bit for bit where fp32 sums are exact.
//
// Contract, per query q of Q (W and C ef wide, sorted best-first, empty
// slots -inf / -1):
//   - "layer" (entry != null): W = the E0 entries in their order, scored;
//     C = the same, stably sorted; visited = the entries' bits, added.
//     "resume": W, C and visited copied from the inputs.
//   - then, while some query is active (its best frontier score >= its
//     worst result score, -inf counting as the lowest float) and it <
//     max_iters, every query takes one step: pop the `expand` head of C,
//     gather their links, drop ids at an earlier position of the step,
//     test and set the visited bit, score the fresh rows, and merge W u new
//     and (C - popped) u new, keeping the top ef of each. Equal scores keep
//     the order of a stable sort of that concatenation: the old list
//     first, then the new rows in (popped slot, link slot) order.
//   - Scores in fp32 FMA: q.v (IP, cosine), 2 q.v - |v|^2 - |q|^2 (L2);
//     SQ8 rows dot code with q * alpha, plus q.lo.
//   - `it` (the JAX loop's count) goes to ctl[CTL_IT].
//
// What bounds it on the H100: latency, not bytes. A step of one query reads
// two link rows, K = expand * M0 visited words and the fresh rows among K
// (at 100k x 96, Q 64, ef 128, expand 2: ~64 rows of 384 bytes, ~25 KB a
// query and step, ~176 MB for a search of ~112 steps, 0.053 ms at 3.35
// TB/s, from L2 in practice). But each step is a dependent chain: the
// frontier's head, then the link rows, then the visited words, then the
// rows, then the merge, then a grid-wide vote on the stop, ~112 times. The
// replayed CUDA graphs it replaces ran ~60 kernels a step and read the stop
// flag on the host every 8 steps. Measured on one H100 SXM (700 W) at that
// shape, a search of 111 steps: 1.11 ms (10.0 us a step) against the bytes'
// bound of 0.028 ms (236k rows scored, 95 MB: 2.5%); the graph replays took
// 16.1 ms, the plain twin run eagerly 147 ms. No library call does a graph
// search.
//
// What the design does about it:
//   - One launch a search. Blocks persist for the whole loop; a block owns
//     one query at a time and walks queries blockIdx.x, + gridDim.x, ...
//     (grid = min(Q, the blocks that co-reside)). W and C live in the
//     output tensors between steps and in shared memory during one (a
//     block that owns one query keeps the query there throughout); the
//     visited bitset stays a [Q, n_words] int32 tensor. Where a block's
//     arrays outgrow shared memory (ef past ~9,500 at D 96, or a very wide
//     D), they spill whole to a global scratch of the caller's, a slice a
//     block: every ef and D run, the spilled ones slower.
//   - The batch-wide stop without the host: after each step thread 0 of
//     every block adds one arrival and its active queries to one 64-bit
//     word (one atomic); the last block to arrive clears it and publishes
//     the round and the verdict in a second word, on which the others wait
//     (`vote`). A query's stop test reads W[ef - 1] and C[0] as the merge
//     placed them, in shared memory, so a round costs one atomic and one
//     wait. The cooperative launch is what makes the spinning wait safe:
//     it fails rather than start more blocks than can be resident at once.
//   - The step in shared memory: 8 lanes score a row (float4 or uchar4
//     loads, two rows a group at a time), the visited test-and-set is one
//     atomicOr a distinct id, and the merge places every finite element
//     directly: an old element at its index plus the new rows above it, a
//     new row at its rank among the new rows plus the old elements at or
//     above it (a binary search: the old list is sorted). One stable bitonic
//     sort of W and of (C - popped) on the first step makes inputs that
//     were not sorted exact too; later steps' lists are sorted already.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GL = 8;                   // lanes that score one row together
constexpr int GROUPS = THREADS / GL;
constexpr int SMEM_MAX = 232448;        // a block's dynamic shared memory
constexpr int SMEM_RESERVE = 1024;      // static shared memory and slack
constexpr float F32_LOWEST = -3.40282346638528859812e+38f;

// ctl: int32 words, zeroed by the caller
constexpr int CTL_VOTES = 0;    // u64: blocks arrived << 32 | active queries
constexpr int CTL_GEN = 2;      // rounds passed << 1 | the last round's go
constexpr int CTL_IT = 5;       // the loop's count, written at the end

struct Params {
  const float* q;          // [Q, D]
  const void* data;        // [N, D] f32 rows or u8 codes
  const float* data_sq;    // [N]
  const float* lo;         // [D] (SQ8)
  const float* alpha;      // [D] (SQ8)
  const int* links;        // [N, M0]
  const int* entry;        // [Q, E0] ("layer") or null ("resume")
  const float* w_in_s;     // [Q, ef] ("resume")
  const int* w_in_i;
  const float* c_in_s;
  const int* c_in_i;
  const int* vis_in;       // [Q, n_words]
  float* w_s;              // [Q, ef] out, and the state between steps
  int* w_i;
  float* c_s;
  int* c_i;
  int* vis;                // [Q, n_words] out
  int* ctl;
  unsigned char* spill;    // [grid, spill_block] or null (shared memory)
  size_t spill_block;
  int Q, D, M0, E0, ef, expand, max_iters, n_words, l2;
  // the descent: links is the top-first stack [Lu, N, M0], entry [Q]
  int* out;                // [Q] the layer-0 entries
  int Lu, N, max_hops;
};

// per-block scalars in static shared memory
struct Scalars {
  float qsq, qlo;          // |q|^2, q.lo of the block's current query
  int cnt[2];              // finite slots of W and C after the merge
  float edge[2];           // W[ef - 1] and C[0] after the merge
  int go;                  // the last vote
};

// a block's arrays, in dynamic shared memory or in its slice of the spill,
// each 16-byte aligned; K4 = ceil(K / 4)
struct Smem {
  float* qv;               // the query (SQ8: q * alpha), D rounded up to 4
  float* ns;               // 4 K4 new scores (-inf past K)
  int* nb;                 // 4 K4 gathered link ids
  int* nid;                // K new ids (-1: not fresh)
  int* nr;                 // K ranks among the new rows
  unsigned long long* keys;  // ef sort keys (first step)
  float* ws;               // W, C: ef each
  int* wi;
  float* cs;
  int* ci;
};

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// the arrays' sizes in bytes, in Smem's order
__host__ __device__ __forceinline__ void smem_sizes(int D, int K, int ef,
                                                    size_t* sz) {
  const size_t k4 = 4 * (size_t)((K + 3) / 4);
  sz[0] = align16(4 * (size_t)D);
  sz[1] = sz[2] = align16(4 * k4);
  sz[3] = sz[4] = align16(4 * (size_t)K);
  sz[5] = align16(8 * (size_t)ef);
  sz[6] = sz[7] = sz[8] = sz[9] = align16(4 * (size_t)ef);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ int d_pad(int D) { return (D + 3) & ~3; }

__device__ __forceinline__ Smem carve(unsigned char* raw, const Params& p) {
  size_t sz[10];
  smem_sizes(p.D, p.expand * p.M0, p.ef, sz);
  void* at[10];
  for (int i = 0; i < 10; ++i) at[i] = raw, raw += sz[i];
  Smem s;
  s.qv = (float*)at[0];
  s.ns = (float*)at[1];
  s.nb = (int*)at[2];
  s.nid = (int*)at[3];
  s.nr = (int*)at[4];
  s.keys = (unsigned long long*)at[5];
  s.ws = (float*)at[6];
  s.wi = (int*)at[7];
  s.cs = (float*)at[8];
  s.ci = (int*)at[9];
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the query of row qi into shared memory, |q|^2 and q.lo into qsq / qlo
// (read after the caller's next __syncthreads)
template <bool SQ8>
__device__ void load_query(const Params& p, const Smem& sm, int qi,
                           float* qsq, float* qlo) {
  const float* q = p.q + (size_t)qi * p.D;
  for (int d = threadIdx.x; d < d_pad(p.D); d += THREADS)
    sm.qv[d] = d < p.D ? (SQ8 ? q[d] * p.alpha[d] : q[d]) : 0.f;
  if (threadIdx.x < 32) {
    float sq = 0.f, lo = 0.f;
    for (int d = threadIdx.x; d < p.D; d += 32) {
      const float x = q[d];
      sq = fmaf(x, x, sq);
      if (SQ8) lo = fmaf(x, p.lo[d], lo);
    }
    sq = warp_sum(sq);
    lo = warp_sum(lo);
    if (threadIdx.x == 0) *qsq = sq, *qlo = lo;
  }
}

// this lane's part of the dot of row id with the query (8 lanes a row)
template <bool SQ8>
__device__ __forceinline__ float part_dot(const Params& p, const Smem& sm,
                                          int id, int sub) {
  float acc = 0.f;
  if (id < 0) return acc;
  const size_t off = (size_t)id * p.D;
  if ((p.D & 3) == 0) {
    const float4* q4 = (const float4*)sm.qv;
    for (int d = sub; d < p.D / 4; d += GL) {
      const float4 w = q4[d];
      float4 v;
      if (SQ8) {
        const uchar4 c = ((const uchar4*)((const uint8_t*)p.data + off))[d];
        v = make_float4(c.x, c.y, c.z, c.w);
      } else {
        v = ((const float4*)((const float*)p.data + off))[d];
      }
      acc = fmaf(v.x, w.x, acc);
      acc = fmaf(v.y, w.y, acc);
      acc = fmaf(v.z, w.z, acc);
      acc = fmaf(v.w, w.w, acc);
    }
  } else {
    for (int d = sub; d < p.D; d += GL) {
      const float v = SQ8 ? (float)((const uint8_t*)p.data)[off + d]
                          : ((const float*)p.data)[off + d];
      acc = fmaf(v, sm.qv[d], acc);
    }
  }
  return acc;
}

// scores of rows ids[0..n) into out (-inf where the id is negative); every
// thread of the block calls it; ends with __syncthreads
template <bool SQ8>
__device__ void score_rows(const Params& p, const Smem& sm, const int* ids,
                           float* out, int n, float qsq, float qlo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (GL - 1);
  // the trip count is the same for the whole warp (shuffles below)
  for (int base = warp * (32 / GL); base < n; base += 2 * GROUPS) {
    const int c0 = base + lane / GL, c1 = c0 + GROUPS;
    const int id0 = c0 < n ? ids[c0] : -1, id1 = c1 < n ? ids[c1] : -1;
    float a0 = part_dot<SQ8>(p, sm, id0, sub);
    float a1 = part_dot<SQ8>(p, sm, id1, sub);
#pragma unroll
    for (int o = GL / 2; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    }
    if (sub == 0) {
      if (SQ8) a0 += qlo, a1 += qlo;
      if (c0 < n)
        out[c0] = id0 < 0 ? neg_inf()
                  : p.l2  ? 2.f * a0 - p.data_sq[id0] - qsq
                          : a0;
      if (c1 < n)
        out[c1] = id1 < 0 ? neg_inf()
                  : p.l2  ? 2.f * a1 - p.data_sq[id1] - qsq
                          : a1;
    }
  }
  __syncthreads();
}

// a float's order as an unsigned key (-0 as +0)
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// keys[0..n) descending: the bitonic network whose comparators all put the
// larger key first (each merge starts by comparing mirrored positions), so
// the missing positions past n, taken as smallest, never move
__device__ void bitonic_desc(unsigned long long* keys, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += THREADS) {
        const int i = (t / j) * 2 * j + t % j;
        const int m = j == (k >> 1) ? (i / k) * k + k - 1 - i % k : i + j;
        if (m < n) {
          const unsigned long long a = keys[i], b = keys[m];
          if (a < b) keys[i] = b, keys[m] = a;
        }
      }
      __syncthreads();
    }
  }
}

// s / ids [0..n) := the stable best-first sort of the list (gs, gi) with
// its first nmask slots emptied
__device__ void stable_sort(const Smem& sm, float* s, int* ids,
                            const float* gs, const int* gi, int n,
                            int nmask) {
  for (int i = threadIdx.x; i < n; i += THREADS)
    sm.keys[i] = ((unsigned long long)order_key(i < nmask ? neg_inf() : s[i])
                  << 32) | (0xffffffffu - (unsigned)i);
  __syncthreads();
  bitonic_desc(sm.keys, n);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int src = (int)(0xffffffffu - (unsigned)sm.keys[i]);
    const bool masked = src < nmask;
    s[i] = masked ? neg_inf() : gs[src];
    ids[i] = masked ? -1 : gi[src];
  }
  __syncthreads();
}

// elements of the best-first list a[lo..hi) that are >= s
__device__ __forceinline__ int count_ge(const float* a, int lo, int hi,
                                        float s) {
  int l = lo, h = hi;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (a[mid] >= s) l = mid + 1;
    else h = mid;
  }
  return l - lo;
}

// The loops below read the step's K new scores or ids four at a time and
// unrolled, so that the shared-memory loads overlap: one at a time, each
// waits out the load before it (~30 cycles), 2,000 cycles for K = 64.

// the new scores above s (the padding past K is -inf)
__device__ __forceinline__ int count_gt(const float* ns, int k4, float s) {
  const float4* n4 = (const float4*)ns;
  int c = 0;
#pragma unroll 4
  for (int l = 0; l < k4; ++l) {
    const float4 v = n4[l];
    c += (v.x > s) + (v.y > s) + (v.z > s) + (v.w > s);
  }
  return c;
}

// the rank of new score s at position c among the new scores: those above
// it, and those equal to it at an earlier position
__device__ __forceinline__ int new_rank(const float* ns, int k4, float s,
                                        int c) {
  const float4* n4 = (const float4*)ns;
  int r = 0;
#pragma unroll 4
  for (int l = 0; l < k4; ++l) {
    const float4 v = n4[l];
    const int b = 4 * l;
    r += (v.x > s) | ((v.x == s) & (b < c));
    r += (v.y > s) | ((v.y == s) & (b + 1 < c));
    r += (v.z > s) | ((v.z == s) & (b + 2 < c));
    r += (v.w > s) | ((v.w == s) & (b + 3 < c));
  }
  return r;
}

// whether id is at a position before c among the gathered ids
__device__ __forceinline__ bool seen_before(const int* nb, int id, int c) {
  const int4* n4 = (const int4*)nb;
  bool dup = false;
#pragma unroll 4
  for (int l = 0; l < (c + 3) / 4; ++l) {
    const int4 v = n4[l];
    const int b = 4 * l;
    dup |= ((v.x == id) & (b < c)) | ((v.y == id) & (b + 1 < c)) |
           ((v.z == id) & (b + 2 < c)) | ((v.w == id) & (b + 3 < c));
  }
  return dup;
}

template <bool SQ8>
__device__ void init_query(const Params& p, const Smem& sm, int qi,
                           float* qsq, float* qlo) {
  const int ef = p.ef;
  const size_t base = (size_t)qi * ef;
  int* vis = p.vis + (size_t)qi * p.n_words;
  if (p.entry == nullptr) {
    for (int i = threadIdx.x; i < ef; i += THREADS) {
      p.w_s[base + i] = p.w_in_s[base + i];
      p.w_i[base + i] = p.w_in_i[base + i];
      p.c_s[base + i] = p.c_in_s[base + i];
      p.c_i[base + i] = p.c_in_i[base + i];
    }
    const int* src = p.vis_in + (size_t)qi * p.n_words;
    for (int w = threadIdx.x; w < p.n_words; w += THREADS) vis[w] = src[w];
    __syncthreads();
    return;
  }
  load_query<SQ8>(p, sm, qi, qsq, qlo);
  for (int w = threadIdx.x; w < p.n_words; w += THREADS) vis[w] = 0;
  __syncthreads();
  const int* ent = p.entry + (size_t)qi * p.E0;
  for (int e = threadIdx.x; e < p.E0; e += THREADS) {
    const int id = ent[e];
    sm.wi[e] = id >= 0 ? id : -1;
    // the bits are added, as the plain version's scatter_add_
    if (id >= 0) atomicAdd(vis + (id >> 5), (int)(1u << (id & 31)));
  }
  __syncthreads();
  score_rows<SQ8>(p, sm, sm.wi, sm.ws, p.E0, *qsq, *qlo);
  for (int i = threadIdx.x; i < ef; i += THREADS) {
    if (i < p.E0) {
      const float s = sm.ws[i];
      int r = 0;
      for (int e = 0; e < p.E0; ++e)
        r += (sm.ws[e] > s) | ((sm.ws[e] == s) & (e < i));
      p.w_s[base + i] = s;
      p.w_i[base + i] = sm.wi[i];
      p.c_s[base + r] = s;
      p.c_i[base + r] = sm.wi[i];
    } else {
      p.w_s[base + i] = p.c_s[base + i] = neg_inf();
      p.w_i[base + i] = p.c_i[base + i] = -1;
    }
  }
  __syncthreads();
}

// whether a query whose best frontier score is c0 and worst result w_last
// can still improve (-inf counts as the lowest float)
__device__ __forceinline__ bool active(float c0, float w_last) {
  return c0 >= fmaxf(w_last, F32_LOWEST);
}

// one step of query qi; returns (to thread 0) whether it is active after
// the step. A block that owns one query keeps it in shared memory.
template <bool SQ8>
__device__ bool beam_step(const Params& p, const Smem& sm, Scalars& sc,
                          int qi, bool first) {
  const int ef = p.ef, M0 = p.M0, K = p.expand * M0, k4 = (K + 3) / 4;
  const size_t base = (size_t)qi * ef;
  float *gws = p.w_s + base, *gcs = p.c_s + base;
  int *gwi = p.w_i + base, *gci = p.c_i + base;
  if (first || (int)gridDim.x < p.Q)
    load_query<SQ8>(p, sm, qi, &sc.qsq, &sc.qlo);
  for (int i = threadIdx.x; i < ef; i += THREADS) {
    sm.ws[i] = gws[i], sm.wi[i] = gwi[i];
    sm.cs[i] = gcs[i], sm.ci[i] = gci[i];
  }
  __syncthreads();
  // 1. the popped head's links
  for (int c = threadIdx.x; c < K; c += THREADS) {
    const int j = c / M0;
    sm.nb[c] = sm.cs[j] > neg_inf()
                   ? p.links[(size_t)sm.ci[j] * M0 + (c - j * M0)]
                   : -1;
  }
  __syncthreads();
  // 2. ids at an earlier position dropped; the visited test and set
  unsigned* vis = (unsigned*)p.vis + (size_t)qi * p.n_words;
  for (int c = threadIdx.x; c < K; c += THREADS) {
    const int id = sm.nb[c];
    bool fresh = id >= 0 && !seen_before(sm.nb, id, c);
    if (fresh) {
      const unsigned bit = 1u << (id & 31);
      fresh = !(atomicOr(vis + (id >> 5), bit) & bit);
    }
    sm.nid[c] = fresh ? id : -1;
  }
  __syncthreads();
  // 3. the fresh rows' scores
  score_rows<SQ8>(p, sm, sm.nid, sm.ns, K, sc.qsq, sc.qlo);
  // 4. the first step sorts W and C - popped (a no-op when they are sorted)
  int coff = p.expand;
  if (first) {
    stable_sort(sm, sm.ws, sm.wi, gws, gwi, ef, 0);
    stable_sort(sm, sm.cs, sm.ci, gcs, gci, ef, p.expand);
    coff = 0;
  }
  // 5. merge: W u new and C[coff..ef) u new, best-first
  for (int c = threadIdx.x; c < K; c += THREADS) {
    const float s = sm.ns[c];
    sm.nr[c] = s > neg_inf() ? new_rank(sm.ns, k4, s, c) : 0;
  }
  if (threadIdx.x < 32) {
    int n_new = 0;
    for (int l0 = 0; l0 < K; l0 += 32) {
      const int l = l0 + threadIdx.x;
      n_new += __popc(__ballot_sync(0xffffffffu,
                                    l < K && sm.ns[l] > neg_inf()));
    }
    if (threadIdx.x == 0) {
      sc.cnt[0] = min(ef, count_ge(sm.ws, 0, ef, F32_LOWEST) + n_new);
      sc.cnt[1] = min(ef, count_ge(sm.cs, coff, ef, F32_LOWEST) + n_new);
      // W[ef - 1] and C[0] after the merge: whatever lands there, else
      // an empty slot
      sc.edge[0] = sc.edge[1] = neg_inf();
    }
  }
  __syncthreads();
  const int *cnt = sc.cnt;
  for (int i = threadIdx.x; i < ef; i += THREADS) {
    float s = sm.ws[i];
    if (s > neg_inf()) {
      const int pos = i + count_gt(sm.ns, k4, s);
      if (pos < ef) gws[pos] = s, gwi[pos] = sm.wi[i];
      if (pos == ef - 1) sc.edge[0] = s;
    }
    if (i >= cnt[0]) gws[i] = neg_inf(), gwi[i] = -1;
    if (coff + i < ef && (s = sm.cs[coff + i]) > neg_inf()) {
      const int pos = i + count_gt(sm.ns, k4, s);
      if (pos < ef) gcs[pos] = s, gci[pos] = sm.ci[coff + i];
      if (pos == 0) sc.edge[1] = s;
    }
    if (i >= cnt[1]) gcs[i] = neg_inf(), gci[i] = -1;
  }
  for (int c = threadIdx.x; c < K; c += THREADS) {
    const float s = sm.ns[c];
    if (s > neg_inf()) {
      int pos = sm.nr[c] + count_ge(sm.ws, 0, ef, s);
      if (pos < ef) gws[pos] = s, gwi[pos] = sm.nid[c];
      if (pos == ef - 1) sc.edge[0] = s;
      pos = sm.nr[c] + count_ge(sm.cs, coff, ef, s);
      if (pos < ef) gcs[pos] = s, gci[pos] = sm.nid[c];
      if (pos == 0) sc.edge[1] = s;
    }
  }
  __syncthreads();
  return active(sc.edge[1], sc.edge[0]);
}

// The stop's vote, a grid barrier that carries a count: thread 0 of each
// block adds (1 << 32) + its active queries to one 64-bit word; the last
// block to arrive clears it and publishes the round and whether any query
// was active in CTL_GEN, which the others wait on. Returns the same go in
// every block. A wait past ~2^34 cycles (seconds; a step takes
// microseconds) means a block that never arrives: the kernel traps rather
// than hang the card.
__device__ bool vote(const Params& p, int n_active, int* go) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = p.ctl + CTL_GEN;
    unsigned long long* votes = (unsigned long long*)(p.ctl + CTL_VOTES);
    const int g = *gen;
    __threadfence();
    const unsigned long long old =
        atomicAdd(votes, (1ull << 32) | (unsigned)n_active);
    if ((old >> 32) == gridDim.x - 1) {
      const bool any = (unsigned)old + (unsigned)n_active > 0;
      atomicExch(votes, 0ull);
      __threadfence();
      atomicExch(p.ctl + CTL_GEN, (((g >> 1) + 1) << 1) | (int)any);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        __nanosleep(32);
        if (clock64() - t0 > (1LL << 34)) __trap();
      }
    }
    __threadfence();
    *go = *gen & 1;
  }
  __syncthreads();
  return *go;
}

template <bool SQ8>
__global__ void __launch_bounds__(THREADS)
    hnsw_beam_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ Scalars sc;
  const Smem sm = carve(
      p.spill != nullptr ? p.spill + blockIdx.x * p.spill_block : raw, p);
  const int K = p.expand * p.M0, pad = K + (int)threadIdx.x;
  if (pad < 4 * ((K + 3) / 4)) sm.ns[pad] = neg_inf();
  int n_active = 0;      // thread 0's count of its block's active queries
  for (int qi = blockIdx.x; qi < p.Q; qi += gridDim.x) {
    init_query<SQ8>(p, sm, qi, &sc.qsq, &sc.qlo);
    if (threadIdx.x == 0)
      n_active += active(p.c_s[(size_t)qi * p.ef],
                         p.w_s[(size_t)qi * p.ef + p.ef - 1]);
  }
  int it = 0;
  bool more = it < p.max_iters && vote(p, n_active, &sc.go);
  while (more) {
    n_active = 0;
    for (int qi = blockIdx.x; qi < p.Q; qi += gridDim.x)
      n_active += beam_step<SQ8>(p, sm, sc, qi, it == 0);
    ++it;
    more = it < p.max_iters && vote(p, n_active, &sc.go);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctl[CTL_IT] = it;
}

// The greedy descent (ops/hnsw_kernels.py::greedy_descend), a block a
// query: from the entry, on each layer of the top-first stack, at most
// max_hops hops; a hop scores the M0 links of `cur` (skipping -1) with
// K7's scoring, takes the best score, the lowest link slot among equals
// (torch.max's and jnp.argmax's rule), and moves only when it is strictly
// greater than cur's; the layer ends at the first hop with no move. A query
// that did not move at a hop finds the same links at the next, so this
// per-query stop gives the JAX loop's batch-wide stop exactly. Each hop is
// a dependent chain (a link row, then its rows), a few us; the whole
// descent is one launch and the host reads nothing.
template <bool SQ8>
__global__ void __launch_bounds__(THREADS)
    hnsw_descend_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ float qsq, qlo, cur_s;
  __shared__ int cur, moved;
  unsigned char* at =
      p.spill != nullptr ? p.spill + blockIdx.x * p.spill_block : raw;
  const int qi = blockIdx.x, M = p.M0;
  Smem sm = {};
  sm.qv = (float*)at;
  sm.ns = (float*)(at + align16(4 * (size_t)p.D));
  sm.nb = (int*)((unsigned char*)sm.ns + align16(4 * (size_t)M));
  load_query<SQ8>(p, sm, qi, &qsq, &qlo);
  if (threadIdx.x == 0) sm.nb[0] = cur = p.entry[qi];
  __syncthreads();
  score_rows<SQ8>(p, sm, sm.nb, sm.ns, 1, qsq, qlo);
  if (threadIdx.x == 0) cur_s = sm.ns[0];
  for (int l = 0; l < p.Lu; ++l) {
    const int* links = p.links + (size_t)l * p.N * M;
    for (int hop = 0; hop < p.max_hops; ++hop) {
      __syncthreads();
      const int c0 = cur;
      for (int c = threadIdx.x; c < M; c += THREADS)
        sm.nb[c] = c0 >= 0 ? links[(size_t)c0 * M + c] : -1;
      __syncthreads();
      score_rows<SQ8>(p, sm, sm.nb, sm.ns, M, qsq, qlo);
      if (threadIdx.x < 32) {
        float bs = neg_inf();
        int bc = M;
        for (int c = threadIdx.x; c < M; c += 32)
          if (sm.ns[c] > bs) bs = sm.ns[c], bc = c;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float s2 = __shfl_xor_sync(0xffffffffu, bs, o);
          const int c2 = __shfl_xor_sync(0xffffffffu, bc, o);
          if (s2 > bs || (s2 == bs && c2 < bc)) bs = s2, bc = c2;
        }
        if (threadIdx.x == 0) {
          moved = bs > cur_s;
          if (moved) cur = sm.nb[bc], cur_s = bs;
        }
      }
      __syncthreads();
      if (!moved) break;
    }
  }
  if (threadIdx.x == 0) p.out[qi] = cur;
}

size_t dyn_smem(int D, int K, int ef) {
  size_t sz[10], n = 0;
  smem_sizes(D, K, ef, sz);
  for (size_t x : sz) n += x;
  return n;
}

// the descent's arrays: the query, M0 scores and M0 link ids
size_t descend_smem(int D, int M0) {
  return align16(4 * (size_t)D) + 2 * align16(4 * (size_t)M0);
}

bool fits_smem(size_t need) {
  return need <= (size_t)(SMEM_MAX - SMEM_RESERVE);
}

// The launch's shape: dynamic shared memory (0 when the arrays spill), the
// bytes of a block's slice of the spill (0 when they do not) and the grid.
struct Shape {
  int smem;
  size_t spill_block;
  int grid;
};

// a block's `need` bytes of arrays in dynamic shared memory, or in a spill
cudaError_t smem_shape(void (*kernel)(const Params), size_t need, Shape* s) {
  const bool fits = fits_smem(need);
  s->smem = fits ? (int)need : 0;
  s->spill_block = fits ? 0 : need;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s->smem);
}

cudaError_t launch_shape(int Q, int D, int K, int ef, int sq8, Shape* s) {
  void (*kernel)(const Params) =
      sq8 ? hnsw_beam_kernel<true> : hnsw_beam_kernel<false>;
  cudaError_t e = smem_shape(kernel, dyn_smem(D, K, ef), s);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, s->smem)) != cudaSuccess)
    return e;
  s->grid = per_sm * sms < Q ? per_sm * sms : Q;
  return s->grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// The bytes of global scratch a launch at these sizes takes (its `spill`):
// 0 where a block's arrays fit its shared memory; -1 on a CUDA error.
extern "C" long long hnsw_beam_spill_bytes(int Q, int D, int K, int ef,
                                           int sq8) {
  if (Q <= 0 || D <= 0 || K <= 0 || ef <= 0) return 0;
  Shape s;
  if (launch_shape(Q, D, K, ef, sq8, &s) != cudaSuccess) return -1;
  return (long long)(s.spill_block * (size_t)s.grid);
}

// Launches K7 on `stream`; returns the first CUDA error (0 on success).
// q f32[Q, D]; data f32[N, D] (sq8 0) or u8[N, D] (sq8 1, with lo, alpha
// f32[D]); data_sq f32[N]; links i32[N, M0]; "layer": entry i32[Q, E0],
// 0 <= E0 <= ef, the *_in pointers null; "resume": entry null, w_in_s /
// w_in_i / c_in_s / c_in_i [Q, ef], vis_in i32[Q, n_words]. Out: w_s, w_i,
// c_s, c_i [Q, ef], vis i32[Q, n_words]; ctl i32[8] zeroed (ctl[5] gets
// `it`); spill hnsw_beam_spill_bytes(Q, D, expand * M0, ef, sq8) bytes, or
// null where that is 0. All contiguous on one device; 1 <= expand <= ef.
extern "C" int hnsw_beam_launch(
    const void* q, const void* data, const void* data_sq, const void* lo,
    const void* alpha, const void* links, const void* entry,
    const void* w_in_s, const void* w_in_i, const void* c_in_s,
    const void* c_in_i, const void* vis_in, void* w_s, void* w_i, void* c_s,
    void* c_i, void* vis, void* ctl, void* spill, int Q, int D, int M0,
    int E0, int ef, int expand, int max_iters, int n_words, int l2, int sq8,
    void* stream) {
  const int K = expand * M0;
  if (Q < 0 || D <= 0 || M0 <= 0 || expand < 1 || expand > ef ||
      n_words <= 0 ||
      (entry != nullptr ? E0 < 0 || E0 > ef
                        : w_in_s == nullptr || vis_in == nullptr) ||
      (sq8 && (lo == nullptr || alpha == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  Shape shape;
  cudaError_t e = launch_shape(Q, D, K, ef, sq8, &shape);
  if (e != cudaSuccess) return (int)e;
  if ((shape.spill_block > 0) != (spill != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = (const float*)q;
  p.data = data;
  p.data_sq = (const float*)data_sq;
  p.lo = (const float*)lo;
  p.alpha = (const float*)alpha;
  p.links = (const int*)links;
  p.entry = (const int*)entry;
  p.w_in_s = (const float*)w_in_s;
  p.w_in_i = (const int*)w_in_i;
  p.c_in_s = (const float*)c_in_s;
  p.c_in_i = (const int*)c_in_i;
  p.vis_in = (const int*)vis_in;
  p.w_s = (float*)w_s, p.w_i = (int*)w_i;
  p.c_s = (float*)c_s, p.c_i = (int*)c_i;
  p.vis = (int*)vis;
  p.ctl = (int*)ctl;
  p.spill = (unsigned char*)spill;
  p.spill_block = shape.spill_block;
  p.Q = Q, p.D = D, p.M0 = M0, p.E0 = E0, p.ef = ef, p.expand = expand;
  p.max_iters = max_iters, p.n_words = n_words, p.l2 = l2;
  void (*kernel)(const Params) =
      sq8 ? hnsw_beam_kernel<true> : hnsw_beam_kernel<false>;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(shape.grid),
                                  dim3(THREADS), args, (size_t)shape.smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bytes of global scratch a descent at these sizes takes (its
// `spill`): 0 where a block's arrays fit its shared memory.
extern "C" long long hnsw_descend_spill_bytes(int Q, int D, int M0) {
  if (Q <= 0 || D <= 0 || M0 <= 0) return 0;
  const size_t need = descend_smem(D, M0);
  return fits_smem(need) ? 0 : (long long)(need * (size_t)Q);
}

// Launches the descent on `stream`; returns the first CUDA error (0 on
// success). q, data, data_sq, lo, alpha as K7's; links i32[Lu, N, M0] top
// first; entry i32[Q], valid rows; out i32[Q]; spill
// hnsw_descend_spill_bytes(Q, D, M0) bytes, or null where that is 0. All
// contiguous on one device.
extern "C" int hnsw_descend_launch(
    const void* q, const void* data, const void* data_sq, const void* lo,
    const void* alpha, const void* links, const void* entry, void* out,
    void* spill, int Q, int D, int M0, int Lu, int N, int max_hops, int l2,
    int sq8, void* stream) {
  if (Q < 0 || D <= 0 || M0 <= 0 || Lu < 0 || N <= 0 || max_hops < 0 ||
      entry == nullptr || out == nullptr ||
      (sq8 && (lo == nullptr || alpha == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  void (*kernel)(const Params) =
      sq8 ? hnsw_descend_kernel<true> : hnsw_descend_kernel<false>;
  Shape shape;
  cudaError_t e = smem_shape(kernel, descend_smem(D, M0), &shape);
  if (e != cudaSuccess) return (int)e;
  if ((shape.spill_block > 0) != (spill != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = (const float*)q;
  p.data = data;
  p.data_sq = (const float*)data_sq;
  p.lo = (const float*)lo;
  p.alpha = (const float*)alpha;
  p.links = (const int*)links;
  p.entry = (const int*)entry;
  p.out = (int*)out;
  p.spill = (unsigned char*)spill;
  p.spill_block = shape.spill_block;
  p.Q = Q, p.D = D, p.M0 = M0, p.l2 = l2;
  p.Lu = Lu, p.N = N, p.max_hops = max_hops;
  kernel<<<Q, THREADS, shape.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* hnsw_beam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
