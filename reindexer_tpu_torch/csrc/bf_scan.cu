// K1 `bf_scan`: partial scores and 64-row block maxima of the exact
// brute-force KNN scan, for Hopper (sm_90a), on the tensor cores.
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
// What bounds it on the H100: bytes. Each base row is read once (N*D*4
// bytes, 67 MB at 131072 x 128) and S is written once (Q*N*4 bytes, 33.5 MB
// at Q = 64): 30 us at 3.35 TB/s. The 2*Q*N*D products are fp32-accurate
// through a 3xTF32 split on the tensor cores, three TF32 products each:
// 13 us at 495 TFLOP/s, below the bytes. (The first K1, fp32 FMA in a 4x4
// register tile, sat at the 67 TFLOP/s fp32 FMA roof: 32 us at best.)
//
// Precision: plain TF32 keeps 11 bits and breaks the exact top-k contract,
// so the product is fp32-accurate through a 3xTF32 split, hi.hi + hi.lo +
// lo.hi with the lo.lo term dropped. A query value x splits into hi =
// tf32(x) and lo = tf32(x - hi), both rounded to nearest. A base value's hi
// is the fp32 value itself, which the wgmma reads as TF32 by dropping its
// low 13 bits, and its lo = tf32(x - trunc(x)). The terms left out are
// about 2^-21 of |q_d b_d| at most. The tensor cores add each k-step into
// the accumulator with truncation, so hi.hi and the two small terms go to
// two accumulators, summed once at the end in fp32: S stays within a few
// fp32 ulps of sum_d |q_d b_d| (chip_smoke.py holds it to 8).
//
// What the design does about it:
//   - `wgmma` m64n128k8 (tf32, K-major operands): a tile is the <= 64
//     queries of a query group (M = 64, one warpgroup) by 128 base rows
//     (N = 128); the three products of a k-step are three wgmmas into two
//     fp32 accumulators of 64 registers a thread each.
//   - Persistent CTAs, one per SM (193 KB of shared memory), each walking
//     its tiles in D-chunks of 32 columns: every chunk's 128 base rows
//     arrive by a TMA tile copy (2D tensor map, 128-byte swizzle, rows past
//     N and columns past D filled with zeros by the copy) into a 6-stage
//     ring guarded by mbarriers, refilled as soon as the wgmmas have read a
//     slot, so four chunks are in flight ahead of the one consumed. The grid
//     covers every tile at any Q, so one query uses the whole card.
//   - The warpgroups are specialized: a producer starts the TMA copies and
//     splits each chunk, a consumer runs the wgmmas and the epilogue;
//     they pass two split buffers back and forth through mbarriers, so the
//     split of chunk c+1 overlaps the wgmmas of chunk c. The split is what
//     bounds the kernel in practice, so it does as little as it can: the
//     base's hi is read by the wgmma straight from the ring slot (a 128-byte
//     swizzle descriptor), the split writes only the lo tile (8-row x
//     16-byte core matrices, no swizzle; it reads the swizzled slot free of
//     bank conflicts), rounding with integer operations; and for D <= 128
//     the query group's hi/lo tiles are split once and stay in shared memory
//     for every tile (wider D streams them through a second ring).
//   - Up to 8 queries (a single select among them) skip the tensor cores,
//     on which one query would waste 63 of a wgmma's 64 rows: the same
//     ring feeds a consumer that forms each base row's dot products in fp32
//     FMA straight from the slot, and the bound is the base's bytes alone.
//   - The epilogue computes fac * (hi + lo) - sq_eff, stores S in whole
//     32-byte sectors, and takes each 64-row block max with warp shuffles
//     from the very values it stores, so K2 thresholds and gathers the same
//     numbers bit for bit.
// Operands that a tensor map cannot take (D % 4 != 0, or a pointer off 16
// bytes) run the same kernel with the producer reading device memory and
// laying the base chunk out in the ring slot as the copy would. The TMA,
// mbarrier and wgmma helpers are tma_wgmma.cuh's, shared with K3 and K4.

#include <math.h>

#include "tma_wgmma.cuh"

namespace {

using namespace rxtc;

constexpr int BM = 64;           // queries per tile: the M of one wgmma
constexpr int BN = 128;          // base rows per tile: the N of one wgmma
constexpr int KC = 32;           // D columns per stage: four k-steps of 8
constexpr int STAGES = 6;        // depth of the raw-chunk ring
constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 2 * WG;  // a consumer and a producer warpgroup
constexpr int BLK = 64;           // rows per block max
constexpr int RES_CHUNKS = 4;    // D <= 128: the query group stays split
constexpr int SMALL_Q = 8;       // Q <= 8: fp32 FMA on the CUDA cores

// the rings first: a 128-byte-swizzled TMA destination is 1024-byte aligned
struct Smem {
  float raw_b[STAGES][BN * KC];       // chunks as copied: rows of 128
                                      // bytes, 16-byte units swizzled
  union {                             // the query group's operand:
    struct {                          // D <= 128: every chunk's hi/lo,
      float hi[RES_CHUNKS][BM * KC];  // split once per query group
      float lo[RES_CHUNKS][BM * KC];
    } res;
    struct {                          // wider: a TMA ring of raw chunks and
      float raw[STAGES][BM * KC];     // a double-buffered split, as for
      float hi[2][BM * KC];           // the base
      float lo[2][BM * KC];
    } ring;
    float qs[2 * RES_CHUNKS * BM * KC];   // Q <= 8: the queries, [q][d]
  } a;
  float b_lo[2][BN * KC];             // the base's split low parts,
                                      // wgmma layout
  unsigned long long full[STAGES];    // ring slot holds its TMA boxes
  unsigned long long split_full[2];   // split buffer written (producer)
  unsigned long long split_empty[2];  // split buffer read (consumer)
  float sq[2][BN];                    // a tile's sq_eff, by tile parity
  float wmax[SMALL_Q][WG / 32];       // Q <= 8: the warps' row maxima
  unsigned long long a_free;          // resident query split read
};

// index of element (row r, column k < KC) of a split tile of R rows: core
// matrices of 8 rows x 4 floats (128 contiguous bytes); the two core
// matrices of a k-step's 8 columns lie 128 bytes apart (LBO), consecutive
// 8-row groups 256 bytes apart (SBO), and k-step s starts at s * R * 32
// bytes
__device__ __forceinline__ int split_idx(int R, int r, int k) {
  return (k >> 3) * (R * 8) + (r >> 3) * 64 + ((k >> 2) & 1) * 32 +
         (r & 7) * 4 + (k & 3);
}

// wgmma descriptor of a K-major tile as a 128-byte-swizzled TMA box lays it
// out (rows of 128 bytes, 8-row groups 1024 bytes apart, the box 1024-byte
// aligned); `tile` may point 32 bytes a k-step into the rows
__device__ __forceinline__ uint64_t make_desc_sw128(const float* tile) {
  const uint64_t lbo = 1, sbo = 1024 >> 4;
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (lbo << 16) |
         (sbo << 32) | (1ull << 62);
}

// x truncated to TF32: what a wgmma reads of an fp32 operand
__device__ __forceinline__ float truncate_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// d[64] += A (64 x 8, tf32) * B (8 x 128, tf32), both from shared memory;
// scale_d == 0 overwrites d instead
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Args {
  CUtensorMap map_q, map_base;   // boxes of KC columns x BM / BN rows
  const float* q;
  const float* base;
  const float* sq_eff;
  float* S;
  float* bmax;
  int Q, N, D, n_tiles, n_items, n_chunks;
  float fac;
  bool a_resident;   // n_chunks <= RES_CHUNKS
  bool q_box;        // the query chunks are TMA'd (not resident, Q > 8)
};

// the (query group, base tile, D offset) of this CTA's stage st
struct Stage {
  int qg, tile, d0;
};

__device__ __forceinline__ Stage stage_of(const Args& a, int st) {
  const int w = blockIdx.x + (st / a.n_chunks) * gridDim.x;
  return {w / a.n_tiles, w % a.n_tiles, (st % a.n_chunks) * KC};
}

// One thread: the base box of stage st, and its query box if the query
// chunks are streamed, into the stage's ring slots. A box is always
// whole (zeros past the tensor's edge), so the barrier expects whole boxes.
__device__ void load_stage(const Args& a, Smem& sm, int st) {
  const Stage s = stage_of(a, st);
  const int slot = st % STAGES;
  mbar_expect_tx(&sm.full[slot], (BN + (a.q_box ? BM : 0)) * KC * 4);
  tma_load(sm.raw_b[slot], &a.map_base, s.d0, s.tile * BN, &sm.full[slot]);
  if (a.q_box)
    tma_load(sm.a.ring.raw[slot], &a.map_q, s.d0, s.qg * BM, &sm.full[slot]);
}

// One chunk of R rows into its hi/lo tiles, four columns a step. ASYNC
// reads the ring slot, whose 16-byte unit j of row r sits at unit j ^ (r % 8)
// (the TMA's 128-byte swizzle: eight rows that read one column hit eight
// different banks); otherwise device memory (src points at row 0, column d0
// of the chunk), with rows past `rows` and columns past kc as zeros. Groups
// of 8 rows wholly past `rows` are skipped: row m of a product depends on
// row m of its operand only, and the epilogue stores no query row past Q
// and no base row past N.
// Run by the producer warpgroup; pt is the thread's index in it.
template <bool ASYNC, int R>
__device__ __forceinline__ void split_chunk(int pt,
                                            const float* __restrict__ raw,
                                            const float* __restrict__ src,
                                            int D, int rows, int kc,
                                            float* __restrict__ hi,
                                            float* __restrict__ lo) {
  constexpr int ITERS = R * KC / 4 / WG;
  // every load first, then every store: the loads' latencies overlap
  float4 v[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = it * WG + pt;
    const int r = (e >> 6) * 8 + (e & 7), c = ((e >> 3) & 7) * 4;
    if ((r & ~7) >= rows) continue;
    if (ASYNC) {
      v[it] = *reinterpret_cast<const float4*>(
          &raw[r * KC + ((c >> 2) ^ (r & 7)) * 4]);
    } else {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = r < rows && c + j < kc ? src[(size_t)r * D + c + j] : 0.f;
      v[it] = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = it * WG + pt;
    const int r = (e >> 6) * 8 + (e & 7), c = ((e >> 3) & 7) * 4;
    if ((r & ~7) >= rows) continue;
    float4 h, l;
    h.x = to_tf32(v[it].x), l.x = to_tf32(v[it].x - h.x);
    h.y = to_tf32(v[it].y), l.y = to_tf32(v[it].y - h.y);
    h.z = to_tf32(v[it].z), l.z = to_tf32(v[it].z - h.z);
    h.w = to_tf32(v[it].w), l.w = to_tf32(v[it].w - h.w);
    const int i = split_idx(R, r, c);
    *reinterpret_cast<float4*>(&hi[i]) = h;
    *reinterpret_cast<float4*>(&lo[i]) = l;
  }
}

// One base chunk's low parts, four columns a step, rows as split_chunk.
// The high part is the fp32 value itself, read by the wgmma as TF32, which
// keeps its top 19 bits (truncation): so lo = tf32(x - trunc(x)), rounded to
// nearest. ASYNC reads the TMA box in the ring slot, which the wgmma then
// reads as the high part; otherwise device memory, and the values go to the
// ring slot in the layout the TMA would give them.
template <bool ASYNC>
__device__ __forceinline__ void split_base(int pt, float* __restrict__ raw,
                                           const float* __restrict__ src,
                                           int D, int rows, int kc,
                                           float* __restrict__ lo) {
  constexpr int ITERS = BN * KC / 4 / WG;
  float4 v[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = it * WG + pt;
    const int r = (e >> 6) * 8 + (e & 7), c = ((e >> 3) & 7) * 4;
    if ((r & ~7) >= rows) continue;
    if (ASYNC) {
      v[it] = *reinterpret_cast<const float4*>(
          &raw[r * KC + ((c >> 2) ^ (r & 7)) * 4]);
    } else {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = r < rows && c + j < kc ? src[(size_t)r * D + c + j] : 0.f;
      v[it] = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(&raw[r * KC + ((c >> 2) ^ (r & 7)) * 4]) =
          v[it];
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = it * WG + pt;
    const int r = (e >> 6) * 8 + (e & 7), c = ((e >> 3) & 7) * 4;
    if ((r & ~7) >= rows) continue;
    float4 l;
    l.x = to_tf32(v[it].x - truncate_tf32(v[it].x));
    l.y = to_tf32(v[it].y - truncate_tf32(v[it].y));
    l.z = to_tf32(v[it].z - truncate_tf32(v[it].z));
    l.w = to_tf32(v[it].w - truncate_tf32(v[it].w));
    *reinterpret_cast<float4*>(&lo[split_idx(BN, r, c)]) = l;
  }
}

// The query group's resident split (D <= RES_CHUNKS * KC): every chunk of
// its `rows` rows from device memory into res hi/lo, all loads first (one
// round trip to memory, at the start of the CTA's work). VEC reads float4s
// (D % 4 == 0 and an aligned q).
template <bool VEC>
__device__ __forceinline__ void split_query_group(
    int pt, const float* __restrict__ src, int D, int rows, Smem& sm) {
  constexpr int ITERS = RES_CHUNKS * BM * KC / 4 / WG;   // 16
  float4 v[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = it * WG + pt, chunk = e / (BM * KC / 4);
    const int f = e % (BM * KC / 4);
    const int r = (f >> 6) * 8 + (f & 7), c = chunk * KC + ((f >> 3) & 7) * 4;
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((r & ~7) >= rows || r >= rows || c >= D) continue;
    if (VEC) {
      v[it] = __ldg(reinterpret_cast<const float4*>(&src[(size_t)r * D + c]));
    } else {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = c + j < D ? src[(size_t)r * D + c + j] : 0.f;
      v[it] = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int e = it * WG + pt, chunk = e / (BM * KC / 4);
    const int f = e % (BM * KC / 4);
    const int r = (f >> 6) * 8 + (f & 7), c = ((f >> 3) & 7) * 4;
    if ((r & ~7) >= rows) continue;
    float4 h, l;
    h.x = to_tf32(v[it].x), l.x = to_tf32(v[it].x - h.x);
    h.y = to_tf32(v[it].y), l.y = to_tf32(v[it].y - h.y);
    h.z = to_tf32(v[it].z), l.z = to_tf32(v[it].z - h.z);
    h.w = to_tf32(v[it].w), l.w = to_tf32(v[it].w - h.w);
    const int i = split_idx(BM, r, c);
    *reinterpret_cast<float4*>(&sm.a.res.hi[chunk][i]) = h;
    *reinterpret_cast<float4*>(&sm.a.res.lo[chunk][i]) = l;
  }
}

// fac * (hi + lo) - sq_eff into S, and the block maxima of those values.
// Register i of an accumulator holds row 16 w + lane/4 + 8 ((i/2) % 2) and
// column 8 (i/4) + 2 (lane % 4) + i % 2 of the tile (warp w of the
// consumer warpgroup, threads 0-127).
// sq_tile holds the tile's sq_eff, staged by the producer.
__device__ void epilogue(const Args& a, const float* hi, const float* lo,
                         const float* sq_tile, int qg, int tile) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int n0 = tile * BN, G = a.N / BLK;
  const int col = 2 * (lane & 3);
  float2 sq[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    sq[j] = *reinterpret_cast<const float2*>(&sq_tile[8 * j + col]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = qg * BM + 16 * w + (lane >> 2) + 8 * h;
    float* srow = a.S + (size_t)q * a.N + n0 + col;
#pragma unroll
    for (int b = 0; b < BN / BLK; ++b) {
      const bool ok = q < a.Q && n0 + BLK * b < a.N;
      float m = -INFINITY;
#pragma unroll
      for (int j = 8 * b; j < 8 * b + 8; ++j) {
        float2 s;
        const int i = 4 * j + 2 * h;
        s.x = a.fac * (hi[i] + lo[i]) - sq[j].x;
        s.y = a.fac * (hi[i + 1] + lo[i + 1]) - sq[j].y;
        m = fmaxf(m, fmaxf(s.x, s.y));
        if (ok) *reinterpret_cast<float2*>(&srow[8 * j]) = s;
      }
      // the 4 lanes of a row hold its 64 columns of block b
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (ok && (lane & 3) == 0)
        a.bmax[(size_t)q * G + tile * (BN / BLK) + b] = m;
    }
  }
}

// The small-Q epilogue: thread r holds base row r of the tile and its
// fp32 dot products with the Q <= 8 queries. S is written coalesced (one
// query's row at a time); the block maxima come from the very values
// stored, through the warps' maxima. Consumer threads only.
__device__ void small_epilogue(const Args& a, const float* acc,
                               const float* sq_tile, int tile, Smem& sm) {
  const int r = threadIdx.x, lane = r & 31, w = r >> 5;
  const int n = tile * BN + r, G = a.N / BLK;
#pragma unroll
  for (int q = 0; q < SMALL_Q; ++q) {
    if (q >= a.Q) break;
    const float v = a.fac * acc[q] - sq_tile[r];
    if (n < a.N) a.S[(size_t)q * a.N + n] = v;
    float m = v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) sm.wmax[q][w] = m;
  }
  asm volatile("bar.sync 2, %0;" ::"n"(WG) : "memory");
  if (r < 2 * a.Q) {
    const int q = r >> 1, b = r & 1;
    if (tile * BN + BLK * b < a.N)
      a.bmax[(size_t)q * G + tile * (BN / BLK) + b] =
          fmaxf(sm.wmax[q][2 * b], sm.wmax[q][2 * b + 1]);
  }
  asm volatile("bar.sync 2, %0;" ::"n"(WG) : "memory");   // wmax reusable
}

// Warp-specialized: the producer warpgroup (threads 128-255) keeps the TMA
// ring full and splits each chunk into the double-buffered hi/lo tiles; the
// consumer warpgroup (threads 0-127) runs the wgmmas of each chunk and, after
// a tile's last chunk, its epilogue. They hand the two split buffers back and
// forth through the split_full / split_empty mbarriers, so the split of chunk
// c+1 overlaps the wgmmas of chunk c; the wgmmas of a tile's chunks chain in
// the accumulators without a wait between them. SMALL (Q <= 8) keeps the
// same pipeline without the tensor cores: the producer only waits for the
// copies (and stages the queries once), and the consumer reads each base
// row from the ring slot and forms its Q dot products in fp32 FMA, as one
// query would waste 63 of the 64 rows of a wgmma.
template <bool ASYNC, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1)
    bf_scan_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int t = threadIdx.x;
  // the warpgroup, read through a shuffle so that the compiler knows it is
  // uniform across each warp: it serializes wgmmas on a path it cannot
  const int wg = __shfl_sync(0xffffffffu, t / WG, 0);
  const int my_items =
      (a.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_items * a.n_chunks;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&sm.full[s], 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.split_full[b], WG);
      mbar_init(&sm.split_empty[b], WG);
    }
    mbar_init(&sm.a_free, WG);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {   // producer
    const int pt = t - WG;
    if (ASYNC && pt == 0)
      for (int st = 0; st < min(STAGES, total); ++st) load_stage(a, sm, st);
    const int dpad = a.n_chunks * KC;
    if (SMALL)   // the queries, zero past D, for every chunk
      for (int i = pt; i < a.Q * dpad; i += WG)
        sm.a.qs[i] = i % dpad < a.D ? a.q[(size_t)(i / dpad) * a.D + i % dpad]
                                    : 0.f;
    int qg_split = -1, a_changes = 0;
    for (int st = 0; st < total; ++st) {
      const Stage s = stage_of(a, st);
      const int slot = st % STAGES, buf = st & 1;
      const int kc = min(KC, a.D - s.d0);
      const int q_rows = a.Q - s.qg * BM;
      const float* q_src = a.q + (size_t)s.qg * BM * a.D;
      if (!SMALL && a.a_resident && s.qg != qg_split) {
        // a new query group: once the consumer is done with the last one,
        // split every chunk of it from device memory
        if (qg_split >= 0)
          mbar_wait(&sm.a_free, (uint32_t)(a_changes++ & 1));
        split_query_group<ASYNC>(pt, q_src, a.D, q_rows, sm);
        qg_split = s.qg;
      }
      // the consumer is done with chunk st - 2: its low-part buffer, and
      // its ring slot (the wgmmas read the base's high part there); refill
      // the slot
      if (st >= 2) {
        mbar_wait(&sm.split_empty[buf], (uint32_t)(((st >> 1) - 1) & 1));
        if (ASYNC && pt == 0 && st - 2 + STAGES < total)
          load_stage(a, sm, st - 2 + STAGES);
      }
      if (ASYNC) mbar_wait(&sm.full[slot], (uint32_t)((st / STAGES) & 1));
      if (s.d0 == 0) {
        // a tile's first chunk: stage its sq_eff for the epilogue, off the
        // consumer's path (buffer item % 2, whose last reader is the
        // epilogue of item - 2: chunk st - 2 is that item's last chunk or a
        // later one, and both consumers release a tile's last chunk only
        // after its epilogue, the wgmma one because it releases each chunk
        // after committing the next)
        const int n = s.tile * BN + pt;
        sm.sq[(st / a.n_chunks) & 1][pt] = n < a.N ? a.sq_eff[n] : 0.f;
      }
      if (!SMALL || !ASYNC)   // SMALL: only to lay the chunk out in the slot
        split_base<ASYNC>(pt, sm.raw_b[slot],
                          a.base + (size_t)s.tile * BN * a.D + s.d0, a.D,
                          a.N - s.tile * BN, kc, sm.b_lo[buf]);
      if (a.q_box)
        split_chunk<ASYNC, BM>(pt, sm.a.ring.raw[slot], q_src + s.d0, a.D,
                               q_rows, kc, sm.a.ring.hi[buf],
                               sm.a.ring.lo[buf]);
      // the split's generic-proxy stores, seen by the wgmmas (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&sm.split_full[buf]);
    }
    return;
  }

  if constexpr (SMALL) {   // consumer, Q <= 8: thread t takes base row t
    const int dpad = a.n_chunks * KC;
    int st = 0;
    for (int item = 0; item < my_items; ++item) {
      const Stage s0 = stage_of(a, st);
      float acc[SMALL_Q];
#pragma unroll
      for (int q = 0; q < SMALL_Q; ++q) acc[q] = 0.f;
      for (int c = 0; c < a.n_chunks; ++c, ++st) {
        const int buf = st & 1, slot = st % STAGES;
        mbar_wait(&sm.split_full[buf], (uint32_t)((st >> 1) & 1));
        const float* row = sm.raw_b[slot] + t * KC;
#pragma unroll
        for (int j = 0; j < KC / 4; ++j) {
          // 16-byte unit j of the row sits at j ^ (row % 8) (the swizzle)
          const float4 x =
              *reinterpret_cast<const float4*>(&row[(j ^ (t & 7)) * 4]);
#pragma unroll
          for (int q = 0; q < SMALL_Q; ++q) {
            if (q >= a.Q) break;
            const float4 y = *reinterpret_cast<const float4*>(
                &sm.a.qs[q * dpad + c * KC + 4 * j]);
            acc[q] = fmaf(x.x, y.x, acc[q]);
            acc[q] = fmaf(x.y, y.y, acc[q]);
            acc[q] = fmaf(x.z, y.z, acc[q]);
            acc[q] = fmaf(x.w, y.w, acc[q]);
          }
        }
        // the slot is read; a tile's last one is handed back after its
        // epilogue, which reads the sq_eff buffer the producer refills then
        if (c + 1 < a.n_chunks) mbar_arrive(&sm.split_empty[buf]);
      }
      small_epilogue(a, acc, sm.sq[item & 1], s0.tile, sm);
      mbar_arrive(&sm.split_empty[(st - 1) & 1]);
    }
  } else {   // consumer, wgmma
    float hi[64], lo[64];   // the hi.hi products; the two small terms
#pragma unroll
    for (int i = 0; i < 64; ++i) hi[i] = lo[i] = 0.f;
    int st = 0;
    for (int item = 0; item < my_items; ++item) {
      const Stage s0 = stage_of(a, st);
      for (int c = 0; c < a.n_chunks; ++c, ++st) {
        const int buf = st & 1, slot = st % STAGES;
        mbar_wait(&sm.split_full[buf], (uint32_t)((st >> 1) & 1));
        wgmma_fence();
        const int first = c > 0 ? 1 : 0;   // a tile's first chunk overwrites
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) {
          const float* a_hi =
              a.a_resident ? sm.a.res.hi[c] : sm.a.ring.hi[buf];
          const float* a_lo =
              a.a_resident ? sm.a.res.lo[c] : sm.a.ring.lo[buf];
          const uint64_t ah = make_desc(a_hi + ks * BM * 8);
          const uint64_t al = make_desc(a_lo + ks * BM * 8);
          const uint64_t bh = make_desc_sw128(sm.raw_b[slot] + ks * 8);
          const uint64_t bl = make_desc(sm.b_lo[buf] + ks * BN * 8);
          wgmma_tf32(lo, al, bh, ks > 0 ? 1 : first);
          wgmma_tf32(lo, ah, bl, 1);
          wgmma_tf32(hi, ah, bh, ks > 0 ? 1 : first);
        }
        wgmma_commit();
        // the chunk before this one is done: hand its buffer back
        wgmma_wait<1>();
        if (st >= 1) mbar_arrive(&sm.split_empty[(st - 1) & 1]);
      }
      wgmma_wait<0>();
      // the next item needs another query group split: this one is read
      if (a.a_resident && item + 1 < my_items &&
          stage_of(a, st).qg != s0.qg)
        mbar_arrive(&sm.a_free);
      fence_operands<64>(hi);
      fence_operands<64>(lo);
      epilogue(a, hi, lo, sm.sq[item & 1], s0.qg, s0.tile);
    }
  }
}

// map of a row-major f32 [rows, D] tensor in boxes of KC columns x box_rows
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows,
              int D, int box_rows) {
  return make_map_2d(enc, map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows,
                     D, KC, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
// q f32[Q, D], base f32[N, D], sq_eff f32[N] in; S f32[Q, N], bmax
// f32[Q, N/64] out. All contiguous on one device; N % 64 == 0.
extern "C" int bf_scan_launch(const void* q, const void* base,
                              const void* sq_eff, void* S, void* bmax, int Q,
                              int N, int D, float fac, void* stream) {
  if (Q <= 0 || N <= 0 || N % BLK != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = (const float*)q;
  a.base = (const float*)base;
  a.sq_eff = (const float*)sq_eff;
  a.S = (float*)S;
  a.bmax = (float*)bmax;
  a.Q = Q, a.N = N, a.D = D, a.fac = fac;
  a.n_tiles = (N + BN - 1) / BN;
  a.n_items = a.n_tiles * ((Q + BM - 1) / BM);
  a.n_chunks = (D + KC - 1) / KC;
  a.a_resident = a.n_chunks <= RES_CHUNKS;
  // the queries fit the query area in shared memory
  const bool small = Q <= SMALL_Q && Q * a.n_chunks * KC <=
                     (int)(sizeof(Smem::a) / sizeof(float));
  a.q_box = !small && !a.a_resident;
  // a tensor map takes a 16-byte aligned base and row stride
  const EncodeTiled enc = encode_tiled();
  const bool async_ok = enc != nullptr && D % 4 == 0 &&
                        (uintptr_t)q % 16 == 0 &&
                        (uintptr_t)base % 16 == 0 &&
                        (!a.q_box || make_map(enc, &a.map_q, q, Q, D, BM)) &&
                        make_map(enc, &a.map_base, base, N, D, BN);
  const int smem = (int)sizeof(Smem) + 1024;   // + the ring's alignment
  const dim3 grid(min(a.n_items, sm_count()));
  void (*kernel)(const Args) =
      async_ok ? (small ? bf_scan_kernel<true, true>
                        : bf_scan_kernel<true, false>)
               : (small ? bf_scan_kernel<false, true>
                        : bf_scan_kernel<false, false>);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* bf_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
