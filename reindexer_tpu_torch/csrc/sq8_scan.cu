// K3 `sq8_scan`: partial scores and 64-row block maxima of the SQ8 scan over
// uint8 codes, for Hopper (sm_90a), on the tensor cores.
//
// Replaces (reindexer_tpu/ops):
//   - pallas_scan.py::_pass1_sq8        partial scores [Q, N] + block maxima
//                                       (S mode, feeding K2 bf_select.cu)
//   - pallas_select.py::sweep_bmax_sq8  shifted block maxima only, and the
//                                       codes sweep (phase 0) of
//                                       ::twinsweep_select_sq8 (bmax-only
//                                       mode, feeding K4 sq8_select.cu)
//
// Contract: with q_alpha = q * alpha (the per-dimension grid step folded into
// the query), fac = 2 for L2 and 1 for IP/cosine,
//   S[q, n]    = max(fac * (q_alpha[q] . codes[n]) - sq_eff[n] + shift[q],
//                    -1e30)
//   bmax[q, g] = max of S[q, 64g .. 64g+63]
// sq_eff is the exact |b|^2 of the original vector (L2) or 0 (IP/cosine) for
// a valid row, 1e30 for an invalid one. S is written only when the S pointer
// is not null (S mode, shift 0: the caller adds fac * q.lo - |q|^2 to the
// winners). The bmax-only mode takes shift = fac * q.lo, which puts the block
// maxima on the scale of the exact fp32 scores for K4's eps-widened
// threshold; it writes no S.
//
// Precision. The codes are integers 0..255, exact in bf16. q_alpha splits
// into three bf16 limbs, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
// - mid), all rounded to nearest: each difference is exact in fp32, the three
// limbs hold x's 24 significant bits, and hi + mid + lo == x exactly
// (ops/scan.py::bf16_limbs is the same split, held to that on the CPU). A
// limb times a code has at most 16 significant bits, exact in the tensor
// cores' fp32 products. The tensor cores add each k-step into the
// accumulator with truncation, so hi's products go to one accumulator and
// mid's and lo's to a second, about 2^-8 of its size, summed once in fp32 in
// the epilogue: a score stays within a few fp32 ulps of sum_d |q_alpha_d
// code_d| (chip_smoke.py holds it to 8, and shows that one bf16 limb misses
// by ~10^3).
//
// What bounds it on the H100: at 64 queries the products. The codes are N*D
// bytes (16.8 MB at 131072 x 128: 5.0 us at 3.35 TB/s); the products are
// 3 limbs x 2*Q*N*D bf16 FLOP (6.4 GFLOP at Q = 64: 6.5 us at 989
// TFLOP/s). S mode adds Q*N*4 bytes of S (33.5 MB: 10 us). One query is
// bound by the codes' bytes: the N of a wgmma is the query group rounded up
// to 8, so it computes 8 columns, not 64 rows.
// What the design does about it:
//   - `wgmma` m64nNk16 (bf16 x bf16 -> fp32): M = 64 code rows, one block-max
//     block; N = NQ, the query group rounded up to 8, 16, 32 or 64; the
//     three limbs' wgmmas share one A operand.
//   - A (the codes) comes from registers: each consumer thread reads its 2 x
//     16 bytes of a 64-byte chunk of its two rows from the ring slot and
//     converts u8 -> bf16 in registers (a byte permute into an fp32 of
//     exponent 2^23, a subtraction, the top halves paired), so the codes
//     never pass through shared memory as bf16. The K order inside a k-step
//     is permuted so that a thread's 16 bytes feed four k-steps; the limbs
//     are laid out in shared memory in the same order, and a dot product
//     does not depend on the order of its terms.
//   - B (the limbs) is split once per query group and stays in shared memory
//     as K-major core matrices (tma_wgmma.cuh::make_desc); for a D whose
//     limbs outgrow LIMB_BYTES they are split again per window of D for
//     each tile.
//   - Persistent CTAs, three per SM, each a producer warp and a consumer
//     warpgroup: the producer keeps 2D TMA boxes of 64 rows x 64 code bytes
//     in flight into a 4-stage mbarrier ring (columns past D filled with
//     zeros by the copy); the consumers release a slot as soon as their
//     registers hold it, and read the next chunk while the last chunk's
//     wgmmas run.
//   - Registers are the scarce resource at 64 queries (128 a thread at
//     three CTAs an SM): the accumulators live for one tile only, so the
//     limb split at a tile's start has their registers, and the split loads
//     two groups of four q_alpha values at a time (eight spilled).
//   - The epilogue computes max(fac * (hi + midlo) - sq_eff + shift, -1e30)
//     in the plain version's order (sq_eff loaded when the tile began, the
//     shift staged in shared memory), stores S (S mode) in whole 32-byte
//     sectors, and takes each 64-row block max from the very values written,
//     so K2 needs no margin.
// Codes that a tensor map cannot take (D % 16 != 0, or a pointer off 16
// bytes) run the same kernel with the producer warp reading device memory
// and laying each box out as the copy would.

#include <math.h>

#include "tma_wgmma.cuh"

namespace {

using namespace rxtc;

constexpr int BR = 64;            // code rows per tile: the M of a wgmma
constexpr int KB = 64;            // code bytes (D columns) per chunk
constexpr int STAGES = 4;         // depth of the codes ring
constexpr int WG = 128;           // the consumer warpgroup
constexpr int THREADS = WG + 32;  // and the producer warp
constexpr int GROUP = 64;         // queries per group: the widest N
constexpr int LIMB_BYTES = 96 * 1024;   // resident limbs, at most
constexpr float SENT = -1e30f;

struct Args {
  CUtensorMap map_codes;   // boxes of KB columns x BR rows
  const float* q_alpha;
  const uint8_t* codes;
  const float* sq_eff;
  const float* shift;
  float* S;                // null: bmax-only mode
  float* bmax;
  int Q, N, D, n_tiles, n_items, n_chunks, win, n_win;
  float fac;
  bool vec;                // D % 4 == 0 and q_alpha 16-byte aligned
};

struct Smem {
  uint8_t ring[STAGES][BR * KB];      // TMA destinations, rows of 64 bytes
  unsigned long long full[STAGES];    // slot holds its box
  unsigned long long empty[STAGES];   // slot read by every consumer thread
  float wmax[2][WG / 32][GROUP];      // the warps' block maxima, by tile
  float shift[GROUP];                 // the query group's shift
  // then, 128-byte aligned: the limbs, [win chunk][limb][k-step][NQ x 16]
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WG) : "memory");
}

// bf16 bits of x, rounded to nearest even (as torch's float -> bfloat16)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float bf16_value(uint32_t b) {
  return __uint_as_float(b << 16);
}

// the three limbs of x, hi + mid + lo == x
__device__ __forceinline__ void limbs_of(float x, uint32_t* l) {
  l[0] = bf16_bits(x);
  const float r1 = x - bf16_value(l[0]);
  l[1] = bf16_bits(r1);
  l[2] = bf16_bits(r1 - bf16_value(l[1]));
}

// bf16 pair of the codes in bytes j0 (low half) and j0 + 1 of w: a byte
// permute makes the fp32 2^23 + code, the subtraction leaves the code, and
// its top 16 bits are its bf16 (exact: codes have at most 8 bits)
__device__ __forceinline__ uint32_t code_pair(uint32_t w, int j0) {
  const float a = __uint_as_float(__byte_perm(w, 0x4B000000u,
                                              0x7440 | j0)) - 8388608.f;
  const float b = __uint_as_float(__byte_perm(w, 0x4B000000u,
                                              0x7440 | (j0 + 1))) - 8388608.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// index, in bf16 elements, of (query row n, d = 16 c + 4 s + e of a chunk)
// in the limb tile of k-step s: the wgmma column of that d is kk = 8 (e / 2)
// + 2 c + e % 2, the column a consumer thread's fragment gives byte e of its
// 4-byte word s (see the consumer); core matrices of 8 rows x 8 columns,
// the two of a k-step 64 elements (128 bytes) apart, 8-row groups 128
// elements (256 bytes) apart
__device__ __forceinline__ int limb_idx(int n, int c, int e) {
  const int kk = 8 * (e >> 1) + 2 * c + (e & 1);
  return (n >> 3) * 128 + (kk >> 3) * 64 + (n & 7) * 8 + (kk & 7);
}

// The limbs of query rows [q0, q0 + NQ) (zeros past Q) and chunks [c0, c0 +
// nc) into the resident area: each thread splits four consecutive d of one
// row at a time and stores them as two bf16 pairs. The loads go out
// SPLIT_BATCH at a time: half the round trips to memory of one a step, in
// the registers that leave the split without spills. Consumer threads
// only.
template <int NQ>
__device__ void split_limbs(const Args& a, uint16_t* limbs, int q0, int c0,
                            int nc) {
  constexpr int SPLIT_BATCH = 2;
  constexpr int per_chunk = NQ * KB / 4;   // 4-column groups of a chunk
  const int t = threadIdx.x;
  const int total = nc * per_chunk;
  for (int e0 = 0; e0 < total; e0 += SPLIT_BATCH * WG) {
    float x[SPLIT_BATCH][4];
#pragma unroll
    for (int b = 0; b < SPLIT_BATCH; ++b) {
      const int e = e0 + b * WG + t;
      const int f = e % per_chunk;
      const int n = f / (KB / 4);
      const int d0 = (c0 + e / per_chunk) * KB + 4 * (f % (KB / 4));
      const float* src = a.q_alpha + (size_t)(q0 + n) * a.D + d0;
      const bool row_ok = e < total && q0 + n < a.Q;
      if (a.vec && row_ok && d0 < a.D) {   // D % 4 == 0: the whole group
        const float4 v = __ldg(reinterpret_cast<const float4*>(src));
        x[b][0] = v.x, x[b][1] = v.y, x[b][2] = v.z, x[b][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[b][j] = row_ok && d0 + j < a.D ? src[j] : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < SPLIT_BATCH; ++b) {
      const int e = e0 + b * WG + t;
      if (e >= total) break;
      const int cw = e / per_chunk, f = e % per_chunk;
      const int n = f / (KB / 4), g4 = f % (KB / 4);   // row, 4-column group
      const int c = g4 >> 2, s = g4 & 3;
      uint32_t l[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) limbs_of(x[b][j], l[j]);
#pragma unroll
      for (int L = 0; L < 3; ++L) {
        uint16_t* tile = limbs + ((cw * 3 + L) * 4 + s) * (NQ * 16);
        // bytes e = 0, 1 sit at kk = 2c, 2c + 1; e = 2, 3 at 8 + 2c, 9 + 2c
        *reinterpret_cast<uint32_t*>(&tile[limb_idx(n, c, 0)]) =
            l[0][L] | (l[1][L] << 16);
        *reinterpret_cast<uint32_t*>(&tile[limb_idx(n, c, 2)]) =
            l[2][L] | (l[3][L] << 16);
      }
    }
  }
}

template <int NQ>
struct Mma;

// d[NQ / 2] (+)= A (64 x 16 bf16, registers) * B (16 x NQ bf16, shared
// memory, K-major); scale_d == 0 overwrites d instead
template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// One thread: the box of chunk `chunk` of tile `tile` into ring slot `slot`
__device__ __forceinline__ void load_box_tma(const Args& a, Smem& sm,
                                             int slot, int tile, int chunk) {
  mbar_expect_tx(&sm.full[slot], BR * KB);
  tma_load(sm.ring[slot], &a.map_codes, chunk * KB, tile * BR,
           &sm.full[slot]);
}

// The producer warp: the same box from device memory, zeros past D; lane l
// takes bytes 2l and 2l + 1 of every row
__device__ __forceinline__ void load_box_plain(const Args& a, Smem& sm,
                                               int slot, int tile,
                                               int chunk) {
  const int lane = threadIdx.x & 31;
  const int d = chunk * KB + 2 * lane;
  const uint8_t* src = a.codes + (size_t)tile * BR * a.D + d;
  for (int r = 0; r < BR; ++r) {
    const uint32_t b0 = d < a.D ? src[(size_t)r * a.D] : 0u;
    const uint32_t b1 = d + 1 < a.D ? src[(size_t)r * a.D + 1] : 0u;
    *reinterpret_cast<uint16_t*>(&sm.ring[slot][r * KB + 2 * lane]) =
        (uint16_t)(b0 | (b1 << 8));
  }
  mbar_arrive(&sm.full[slot]);
}

// fac * (hi + midlo) - sq_eff + shift, clamped, into S (S mode), and the
// block max of those values into bmax. Register i of an accumulator holds
// code row 16 w + lane/4 + 8 ((i/2) % 2) and query column 8 (i/4) + 2
// (lane % 4) + i % 2 of the tile (warp w of the consumer warpgroup).
// sq holds the sq_eff of the thread's two rows, loaded when the tile began.
template <int NQ>
__device__ void epilogue(const Args& a, const float* hi, const float* lo,
                         const float* sq, int qg, int tile, Smem& sm,
                         int buf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = 16 * w + (lane >> 2);
  const size_t n0 = (size_t)tile * BR;
  const int G = a.N / BR;
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {         // column 8j + 2 (lane % 4) + h
      const int col = 8 * j + 2 * (lane & 3) + h;
      const int q = qg * GROUP + col;
      const bool ok = col < GROUP && q < a.Q;
      const float sh = sm.shift[col];
      float m = -INFINITY;
#pragma unroll
      for (int v = 0; v < 2; ++v) {       // rows r0 and r0 + 8
        const int i = 4 * j + 2 * v + h;
        // (fac * dot - sq_eff) + shift, in that order, as the plain version
        const float s = fmaxf(a.fac * (hi[i] + lo[i]) - sq[v] + sh, SENT);
        m = fmaxf(m, s);
        if (a.S != nullptr && ok) a.S[(size_t)q * a.N + n0 + r0 + 8 * v] = s;
      }
      // the 8 lanes that share lane % 4 hold the warp's 16 rows
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (lane < 4) sm.wmax[buf][w][col] = m;
    }
  }
  consumer_sync();
  const int t = threadIdx.x;
  if (t < NQ && qg * GROUP + t < a.Q) {
    float m = sm.wmax[buf][0][t];
#pragma unroll
    for (int ww = 1; ww < WG / 32; ++ww) m = fmaxf(m, sm.wmax[buf][ww][t]);
    a.bmax[(size_t)(qg * GROUP + t) * G + tile] = m;
  }
}

// Warp-specialized: the producer warp (threads 128-159) keeps the codes
// ring full; the consumer warpgroup (threads 0-127) splits the query
// group's limbs, converts each chunk's codes to bf16 A fragments, runs the
// three limbs' wgmmas of its four k-steps and, after a tile's last chunk,
// its epilogue.
template <int NQ, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 3)
    sq8_scan_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  uint16_t* limbs = reinterpret_cast<uint16_t*>(
      reinterpret_cast<unsigned char*>(&sm) + ((sizeof(Smem) + 127) & ~127));
  const int t = threadIdx.x;
  const int my_items =
      (a.n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_items * a.n_chunks;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], ASYNC ? 1 : 32);
      mbar_init(&sm.empty[s], WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= WG) {   // producer warp
    for (int st = 0; st < total; ++st) {
      const int slot = st % STAGES;
      if (st >= STAGES)
        mbar_wait(&sm.empty[slot], (uint32_t)((st / STAGES - 1) & 1));
      const int w = blockIdx.x + (st / a.n_chunks) * gridDim.x;
      const int tile = w % a.n_tiles, chunk = st % a.n_chunks;
      if (ASYNC) {
        if (t == WG) load_box_tma(a, sm, slot, tile, chunk);
      } else {
        load_box_plain(a, sm, slot, tile, chunk);
      }
    }
    return;
  }

  // consumer warpgroup
  const int lane = t & 31, w = t >> 5;
  // this thread's rows of a box and the 16-byte column of its chunk
  const int row_off = (16 * w + (lane >> 2)) * KB + 16 * (lane & 3);
  int qg_split = -1, st = 0;
  for (int item = 0; item < my_items; ++item) {
    const int wi = blockIdx.x + item * gridDim.x;
    const int qg = wi / a.n_tiles, tile = wi % a.n_tiles;
    // a tile's accumulators, dead outside it (the limb split at a tile's
    // start has their registers) and not set here: the tile's first wgmmas
    // overwrite them (scale_d 0), and an instruction writing them would
    // serialize the wgmmas (ptxas C7515)
    float hi[NQ / 2], lo[NQ / 2];
    // the epilogue's sq_eff, in flight while the tile's chunks are scored
    const size_t rows = (size_t)tile * BR + 16 * w + (lane >> 2);
    const float sq[2] = {a.sq_eff[rows], a.sq_eff[rows + 8]};
    for (int win = 0; win < a.n_win; ++win) {
      const int c0 = win * a.win, nc = min(a.win, a.n_chunks - c0);
      if (a.n_win > 1 || qg != qg_split) {
        // every warp's wgmmas on the old limbs are complete (each waited
        // before its last epilogue or its window's last chunk) before the
        // limbs are overwritten
        if (win > 0) {
          wgmma_wait<0>();
          fence_operands<NQ / 2>(hi);
          fence_operands<NQ / 2>(lo);
        }
        consumer_sync();
        split_limbs<NQ>(a, limbs, qg * GROUP, c0, nc);
        if (t < GROUP)
          sm.shift[t] = qg * GROUP + t < a.Q ? a.shift[qg * GROUP + t] : 0.f;
        // the split's generic-proxy stores, seen by the wgmmas
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumer_sync();
        qg_split = qg;
      }
      for (int c = 0; c < nc; ++c, ++st) {
        const int slot = st % STAGES;
        mbar_wait(&sm.full[slot], (uint32_t)((st / STAGES) & 1));
        const uint4 x0 =
            *reinterpret_cast<const uint4*>(&sm.ring[slot][row_off]);
        const uint4 x1 =
            *reinterpret_cast<const uint4*>(&sm.ring[slot][row_off + 8 * KB]);
        mbar_arrive(&sm.empty[slot]);   // the registers hold the slot
        // the last chunk's wgmmas ran while this chunk was read; they are
        // done before its A registers are rewritten
        wgmma_wait<0>();
        fence_operands<NQ / 2>(hi);
        fence_operands<NQ / 2>(lo);
        // k-step s takes word s of each row: bytes 0, 1 are fragment columns
        // 2c, 2c + 1 and bytes 2, 3 columns 8 + 2c, 9 + 2c (limb_idx)
        const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
        const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
        uint32_t frag[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          frag[s][0] = code_pair(w0[s], 0);   // row r, columns 2c, 2c + 1
          frag[s][1] = code_pair(w1[s], 0);   // row r + 8
          frag[s][2] = code_pair(w0[s], 2);   // row r, columns 8 + 2c, ..
          frag[s][3] = code_pair(w1[s], 2);   // row r + 8
        }
        const int first = (win == 0 && c == 0) ? 0 : 1;
        const uint16_t* lt = limbs + (size_t)c * 3 * 4 * (NQ * 16);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int acc = s > 0 ? 1 : first;
          Mma<NQ>::run(hi, frag[s], make_desc(lt + (0 * 4 + s) * NQ * 16),
                       acc);
          Mma<NQ>::run(lo, frag[s], make_desc(lt + (1 * 4 + s) * NQ * 16),
                       acc);
          Mma<NQ>::run(lo, frag[s], make_desc(lt + (2 * 4 + s) * NQ * 16),
                       1);
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_operands<NQ / 2>(hi);
    fence_operands<NQ / 2>(lo);
    epilogue<NQ>(a, hi, lo, sq, qg, tile, sm, item & 1);
  }
}

template <int NQ>
cudaError_t launch(Args& a, bool async_ok, cudaStream_t stream) {
  const int limb_chunk = 3 * 4 * NQ * 16 * 2;   // bytes of one chunk's limbs
  a.win = min(a.n_chunks, max(1, LIMB_BYTES / limb_chunk));
  a.n_win = (a.n_chunks + a.win - 1) / a.win;
  const int smem = 128 + (((int)sizeof(Smem) + 127) & ~127) +
                   a.win * limb_chunk;
  void (*kernel)(const Args) = async_ok ? sq8_scan_kernel<NQ, true>
                                        : sq8_scan_kernel<NQ, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(min(a.n_items, max(1, per_sm) * sm_count()));
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() (0 on success).
// q_alpha f32[Q, D], codes u8[N, D], sq_eff f32[N], shift f32[Q] in; S
// f32[Q, N] (or null: bmax-only mode), bmax f32[Q, N/64] out. All contiguous
// on one device; N % 64 == 0.
extern "C" int sq8_scan_launch(const void* q_alpha, const void* codes,
                               const void* sq_eff, const void* shift, void* S,
                               void* bmax, int Q, int N, int D, float fac,
                               void* stream) {
  if (Q <= 0 || N <= 0 || N % BR != 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q_alpha = (const float*)q_alpha;
  a.codes = (const uint8_t*)codes;
  a.sq_eff = (const float*)sq_eff;
  a.shift = (const float*)shift;
  a.S = (float*)S;
  a.bmax = (float*)bmax;
  a.Q = Q, a.N = N, a.D = D, a.fac = fac;
  a.n_tiles = N / BR;
  a.n_items = a.n_tiles * ((Q + GROUP - 1) / GROUP);
  a.n_chunks = (D + KB - 1) / KB;
  a.vec = D % 4 == 0 && (uintptr_t)q_alpha % 16 == 0;
  // a tensor map takes a 16-byte aligned base and row stride
  const EncodeTiled enc = encode_tiled();
  const bool async_ok =
      enc != nullptr && D % 16 == 0 && (uintptr_t)codes % 16 == 0 &&
      make_map_2d(enc, &a.map_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes,
                  N, D, KB, BR, CU_TENSOR_MAP_SWIZZLE_NONE);
  const cudaStream_t s = (cudaStream_t)stream;
  const int nq = min(Q, GROUP);
  const cudaError_t e = nq <= 8    ? launch<8>(a, async_ok, s)
                        : nq <= 16 ? launch<16>(a, async_ok, s)
                        : nq <= 32 ? launch<32>(a, async_ok, s)
                                   : launch<64>(a, async_ok, s);
  return (int)e;
}

extern "C" const char* sq8_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
