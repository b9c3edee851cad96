// K5 `sq8_i8_scan`: partial scores and 64-row block maxima of the approximate
// SQ8 scan, int8 query x int8 codes, for Hopper (sm_90a), on the int8 tensor
// cores.
//
// Replaces (reindexer_tpu/ops): the scoring half of
// pallas_select.py::pipelined_select_sq8 (its _kernel with sq8=True,
// pallas_select.py:1292-1300), whose selection half is K2 (bf_select.cu)
// unchanged.
//
// Contract: with qa_i8 the per-query int8 quantization of q * alpha (scale
// s_q), sqscale[q] = fac * s_q, and codes - 128 the signed codes,
//   S[q, n]    = max(float(sum_d qa_i8[q, d] * (codes[n, d] - 128))
//                    * sqscale[q] - sq_eff[n], -1e30)
//   bmax[q, g] = max of S[q, 64g .. 64g+63]
// The float conversion, product and difference are each rounded once, in
// that order (no fused multiply-add), so the plain version in ops/scan.py
// gives the same bits. The block maximum is taken from the very values
// written to S, so K2's selection is exact for these scores with no margin:
// the top-k of the quantized scores (the reference's approximate SQ8
// semantics).
//
// Why the integer sum is exact. The products run as s8 x s8: each code byte
// is made signed in registers (x ^ 0x80 == x - 128 as an int8), so every
// term is at most 127 * 128 in magnitude and |sum| <= D * 16,256 < 2^31 for
// any D up to 132,000, the width the launcher admits. The tensor cores add
// int8 products into s32 accumulators exactly (no .satfinite is asked for,
// and none is needed: no partial sum leaves the int32 range). The other
// route, u8 codes x s8 queries less 128 * sum(qa_i8), would reach 127 * 255
// * D and pass 2^31 at D >= 66,312.
//
// What bounds it on the H100: the bytes. The codes are N*D bytes (16.8 MB at
// 131072 x 128: 5.0 us at 3.35 TB/s) and S is Q*N*4 bytes written (33.5 MB
// at Q = 64: 10.0 us); the products are Q*N*D int8 multiply-adds (2.1 G at
// Q = 64: 1.1 us at 1,979 TOP/s). One query is bound by the codes: the N of
// a wgmma is the query group rounded up to 8.
// What the design does about it (K3's structure, sq8_scan.cu):
//   - `wgmma` m64nNk32 (s8 x s8 -> s32): M = 64 code rows, one block-max
//     block; N = NQ, the query group rounded up to 8, 16, 32 or 64.
//   - A (the codes) comes from registers: each consumer thread reads 2 x 16
//     bytes of a 64-byte chunk of its two rows from the ring slot and flips
//     their sign bits; the K order inside a chunk is permuted so that a
//     thread's 16 bytes feed both k-steps, and the queries are laid out in
//     shared memory in the same order (an integer dot product does not
//     depend on the order of its terms).
//   - B (the int8 queries) is staged once per query group and stays in
//     shared memory as K-major core matrices (tma_wgmma.cuh::make_desc); for
//     a D whose queries outgrow QRY_BYTES they are staged again per window
//     of D for each tile.
//   - Persistent CTAs, four per SM, each a producer warp and a consumer
//     warpgroup: the producer keeps 2D TMA boxes of 64 rows x 64 code bytes
//     in flight into a 6-stage mbarrier ring (columns past D filled with
//     zeros by the copy, whose query bytes are zero); the consumers release
//     a slot as soon as their registers hold it.
//   - The epilogue converts, scales and subtracts sq_eff (loaded when the
//     tile began) in the plain version's order, stores S in whole 32-byte
//     sectors and takes each 64-row block max from the values written.
// Codes that a tensor map cannot take (D % 16 != 0, or a pointer off 16
// bytes) run the same kernel with the producer warp reading device memory
// and laying each box out as the copy would.
// Later work: fusing K2's selection so that S never leaves the SM (a change
// of contract).

#include <math.h>

#include "tma_wgmma.cuh"

namespace {

using namespace rxtc;

constexpr int BR = 64;            // code rows per tile: the M of a wgmma
constexpr int KB = 64;            // code bytes (D columns) per chunk
constexpr int STAGES = 6;         // depth of the codes ring
constexpr int WG = 128;           // the consumer warpgroup
constexpr int THREADS = WG + 32;  // and the producer warp
constexpr int GROUP = 64;         // queries per group: the widest N
constexpr int QRY_BYTES = 64 * 1024;   // resident int8 queries, at most
constexpr int MAX_D = 132000;     // |sum| < 2^31 below this width
constexpr float SENT = -1e30f;

struct Args {
  CUtensorMap map_codes;   // boxes of KB columns x BR rows
  const int8_t* qa_i8;
  const float* sqscale;
  const uint8_t* codes;
  const float* sq_eff;
  float* S;
  float* bmax;
  int Q, N, D, n_tiles, n_items, n_chunks, win, n_win;
  bool vec;                // D % 4 == 0 and qa_i8 4-byte aligned
};

struct Smem {
  uint8_t ring[STAGES][BR * KB];      // TMA destinations, rows of 64 bytes
  unsigned long long full[STAGES];    // slot holds its box
  unsigned long long empty[STAGES];   // slot read by every consumer thread
  float wmax[2][WG / 32][GROUP];      // the warps' block maxima, by tile
  float scale[GROUP];                 // the query group's sqscale
  // then, 128-byte aligned: the queries, [win chunk][k-step][NQ x 32 bytes]
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WG) : "memory");
}

// byte offset of (query row n, wgmma column kk of a k-step) in a k-step's
// K-major tile of core matrices: 8 rows x 16 bytes, the two of a k-step 128
// bytes apart, 8-row groups 256 bytes apart
__device__ __forceinline__ int qry_off(int n, int kk) {
  return (n >> 3) * 256 + (kk >> 4) * 128 + (n & 7) * 16 + (kk & 15);
}

// The queries of rows [q0, q0 + NQ) (zeros past Q and past D) and chunks
// [c0, c0 + nc) into the resident area, a 4-byte word at a time. Word wd of
// a chunk's row (bytes 4 wd .. 4 wd + 3) is word 2 s + h of the 16 bytes
// that consumer lane t = wd / 4 reads of a code row, which its fragment
// gives to k-step s at wgmma columns 16 h + 4 t .. + 3 (see the consumer).
// Consumer threads only; the loads go out BATCH at a time, all before
// their stores, so a thread waits for memory once a batch.
template <int NQ>
__device__ void stage_queries(const Args& a, uint8_t* qry, int q0, int c0,
                              int nc) {
  constexpr int per_chunk = NQ * KB / 4;   // words of a chunk
  constexpr int BATCH = 8;
  const int total = nc * per_chunk;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * WG) {
    uint32_t x[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * WG;
      const int cw = e / per_chunk, f = e % per_chunk;
      const int n = f / (KB / 4), wd = f % (KB / 4);
      const int d0 = (c0 + cw) * KB + 4 * wd;
      const int8_t* src = a.qa_i8 + (size_t)(q0 + n) * a.D + d0;
      x[b] = 0;
      if (e < total && q0 + n < a.Q) {
        if (a.vec && d0 < a.D) {     // D % 4 == 0: the whole word
          x[b] = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d0 + j < a.D) x[b] |= (uint32_t)(uint8_t)src[j] << (8 * j);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * WG;
      if (e >= total) break;
      const int cw = e / per_chunk, f = e % per_chunk;
      const int n = f / (KB / 4), wd = f % (KB / 4);
      const int t = wd >> 2, s = (wd >> 1) & 1, h = wd & 1;
      *reinterpret_cast<uint32_t*>(
          qry + (cw * 2 + s) * (NQ * 32) + qry_off(n, 16 * h + 4 * t)) = x[b];
    }
  }
}

template <int NQ>
struct Mma;

// d[NQ / 2] (+)= A (64 x 32 s8, registers) * B (32 x NQ s8, shared memory,
// K-major) in s32; scale_d == 0 overwrites d instead
template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
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

// float(acc) * sqscale - sq_eff, each rounded once, clamped, into S, and the
// block max of those values into bmax. Register i of an accumulator holds
// code row 16 w + lane/4 + 8 ((i/2) % 2) and query column 8 (i/4) + 2
// (lane % 4) + i % 2 of the tile (warp w of the consumer warpgroup). sq
// holds the sq_eff of the thread's two rows, loaded when the tile began.
template <int NQ>
__device__ void epilogue(const Args& a, const int* acc, const float* sq,
                         int qg, int tile, Smem& sm, int buf) {
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
      const float sc = sm.scale[col];
      float m = -INFINITY;
#pragma unroll
      for (int v = 0; v < 2; ++v) {       // rows r0 and r0 + 8
        const int i = 4 * j + 2 * v + h;
        const float s = fmaxf(
            __fsub_rn(__fmul_rn(__int2float_rn(acc[i]), sc), sq[v]), SENT);
        m = fmaxf(m, s);
        if (q < a.Q) a.S[(size_t)q * a.N + n0 + r0 + 8 * v] = s;
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
// ring full; the consumer warpgroup (threads 0-127) stages the query
// group, makes each chunk's codes signed A fragments, runs its two k-steps'
// wgmmas and, after a tile's last chunk, its epilogue.
template <int NQ, bool ASYNC>
__global__ void __launch_bounds__(THREADS, 4)
    sq8_i8_scan_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  uint8_t* qry = reinterpret_cast<uint8_t*>(&sm) +
                 ((sizeof(Smem) + 127) & ~(size_t)127);
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
  int qg_staged = -1, st = 0;
  for (int item = 0; item < my_items; ++item) {
    const int wi = blockIdx.x + item * gridDim.x;
    const int qg = wi / a.n_tiles, tile = wi % a.n_tiles;
    // a tile's accumulators, not set here: the tile's first wgmmas
    // overwrite them (scale_d 0), and an instruction writing them would
    // serialize the wgmmas (ptxas C7515)
    int acc[NQ / 2];
    // the epilogue's sq_eff, in flight while the tile's chunks are scored
    const size_t rows = (size_t)tile * BR + 16 * w + (lane >> 2);
    const float sq[2] = {a.sq_eff[rows], a.sq_eff[rows + 8]};
    for (int win = 0; win < a.n_win; ++win) {
      const int c0 = win * a.win, nc = min(a.win, a.n_chunks - c0);
      if (a.n_win > 1 || qg != qg_staged) {
        // every warp's wgmmas on the old queries are complete (each waited
        // before its last epilogue or its window's last chunk) before the
        // queries are overwritten
        if (win > 0) {
          wgmma_wait<0>();
          fence_operands<NQ / 2>(acc);
        }
        consumer_sync();
        stage_queries<NQ>(a, qry, qg * GROUP, c0, nc);
        if (t < GROUP)
          sm.scale[t] = qg * GROUP + t < a.Q ? a.sqscale[qg * GROUP + t] : 0.f;
        // the staging's generic-proxy stores, seen by the wgmmas
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumer_sync();
        qg_staged = qg;
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
        fence_operands<NQ / 2>(acc);
        // k-step s takes words 2s (columns 4 (lane % 4) ..) and 2s + 1
        // (columns 16 + 4 (lane % 4) ..) of each row, signed
        const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
        const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
        uint32_t frag[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          frag[s][0] = w0[2 * s] ^ 0x80808080u;       // row r
          frag[s][1] = w1[2 * s] ^ 0x80808080u;       // row r + 8
          frag[s][2] = w0[2 * s + 1] ^ 0x80808080u;   // row r, columns 16..
          frag[s][3] = w1[2 * s + 1] ^ 0x80808080u;   // row r + 8
        }
        const int first = (win == 0 && c == 0) ? 0 : 1;
        const uint8_t* qt = qry + (size_t)c * 2 * (NQ * 32);
        wgmma_fence();
        Mma<NQ>::run(acc, frag[0], make_desc(qt), first);
        Mma<NQ>::run(acc, frag[1], make_desc(qt + NQ * 32), 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_operands<NQ / 2>(acc);
    epilogue<NQ>(a, acc, sq, qg, tile, sm, item & 1);
  }
}

template <int NQ>
cudaError_t launch(Args& a, bool async_ok, cudaStream_t stream) {
  const int qry_chunk = 2 * NQ * 32;   // bytes of one chunk's queries
  a.win = min(a.n_chunks, max(1, QRY_BYTES / qry_chunk));
  a.n_win = (a.n_chunks + a.win - 1) / a.win;
  const int smem = 128 + (((int)sizeof(Smem) + 127) & ~127) +
                   a.win * qry_chunk;
  void (*kernel)(const Args) = async_ok ? sq8_i8_scan_kernel<NQ, true>
                                        : sq8_i8_scan_kernel<NQ, false>;
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

// Launches K5 on `stream`; returns cudaGetLastError() (0 on success).
// qa_i8 i8[Q, D], sqscale f32[Q], codes u8[N, D], sq_eff f32[N] in; S
// f32[Q, N], bmax f32[Q, N/64] out. All contiguous on one device; N % 64 ==
// 0 and D < 132,000.
extern "C" int sq8_i8_scan_launch(const void* qa_i8, const void* sqscale,
                                  const void* codes, const void* sq_eff,
                                  void* S, void* bmax, int Q, int N, int D,
                                  void* stream) {
  if (Q <= 0 || N <= 0 || N % BR != 0 || D <= 0 || D >= MAX_D)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.qa_i8 = (const int8_t*)qa_i8;
  a.sqscale = (const float*)sqscale;
  a.codes = (const uint8_t*)codes;
  a.sq_eff = (const float*)sq_eff;
  a.S = (float*)S;
  a.bmax = (float*)bmax;
  a.Q = Q, a.N = N, a.D = D;
  a.n_tiles = N / BR;
  a.n_items = a.n_tiles * ((Q + GROUP - 1) / GROUP);
  a.n_chunks = (D + KB - 1) / KB;
  a.vec = D % 4 == 0 && (uintptr_t)qa_i8 % 4 == 0;
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

extern "C" const char* sq8_i8_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
