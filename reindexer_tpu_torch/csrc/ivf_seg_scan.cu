// K6 `ivf_seg_scan`: scores of the probed 128-row blocks of the IVF
// list-contiguous reorder, for Hopper (sm_90a). Each probed block is read
// from device memory once for all the queries that probe it.
//
// Replaces reindexer_tpu/ops/ivf_kernels.py::scan_segments (the Pallas
// kernel of _make_seg_kernel), whose grid walks the probed blocks through
// scalar-prefetched block indices, one (query, block) segment a step.
//
// Contract, per segment i of NSEG: b_r = row r of the 128-row block
// starts[i] of reordered [Npad, D], q = row qids[i] of queries [B, D],
//   out[i, r] = max(2 q.b_r - |b_r|^2 (L2) or q.b_r (IP/cosine), -1e30)
//               for r < counts[i], and -1e30 for r >= counts[i];
// a segment with counts[i] > 0 whose block or query index is out of range
// reads nothing and comes out NaN. |b|^2 comes from the block itself; the
// rank-invariant -|q|^2 is the caller's.
//
// Precision: fp32-accurate products on the tensor cores through K1's
// 3xTF32 split (bf_scan.cu), never a single TF32 or bf16 product (the TPU
// kernel's bf16x3 split was a Mosaic workaround). Each value x splits into
// hi = tf32(x) and lo = tf32(x - hi), rounded to nearest; hi.hi goes to one
// accumulator, hi.lo + lo.hi to another, lo.lo (about 2^-22 of a term) is
// dropped. The tensor cores truncate as they accumulate, so a chunk's
// products (32 of D) start from zero and join the fp32 totals once: a
// score stays within a few fp32 ulps of sum_d |q_d b_d| (+ |b|^2 for L2,
// summed in fp32 FMA from the same fragments).
//
// What bounds it on the H100: the bytes of the unique probed rows, each
// read once, plus the scores written (128 floats a segment): at 1M x 768
// (lists of ~977 rows, 8 blocks each) batch 16 x nprobe 128 probes 2.58 GB
// of unique rows (0.77 ms at 3.35 TB/s), batch 256 x nprobe 128 nearly the
// whole reorder, 3.07 GB. The products are 2 * D flop a probed row and
// query: 50 GFLOP at 256 x 128, 0.75 ms at the 67 TFLOP/s of fp32 FMA, which
// is why they run on the tensor cores (a first version of this kernel, fp32
// FMA on the CUDA cores, was bound there by its shared-memory reads).
//
// What the design does about it:
//   - Grouping, on the device and without a host sync: a counting sort of
//     the segments by block (`group`: a histogram by atomics, whose return
//     value is each segment's rank in its block, and each block's largest
//     count; `offsets`: one CTA's exclusive scans of the group sizes and of
//     their tiles of QT queries; `order`: the segments scattered into block
//     order, and one work item {block, first, queries, rows} a tile).
//     Padding segments (count 0, up to half of NSEG, all pointing at one pad
//     block) and out-of-range ones write their sentinel or NaN row in
//     `group` and join no group. With one query (B = 1) no block is probed
//     twice: the sort is skipped and each segment is its own item.
//   - The scan: persistent CTAs, one an SM, walk the items. A producer warp
//     streams the item's block through a 6-stage mbarrier ring, 32 columns
//     (128 bytes) of D a stage, by TMA (128-byte swizzle, columns past D
//     filled with zeros; a whole block in one 128-row box, the rows of a
//     ragged last block of a list in 32-row boxes), and copies the same
//     columns of each of the item's queries beside it (cp.async, counted by
//     the stage's mbarrier). So a block is read once for up to QT = 64
//     queries; a larger group splits into tiles, read one after another
//     while the block is in L2.
//   - Eight consumer warps take 16 rows of the block each and run
//     mma.sync m16n8k8 (tf32) against the item's queries in tiles of 8 (an
//     instance per count of tiles, so the inner loop has no branches); with
//     more than one tile the warps share one split of the chunk's queries.
//     |b|^2 is taken once a row from the warp's own fragments and shared by
//     every query.
//   - Each segment's 128 scores go to its own row of `out`, rows past its
//     own count masked (the queries of a block may differ in count).
// Blocks that a tensor map cannot take (D % 4 != 0, or a base off 16 bytes)
// run the same kernel with the producer warp reading device memory and
// laying each stage out as the copy would.

#include <math.h>

#include "tma_wgmma.cuh"

namespace {

using namespace rxtc;

constexpr int SEG_BLK = 128;          // rows per block and per segment
constexpr int KC = 32;                // floats of D per chunk: 128 bytes
constexpr int STAGES = 6;             // depth of the ring
constexpr int CWARPS = SEG_BLK / 16;  // consumer warps, 16 rows each
constexpr int CONSUMERS = 32 * CWARPS;
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int QT = 64;                // queries an item, at most
constexpr int QS = KC + 4;            // floats a query row of a chunk: the
                                      // padding spreads B's loads on banks
constexpr int BOX_ROWS = 32;          // rows of a TMA box
constexpr int BOX_BYTES = BOX_ROWS * KC * 4;
constexpr int PREP_THREADS = 256;
constexpr float SENT = -1e30f;

struct Args {
  CUtensorMap map;          // reordered: boxes of KC columns x 128 rows
  CUtensorMap map_part;     // and of KC columns x BOX_ROWS rows
  const int* starts;
  const int* qids;
  const int* counts;
  const float* queries;
  const float* reordered;
  float* out;
  // grouped: the items and the segments in block order; null items: each
  // segment is its own item (one query)
  const int4* items;        // {block, first sorted position, queries, rows}
  const int* n_items;       // the items' count, on the device
  const int* s_seg;
  const int* s_qid;
  const int* s_cnt;
  int nseg, n_blocks, n_q, D, n_chunks, l2;
};

struct Smem {
  float ring[STAGES][SEG_BLK * KC];   // TMA destinations (1024-aligned)
  float qc[STAGES][QT * QS];          // the item's queries, same columns
  float qh[2][QT * QS];               // their TF32 split, by chunk parity
  float ql[2][QT * QS];
  unsigned long long full[STAGES];    // slot holds its box and queries
  unsigned long long empty[STAGES];   // slot read by every consumer thread
};

// The sentinel (or NaN) row of a segment that reads nothing, by one warp
__device__ __forceinline__ void fill_row(float* out, int seg, float v) {
  reinterpret_cast<float4*>(out + (size_t)seg * SEG_BLK)[threadIdx.x & 31] =
      make_float4(v, v, v, v);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

struct Item {
  int block, first, m;   // m: queries of the item (0: it reads nothing)
  int rows;              // rows read: the largest count of its segments
};

__device__ __forceinline__ Item decode(const Args& a, int i) {
  if (a.items != nullptr) {
    const int4 d = a.items[i];
    return {d.x, d.y, d.z, d.w};
  }
  const int start = a.starts[i], qid = a.qids[i], cnt = a.counts[i];
  const bool ok = cnt > 0 && start >= 0 && start < a.n_blocks && qid >= 0 &&
                  qid < a.n_q;
  return {start, i, ok ? 1 : 0, min(cnt, SEG_BLK)};
}

__device__ __forceinline__ int n_items(const Args& a) {
  return a.items != nullptr ? *a.n_items : a.nseg;
}

// ---------------------------------------------------------------- grouping

// Each segment: its rank in its block's group (atomics on the histogram)
// and its count into the block's largest (`rows`); or rank -1 and its
// sentinel (count <= 0) or NaN (an index out of range) row written, a
// warp's 32 segments at a time so that the rows go out coalesced.
__global__ void __launch_bounds__(PREP_THREADS)
    ivf_seg_scan_group(const Args a, int* hist, int* rows, int* rank) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * PREP_THREADS + threadIdx.x) >> 5;
  const int n_warps = gridDim.x * (PREP_THREADS / 32);
  for (int base = 32 * warp; base < a.nseg; base += 32 * n_warps) {
    const int i = base + lane;
    float fill = 0.f;
    bool none = false;
    if (i < a.nseg) {
      const int start = a.starts[i], qid = a.qids[i];
      const int cnt = min(a.counts[i], SEG_BLK);
      if (cnt <= 0) {
        none = true, fill = SENT;
      } else if (start < 0 || start >= a.n_blocks || qid < 0 ||
                 qid >= a.n_q) {
        none = true, fill = NAN;
      }
      rank[i] = none ? -1 : atomicAdd(&hist[start], 1);
      if (!none) atomicMax(&rows[start], cnt);
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, none); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      fill_row(a.out, base + src, __shfl_sync(0xffffffffu, fill, src));
    }
  }
}

// One CTA: exclusive scans of the group sizes (grp_off) and of their tiles
// of QT queries (item_off) over the n blocks, totals at index n; a pass
// takes 4,096 blocks, 4 contiguous ones a thread read as one int4.
__global__ void __launch_bounds__(1024)
    ivf_seg_scan_offsets(const int* hist, int* grp_off, int* item_off,
                         int n) {
  constexpr int PER = 4;
  __shared__ int wsum[2][32];
  __shared__ int pass_total[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int cg = 0, ci = 0;   // the totals of the earlier passes
  for (int base = 0; base < n; base += 1024 * PER) {
    const int i0 = base + PER * t;
    int h[PER];
#pragma unroll
    for (int k = 0; k < PER; k += 4) {
      if (i0 + k + 3 < n) {
        const int4 v = *reinterpret_cast<const int4*>(hist + i0 + k);
        h[k] = v.x, h[k + 1] = v.y, h[k + 2] = v.z, h[k + 3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[k + j] = i0 + k + j < n ? hist[i0 + k + j] : 0;
      }
    }
    int sg = 0, si = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) sg += h[k], si += (h[k] + QT - 1) / QT;
    int ig = sg, ii = si;   // inclusive scans within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, ig, off);
      const int y = __shfl_up_sync(0xffffffffu, ii, off);
      if (lane >= off) ig += x, ii += y;
    }
    if (lane == 31) wsum[0][warp] = ig, wsum[1][warp] = ii;
    __syncthreads();
    if (warp == 0) {
      int g = wsum[0][lane], it = wsum[1][lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, g, off);
        const int y = __shfl_up_sync(0xffffffffu, it, off);
        if (lane >= off) g += x, it += y;
      }
      wsum[0][lane] = g - wsum[0][lane];   // exclusive over the warps
      wsum[1][lane] = it - wsum[1][lane];
      if (lane == 31) pass_total[0] = g, pass_total[1] = it;
    }
    __syncthreads();
    int eg = cg + wsum[0][warp] + ig - sg, ei = ci + wsum[1][warp] + ii - si;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (i0 + k < n) grp_off[i0 + k] = eg, item_off[i0 + k] = ei;
      eg += h[k];
      ei += (h[k] + QT - 1) / QT;
    }
    cg += pass_total[0];
    ci += pass_total[1];
    __syncthreads();   // wsum and pass_total are rewritten by the next pass
  }
  if (t == 0) grp_off[n] = cg, item_off[n] = ci;
}

// The segments into block order (their query and clamped count beside
// them), and each block's items, one a tile of QT of its queries, with the
// rows the block's segments need.
__global__ void __launch_bounds__(PREP_THREADS)
    ivf_seg_scan_order(const Args a, const int* hist, const int* rows,
                       const int* grp_off, const int* item_off,
                       const int* rank, int4* items,
                       int* s_seg, int* s_qid, int* s_cnt) {
  const int n = max(a.nseg, a.n_blocks);
  for (int i = blockIdx.x * PREP_THREADS + threadIdx.x; i < n;
       i += gridDim.x * PREP_THREADS) {
    if (i < a.nseg && rank[i] >= 0) {
      const int pos = grp_off[a.starts[i]] + rank[i];
      s_seg[pos] = i;
      s_qid[pos] = a.qids[i];
      s_cnt[pos] = min(a.counts[i], SEG_BLK);
    }
    if (i < a.n_blocks) {
      const int h = hist[i], g = grp_off[i], o = item_off[i];
      for (int t = 0; t * QT < h; ++t)
        items[o + t] =
            make_int4(i, g + t * QT, min(QT, h - t * QT), rows[i]);
    }
  }
}

// -------------------------------------------------------------------- scan

// 4 bytes from global to shared memory, asynchronously; src_bytes 0 writes
// a zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the mbarrier's arrival (counted in its init) once this thread's earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the bytes a TMA copy will bring, without an arrival
__device__ __forceinline__ void expect_bytes(unsigned long long* bar,
                                             uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// The producer warp, without a tensor map: the first `rows` rows of chunk
// `chunk` of block `block` from device memory (zeros past D), lane l
// copying column l of every row to the 128-byte swizzle's place for it.
__device__ __forceinline__ void load_box_plain(const Args& a, float* slot,
                                               int block, int rows,
                                               int chunk) {
  const int lane = threadIdx.x & 31;
  const int d = chunk * KC + lane;
  const float* src =
      a.reordered + (size_t)block * SEG_BLK * a.D + (d < a.D ? d : 0);
  for (int r = 0; r < rows; ++r)
    cp_async4(slot + r * KC + (((lane >> 2) ^ (r & 7)) << 2) + (lane & 3),
              src + (size_t)r * a.D, d < a.D ? 4 : 0);
}

// The producer warp: for every item of this CTA and every chunk of D, the
// block's box (TMA, or load_box_plain) and the same 32 columns of each of
// the item's queries (lane l copying column l) into the next ring slot. The
// slot's full barrier counts the 32 lanes' cp.async arrivals and the TMA's
// bytes.
template <bool ASYNC>
__device__ void producer(const Args& a, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int total = n_items(a);
  int st = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const Item it = decode(a, i);
    if (it.m == 0) continue;
    const int* qsrc = a.items != nullptr ? a.s_qid : a.qids;
    const int qa = lane < it.m ? qsrc[it.first + lane] : 0;
    const int qb = lane + 32 < it.m ? qsrc[it.first + lane + 32] : 0;
    for (int c = 0; c < a.n_chunks; ++c, ++st) {
      const int slot = st % STAGES;
      if (st >= STAGES)
        mbar_wait(&sm.empty[slot], (uint32_t)((st / STAGES - 1) & 1));
      const int d = c * KC + lane;
      const int bytes = d < a.D ? 4 : 0;
      for (int j = 0; j < it.m; ++j) {
        const int qid = __shfl_sync(0xffffffffu, j < 32 ? qa : qb, j & 31);
        cp_async4(sm.qc[slot] + j * QS + lane,
                  a.queries + (size_t)qid * a.D + (bytes ? d : 0), bytes);
      }
      if (ASYNC) {
        if (lane == 0) {
          // a whole block in one box, a ragged one in the boxes of
          // BOX_ROWS rows that hold its rows
          const int n_box = (it.rows + BOX_ROWS - 1) / BOX_ROWS;
          expect_bytes(&sm.full[slot], n_box * BOX_BYTES);
          if (n_box == SEG_BLK / BOX_ROWS)
            tma_load(sm.ring[slot], &a.map, c * KC, it.block * SEG_BLK,
                     &sm.full[slot]);
          else
            for (int b = 0; b < n_box; ++b)
              tma_load(sm.ring[slot] + b * BOX_ROWS * KC, &a.map_part,
                       c * KC, it.block * SEG_BLK + b * BOX_ROWS,
                       &sm.full[slot]);
        }
      } else {
        load_box_plain(a, sm.ring[slot], it.block, it.rows, c);
      }
      cp_async_arrive(&sm.full[slot]);
    }
  }
  // no copy of this thread is in flight when it exits
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// d (16 x 8, fp32) += A (16 x 8, tf32, row-major) * B (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One item for one consumer warp: its 16 rows (16 w ..) of the block
// against the item's m <= 8 NT queries, NT tiles of 8, over every chunk of
// D, then those rows of each query's segment. In the fragments of an
// m16n8k8 product lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8
// and columns t and t + 4 of A, columns t and t + 4 of query g of B, and
// rows g and g + 8 of queries 2t and 2t + 1 of the scores.
template <int NT>
__device__ __noinline__ void consume_item(const Args& a, Smem& sm,
                                          const Item& it, int st) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = 16 * w + g;   // rows x0 and x0 + 8 (x % 8 == g for both)
  const bool l2 = a.l2 != 0;
  int seg[NT][2], cnt[NT][2];   // queries 8 T + 2 t + h, in flight until
#pragma unroll                    // the epilogue
  for (int T = 0; T < NT; ++T)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 8 * T + 2 * t + h, pos = it.first + j;
      seg[T][h] = j < it.m ? (a.items != nullptr ? a.s_seg[pos] : pos) : 0;
      cnt[T][h] = j < it.m ? min((a.items != nullptr ? a.s_cnt
                                                     : a.counts)[pos],
                                 SEG_BLK)
                           : 0;
    }
  constexpr bool SHARED = NT > 1;   // the warps share the query split
  float tot[NT][4], ss[2] = {0.f, 0.f};
#pragma unroll
  for (int T = 0; T < NT; ++T)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[T][i] = 0.f;
  if (SHARED) consumer_sync();   // every warp is past the earlier items
  for (int c = 0; c < a.n_chunks; ++c, ++st) {
    const int slot = st % STAGES;
    mbar_wait(&sm.full[slot], (uint32_t)((st / STAGES) & 1));
    const float* box = sm.ring[slot];
    const float* qc = sm.qc[slot];
    // SHARED: the chunk's queries split once for every warp, hi = tf32(x)
    // and lo = tf32(x - hi); the buffer's last readers finished chunk st - 2
    // before they passed the barrier of chunk st - 1 (or of this item)
    float* qh = sm.qh[st & 1];
    float* ql = sm.ql[st & 1];
    if (SHARED) {
      for (int e = threadIdx.x; e < it.m * KC; e += CONSUMERS) {
        const int i = (e / KC) * QS + e % KC;
        const float x = qc[i], h = to_tf32(x);
        qh[i] = h;
        ql[i] = to_tf32(x - h);
      }
      consumer_sync();
    }
    // a chunk's products start from zero and join the totals in fp32 once:
    // the tensor cores truncate as they accumulate
    float hi[NT][4], lo[NT][4], sp[2] = {0.f, 0.f};
#pragma unroll
    for (int T = 0; T < NT; ++T)
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[T][i] = 0.f, lo[T][i] = 0.f;
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
      // A: rows x0, x0 + 8, columns 8 s + t and + 4 of the swizzled box
      // (16-byte unit u of row x at u ^ (x % 8))
      const int u0 = ((2 * s) ^ g) << 2, u1 = ((2 * s + 1) ^ g) << 2;
      const float av[4] = {box[x0 * KC + u0 + t], box[(x0 + 8) * KC + u0 + t],
                           box[x0 * KC + u1 + t],
                           box[(x0 + 8) * KC + u1 + t]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = to_tf32(av[i]);
        ah[i] = __float_as_uint(h);
        al[i] = __float_as_uint(to_tf32(av[i] - h));
      }
      if (l2) {
        sp[0] = fmaf(av[2], av[2], fmaf(av[0], av[0], sp[0]));
        sp[1] = fmaf(av[3], av[3], fmaf(av[1], av[1], sp[1]));
      }
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        // B: query 8 T + g, columns 8 s + t and + 4 (rows QS floats apart)
        const int qi = (8 * T + g) * QS + 8 * s + t;
        uint32_t bh0, bh1, bl0, bl1;
        if (SHARED) {
          bh0 = __float_as_uint(qh[qi]), bh1 = __float_as_uint(qh[qi + 4]);
          bl0 = __float_as_uint(ql[qi]), bl1 = __float_as_uint(ql[qi + 4]);
        } else {   // one tile: this warp splits its own
          const float b0 = qc[qi], b1 = qc[qi + 4];
          const float h0 = to_tf32(b0), h1 = to_tf32(b1);
          bh0 = __float_as_uint(h0), bh1 = __float_as_uint(h1);
          bl0 = __float_as_uint(to_tf32(b0 - h0));
          bl1 = __float_as_uint(to_tf32(b1 - h1));
        }
        // 3xTF32: hi.hi into one accumulator, hi.lo + lo.hi into another
        mma_tf32(hi[T], ah, bh0, bh1);
        mma_tf32(lo[T], ah, bl0, bl1);
        mma_tf32(lo[T], al, bh0, bh1);
      }
    }
    mbar_arrive(&sm.empty[slot]);
#pragma unroll
    for (int T = 0; T < NT; ++T)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[T][i] += hi[T][i] + lo[T][i];
    ss[0] += sp[0];
    ss[1] += sp[1];
  }
  // epilogue: |b|^2 of rows x0, x0 + 8 summed over the 4 lanes of a row,
  // then each query's two rows
  if (l2)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      ss[v] += __shfl_xor_sync(0xffffffffu, ss[v], 1);
      ss[v] += __shfl_xor_sync(0xffffffffu, ss[v], 2);
    }
#pragma unroll
  for (int T = 0; T < NT; ++T)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (8 * T + 2 * t + h >= it.m) continue;
      float* row = a.out + (size_t)seg[T][h] * SEG_BLK;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int x = x0 + 8 * v;
        const float d = tot[T][2 * v + h];
        const float s = l2 ? 2.f * d - ss[v] : d;
        row[x] = x < cnt[T][h] ? fmaxf(s, SENT) : SENT;
      }
    }
}

// consume_item<nt> for a count nt <= N known only at run time
template <int N>
__device__ __forceinline__ void dispatch_item(const Args& a, Smem& sm,
                                              const Item& it, int st,
                                              int nt) {
  if constexpr (N == 1) {
    consume_item<1>(a, sm, it, st);
  } else {
    if (nt == N)
      consume_item<N>(a, sm, it, st);
    else
      dispatch_item<N - 1>(a, sm, it, st, nt);
  }
}

// The consumer warps: the items of this CTA, each with its queries in
// tiles of 8.
__device__ void consumers(const Args& a, Smem& sm) {
  const int w = threadIdx.x >> 5;
  const int total = n_items(a);
  int st = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const Item it = decode(a, i);
    if (it.m == 0) {   // one query: a segment that reads nothing
      if (w == 0) fill_row(a.out, i, a.counts[i] > 0 ? NAN : SENT);
      continue;
    }
    dispatch_item<QT / 8>(a, sm, it, st, (it.m + 7) / 8);
    st += a.n_chunks;
  }
}

template <bool ASYNC>
__global__ void __launch_bounds__(THREADS, 1)
    ivf_seg_scan_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS)
    producer<ASYNC>(a, sm);
  else
    consumers(a, sm);
}

}  // namespace

// int32 scratch that ivf_seg_scan_launch needs for nseg segments over
// n_blocks blocks and n_q queries (0 with one query: nothing is grouped)
extern "C" long long ivf_seg_scan_scratch_ints(int nseg, int n_blocks,
                                               int n_q) {
  return n_q > 1 ? 8LL * nseg + 4LL * n_blocks + 2 : 0;
}

// Launches K6 on `stream`; returns the first CUDA error (0 on success).
// starts, qids, counts i32[nseg]; queries f32[n_q, D]; reordered
// f32[n_blocks * 128, D] in; out f32[nseg, 128] out; scratch
// i32[ivf_seg_scan_scratch_ints(...)], 16-byte aligned. All contiguous on
// one device. With n_q > 1 the segments are grouped by block first (three
// small kernels and a memset), then one persistent kernel scores them.
extern "C" int ivf_seg_scan_launch(const void* starts, const void* qids,
                                   const void* counts, const void* queries,
                                   const void* reordered, void* out,
                                   void* scratch, int nseg, int n_blocks,
                                   int n_q, int D, int l2, void* stream) {
  if (nseg <= 0 || n_blocks <= 0 || n_q <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Args a = {};
  a.starts = (const int*)starts;
  a.qids = (const int*)qids;
  a.counts = (const int*)counts;
  a.queries = (const float*)queries;
  a.reordered = (const float*)reordered;
  a.out = (float*)out;
  a.nseg = nseg, a.n_blocks = n_blocks, a.n_q = n_q, a.D = D, a.l2 = l2;
  a.n_chunks = (D + KC - 1) / KC;
  cudaError_t e;
  if (n_q > 1) {
    if (scratch == nullptr || (uintptr_t)scratch % 16)
      return (int)cudaErrorInvalidValue;
    int4* items = (int4*)scratch;
    int* hist = (int*)scratch + 4LL * nseg;   // then rows: zeroed together
    int* rows = hist + n_blocks;
    int* grp_off = rows + n_blocks;
    int* item_off = grp_off + n_blocks + 1;
    int* rank = item_off + n_blocks + 1;
    int* s_seg = rank + nseg;
    int* s_qid = s_seg + nseg;
    int* s_cnt = s_qid + nseg;
    e = cudaMemsetAsync(hist, 0, 2 * sizeof(int) * (size_t)n_blocks, s);
    if (e != cudaSuccess) return (int)e;
    const int prep_grid =
        min((max(nseg, n_blocks) + PREP_THREADS - 1) / PREP_THREADS,
            8 * sm_count());
    ivf_seg_scan_group<<<prep_grid, PREP_THREADS, 0, s>>>(a, hist, rows,
                                                          rank);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ivf_seg_scan_offsets<<<1, 1024, 0, s>>>(hist, grp_off, item_off,
                                            n_blocks);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    ivf_seg_scan_order<<<prep_grid, PREP_THREADS, 0, s>>>(
        a, hist, rows, grp_off, item_off, rank, items, s_seg, s_qid, s_cnt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    a.items = items;
    a.n_items = item_off + n_blocks;
    a.s_seg = s_seg, a.s_qid = s_qid, a.s_cnt = s_cnt;
  }
  // a tensor map takes a 16-byte aligned base and row stride
  const EncodeTiled enc = encode_tiled();
  const bool async_ok =
      enc != nullptr && D % 4 == 0 && (uintptr_t)reordered % 16 == 0 &&
      make_map_2d(enc, &a.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, reordered,
                  n_blocks * SEG_BLK, D, KC, SEG_BLK,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map_2d(enc, &a.map_part, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  reordered, n_blocks * SEG_BLK, D, KC, BOX_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  void (*kernel)(const Args) = async_ok ? ivf_seg_scan_kernel<true>
                                        : ivf_seg_scan_kernel<false>;
  const int smem = (int)sizeof(Smem) + 1024;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<min(nseg, sm_count()), THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ivf_seg_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
