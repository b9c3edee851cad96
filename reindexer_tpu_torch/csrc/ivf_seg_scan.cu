// K6 `ivf_seg_scan`: scores of the probed 128-row blocks of the IVF
// list-contiguous reorder, for Hopper (sm_90a).
//
// Replaces reindexer_tpu/ops/ivf_kernels.py::scan_segments (the Pallas
// kernel of _make_seg_kernel), whose grid walks the probed blocks through
// scalar-prefetched block indices. Here each CTA loads its own segment's
// block index, query row and count.
//
// Contract, per segment i of NSEG: b_r = row r of the 128-row block
// starts[i] of reordered [Npad, D], q = row qids[i] of queries [B, D],
//   out[i, r] = max(2 q.b_r - |b_r|^2 (L2) or q.b_r (IP/cosine), -1e30)
//               for r < counts[i], and -1e30 for r >= counts[i].
// |b|^2 comes from the tile itself; the rank-invariant -|q|^2 is the
// caller's. Products are fp32 FMAs (the TPU kernel's bf16x3 split was a
// Mosaic workaround).
//
// What bounds it on the H100: the bytes of the probed rows, sum(counts) * D
// * 4, read once. At 1M x 768 (lists of ~977 rows, 8 blocks each): batch 1 x
// nprobe 8 reads ~25 MB (~7.5 us at 3.35 TB/s); batch 16 x nprobe 128 ~6.4
// GB (~1.9 ms). Probe sets of distinct queries are not deduplicated. The
// 2 FLOP per byte read are far below the card's FMA rate.
// What the design does about it: one CTA per segment; the query row sits in
// shared memory; each warp walks rows, its lanes reading consecutive float4s
// of a row (16 bytes a lane, coalesced), the dot and the sum of squares
// taken in one pass and reduced by warp shuffles. Rows past counts[i] are
// never read, so padding segments (count 0, up to half of NSEG once the
// segments per query are rounded to a power of two) cost one store of
// sentinels. D not a multiple of 4 takes a scalar loop.
// Later work: several segments of one query per CTA (the query row loaded
// once), TMA bulk copies of whole blocks, fusing segment_topk.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SEG_BLK = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float SENT = -1e30f;

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
ivf_seg_scan_kernel(const int* __restrict__ starts,
                    const int* __restrict__ qids,
                    const int* __restrict__ counts,
                    const float* __restrict__ queries,
                    const float* __restrict__ reordered,
                    float* __restrict__ out, int n_blocks, int n_q, int D,
                    int l2) {
  extern __shared__ float4 q_smem4[];
  float* q_smem = reinterpret_cast<float*>(q_smem4);
  const int seg = blockIdx.x;
  const int t = threadIdx.x;
  float* out_row = out + (size_t)seg * SEG_BLK;
  const int start = starts[seg];
  const int qid = qids[seg];
  int count = min(counts[seg], SEG_BLK);
  if (count > 0 && (start < 0 || start >= n_blocks || qid < 0 || qid >= n_q)) {
    // an index out of range never reads memory: the segment comes out NaN
    for (int r = t; r < SEG_BLK; r += THREADS) out_row[r] = NAN;
    return;
  }
  for (int r = max(count, 0) + t; r < SEG_BLK; r += THREADS) out_row[r] = SENT;
  if (count <= 0) return;

  const float* q = queries + (size_t)qid * D;
  for (int j = t; j < D; j += THREADS) q_smem[j] = q[j];
  __syncthreads();

  const float* tile = reordered + (size_t)start * SEG_BLK * D;
  const int warp = t >> 5, lane = t & 31;
  for (int r = warp; r < count; r += WARPS) {
    const float* row = tile + (size_t)r * D;
    float dot = 0.f, ss = 0.f;
    if (VEC4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int d4 = D >> 2;
#pragma unroll 4
      for (int j = lane; j < d4; j += 32) {
        const float4 b = __ldg(row4 + j);
        const float4 a = q_smem4[j];
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
        ss = fmaf(b.x, b.x, ss);
        ss = fmaf(b.y, b.y, ss);
        ss = fmaf(b.z, b.z, ss);
        ss = fmaf(b.w, b.w, ss);
      }
    } else {
#pragma unroll 4
      for (int j = lane; j < D; j += 32) {
        const float b = __ldg(row + j);
        dot = fmaf(q_smem[j], b, dot);
        ss = fmaf(b, b, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      const float s = l2 ? 2.f * dot - ss : dot;
      out_row[r] = fmaxf(s, SENT);
    }
  }
}

}  // namespace

// Launches K6 on `stream`; returns cudaGetLastError() (0 on success).
// starts, qids, counts i32[nseg]; queries f32[n_q, D]; reordered
// f32[n_blocks * 128, D] in; out f32[nseg, 128] out. All contiguous on one
// device; the float4 path needs D % 4 == 0 and 16-byte aligned
// queries/reordered, else the scalar path runs.
extern "C" int ivf_seg_scan_launch(const void* starts, const void* qids,
                                   const void* counts, const void* queries,
                                   const void* reordered, void* out, int nseg,
                                   int n_blocks, int n_q, int D, int l2,
                                   void* stream) {
  if (nseg <= 0 || n_blocks <= 0 || n_q <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((D + 3) / 4) * sizeof(float4);
  const bool vec4 = D % 4 == 0 && (size_t)queries % 16 == 0 &&
                    (size_t)reordered % 16 == 0;
  const void* fn = vec4 ? (const void*)ivf_seg_scan_kernel<true>
                        : (const void*)ivf_seg_scan_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    ivf_seg_scan_kernel<true><<<nseg, THREADS, smem, s>>>(
        (const int*)starts, (const int*)qids, (const int*)counts,
        (const float*)queries, (const float*)reordered, (float*)out, n_blocks,
        n_q, D, l2);
  else
    ivf_seg_scan_kernel<false><<<nseg, THREADS, smem, s>>>(
        (const int*)starts, (const int*)qids, (const int*)counts,
        (const float*)queries, (const float*)reordered, (float*)out, n_blocks,
        n_q, D, l2);
  return (int)cudaGetLastError();
}

extern "C" const char* ivf_seg_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
