// Row gather + sum over the dense shifted plane: Sp[r] = sum_w plane[rows[r, w]].
//
// Replaces the TPU kernel epik_tpu/ops/pallas/rowgather_mq.py::rowgather_sum_mq
// (body `_kernel`), which computes the function of
// epik_tpu/engine/placer.py::dense_sums_shifted, the hot loop of the default
// dense pair-plane placement step. The TPU kernel was bound by the rate at
// which its scalar core could issue one DMA per plane row; on Hopper a row read
// is a run of ordinary coalesced loads, so there is no issue limit to design
// around. The TPU's 16-sublane staging (`stage_plane`) is not carried over.
//
// Bound on the H100: HBM bytes. Each window slot reads one whole plane row of
// bw * 4 bytes (5,632 B at the D652 width bw = 1408) and the rows of one read
// are scattered over a multi-GB plane, so the 50 MB L2 gives little reuse. The
// roofline yardstick is W * bw * 4 bytes per read (71 * 5,632 B ~ 0.4 MB for a
// 150 bp read at k = 10) against 3.35 TB/s.
//
// Design: one block per read. The block stages its row offsets (int64, so
// planes beyond 2^31 floats address correctly) in shared memory, a tile at a
// time; its threads span the row in float4s (16-byte loads, neighbouring
// threads on neighbouring addresses); each thread adds the rows in window
// order, one after another, in registers. That is the order of the plain
// version's `acc += plane.index_select(0, rows[:, w])` loop, with no
// multiply, so the result is bit-equal to it. Misses point at the all-zero row.
//
// A second entry point, epik_rowgather_sum_topk, runs the placement finish in
// the same block (the contract of ROADMAP queue 2 item 1: the TPU kernel
// #2's finish in #1's epilogue), so the (R, bw) sums never reach HBM:
// * the window-order sums go to shared memory (bw floats, 5.6 KB at D652)
//   instead of HBM;
// * a read with an ambiguous (IUPAC) delta row adds it there, one
//   __fadd_rn per branch: the add of epik_tpu/engine/placer.py::_apply_amb;
// * a warp ballot of Sp > 0 over the B branches, one compaction into the
//   touched ids in ascending order, and finish_row.cuh's list finish write
//   the read's (2K+3) pack.
// Block i places read i. (Taking the reads in the order of each one's
// smallest plane row, so that reads sharing rows run together, measured no
// faster on an H100: PERF.md.) Shared memory: bw sums + ceil(B / 32) mask
// words + B ids + the warps' top-K candidates, 11.3 KB at D652 (B = 1,303,
// bw = 1,408, K = 7) next to the 8 KB of staged row offsets; a listed
// branch's score is computed again from its sum where the finish needs it,
// so B reaches about 28,000. Bound on the H100: the distinct plane rows a
// batch reads, the row ids, m and the pack (no (R, bw) write).

#include <cuda_runtime.h>

#include <cstdint>

#include "finish_row.cuh"

namespace {

constexpr int kTileW = 1024;  // row offsets staged per shared-memory tile

// Thread c of the block adds float4 column c (c < bw4) of the read's rows in
// window order; `off` is the block's shared tile of row offsets. Returns the
// sum (zero for c >= bw4). Every thread of the block must call it.
__device__ __forceinline__ float4 gather_column(const float4* __restrict__ plane,
                                                const int32_t* __restrict__ rrow,
                                                int W, int bw4, int c,
                                                long long* off) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w0 = 0; w0 < W; w0 += kTileW) {
    const int nw = min(kTileW, W - w0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      off[i] = static_cast<long long>(rrow[w0 + i]) * bw4;
    }
    __syncthreads();
    if (c < bw4) {
#pragma unroll 8
      for (int i = 0; i < nw; ++i) {
        const float4 v = __ldg(plane + off[i] + c);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
  }
  return acc;
}

__global__ void rowgather_sum_kernel(const float4* __restrict__ plane,
                                     const int32_t* __restrict__ rows,
                                     float4* __restrict__ out, int W, int bw4) {
  __shared__ long long off[kTileW];
  const long long r = blockIdx.x;
  const int32_t* rrow = rows + r * W;
  for (int c0 = 0; c0 < bw4; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const float4 acc = gather_column(plane, rrow, W, bw4, c, off);
    if (c < bw4) out[r * bw4 + c] = acc;
  }
}

__global__ void rowgather_sum_topk_kernel(
    const float4* __restrict__ plane, const int32_t* __restrict__ rows,
    const float* __restrict__ m, const int32_t* __restrict__ slot,
    const float* __restrict__ delta, float* __restrict__ out, int W, int bw4, int B,
    int K, float kf, float log_eps) {
  // bw sums | mask words | ids (B) | candidates
  extern __shared__ float4 sums4[];
  __shared__ long long off[kTileW];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int nwords = (B + 31) >> 5;
  float* sums = reinterpret_cast<float*>(sums4);
  unsigned* mask = reinterpret_cast<unsigned*>(sums + 4 * bw4);
  int* ids = reinterpret_cast<int*>(mask + nwords);
  float* cand_v = reinterpret_cast<float*>(ids + B);
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  const long long r = blockIdx.x;
  const int32_t* rrow = rows + r * W;
  for (int c0 = 0; c0 < bw4; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const float4 acc = gather_column(plane, rrow, W, bw4, c, off);
    if (c < bw4) sums4[c] = acc;
  }
  const int a = slot != nullptr ? slot[r] : -1;
  if (a >= 0) {  // the ambiguous first-hit delta row of this read
    __syncthreads();
    const float* drow = delta + static_cast<long long>(a) * B;
    for (int b = threadIdx.x; b < B; b += blockDim.x) sums[b] = __fadd_rn(sums[b], drow[b]);
  }
  __syncthreads();
  epik::build_mask([sums](int b) { return sums[b] > 0.f; }, B, mask);
  const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
  const float mr = m[r];
  epik::finish_list(
      [sums, ids, mr, kf, log_eps](int i) {
        return epik::correct(sums[ids[i]], mr, kf, log_eps);
      },
      ids, n, B, K, mr, kf, log_eps, scratch, out + r * (2LL * K + 3));
}

// Threads of a block: one per float4 column up to 1,024, else 512 looping
// over the columns; whole warps (the finish's shuffles and ballots need them).
int gather_threads(int bw4) {
  const int t = bw4 <= 1024 ? bw4 : 512;
  return (t + 31) / 32 * 32;
}

}  // namespace

// plane: f32 (n_rows, bw), bw % 4 == 0, 16-byte aligned; rows: int32 (R, W);
// out: f32 (R, bw). Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_rowgather_sum(const void* plane, const void* rows,
                                  void* out, int R, int W, int bw,
                                  void* stream) {
  const int bw4 = bw / 4;
  if (R > 0 && bw4 > 0) {
    rowgather_sum_kernel<<<R, gather_threads(bw4), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(plane), static_cast<const int32_t*>(rows),
        static_cast<float4*>(out), W, bw4);
  }
  return static_cast<int>(cudaGetLastError());
}

// plane: f32 (n_rows, bw), bw % 4 == 0, 16-byte aligned; rows: int32 (R, W);
// m: f32 (R,) window counts; slot: int32 (R,), the read's row of `delta` or -1, or null; delta:
// f32 (A, B); out: f32 (R, 2K+3). B <= bw, 1 <= K <= min(64, B). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int epik_rowgather_sum_topk(const void* plane, const void* rows,
                                       const void* m, const void* slot,
                                       const void* delta,
                                       void* out, int R, int W, int bw, int B,
                                       int K, int k, float log_eps, void* stream) {
  const int bw4 = bw / 4;
  const int threads = gather_threads(bw4);
  const size_t smem = static_cast<size_t>(bw) * sizeof(float) +
                      (static_cast<size_t>((B + 31) / 32) + B) * sizeof(int) +
                      epik::cand_bytes(threads, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowgather_sum_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (R > 0 && bw4 > 0) {
    rowgather_sum_topk_kernel<<<R, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(plane), static_cast<const int32_t*>(rows),
        static_cast<const float*>(m),
        static_cast<const int32_t*>(slot), static_cast<const float*>(delta),
        static_cast<float*>(out), W, bw4, B, K, static_cast<float>(k), log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* epik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
