// Packed posting-tile accumulate fused with the placement finish: for each
// read, the exact integer sums Sq[b] = sum of q over the read's cells
// (branch << 16) | q with that branch, then Sp = Sq / scale and the finish of
// finish_row.cuh into the slim pack [scores K | idx K | log_sum | n | zero_sum].
// A second entry point, epik_accumulate_packed_sums (at the end), writes the
// sums alone; its kernel is described where it is defined.
//
// Replaces the TPU kernel epik_tpu/ops/pallas/accumulate.py::
// segment_accumulate_packed_topk (body `_kernel_packed_topk`), the device step
// of the big-tree posting-tile path (engine/placer.py::_place_batch_tiles_bytes,
// packed payload). On the TPU the sums ran as bf16 digit matmuls over 128-lane
// one-hots, and the finish had a per-lane top-2 fast path; both work around
// the MXU and the VPU and are not carried over.
//
// Bound on the H100: the cells, PP * 4 bytes per read (about 11 KB for a
// 150 bp read at the 10k-taxa widths), read once from HBM, and the pack
// written once. Only the (2K+3)-float pack leaves the block, as on the TPU, so
// the (R, B) score matrix never reaches HBM.
//
// Design (redesigned for the H100 after the first port spent O(B * (K + 3))
// work a read on branches that hold nothing): a read touches at most PP of
// the B branches, so everything after the adds runs over the touched ones.
// * Persistent blocks: as many as fit on the card (the occupancy API); block
//   i places reads i, i + grid, ... Its B int32 sums (B < 2^15, so at most
//   128 KB) are zeroed once; after each read only the touched entries are
//   reset.
// * The adds: every thread walks the read's cells with a stride, 4 cells of
//   it loaded at once into registers (the next read's first 4 while the
//   current one finishes), and adds q with a shared-memory atomicAdd (integer sums do not depend on the order
//   of the adds, so they are exact and the same on every run). Every kept
//   cell has q >= 1, so the add that finds 0 is the branch's first touch: it
//   sets the branch's bit in a bitmask of ceil(B / 32) words. Cells whose
//   branch is >= B (the trash column bw - 1 of the padding) are skipped, as
//   the TPU kernel's `lane < B` mask drops them.
// * One compaction of the bitmask (finish_row.cuh::compact_mask) lists the
//   touched ids in ascending order whatever order the atomics ran in, and
//   clears the mask; Sp = (float)Sq / scale (correctly rounded, like the plain
//   version's f32 divide) and the corrected score are computed once per listed
//   branch and stored over that branch's sum, and finish_row.cuh::finish_list
//   finishes the read from the list.
// Shared memory: B sums + ceil(B / 32) mask words + min(PP, B) 16-bit ids +
// the warps' top-K candidates: 88.6 KB at B = 19,999, PP = 2,816, K = 7, two
// blocks of 256 threads per SM; at most 200 KB for any PP (B < 2^15, K <= 64),
// under the card's 227 KB a block. (A one-off sweep on an H100 at that shape
// read 0.21-0.25 ms for 256 or 512 threads and 4, 8 or 16 cells in flight,
// within the run-to-run spread: the loads no longer bound it.)

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrefetch = 4;  // cells per thread in flight (kernel 2)
constexpr int kSumThreads = 512;

// Kernel 3's adds: zero the B shared-memory sums, then add every cell of the
// row: q at its branch, skipping trash cells (branch >= B) and q == 0. Ends
// synchronised.
__device__ __forceinline__ void add_row_cells(const int32_t* __restrict__ prow,
                                              int PP, int B, int* sq) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) sq[b] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < PP; c += blockDim.x) {
    const uint32_t v = static_cast<uint32_t>(prow[c]);
    const int b = static_cast<int>(v >> 16);
    const int q = static_cast<int>(v & 0xFFFFu);
    if (b < B && q != 0) atomicAdd(&sq[b], q);
  }
  __syncthreads();
}

// Cells c0 + u * blockDim.x + threadIdx.x (u < N) of read r; a cell past the
// row, or a read past R, loads as 0, which add_cells skips (q == 0).
template <int N>
__device__ __forceinline__ void load_cells(int32_t (&cells)[N], const int32_t* __restrict__ p,
                                           long long r, int R, int PP, int c0) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int c = c0 + u * blockDim.x + threadIdx.x;
    cells[u] = r < R && c < PP ? __ldg(p + r * PP + c) : 0;
  }
}

// Add each cell's q at its branch; the add that finds 0 (every kept q >= 1)
// is the branch's first touch and sets its bit in `mask`.
template <int N>
__device__ __forceinline__ void add_cells(const int32_t (&cells)[N], int B, int* sq,
                                          unsigned* mask) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const uint32_t v = static_cast<uint32_t>(cells[u]);
    const int b = static_cast<int>(v >> 16);
    const int q = static_cast<int>(v & 0xFFFFu);
    if (b < B && q != 0 && atomicAdd(&sq[b], q) == 0) atomicOr(&mask[b >> 5], 1u << (b & 31));
  }
}

__global__ void __launch_bounds__(kThreads)
    accumulate_packed_topk_kernel(const int32_t* __restrict__ p, int R, int PP,
                                  const float* __restrict__ m,
                                  float* __restrict__ out,
                                  int32_t* __restrict__ sq_out, int B, int K,
                                  float kf, float log_eps, float scale) {
  // B sums | mask words | ids (cap, 16 bits, padded to 4 bytes) | candidates
  extern __shared__ int smem[];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int nwords = (B + 31) >> 5;
  const int cap = min(PP, B);
  int* sq = smem;
  unsigned* mask = reinterpret_cast<unsigned*>(sq + B);
  uint16_t* ids = reinterpret_cast<uint16_t*>(mask + nwords);
  float* cand_v = reinterpret_cast<float*>(mask + nwords + (cap + 1) / 2);
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  for (int b = threadIdx.x; b < B; b += blockDim.x) sq[b] = 0;
  for (int w = threadIdx.x; w < nwords; w += blockDim.x) mask[w] = 0u;
  // kPrefetch cells per thread in registers: a chunk's loads are all in
  // flight at once, and the next read's first chunk loads during the finish.
  int32_t cells[kPrefetch];
  const int chunk = kPrefetch * blockDim.x;
  load_cells(cells, p, blockIdx.x, R, PP, 0);
  __syncthreads();
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    add_cells(cells, B, sq, mask);  // the first chunk, loaded ahead
    for (int c0 = chunk; c0 < PP; c0 += chunk) {
      load_cells(cells, p, r, R, PP, c0);
      add_cells(cells, B, sq, mask);
    }
    const int n = epik::compact_mask(mask, nwords, ids, red_i, true);
    if (sq_out != nullptr) {  // the integer sums, for checking only
      for (int b = threadIdx.x; b < B; b += blockDim.x) sq_out[r * B + b] = sq[b];
      __syncthreads();
    }
    const float mr = m[r];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {  // the score over the sum
      const int b = ids[i];
      sq[b] = __float_as_int(
          epik::correct(__fdiv_rn(__int2float_rn(sq[b]), scale), mr, kf, log_eps));
    }
    __syncthreads();
    load_cells(cells, p, r + gridDim.x, R, PP, 0);  // in flight during the finish
    epik::finish_list([sq, ids](int i) { return __int_as_float(sq[ids[i]]); }, ids, n, B,
                      K, mr, kf, log_eps, scratch,
                      epik::SlimRow{out + r * (2LL * K + 3), K});
    __syncthreads();  // the finish has read the scores, the list and the scratch
    for (int i = threadIdx.x; i < n; i += blockDim.x) sq[ids[i]] = 0;  // for the next read
    __syncthreads();
  }
}

// The sums alone, for the column-sharded tile step, whose finish merges the
// shards' columns outside the kernel: each read's B integer sums written
// once as f32 (exact, below 2^24). Replaces the TPU kernel
// epik_tpu/ops/pallas/accumulate.py::segment_accumulate_packed (body
// `_kernel_packed_sums`, bf16 digit matmuls over one-hots). Bound on the
// H100 by the (R, B) f32 output it writes to HBM, about 80 KB a read at a
// 20k-branch shard, next to some 10 KB of cells read; 512 threads a block
// speed the zero and write passes over the B sums.
__global__ void __launch_bounds__(kSumThreads)
    accumulate_packed_sums_kernel(const int32_t* __restrict__ p, int PP,
                                  float* __restrict__ out, int B) {
  extern __shared__ int sq[];  // B sums
  const long long r = blockIdx.x;
  add_row_cells(p + r * PP, PP, B, sq);
  float* orow = out + r * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) orow[b] = __int2float_rn(sq[b]);
}

// Opt the kernel in to the launch's dynamic shared memory (always: past 48 KB
// of static and dynamic bytes together a launch needs it).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// p: int32 (R, PP) packed cells; m: f32 (R,) window counts; out: f32
// (R, 2K+3); sq: int32 (R, B) for the integer sums, or null. B < 2^15,
// 1 <= K <= min(64, B): the block's shared memory stays under 200 KB for any
// PP. Launches as many blocks as fit on the card, on `stream`; returns
// cudaGetLastError().
extern "C" int epik_accumulate_packed_topk(const void* p, const void* m,
                                           void* out, void* sq, int R, int PP,
                                           int B, int K, int k, float log_eps,
                                           float scale, void* stream) {
  const int nwords = (B + 31) / 32;
  const size_t smem =
      (static_cast<size_t>(B) + nwords + (static_cast<size_t>(std::min(PP, B)) + 1) / 2) *
          sizeof(int) +
      epik::cand_bytes(kThreads, K);
  cudaError_t err = allow_smem(accumulate_packed_topk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, accumulate_packed_topk_kernel, kThreads, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int grid = std::min(R, std::max(1, per_sm * sms));
    accumulate_packed_topk_kernel<<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(p), R, PP, static_cast<const float*>(m),
        static_cast<float*>(out), static_cast<int32_t*>(sq), B, K,
        static_cast<float>(k), log_eps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// p: int32 (R, PP) packed cells; out: f32 (R, B) exact integer sums of q per
// (read, branch). B < 2^15. Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_accumulate_packed_sums(const void* p, void* out, int R,
                                           int PP, int B, void* stream) {
  const size_t smem = static_cast<size_t>(B) * sizeof(int);
  const cudaError_t err = allow_smem(accumulate_packed_sums_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0) {
    accumulate_packed_sums_kernel<<<R, kSumThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(p), PP, static_cast<float*>(out), B);
  }
  return static_cast<int>(cudaGetLastError());
}
