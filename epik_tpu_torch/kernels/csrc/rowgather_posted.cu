// The gather 1d over a shifted f32 plane's posted cells: Sp[r] = sum_w
// plane[rows[r, w]], read from a row-compressed copy of the plane's non-zero
// cells instead of its rows.
//
// Where a shifted plane is wide and sparse (a genome-scale tree: 21,248
// columns, ~12 of a row's cells posted, 0.056%), 1d (rowgather_sum.cu's slice
// layout) moves a whole 85 KB row for every window, ~1,500 bytes for each
// byte that changes a sum. A shifted cell is above zero where the key has a
// posting and exactly 0 where it has none, so a sum over the posted cells
// alone, added in window order from +0, has the bits of 1d's: x + 0.0 == x
// for every x >= 0, and a row's posted columns are distinct, so the adds of
// one window to one read never meet on a column.
//
// The index (engine/state.py::build_posted, read back from the finished
// plane): int64 off (n_rows + 1), a row's cells in [off[row], off[row + 1]),
// the all-zero row's range empty; int2 cells (nnz), (column, f32 value bits),
// a row's in column order.
//
// One block a read (kPostedThreads threads): the read's bw f32 sums in
// dynamic shared memory, zeroed; its windows a tile of kPostedThreads at a
// time (one row id a thread, its range's start and length, a block scan of
// the lengths); the tile's cells, in window order, kPostedCells at a time:
// each thread loads kPerThread consecutive ones into registers (all its loads
// in flight at once), the block sorts them by column with a stable radix sort
// (cub::BlockRadixSort over the column's 16 bits), so each column's cells
// stay in window order, and the first thread of each column's run adds the
// run to its sum in that order, one __fadd_rn each (no FMA, no atomics; a
// run's columns are its own, so no two threads meet); last, the whole row out
// with 16-byte stores. No read order: each read's cells are read once, so
// there is nothing for an order to share.
// Bound on the H100: the read's cells (8 bytes each, ~1,700 a 150 bp read at
// ~12 a key) and its bw sums written, 4 bytes each; at wol10k's 2,000 x 141
// windows and 21,248 columns ~27 MB of cells and 170 MB of sums: 0.059 ms.
// On an H100 (kernel_sweep.py --only posted, the wol10k cell's shapes) the
// first design, one warp adding the staged cells window after window (a
// __syncwarp between windows), took 0.24 ms against 1d's 7.7: its adds, a
// chain of ~141 windows a read with two blocks an SM, were half of it (0.12
// ms; the write-out 0.05, the staging 0.025, the rest 0.03). In one later
// call the sort took 0.190 ms against that design's 0.306 and 1d's 7.0;
// tiles of 1,024 cells 0.176 against 2,048's 0.190 (4,096: 0.339, one block
// an SM), 128 and 512 threads 0.306 and 0.206.
// Shared memory: bw sums + the sorted tile + the window tile's starts and
// scan (posted_smem), and the sort's own; 2 blocks an SM at 21,248 columns;
// the widest plane a block takes is epik_rowgather_posted_smem_limit's, and
// the columns' ids must fit the sort's 16 bits.
//
// With the finish fused in (rowgather_posted_topk_kernel, the placement's
// slim pack row out, not the sums): where the two kernels ran apart, the
// gather wrote each read's 85 KB of sums (170 MB a 2,000-read batch at
// wol10k's shapes, 0.051 of its 0.060 ms bound) and finish_topk read them
// back (its whole bound), to find ~1-2 thousand touched branches of 21,149
// and the top 7. Here the block keeps its sums after the last tile and
// finishes the read from them with finish_row.cuh's math:
// * the touched bits: set by the gather itself (a shared atomicOr for each
//   column's run: a sum is above zero exactly where a posted cell was added),
//   so no pass over the B sums; an ambiguous read's delta row is added in one
//   (one __fadd_rn a branch, Sp[:B] + delta as the pair adds it, a warp ballot
//   a word of 32 branches: the bits anew);
// * the touched list: its ids in ascending order (compact_mask) over the
//   staging, and each one's corrected score moved down over the first n sums
//   (a chunk of a block at a time), so the finish reads contiguous scores;
// * finish_list over it: max, exp-sum over all B branches, top-K with ties to
//   the lowest id, the slots past n.
// A read with more touched branches than the ids the staging holds (5,410 at
// K = 7) is finished by one warp walking its B bits instead (warp_finish, as
// the group layout finishes its reads): slower, but no read is dropped. Its
// shared memory: the bw sums + the B touched bits + the gather's staging,
// over which the finish lays its candidates and list (posted_topk_smem), 2
// blocks an SM at 21,248 columns, as the gather alone. The bound: the
// gather's less the sums written, the pack written instead. On an H100 at
// the wol10k cell's shapes (a one-off timing of the kernel stopped after each
// phase, CUDA events): the gather alone 0.134 ms, the touched list 0.016, the
// max and exp-sum 0.009, the top-K 0.041 (0.199-0.206 in all, against the
// pair's 0.338-0.340); the first design, the bits from a pass over the B sums that
// corrected each touched one there and the finish walking the bits for every
// read, took 0.347: the pass 0.068, the top-K rounds over the bits 0.114.
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include <cstdint>

#include "finish_row.cuh"
#include "slot_map.cuh"

// The block: threads (one window of the tile a thread), cells a tile, and the
// blocks an SM the register budget names. The macros let kernel_sweep.py
// build other blocks.
#ifndef EPIK_POSTED_THREADS
#define EPIK_POSTED_THREADS 256
#endif
#ifndef EPIK_POSTED_CELLS
#define EPIK_POSTED_CELLS 1024
#endif
#ifndef EPIK_POSTED_MIN_BLOCKS
#define EPIK_POSTED_MIN_BLOCKS 2
#endif

namespace {

constexpr int kPostedThreads = EPIK_POSTED_THREADS;
constexpr int kPostedCells = EPIK_POSTED_CELLS;
// a tile's cells a thread, consecutive ones, all loads of them in flight
constexpr int kPerThread = kPostedCells / kPostedThreads;
static_assert(kPerThread * kPostedThreads == kPostedCells, "whole cells a thread");
// the sort's key bits: a column id below 2^16 (the largest key pads a tile)
constexpr int kColumnBits = 16;
constexpr unsigned kPadKey = (1u << kColumnBits) - 1;

// a block's warps
constexpr int kPostedWarps = kPostedThreads / 32;

// The bytes past the bw sums the gather stages its tiles in: the tile's
// sorted cells | the window tile's starts (int64) | its scan (one past it).
constexpr size_t kStagingBytes = kPostedCells * sizeof(int2) + kPostedThreads * sizeof(long long) +
                                 (kPostedThreads + 1) * sizeof(int);

// Dynamic shared memory of a block at width bw: the bw sums | the staging.
size_t posted_smem(int bw) { return static_cast<size_t>(bw) * sizeof(float) + kStagingBytes; }

// With the finish fused in: the bw sums | the touched bits, B of them in whole
// 8-byte pairs of words | the staging, the finish's top-K candidates and the
// touched list's 16-bit ids laid over it after the last tile.
__host__ __device__ inline int mask_words(int B) { return (B + 63) / 64 * 2; }
size_t posted_topk_smem(int bw, int B) {
  return static_cast<size_t>(bw) * sizeof(float) + mask_words(B) * sizeof(unsigned) +
         kStagingBytes;
}
static_assert(kPostedWarps * 64 * (sizeof(float) + sizeof(int)) < kStagingBytes,
              "the top-K candidates at K = 64 within the staging");
// The touched list's ids the staging holds beside the candidates.
int id_cap(int K) {
  return static_cast<int>((kStagingBytes - epik::cand_bytes(kPostedThreads, K)) /
                          sizeof(uint16_t));
}

using Scan = cub::BlockScan<int, kPostedThreads>;
using Sort = cub::BlockRadixSort<unsigned, kPostedThreads, kPerThread, int>;

// A block's static shared memory: the scan's and the sort's, and after the
// last tile the finish's reductions, one over the other.
union PostedTemp {
  typename Scan::TempStorage scan;
  typename Sort::TempStorage sort;
  struct {
    float red_f[32];
    int red_i[32];
  } finish;
};

// The last window w of the tile with pos[w] <= g (pos[0] == 0 <= g < pos[nw]):
// the window that holds the tile's cell g (an empty window never does).
__device__ __forceinline__ int window_of(const int* pos, int nw, int g) {
  int lo = 0, hi = nw;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pos[mid] <= g) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The block's read, its W plane rows at `my`: the dynamic shared memory's
// first bw floats = the adds of its windows' posted cells, in window order for
// each column, into zeros, the tiles staged at `stage` (kStagingBytes). With
// kMask, bit b < B of `mask` (its ceil(B / 32) words zeroed first) is set
// where a cell was added to sum b: where the sum is above zero, a posted cell
// being; returns the bits the calling thread set first (0 without kMask).
// Ends synchronised after its last tile (with no window, not at all: each
// thread zeroed its own sums and words).
template <bool kMask>
__device__ __forceinline__ int gather_read(const long long* __restrict__ off,
                                            const int2* __restrict__ cells,
                                            const int32_t* __restrict__ my, int W, int bw,
                                            float4* smem4, void* stage, unsigned* mask, int B,
                                            PostedTemp& tmp) {
  float* S = reinterpret_cast<float*>(smem4);
  int2* staged = reinterpret_cast<int2*>(stage);
  long long* start = reinterpret_cast<long long*>(staged + kPostedCells);
  int* pos = reinterpret_cast<int*>(start + kPostedThreads);
  const int t = threadIdx.x;
  const int n4 = bw >> 2;
  for (int i = t; i < n4; i += kPostedThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int fresh = 0;
  if constexpr (kMask) {
    for (int i = t; i < (B + 31) >> 5; i += kPostedThreads) mask[i] = 0u;
  }
  for (int w0 = 0; w0 < W; w0 += kPostedThreads) {
    const int nw = min(kPostedThreads, W - w0);
    long long st = 0;
    int len = 0;
    if (t < nw) {
      const int row = my[w0 + t];
      st = off[row];
      len = static_cast<int>(off[row + 1] - st);
    }
    int p, total;
    Scan(tmp.scan).ExclusiveSum(len, p, total);
    start[t] = st;
    pos[t] = p;
    if (t == 0) pos[kPostedThreads] = total;  // so pos[nw] == total
    __syncthreads();  // also: the zeroed sums, before the first add
    for (int c0 = 0; c0 < total; c0 += kPostedCells) {
      const int n = min(kPostedCells, total - c0);
      // this thread's cells, [f0, f0 + kPerThread) of the tile, in window order
      const int f0 = t * kPerThread;
      unsigned key[kPerThread];
      int val[kPerThread];
      int w = f0 < n ? window_of(pos, nw, c0 + f0) : 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int g = c0 + f0 + j;
        key[j] = kPadKey;
        val[j] = 0;
        if (f0 + j < n) {
          while (pos[w + 1] <= g) ++w;
          const int2 c = __ldg(cells + start[w] + (g - pos[w]));
          key[j] = static_cast<unsigned>(c.x);
          val[j] = c.y;
        }
      }
      // stable: a column's cells keep their window order
      Sort(tmp.sort).Sort(key, val, 0, kColumnBits);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        staged[f0 + j] = make_int2(static_cast<int>(key[j]), val[j]);
      }
      __syncthreads();
      // the first cell of each column's run adds the run, in its order
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = f0 + j;
        const int col = static_cast<int>(key[j]);
        if (i < n && (i == 0 || staged[i - 1].x != col)) {
          float acc = S[col];
          for (int r = i; r < n && staged[r].x == col; ++r) {
            acc = __fadd_rn(acc, __int_as_float(staged[r].y));
          }
          S[col] = acc;
          if constexpr (kMask) {
            const unsigned bit = 1u << (col & 31);
            if (col < B && (atomicOr(mask + (col >> 5), bit) & bit) == 0u) ++fresh;
          }
        }
      }
      __syncthreads();  // the tile is added before the next one is staged
    }
    // the scan's storage and the tile's starts are reused by the next tile
    __syncthreads();
  }
  return fresh;
}

// Block r sums read r: out[r] = the adds of its windows' posted cells, in
// window order for each column, into zeros.
__global__ void __launch_bounds__(kPostedThreads, EPIK_POSTED_MIN_BLOCKS)
    rowgather_posted_kernel(const long long* __restrict__ off, const int2* __restrict__ cells,
                            const int32_t* __restrict__ rows, float* __restrict__ out, int W,
                            int bw) {
  __shared__ PostedTemp tmp;
  extern __shared__ float4 posted_smem4[];
  gather_read<false>(off, cells, rows + static_cast<long long>(blockIdx.x) * W, W, bw,
                     posted_smem4, reinterpret_cast<float*>(posted_smem4) + bw, nullptr, 0,
                     tmp);
  float4* o = reinterpret_cast<float4*>(out + static_cast<long long>(blockIdx.x) * bw);
  for (int i = threadIdx.x; i < (bw >> 2); i += kPostedThreads) o[i] = posted_smem4[i];
}

// Block r places read r: its sums as rowgather_posted_kernel gathers them,
// its delta row added where slot[r] >= 0, and the finish of finish_topk over
// the first B into the slim pack row out[r] [scores K | idx K | log_sum | n |
// zero_sum].
__global__ void __launch_bounds__(kPostedThreads, EPIK_POSTED_MIN_BLOCKS)
    rowgather_posted_topk_kernel(const long long* __restrict__ off,
                                 const int2* __restrict__ cells,
                                 const int32_t* __restrict__ rows, const float* __restrict__ m,
                                 const int32_t* __restrict__ slot,
                                 const float* __restrict__ delta, float* __restrict__ out, int W,
                                 int bw, int B, int K, int cap, float kf, float log_eps) {
  __shared__ PostedTemp tmp;
  extern __shared__ float4 posted_smem4[];
  const long long r = blockIdx.x;
  // the bw sums | the touched bits | the staging, then the finish's top-K
  // candidates and the touched list's ids laid over it
  float* S = reinterpret_cast<float*>(posted_smem4);
  const int nwords = (B + 31) >> 5;
  unsigned* mask = reinterpret_cast<unsigned*>(S + bw);
  float* stage = reinterpret_cast<float*>(mask + mask_words(B));
  // the bits this thread set first: n, summed over the block
  int cnt = gather_read<true>(off, cells, rows + r * W, W, bw, posted_smem4, stage, mask, B,
                              tmp);
  __syncthreads();  // every sum added and its bit set (with no window: zeroed)

  const float mr = m[r];
  const int a = slot != nullptr ? slot[r] : -1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (a >= 0) {  // the delta row added: its branches' bits anew, a warp a word
    const float* drow = delta + static_cast<long long>(a) * B;
    cnt = 0;
    for (int w = warp; w < nwords; w += kPostedWarps) {
      const int b = w * 32 + lane;
      bool hit = false;
      if (b < B) {
        const float v = __fadd_rn(S[b], drow[b]);
        S[b] = v;
        hit = v > 0.f;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) {
        mask[w] = bal;
        cnt += __popc(bal);
      }
    }
  }
  int n;
  epik::block_exclusive_scan(cnt, tmp.finish.red_i, n);  // its barriers: the mask is whole

  // ---- the touched list: its ids after the candidates; its corrected scores
  // over the first n sums, moved down a chunk of a block at a time (entry j's
  // branch is at or past j, so a chunk's moves never reach a sum a later chunk
  // reads) -------------------------------------------------------------------------
  float* cand_v = stage;
  uint16_t* ids = reinterpret_cast<uint16_t*>(cand_v + 2 * kPostedWarps * K);
  const epik::FinishScratch scratch{tmp.finish.red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v + kPostedWarps * K)};
  const auto row = epik::SlimRow{out + r * (2LL * K + 3), K};
  if (n <= cap) {
    epik::compact_mask(mask, nwords, ids, tmp.finish.red_i, false);
    for (int c0 = 0; c0 < n; c0 += kPostedThreads) {
      const int i = c0 + threadIdx.x;
      const float v = i < n ? S[ids[i]] : 0.f;
      __syncthreads();  // the chunk's sums are read before any is overwritten
      if (i < n) S[i] = epik::correct(v, mr, kf, log_eps);
    }
    __syncthreads();
    epik::finish_list([S](int i) { return S[i]; }, ids, n, B, K, mr, kf, log_eps, scratch, row);
  } else if (warp == 0) {  // more touched branches than ids fit: one warp walks the bits
    epik::warp_finish(
        [mask](int b) { return ((mask[b >> 5] >> (b & 31)) & 1u) != 0u; },
        [S, mr, kf, log_eps](int b) { return epik::correct(S[b], mr, kf, log_eps); }, B, K, mr,
        kf, log_eps, row);
  }
}

// Bytes a block of `fn` may take beside its static shared memory on the
// current device: the opt-in limit less the static bytes. Negative: minus a
// CUDA error code.
long long smem_limit(const void* fn) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, fn) != cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// Blocks of `fn` an SM holds with `smem` bytes of dynamic shared memory, as
// the card's occupancy calculator gives them for the compiled kernel.
// Negative: minus a CUDA error code.
int blocks_per_sm(const void* fn, size_t smem) {
  int blocks = 0;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kPostedThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const void* const kGather = reinterpret_cast<const void*>(rowgather_posted_kernel);
const void* const kGatherTopk = reinterpret_cast<const void*>(rowgather_posted_topk_kernel);

}  // namespace

// off: int64 (n_rows + 1) and cells: int2 (nnz) (column, f32 bits), the
// plane's posted cells row by row; rows: int32 (R, W) plane rows, each in
// [0, n_rows); out: f32 (R, bw), bw % 4 == 0, bw <= 2^16. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a width
// not a multiple of 4 or past the sort's 16 bits, an invalid configuration
// error past the shared memory a block may take).
extern "C" int epik_rowgather_sum_posted(const void* off, const void* cells, const void* rows,
                                         void* out, int R, int W, int bw, void* stream) {
  if (bw <= 0 || bw % 4 != 0 || bw > (1 << kColumnBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = posted_smem(bw);
  const cudaError_t err = cudaFuncSetAttribute(
      rowgather_posted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0) {
    rowgather_posted_kernel<<<R, kPostedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(off), static_cast<const int2*>(cells),
        static_cast<const int32_t*>(rows), static_cast<float*>(out), W, bw);
  }
  return static_cast<int>(cudaGetLastError());
}

// off, cells, rows: as for epik_rowgather_sum_posted; m: f32 (R,) window
// counts; amb: the A reads with a delta row (distinct ids, int64 where amb64,
// else int32), or null where A == 0; slot: int32 (R,) scratch, which the
// launch fills with each read's row of `delta` or -1 (on `stream`, before the
// kernel); delta: f32 (A, B); out: f32 (R, 2K+3), read r's slim pack row.
// bw % 4 == 0, bw <= 2^16, 1 <= B <= bw, 1 <= K <= min(64, B), and
// epik_rowgather_posted_topk_smem(bw, B) <=
// epik_rowgather_posted_topk_smem_limit(). Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for the shapes it does not take).
extern "C" int epik_rowgather_sum_posted_topk(const void* off, const void* cells,
                                              const void* rows, const void* m, const void* amb,
                                              int amb64, int A, void* slot, const void* delta,
                                              void* out, int R, int W, int bw, int B, int K, int k,
                                              float log_eps, void* stream) {
  if (bw <= 0 || bw % 4 != 0 || bw > (1 << kColumnBits) || B < 1 || B > bw || K < 1 ||
      K > B || K > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const void* map = nullptr;
  if (const int err = map_slots(amb, amb64, A, slot, R, s, &map)) return err;
  const size_t smem = posted_topk_smem(bw, B);
  const cudaError_t err = cudaFuncSetAttribute(
      rowgather_posted_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0) {
    rowgather_posted_topk_kernel<<<R, kPostedThreads, smem, s>>>(
        static_cast<const long long*>(off), static_cast<const int2*>(cells),
        static_cast<const int32_t*>(rows), static_cast<const float*>(m),
        static_cast<const int32_t*>(map), static_cast<const float*>(delta),
        static_cast<float*>(out), W, bw, B, K, id_cap(K), static_cast<float>(k), log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a launch at width bw asks.
extern "C" long long epik_rowgather_posted_smem(int bw) {
  return static_cast<long long>(posted_smem(bw));
}

// The same with the finish fused in, at (bw, B).
extern "C" long long epik_rowgather_posted_topk_smem(int bw, int B) {
  return static_cast<long long>(posted_topk_smem(bw, B));
}

// Bytes of dynamic shared memory a block may take on the current device: the
// opt-in limit less the kernel's static shared memory. Negative: minus a CUDA
// error code.
extern "C" long long epik_rowgather_posted_smem_limit() { return smem_limit(kGather); }

extern "C" long long epik_rowgather_posted_topk_smem_limit() { return smem_limit(kGatherTopk); }

// Blocks an SM holds at width bw, as the card's occupancy calculator gives
// them for the compiled kernel. Negative: minus a CUDA error code.
extern "C" int epik_rowgather_posted_blocks_per_sm(int bw) {
  return blocks_per_sm(kGather, posted_smem(bw));
}

extern "C" int epik_rowgather_posted_topk_blocks_per_sm(int bw, int B) {
  return blocks_per_sm(kGatherTopk, posted_topk_smem(bw, B));
}
