// The column-sharded placement finish of one model shard, in one launch: each
// model shard of a column-sharded step holds the sums of its own bwl branch
// columns, and the per-shard half of epik_tpu/parallel/sharding.py::
// finish_scores_cols_shifted / finish_scores_cols + _lwr_topk_cols (an XLA
// function there, no Pallas kernel) runs here; the merge of the shards'
// per-read scalars and candidates is torch ops of the caller
// (parallel/sharding.py::_merge_cols).
//
// finish_cols_partial, per shard s and read r, from the shifted sums Sp
// (touched: Sp > 0, the correction finish_row.cuh's correct()) or, in the
// counts form, from the classic sums S and exact counts C (touched: C > 0,
// correct_counts(): m - C wrapped to 2^64 where negative, quirk Q1):
// finish_row.cuh's cols_list over the touched list (ballot and block scan, so
// ascending ids), i.e. the count n_s, the largest corrected score max_s (-inf
// when nothing is touched), the shard's exp-sum against its OWN maximum,
// e_s = sum 10^(corrected - max_s) (0 when nothing is touched), and the top
// Kl = min(K, bwl) candidates by (value desc, local index asc), the slots past
// n_s holding -inf and the lowest untouched columns, as a stable sort gives;
// ids written as global columns (local + col0). Out: f32 (R, 2 Kl + 3) =
// [values Kl | ids Kl | n_s | max_s | e_s], and in the counts form the
// candidates' exact counts as int32 (R, Kl). JAX takes each exp term against
// the merged max_t instead; the merge rescales, sum10 = sum_s e_s *
// 10^(max_s - max_t), which is exactly e_s wherever max_s = max_t, so one
// launch per shard does what took a second pass over the sums before.
//
// Rounding: the corrected score is correct() / correct_counts() (__f*_rn,
// built with -fmad=false), so n_s, max_s, the candidates' values, ids and
// counts are bit-equal to the plain PyTorch version; e_s's order of adds
// differs from torch's reduction (rtol 1e-6).
//
// Bound on the H100: HBM bytes. A launch reads the (R, bwl) sums (and counts)
// once and writes 2 Kl + 3 floats a read. On the dense shards the same finish
// runs in kernel 1's epilogue (rowgather_sum.cu's rowgather_sum_cols), so
// the sums never reach HBM; this launch serves the sharded tile step and the
// dense shards past that kernel's shared-memory limit.
//
// Design: one block per read (past bwl = 2^16, as many blocks as fit on the
// card, each taking reads blockIdx.x, blockIdx.x + gridDim.x, ...). The
// warps read the row once into a bitmask of the touched columns, one
// compaction lists them in ascending order, and each listed column's
// corrected score is computed once, from its sum (and count) read again from
// the row, into a shared-memory cache; finish_row.cuh's cols_list (list max,
// exp-sum, K top-K rounds) then reads the cache. A read with more touched
// columns than the cache holds reads its row each round instead (the same
// scores, so the same bits). Before the cache every pass gathered S[b] (and
// C[b]) and divided again: 9 gathers and divides per touched entry, across
// about a dozen block barriers, 0.63-0.70 ms at D652's (16,384 x 1,408)
// classic sums on an H100 with 512 threads a read.
//
// The block follows the width (cols_layout, the one formula of the layout,
// its bytes and its limit):
// * bwl <= kSmallCols: kSmallThreads (128) threads a read, registers capped
//   at 32 so that 16 blocks fit an SM, and the barriers of a read of ~1,400
//   columns bind 4 warps, not 16 (512 threads with the cache: 0.53-0.69 ms
//   at D652's classic sums);
// * wider: kWideThreads (512) threads, registers capped at 32 so that 4
//   blocks fit an SM: at the wide classic shard (22,272 columns, ~1,550
//   touched a read) a cache of 2,216 scores. Uncapped, ptxas gives the block
//   56-60 registers, 2 blocks an SM and a cache of kCache scores: 3-6%
//   slower there and 26-29% at config 4's sharded tiles (20,096 columns) on
//   an H100 (kernel_sweep.py).
// The blocks an SM are the card's own count for the kernel as compiled
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the bytes less the
// cache), so the cache follows whatever occupancy the registers leave.
// A cache indexed by column and filled in the mask's pass (no gather of the
// touched scores) measured 40% slower at D652's classic sums.
// Shared memory: ceil(bwl / 32) mask words + bwl 16-bit ids (past bwl = 2^16
// the ids go to a global int32 workspace, one row of bwl per block) + the
// warps' candidates + the cache, which takes what is left of the SM's shared
// memory at that occupancy, up to min(bwl, kCache) scores (0 where the rest
// alone fills it). epik_finish_cols_layout gives a launch's layout, its
// bytes and what a block may take.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "finish_row.cuh"

namespace {

#ifndef EPIK_COLS_SMALL
#define EPIK_COLS_SMALL 4096
#endif
#ifndef EPIK_COLS_SMALL_MIN_BLOCKS
#define EPIK_COLS_SMALL_MIN_BLOCKS 16
#endif
#ifndef EPIK_COLS_WIDE_MIN_BLOCKS
#define EPIK_COLS_WIDE_MIN_BLOCKS 4
#endif
constexpr int kSmallCols = EPIK_COLS_SMALL;  // widest shard that takes the small block
constexpr int kSmallThreads = 128;
// the blocks' register caps: 16 blocks of 128 threads, or 4 of 512, an SM
// hold 32 registers a thread (uncapped, 56 registers: 9 and 2 blocks)
constexpr int kSmallMinBlocks = EPIK_COLS_SMALL_MIN_BLOCKS;
constexpr int kWideThreads = 512;
constexpr int kWideMinBlocks = EPIK_COLS_WIDE_MIN_BLOCKS;
constexpr int kCache = 8192;  // corrected scores a block keeps at most (32 KB)
constexpr int kMaxSharedIds = 1 << 16;  // 16-bit ids

// The finish of one read's touched list from its corrected scores in the
// cache when its n columns fit `cache_n` (each corrected once, then read by
// the max, the exp-sum and the K rounds), else from `corr` itself, which
// reads the row again each time. The same scores either way.
template <class Corr, class Id, class Count>
__device__ void cols_read(Corr corr, const Id* ids, int n, float* cache, int cache_n, int K,
                          int col0, epik::FinishScratch s, float* orow, int* crow, Count count) {
  if (n <= cache_n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cache[i] = corr(i);
    __syncthreads();
    epik::cols_list([cache](int i) { return cache[i]; }, ids, n, K, col0, s, orow, crow, count);
  } else {
    epik::cols_list(corr, ids, n, K, col0, s, orow, crow, count);
  }
}

template <bool kGlobal, bool kCounts, int kThreads>
__global__ void __launch_bounds__(kThreads,
                                  kThreads == kSmallThreads ? kSmallMinBlocks : kWideMinBlocks)
    finish_cols_partial_kernel(const float* __restrict__ S, long long ld,
                               const int* __restrict__ C, long long ldc,
                               const float* __restrict__ m, float* __restrict__ out,
                               int* __restrict__ cnt_out, int R, int bwl, int K, int col0,
                               float kf, float log_eps, int* __restrict__ ws, int cache_n) {
  // mask words | ids (bwl, 16 bits, padded to 4 bytes; global: none) |
  // candidates | cache_n corrected scores
  extern __shared__ unsigned mask[];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  using Id = std::conditional_t<kGlobal, int, uint16_t>;
  const int nwords = (bwl + 31) >> 5;
  Id* ids;
  float* cand_v;
  if constexpr (kGlobal) {
    ids = ws + static_cast<long long>(blockIdx.x) * bwl;
    cand_v = reinterpret_cast<float*>(mask + nwords);
  } else {
    ids = reinterpret_cast<uint16_t*>(mask + nwords);
    cand_v = reinterpret_cast<float*>(mask + nwords + (bwl + 1) / 2);
  }
  const int n_cand = (kThreads >> 5) * K;
  const epik::FinishScratch scratch{red_f, cand_v, reinterpret_cast<int*>(cand_v) + n_cand};
  float* cache = cand_v + 2 * n_cand;
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const float* row = S + r * ld;
    const float mr = m[r];
    float* orow = out + r * (2LL * K + 3);
    if constexpr (kCounts) {
      const int* crow = C + r * ldc;
      epik::build_mask([crow](int b) { return __ldg(crow + b) > 0; }, bwl, mask);
      const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
      cols_read(
          [row, crow, ids, mr, kf, log_eps](int i) {
            const int b = static_cast<int>(ids[i]);
            return epik::correct_counts(__ldg(row + b), __ldg(crow + b), mr, kf, log_eps);
          },
          ids, n, cache, cache_n, K, col0, scratch, orow, cnt_out + r * K,
          [crow](int b) { return __ldg(crow + b); });
    } else {
      epik::build_mask([row](int b) { return __ldg(row + b) > 0.f; }, bwl, mask);
      const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
      cols_read(
          [row, ids, mr, kf, log_eps](int i) {
            return epik::correct(__ldg(row + ids[i]), mr, kf, log_eps);
          },
          ids, n, cache, cache_n, K, col0, scratch, orow, nullptr, [](int) { return 0; });
    }
    __syncthreads();  // warp 0 is done with the list, the candidates and the cache
  }
}

// The threads of a block at this width.
int cols_threads(int bwl) { return bwl <= kSmallCols ? kSmallThreads : kWideThreads; }

// The shared memory of a block less its cache: the mask words, the 16-bit
// ids unless they go to the global workspace, and the warps' candidates.
long long fixed_smem(int bwl, int K) {
  const long long ids = bwl > kMaxSharedIds ? 0 : (bwl + 1) / 2;
  return (static_cast<long long>((bwl + 31) / 32) + ids) * static_cast<long long>(sizeof(int)) +
         static_cast<long long>(epik::cand_bytes(cols_threads(bwl), K));
}

// The kernel instance of a launch: the block and the ids' place follow bwl.
template <bool kCounts>
const void* kernel_of(int bwl) {
  if (bwl > kMaxSharedIds) {
    return reinterpret_cast<const void*>(&finish_cols_partial_kernel<true, kCounts, kWideThreads>);
  }
  if (bwl > kSmallCols) {
    return reinterpret_cast<const void*>(
        &finish_cols_partial_kernel<false, kCounts, kWideThreads>);
  }
  return reinterpret_cast<const void*>(&finish_cols_partial_kernel<false, kCounts, kSmallThreads>);
}

// always: the 48 KB a launch may take without opting in count static bytes too
template <bool kCounts>
cudaError_t allow(int bwl, long long smem) {
  return cudaFuncSetAttribute(kernel_of<kCounts>(bwl), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The one formula of a launch's layout at (bwl, K) on the current device:
// the threads from the width; the fixed part; the blocks an SM the card
// gives the kernel with the fixed part alone (its registers and threads
// decide); the cache from what is left of the SM's shared memory at those
// blocks (less the reserved and static bytes of each), within the opt-in
// limit, up to min(bwl, kCache) scores, so the cache keeps that occupancy.
// out: [global ids, threads, cache scores, dynamic shared memory, what a
// block may take (the opt-in limit less the kernel's static bytes), blocks
// an SM (1 where the fixed part is over the limit)].
template <bool kCounts>
cudaError_t cols_layout(int bwl, int K, long long* out) {
  const bool global = bwl > kMaxSharedIds;
  const int threads = cols_threads(bwl);
  int dev = 0, optin = 0, per_sm_smem = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel_of<kCounts>(bwl));
  if (e != cudaSuccess) return e;
  const long long fixed = fixed_smem(bwl, K);
  const long long limit =
      static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  int blocks = 1;
  if (fixed <= limit) {
    e = allow<kCounts>(bwl, fixed);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of<kCounts>(bwl), threads,
                                                        static_cast<size_t>(fixed));
    }
    if (e != cudaSuccess) return e;
    if (blocks < 1) return cudaErrorInvalidValue;
  }
  long long share = static_cast<long long>(per_sm_smem) / blocks - reserved -
                    static_cast<long long>(attr.sharedSizeBytes);
  if (share > limit) share = limit;
  long long cache = (share - fixed) / static_cast<long long>(sizeof(float));
  const long long most = bwl < kCache ? bwl : kCache;
  if (cache > most) cache = most;
  if (cache < 0) cache = 0;
  const long long smem = fixed + cache * static_cast<long long>(sizeof(float));
  const long long outs[6] = {global ? 1 : 0, threads, cache, smem, limit, blocks};
  for (int i = 0; i < 6; ++i) out[i] = outs[i];
  return cudaSuccess;
}

template <bool kCounts>
void launch(int blocks, long long smem, int cache_n, cudaStream_t s, const float* S,
            long long ld, const int* C, long long ldc, const float* m, float* out, int* cnt,
            int R, int bwl, int K, int col0, float kf, float log_eps, int* ws) {
  const auto bytes = static_cast<size_t>(smem);
  if (bwl > kMaxSharedIds) {
    finish_cols_partial_kernel<true, kCounts, kWideThreads><<<blocks, kWideThreads, bytes, s>>>(
        S, ld, C, ldc, m, out, cnt, R, bwl, K, col0, kf, log_eps, ws, cache_n);
  } else if (bwl > kSmallCols) {
    finish_cols_partial_kernel<false, kCounts, kWideThreads><<<blocks, kWideThreads, bytes, s>>>(
        S, ld, C, ldc, m, out, cnt, R, bwl, K, col0, kf, log_eps, nullptr, cache_n);
  } else {
    finish_cols_partial_kernel<false, kCounts, kSmallThreads>
        <<<blocks, kSmallThreads, bytes, s>>>(S, ld, C, ldc, m, out, cnt, R, bwl, K, col0, kf,
                                              log_eps, nullptr, cache_n);
  }
}

}  // namespace

// The layout of finish_cols_partial (`counts`: the counts form) at (bwl, K)
// on the current device, into out[6] (cols_layout's). The caller checks the
// shared memory against the limit before it launches, and sizes the global
// workspace (global ids: min(R, out[5] x the SMs) blocks of bwl int32 ids).
// Returns a CUDA error code.
extern "C" int epik_finish_cols_layout(int bwl, int K, int counts, long long* out) {
  return static_cast<int>(counts ? cols_layout<true>(bwl, K, out)
                                 : cols_layout<false>(bwl, K, out));
}

// S: f32 rows of stride `ld` floats, bwl used columns (the shifted sums, or
// the classic sums with C); C: int32 rows of stride `ldc` (the exact counts:
// the counts form), or null (the shifted form); m: f32 (R,) window counts;
// out: f32 (R, 2K+3); cnt: int32 (R, K), the counts form's candidate counts
// (null otherwise); 1 <= K <= min(64, bwl); col0: the shard's first global
// column; cache_n and smem from epik_finish_cols_layout (smem within its
// limit); ws: with global ids (bwl > 2^16) an int32 workspace of `blocks`
// rows of bwl ids, else null; blocks: R, or with global ids at most the
// layout's out[5] x the SMs. Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_finish_cols_partial(const void* S, long long ld, const void* C,
                                        long long ldc, const void* m, void* out, void* cnt,
                                        int R, int bwl, int K, int col0, int k, float log_eps,
                                        void* ws, int blocks, int cache_n, long long smem,
                                        void* stream) {
  const bool counts = C != nullptr;
  if ((bwl > kMaxSharedIds) != (ws != nullptr) || counts != (cnt != nullptr) || cache_n < 0 ||
      smem < fixed_smem(bwl, K) + static_cast<long long>(cache_n) * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = counts ? allow<true>(bwl, smem) : allow<false>(bwl, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && blocks > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* sp = static_cast<const float*>(S);
    const auto* mp = static_cast<const float*>(m);
    auto* op = static_cast<float*>(out);
    auto* wp = static_cast<int*>(ws);
    const float kf = static_cast<float>(k);
    if (counts) {
      launch<true>(blocks, smem, cache_n, s, sp, ld, static_cast<const int*>(C), ldc, mp, op,
                   static_cast<int*>(cnt), R, bwl, K, col0, kf, log_eps, wp);
    } else {
      launch<false>(blocks, smem, cache_n, s, sp, ld, nullptr, 0, mp, op, nullptr, R, bwl, K,
                    col0, kf, log_eps, wp);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
