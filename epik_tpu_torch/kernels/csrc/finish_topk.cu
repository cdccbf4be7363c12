// Placement finish over a score matrix in device memory: score correction,
// LWR log-sum over all branches and top-K, written straight into the result
// pack. Two forms of one kernel (a template flag):
//
// * over the shifted sums Sp alone (touched = Sp > 0), into the slim pack
//   [scores K | idx K | log_sum | n | zero_sum]: replaces the finish epilogue
//   of the TPU kernel epik_tpu/ops/pallas/accumulate.py::
//   segment_accumulate_packed_topk (the last grid step of
//   `_kernel_packed_topk`), on the f32-payload tile path after the segment
//   sums (epik_tpu/engine/placer.py::finish_scores_shifted + _lwr_topk +
//   _pack_outputs_slim), and on the dense steps past the fused row gather's
//   shared-memory limit (rowgather_sum.cu);
// * the counts finish (epik_finish_topk_counts): over the sums S and the
//   exact counts C (touched = C > 0, the count-aware correction of
//   placer.py::finish_scores, quirk Q1), into the full pack's body [scores K |
//   wr K | idx K | counts K | n | zero_sum] (_pack_outputs; the CSR step and
//   the classic dense steps past rowgather_sum_counts_topk's limit) or the
//   slim pack (_pack_outputs_slim; the hash-sharded CSR steps). On the TPU
//   this finish is XLA's, after #5 (segment_accumulate) or the classic dense
//   sums.
//
// The math, the tie rule and the rounding rules are those of finish_row.cuh.
//
// Bound on the H100: HBM bytes, one read of the (R, B) score matrix (and of
// the counts), B * 4 (or 8) bytes per read (80 KB, 160 KB at B = 19,999), and
// the pack written once.
//
// Design: one block of 512 threads per read. The warps read the row once,
// coalesced, 8 words of 32 branches in flight per lane, into a bitmask of the
// touched branches (a ballot of Sp > 0, or of C > 0: a classic sum can be
// negative); one compaction lists the touched ids in ascending order; each
// listed branch's corrected score is computed once, from its sum (and
// count) read again from the row, into shared memory, and the finish runs
// over that list (finish_row.cuh): its max, exp-sum and K top-K rounds read
// the scores there. (Without that cache every round read the row again: at
// the 400 bp CSR batch's ~4,000 touched branches a read, the rows of the
// blocks in flight outgrow the L2, and the rounds cost 1.84 ms at (4,096 x
// 19,999) on an H100.) A read with more than kCache touched branches reads
// its row each round instead. Shared memory: ceil(B / 32) mask words + B
// 16-bit ids + the warps' top-K candidates + min(B, kCache) scores, about
// 75.4 KB at B = 19,999: three blocks per SM. (Before the cache, 512 threads
// with 4 or 8 loads in flight per lane measured 0.302 ms at the f32 tile
// path's (4,096 x 19,999); 256 threads 0.31-0.53 ms and 1,024 threads
// 0.35-0.49 ms, by a one-off sweep on an H100.)
//
// Past B = 2^16 the ids do not fit 16 bits, nor B of them in shared memory:
// the list goes to a global-memory workspace of int32 ids, one row of B per
// block, sized per launch (epik_finish_topk_layout gives the blocks: as many
// as fit on the card at once, each finishing reads blockIdx.x, blockIdx.x +
// gridDim.x, ...). Only the mask, the candidates and the score cache stay in
// shared memory, which bounds B near 1.5 million. The list and its order are the same in both
// layouts, so are the output bits.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSharedIds = 1 << 16;  // 16-bit ids
constexpr int kCache = 8192;  // corrected scores a block keeps (32 KB)

// The variants of the kernel (the C entry points' `variant` codes): the
// shifted sums into the slim pack; the sums and counts into the slim pack; the
// sums and counts into the full pack's body.
enum Variant { kSumsSlim = 0, kCountsSlim = 1, kCountsFull = 2 };

// The list finish of one read, from its corrected scores held in shared
// memory (`cache`, when the n touched branches fit its `cache_n` entries:
// each corrected once, then read by the max, the exp-sum and the K top-K
// rounds), else from `corr` itself, which reads the read's row again each
// time. The same scores either way, so the same bits.
template <class Corr, class Id, class Row>
__device__ void finish_read(Corr corr, const Id* ids, int n, float* cache, int cache_n, int B,
                            int K, float mr, float kf, float log_eps, epik::FinishScratch s,
                            Row out) {
  if (n <= cache_n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cache[i] = corr(i);
    __syncthreads();
    epik::finish_list([cache](int i) { return cache[i]; }, ids, n, B, K, mr, kf, log_eps, s,
                      out);
  } else {
    epik::finish_list(corr, ids, n, B, K, mr, kf, log_eps, s, out);
  }
}

template <bool kGlobal, int kVariant>
__global__ void __launch_bounds__(kThreads)
    finish_topk_kernel(const float* __restrict__ Sp, long long ld,
                       const int* __restrict__ C, long long ldc,
                       const float* __restrict__ m, float* __restrict__ out, int R,
                       int B, int K, float kf, float log_eps, int* __restrict__ ws) {
  // mask words | ids (B, 16 bits, padded to 4 bytes; global: none) |
  // candidates | min(B, kCache) corrected scores
  extern __shared__ unsigned mask[];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  using Id = std::conditional_t<kGlobal, int, uint16_t>;
  const int nwords = (B + 31) >> 5;
  Id* ids;
  float* cand_v;
  if constexpr (kGlobal) {
    ids = ws + static_cast<long long>(blockIdx.x) * B;
    cand_v = reinterpret_cast<float*>(mask + nwords);
  } else {
    ids = reinterpret_cast<uint16_t*>(mask + nwords);
    cand_v = reinterpret_cast<float*>(mask + nwords + (B + 1) / 2);
  }
  const int n_cand = (blockDim.x >> 5) * K;
  const epik::FinishScratch scratch{red_f, cand_v, reinterpret_cast<int*>(cand_v) + n_cand};
  float* cache = cand_v + 2 * n_cand;
  const int cache_n = min(B, kCache);
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const float* row = Sp + r * ld;
    const float mr = m[r];
    if constexpr (kVariant == kSumsSlim) {
      epik::build_mask([row](int b) { return __ldg(row + b) > 0.f; }, B, mask);
      const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
      finish_read(
          [row, ids, mr, kf, log_eps](int i) {
            return epik::correct(__ldg(row + ids[i]), mr, kf, log_eps);
          },
          ids, n, cache, cache_n, B, K, mr, kf, log_eps, scratch,
          epik::SlimRow{out + r * (2LL * K + 3), K});
    } else {
      const int* crow = C + r * ldc;
      epik::build_mask([crow](int b) { return __ldg(crow + b) > 0; }, B, mask);
      const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
      const auto corr = [row, crow, ids, mr, kf, log_eps](int i) {
        const int b = static_cast<int>(ids[i]);
        return epik::correct_counts(__ldg(row + b), __ldg(crow + b), mr, kf, log_eps);
      };
      if constexpr (kVariant == kCountsFull) {
        finish_read(corr, ids, n, cache, cache_n, B, K, mr, kf, log_eps, scratch,
                    epik::full_row(out + r * (4LL * K + 2), K,
                                   [crow](int b) { return __ldg(crow + b); }));
      } else {
        finish_read(corr, ids, n, cache, cache_n, B, K, mr, kf, log_eps, scratch,
                    epik::SlimRow{out + r * (2LL * K + 3), K});
      }
    }
    __syncthreads();  // warp 0 is done with the list, the candidates and the cache
  }
}

size_t finish_smem(int B, int K, bool global) {
  const size_t words = static_cast<size_t>((B + 31) / 32) + (global ? 0 : (B + 1) / 2) +
                       static_cast<size_t>(B < kCache ? B : kCache);
  return words * sizeof(int) + epik::cand_bytes(kThreads, K);
}

template <bool kGlobal, int kVariant>
cudaError_t allow_smem(size_t smem) {  // always: the 48 KB default counts static bytes too
  return cudaFuncSetAttribute(finish_topk_kernel<kGlobal, kVariant>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The blocks of a global-workspace launch: as many as fit on the card at once.
template <int kVariant>
cudaError_t global_blocks(int R, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, finish_topk_kernel<true, kVariant>, kThreads, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  *blocks = R < sms * per_sm ? R : sms * per_sm;
  return cudaSuccess;
}

template <int kVariant>
int layout(int R, int B, int K, int* out) {
  const bool global = B > kMaxSharedIds;
  const size_t smem = finish_smem(B, K, global);
  cudaError_t err =
      global ? allow_smem<true, kVariant>(smem) : allow_smem<false, kVariant>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = global ? 1 : 0;
  out[1] = R;
  out[2] = 0;
  if (global) {
    err = global_blocks<kVariant>(R, smem, &out[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[2] = out[1] * B;
  }
  return static_cast<int>(cudaSuccess);
}

template <int kVariant>
int launch(const void* Sp, long long ld, const void* C, long long ldc, const void* m,
           void* out, int R, int B, int K, int k, float log_eps, void* ws, int blocks,
           void* stream) {
  const bool global = B > kMaxSharedIds;
  if (global && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = finish_smem(B, K, global);
  const cudaError_t err =
      global ? allow_smem<true, kVariant>(smem) : allow_smem<false, kVariant>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && blocks > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto kernel =
        global ? &finish_topk_kernel<true, kVariant> : &finish_topk_kernel<false, kVariant>;
    kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(Sp), ld, static_cast<const int*>(C), ldc,
        static_cast<const float*>(m), static_cast<float*>(out), R, B, K,
        static_cast<float>(k), log_eps, static_cast<int*>(ws));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch layout of epik_finish_topk (variant 0) or epik_finish_topk_counts
// (variant 1: the slim pack, 2: the full pack) for R reads of B branches:
// out[0] = 1 when the ids go to a global workspace (B > 2^16), else 0; out[1]
// = the blocks (R, or with the workspace as many as fit on the card at once,
// at most R); out[2] = the workspace's int32 ids (out[1] * B, or 0). Returns a
// CUDA error code (cudaErrorInvalidValue when B is past what the shared
// memory of the mask holds).
extern "C" int epik_finish_topk_layout(int R, int B, int K, int variant, int* out) {
  if (variant == kSumsSlim) return layout<kSumsSlim>(R, B, K, out);
  if (variant == kCountsSlim) return layout<kCountsSlim>(R, B, K, out);
  if (variant == kCountsFull) return layout<kCountsFull>(R, B, K, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Sp: f32 rows of stride `ld` floats, B used columns; m: f32 (R,) window
// counts; out: f32 (R, 2K+3); ws: int32 workspace of epik_finish_topk_layout's
// out[2] ids, or null when that is 0; `blocks`: its out[1]. 1 <= K <= min(64,
// B). Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_finish_topk(const void* Sp, long long ld, const void* m, void* out,
                                int R, int B, int K, int k, float log_eps, void* ws,
                                int blocks, void* stream) {
  return launch<kSumsSlim>(Sp, ld, nullptr, 0, m, out, R, B, K, k, log_eps, ws, blocks,
                           stream);
}

// The counts finish. S: f32 rows of stride `ld` floats and C: int32 rows of
// stride `ldc`, B used columns each; m: f32 (R,) window counts; out: f32 (R,
// 4K+2) with `full`, else (R, 2K+3); ws and `blocks` from
// epik_finish_topk_layout (variant 2 with `full`, else 1). 1 <= K <= min(64,
// B). Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_finish_topk_counts(const void* S, long long ld, const void* C,
                                       long long ldc, const void* m, void* out, int R, int B,
                                       int K, int k, float log_eps, int full, void* ws,
                                       int blocks, void* stream) {
  if (full) {
    return launch<kCountsFull>(S, ld, C, ldc, m, out, R, B, K, k, log_eps, ws, blocks,
                               stream);
  }
  return launch<kCountsSlim>(S, ld, C, ldc, m, out, R, B, K, k, log_eps, ws, blocks, stream);
}
