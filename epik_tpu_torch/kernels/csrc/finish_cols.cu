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
// Design: finish_topk.cu's block of 512 threads per read, with finish_row.cuh's
// list max, one exp-sum and top-K in place of the LWR finish. Shared memory:
// ceil(bwl / 32) mask words + bwl 16-bit ids + the warps' candidates; past
// bwl = 2^16 the ids go to a global int32 workspace, one row of bwl per block,
// as many blocks as fit on the card at once (each takes reads blockIdx.x,
// blockIdx.x + gridDim.x, ...). epik_finish_cols_smem gives a launch's bytes
// and epik_finish_cols_smem_limit what a block may take, from the formula
// below.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSharedIds = 1 << 16;  // 16-bit ids

template <bool kGlobal, bool kCounts>
__global__ void __launch_bounds__(kThreads)
    finish_cols_partial_kernel(const float* __restrict__ S, long long ld,
                               const int* __restrict__ C, long long ldc,
                               const float* __restrict__ m, float* __restrict__ out,
                               int* __restrict__ cnt_out, int R, int bwl, int K, int col0,
                               float kf, float log_eps, int* __restrict__ ws) {
  // mask words | ids (bwl, 16 bits, padded to 4 bytes; global: none) | candidates
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
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const float* row = S + r * ld;
    const float mr = m[r];
    float* orow = out + r * (2LL * K + 3);
    if constexpr (kCounts) {
      const int* crow = C + r * ldc;
      epik::build_mask([crow](int b) { return __ldg(crow + b) > 0; }, bwl, mask);
      const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
      epik::cols_list(
          [row, crow, ids, mr, kf, log_eps](int i) {
            const int b = static_cast<int>(ids[i]);
            return epik::correct_counts(__ldg(row + b), __ldg(crow + b), mr, kf, log_eps);
          },
          ids, n, K, col0, scratch, orow, cnt_out + r * K,
          [crow](int b) { return __ldg(crow + b); });
    } else {
      epik::build_mask([row](int b) { return __ldg(row + b) > 0.f; }, bwl, mask);
      const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
      epik::cols_list(
          [row, ids, mr, kf, log_eps](int i) {
            return epik::correct(__ldg(row + ids[i]), mr, kf, log_eps);
          },
          ids, n, K, col0, scratch, orow, nullptr, [](int) { return 0; });
    }
    __syncthreads();  // warp 0 is done with the list and the candidates
  }
}

// Dynamic shared memory of a launch at (bwl, K): the mask words, the 16-bit
// ids unless they go to the global workspace, and the warps' candidates.
size_t partial_smem(int bwl, int K, bool global) {
  const size_t words = static_cast<size_t>((bwl + 31) / 32) + (global ? 0 : (bwl + 1) / 2);
  return words * sizeof(int) + epik::cand_bytes(kThreads, K);
}

template <bool kGlobal, bool kCounts>
long long partial_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, finish_cols_partial_kernel<kGlobal, kCounts>) !=
          cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// always: the 48 KB a launch may take without opting in count static bytes too
template <bool kGlobal, bool kCounts>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(finish_cols_partial_kernel<kGlobal, kCounts>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t allow(bool global, bool counts, size_t smem) {
  if (global) return counts ? allow_smem<true, true>(smem) : allow_smem<true, false>(smem);
  return counts ? allow_smem<false, true>(smem) : allow_smem<false, false>(smem);
}

template <bool kCounts>
cudaError_t blocks_per_sm(bool global, size_t smem, int* per_sm) {
  return global ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      per_sm, finish_cols_partial_kernel<true, kCounts>, kThreads, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      per_sm, finish_cols_partial_kernel<false, kCounts>, kThreads, smem);
}

}  // namespace

// Bytes of dynamic shared memory a finish_cols_partial launch at (bwl, K) asks
// (either form: the counts stay in device memory).
extern "C" long long epik_finish_cols_smem(int bwl, int K) {
  return static_cast<long long>(partial_smem(bwl, K, bwl > kMaxSharedIds));
}

// Bytes of dynamic shared memory a finish_cols_partial block at this width
// may take on the current device (`counts`: the counts form): the opt-in limit
// less the kernel's static shared memory. Negative: minus a CUDA error code.
extern "C" long long epik_finish_cols_smem_limit(int bwl, int counts) {
  const bool global = bwl > kMaxSharedIds;
  if (global) return counts ? partial_smem_limit<true, true>() : partial_smem_limit<true, false>();
  return counts ? partial_smem_limit<false, true>() : partial_smem_limit<false, false>();
}

// The launch layout of epik_finish_cols_partial for R reads of bwl columns
// (`counts`: the counts form): out[0] = 1 when the ids go to a global
// workspace (bwl > 2^16), else 0; out[1] = the blocks (R, or with the
// workspace as many as fit on the card at once, at most R); out[2] = the
// workspace's int32 ids (out[1] * bwl, or 0). The caller has checked
// epik_finish_cols_smem against epik_finish_cols_smem_limit. Returns a CUDA
// error code.
extern "C" int epik_finish_cols_layout(int R, int bwl, int K, int counts, int* out) {
  const bool global = bwl > kMaxSharedIds;
  const size_t smem = partial_smem(bwl, K, global);
  const cudaError_t err = allow(global, counts != 0, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = global ? 1 : 0;
  out[1] = R;
  out[2] = 0;
  if (global) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = counts ? blocks_per_sm<true>(true, smem, &per_sm)
                 : blocks_per_sm<false>(true, smem, &per_sm);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    out[1] = R < sms * per_sm ? R : sms * per_sm;
    out[2] = out[1] * bwl;
  }
  return static_cast<int>(cudaSuccess);
}

// S: f32 rows of stride `ld` floats, bwl used columns (the shifted sums, or
// the classic sums with C); C: int32 rows of stride `ldc` (the exact counts:
// the counts form), or null (the shifted form); m: f32 (R,) window counts;
// out: f32 (R, 2K+3); cnt: int32 (R, K), the counts form's candidate counts
// (null otherwise); 1 <= K <= min(64, bwl); col0: the shard's first global
// column; ws and blocks from epik_finish_cols_layout (ws null when its out[2]
// is 0). Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_finish_cols_partial(const void* S, long long ld, const void* C,
                                        long long ldc, const void* m, void* out, void* cnt,
                                        int R, int bwl, int K, int col0, int k, float log_eps,
                                        void* ws, int blocks, void* stream) {
  const bool global = bwl > kMaxSharedIds;
  const bool counts = C != nullptr;
  if ((global && ws == nullptr) || counts != (cnt != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = partial_smem(bwl, K, global);
  const cudaError_t err = allow(global, counts, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && blocks > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* sp = static_cast<const float*>(S);
    const auto* cp = static_cast<const int*>(C);
    const auto* mp = static_cast<const float*>(m);
    auto* op = static_cast<float*>(out);
    auto* np = static_cast<int*>(cnt);
    auto* wp = static_cast<int*>(ws);
    const float kf = static_cast<float>(k);
    if (global && counts) {
      finish_cols_partial_kernel<true, true><<<blocks, kThreads, smem, s>>>(
          sp, ld, cp, ldc, mp, op, np, R, bwl, K, col0, kf, log_eps, wp);
    } else if (global) {
      finish_cols_partial_kernel<true, false><<<blocks, kThreads, smem, s>>>(
          sp, ld, nullptr, 0, mp, op, nullptr, R, bwl, K, col0, kf, log_eps, wp);
    } else if (counts) {
      finish_cols_partial_kernel<false, true><<<blocks, kThreads, smem, s>>>(
          sp, ld, cp, ldc, mp, op, np, R, bwl, K, col0, kf, log_eps, nullptr);
    } else {
      finish_cols_partial_kernel<false, false><<<blocks, kThreads, smem, s>>>(
          sp, ld, nullptr, 0, mp, op, nullptr, R, bwl, K, col0, kf, log_eps, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
