// The column-sharded placement finish: each model shard of a column-sharded
// step holds the shifted sums Sp of its own bwl branch columns, and the finish
// of epik_tpu/parallel/sharding.py::finish_scores_cols_shifted + _lwr_topk_cols
// (an XLA function there, no Pallas kernel) runs here per shard, in two
// launches around a merge of per-read scalars on the lead device:
//
// * finish_cols_partial (launch A), per shard s and read r: the touched list
//   of Sp[r] > 0 (finish_row.cuh's ballot and block scan), the count n_s, the
//   largest corrected score max_s (-inf when nothing is touched) and the
//   shard's top Kl = min(K, bwl) candidates by (value desc, local index asc),
//   the slots past n_s holding -inf and the lowest untouched columns, as a
//   stable sort gives; ids are written as global columns (local + col0). Out:
//   f32 (R, 2 Kl + 2) = [values Kl | ids Kl | n_s | max_s].
// * the merge (torch ops on the (R,) vectors): n = sum n_s, max_c = max
//   max_s, then max_t as finish_row.cuh computes it.
// * finish_cols_expsum (launch B), per shard: sum over the touched columns of
//   10^(corrected - max_t), taken against the GLOBAL max_t, so each term is
//   JAX's term; each thread adds its columns in ascending order, then one
//   block reduction. The shards' sums are added in shard order with the
//   (B - n) untouched term, and the shards' candidates (shards in column
//   order) go through one more top-K; both are small torch ops.
//
// Rounding: the corrected score is finish_row.cuh's correct() (__f*_rn, built
// with -fmad=false), so n_s, max_s, the candidates' values and ids are
// bit-equal to the plain PyTorch version; the exp-sum's order of adds differs
// from torch's reduction (log_sum within rtol 1e-6).
//
// Bound on the H100: HBM bytes. Launch A reads the (R, bwl) sums once and
// writes 2 Kl + 2 floats a read; launch B reads the sums once more (L2 holds
// none of a 329 MB (4,096 x 20,096) matrix), so the pair moves about twice the
// least bytes: fusing launch A into kernel 1's epilogue on the dense shards is
// the later step.
//
// Design of launch A: finish_topk.cu's block of 512 threads per read, with
// finish_row.cuh's list max and top-K in place of the LWR finish. Shared
// memory: ceil(bwl / 32) mask words + bwl 16-bit ids + the warps' candidates;
// past bwl = 2^16 the ids go to a global int32 workspace, one row of bwl per
// block, as many blocks as fit on the card at once (each takes reads
// blockIdx.x, blockIdx.x + gridDim.x, ...). epik_finish_cols_smem gives a
// launch's bytes and epik_finish_cols_smem_limit what a block may take, from
// the formula below. Launch B keeps no list: 256 threads stride a read's
// columns, coalesced, one block per read.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 512;     // launch A
constexpr int kSumThreads = 256;  // launch B
constexpr int kMaxSharedIds = 1 << 16;  // 16-bit ids

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    finish_cols_partial_kernel(const float* __restrict__ Sp, long long ld,
                               const float* __restrict__ m, float* __restrict__ out, int R,
                               int bwl, int K, int col0, float kf, float log_eps,
                               int* __restrict__ ws) {
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
    const float* row = Sp + r * ld;
    epik::build_mask([row](int b) { return __ldg(row + b) > 0.f; }, bwl, mask);
    const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
    const float mr = m[r];
    const auto corr = [row, ids, mr, kf, log_eps](int i) {
      return epik::correct(__ldg(row + ids[i]), mr, kf, log_eps);
    };
    const float max_s = epik::list_max(corr, n, red_f);
    float* orow = out + r * (2LL * K + 2);
    const bool lead = epik::topk_list(corr, ids, n, K, scratch,
                                      [orow, K, col0](int j, float v, int b) {
                                        orow[j] = v;
                                        orow[K + j] = static_cast<float>(b + col0);
                                      });
    if (lead && threadIdx.x == 0) {
      orow[2 * K] = static_cast<float>(n);
      orow[2 * K + 1] = max_s;
    }
    __syncthreads();  // warp 0 is done with the list and the candidates
  }
}

__global__ void __launch_bounds__(kSumThreads)
    finish_cols_expsum_kernel(const float* __restrict__ Sp, long long ld,
                              const float* __restrict__ m, const float* __restrict__ max_t,
                              float* __restrict__ out, int bwl, float kf, float log_eps) {
  __shared__ float red_f[32];
  const long long r = blockIdx.x;
  const float* row = Sp + r * ld;
  const float mr = m[r], mt = max_t[r];
  float sum = 0.f;
  for (int b = threadIdx.x; b < bwl; b += blockDim.x) {
    const float s = __ldg(row + b);
    if (s > 0.f) {
      sum += expf(__fmul_rn(__fsub_rn(epik::correct(s, mr, kf, log_eps), mt), epik::kLn10));
    }
  }
  sum = epik::block_sum(sum, red_f);
  if (threadIdx.x == 0) out[r] = sum;
}

// Dynamic shared memory of a launch A at (bwl, K): the mask words, the 16-bit
// ids unless they go to the global workspace, and the warps' candidates.
size_t partial_smem(int bwl, int K, bool global) {
  const size_t words = static_cast<size_t>((bwl + 31) / 32) + (global ? 0 : (bwl + 1) / 2);
  return words * sizeof(int) + epik::cand_bytes(kThreads, K);
}

template <bool kGlobal>
long long partial_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, finish_cols_partial_kernel<kGlobal>) != cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

template <bool kGlobal>
cudaError_t allow_smem(size_t smem) {  // always: the 48 KB default counts static bytes too
  return cudaFuncSetAttribute(finish_cols_partial_kernel<kGlobal>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Bytes of dynamic shared memory a finish_cols_partial launch at (bwl, K) asks.
extern "C" long long epik_finish_cols_smem(int bwl, int K) {
  return static_cast<long long>(partial_smem(bwl, K, bwl > kMaxSharedIds));
}

// Bytes of dynamic shared memory a finish_cols_partial block at this width may
// take on the current device: the opt-in limit less the kernel's static
// shared memory. Negative: minus a CUDA error code.
extern "C" long long epik_finish_cols_smem_limit(int bwl) {
  return bwl > kMaxSharedIds ? partial_smem_limit<true>() : partial_smem_limit<false>();
}

// The launch layout of epik_finish_cols_partial for R reads of bwl columns:
// out[0] = 1 when the ids go to a global workspace (bwl > 2^16), else 0;
// out[1] = the blocks (R, or with the workspace as many as fit on the card at
// once, at most R); out[2] = the workspace's int32 ids (out[1] * bwl, or 0).
// The caller has checked epik_finish_cols_smem against
// epik_finish_cols_smem_limit. Returns a CUDA error code.
extern "C" int epik_finish_cols_layout(int R, int bwl, int K, int* out) {
  const bool global = bwl > kMaxSharedIds;
  const size_t smem = partial_smem(bwl, K, global);
  const cudaError_t err = global ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = global ? 1 : 0;
  out[1] = R;
  out[2] = 0;
  if (global) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, finish_cols_partial_kernel<true>, kThreads, smem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    out[1] = R < sms * per_sm ? R : sms * per_sm;
    out[2] = out[1] * bwl;
  }
  return static_cast<int>(cudaSuccess);
}

// Launch A. Sp: f32 rows of stride `ld` floats, bwl used columns; m: f32 (R,)
// window counts; out: f32 (R, 2K+2); 1 <= K <= min(64, bwl); col0: the
// shard's first global column; ws and blocks from epik_finish_cols_layout
// (ws null when its out[2] is 0). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_finish_cols_partial(const void* Sp, long long ld, const void* m, void* out,
                                        int R, int bwl, int K, int col0, int k, float log_eps,
                                        void* ws, int blocks, void* stream) {
  const bool global = bwl > kMaxSharedIds;
  if (global && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = partial_smem(bwl, K, global);
  const cudaError_t err = global ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && blocks > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* sp = static_cast<const float*>(Sp);
    const auto* mp = static_cast<const float*>(m);
    auto* op = static_cast<float*>(out);
    if (global) {
      finish_cols_partial_kernel<true><<<blocks, kThreads, smem, s>>>(
          sp, ld, mp, op, R, bwl, K, col0, static_cast<float>(k), log_eps,
          static_cast<int*>(ws));
    } else {
      finish_cols_partial_kernel<false><<<blocks, kThreads, smem, s>>>(
          sp, ld, mp, op, R, bwl, K, col0, static_cast<float>(k), log_eps, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch B. Sp, ld, m as above; max_t: f32 (R,) the merged maxima; out: f32
// (R,) each read's sum of 10^(corrected - max_t) over the shard's touched
// columns. Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_finish_cols_expsum(const void* Sp, long long ld, const void* m,
                                       const void* max_t, void* out, int R, int bwl, int k,
                                       float log_eps, void* stream) {
  if (R > 0) {
    finish_cols_expsum_kernel<<<R, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Sp), ld, static_cast<const float*>(m),
        static_cast<const float*>(max_t), static_cast<float*>(out), bwl,
        static_cast<float>(k), log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}
