// Placement finish over a score matrix in device memory: score correction,
// LWR log-sum over all branches and top-K, written straight into the slim
// result pack [scores K | idx K | log_sum | n | zero_sum].
//
// Replaces the finish epilogue of the TPU kernel
// epik_tpu/ops/pallas/accumulate.py::segment_accumulate_packed_topk (the last
// grid step of `_kernel_packed_topk`), on the f32-payload tile path after the
// segment sums (epik_tpu/engine/placer.py::finish_scores_shifted + _lwr_topk +
// _pack_outputs_slim), and on the dense steps past the fused row gather's
// shared-memory limit (rowgather_sum.cu). The math, the tie rule and the
// rounding rules are those of finish_row.cuh.
//
// Bound on the H100: HBM bytes, one read of the (R, B) score matrix, B * 4
// bytes per read (80 KB at B = 19,999), and the pack written once.
//
// Design: one block of 512 threads per read. The warps read the row once,
// coalesced, 8 words of 32 branches in flight per lane, into a bitmask of the
// touched branches (a ballot of Sp > 0); one compaction lists the touched ids
// in ascending order; the finish runs over that list (finish_row.cuh), reading
// a listed branch's score again from the row, which L1/L2 still hold. Shared
// memory: ceil(B / 32) mask words + B 16-bit ids + the warps' top-K
// candidates, about 43.4 KB at B = 19,999: four blocks per SM, the thread
// limit. (At that shape 512 threads with 4 or 8 loads in flight per lane
// measured 0.302 ms; 256 threads 0.31-0.53 ms and 1,024 threads 0.35-0.49 ms,
// by a one-off sweep on an H100.)
//
// Past B = 2^16 the ids do not fit 16 bits, nor B of them in shared memory:
// the list goes to a global-memory workspace of int32 ids, one row of B per
// block, sized per launch (epik_finish_topk_layout gives the blocks: as many
// as fit on the card at once, each finishing reads blockIdx.x, blockIdx.x +
// gridDim.x, ...). Only the mask and the candidates stay in shared memory,
// which bounds B near 1.8 million. The list and its order are the same in both
// layouts, so are the output bits.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSharedIds = 1 << 16;  // 16-bit ids

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    finish_topk_kernel(const float* __restrict__ Sp, long long ld,
                       const float* __restrict__ m, float* __restrict__ out, int R,
                       int B, int K, float kf, float log_eps, int* __restrict__ ws) {
  // mask words | ids (B, 16 bits, padded to 4 bytes; global: none) | candidates
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
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  for (long long r = blockIdx.x; r < R; r += gridDim.x) {
    const float* row = Sp + r * ld;
    epik::build_mask([row](int b) { return __ldg(row + b) > 0.f; }, B, mask);
    const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
    const float mr = m[r];
    epik::finish_list(
        [row, ids, mr, kf, log_eps](int i) {
          return epik::correct(__ldg(row + ids[i]), mr, kf, log_eps);
        },
        ids, n, B, K, mr, kf, log_eps, scratch, out + r * (2LL * K + 3));
    __syncthreads();  // warp 0 is done with the list and the candidates
  }
}

size_t finish_smem(int B, int K, bool global) {
  const size_t words = static_cast<size_t>((B + 31) / 32) + (global ? 0 : (B + 1) / 2);
  return words * sizeof(int) + epik::cand_bytes(kThreads, K);
}

template <bool kGlobal>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(finish_topk_kernel<kGlobal>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// The launch layout of epik_finish_topk for R reads of B branches: out[0] = 1
// when the ids go to a global workspace (B > 2^16), else 0; out[1] = the
// blocks (R, or with the workspace as many as fit on the card at once, at
// most R); out[2] = the workspace's int32 ids (out[1] * B, or 0). Returns a
// CUDA error code (cudaErrorInvalidValue when B is past what the shared
// memory of the mask holds).
extern "C" int epik_finish_topk_layout(int R, int B, int K, int* out) {
  const bool global = B > kMaxSharedIds;
  const size_t smem = finish_smem(B, K, global);
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
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, finish_topk_kernel<true>,
                                                        kThreads, smem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    out[1] = R < sms * per_sm ? R : sms * per_sm;
    out[2] = out[1] * B;
  }
  return static_cast<int>(cudaSuccess);
}

// Sp: f32 rows of stride `ld` floats, B used columns; m: f32 (R,) window
// counts; out: f32 (R, 2K+3); ws: int32 workspace of epik_finish_topk_layout's
// out[2] ids, or null when that is 0; `blocks`: its out[1]. 1 <= K <= min(64,
// B). Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_finish_topk(const void* Sp, long long ld, const void* m, void* out,
                                int R, int B, int K, int k, float log_eps, void* ws,
                                int blocks, void* stream) {
  const bool global = B > kMaxSharedIds;
  if (global && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = finish_smem(B, K, global);
  const cudaError_t err = global ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && blocks > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (global) {
      finish_topk_kernel<true><<<blocks, kThreads, smem, s>>>(
          static_cast<const float*>(Sp), ld, static_cast<const float*>(m),
          static_cast<float*>(out), R, B, K, static_cast<float>(k), log_eps,
          static_cast<int*>(ws));
    } else {
      finish_topk_kernel<false><<<blocks, kThreads, smem, s>>>(
          static_cast<const float*>(Sp), ld, static_cast<const float*>(m),
          static_cast<float*>(out), R, B, K, static_cast<float>(k), log_eps, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
