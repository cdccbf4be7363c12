// Placement finish over a score matrix in device memory: score correction,
// LWR log-sum over all branches and top-K, written straight into the slim
// result pack [scores K | idx K | log_sum | n | zero_sum].
//
// Replaces the finish epilogue of the TPU kernel
// epik_tpu/ops/pallas/accumulate.py::segment_accumulate_packed_topk (the last
// grid step of `_kernel_packed_topk`), on the f32-payload tile path after the
// segment sums (epik_tpu/engine/placer.py::finish_scores_shifted + _lwr_topk +
// _pack_outputs_slim). The dense main path runs the same finish fused into
// the row gather (rowgather_sum.cu). The math, the tie rule and the rounding
// rules are those of finish_row.cuh.
//
// Bound on the H100: HBM bytes, one read of the (R, B) score matrix, B * 4
// bytes per read (80 KB at B = 19,999), and the pack written once.
//
// Design: one block of 512 threads per read. The warps read the row once,
// coalesced, 8 words of 32 branches in flight per lane, into a bitmask of the
// touched branches (a ballot of Sp > 0); one compaction lists the touched ids
// in ascending order; the finish runs over that list (finish_row.cuh), reading
// a listed branch's score again from the row, which L1/L2 still hold. Shared
// memory: ceil(B / 32) mask words + B 16-bit ids (B <= 2^16) + the warps'
// top-K candidates, about 43.4 KB at B = 19,999: four blocks per SM, the
// thread limit. (At that shape 512 threads with 4 or 8 loads in flight per
// lane measured 0.302 ms; 256 threads 0.31-0.53 ms and 1,024 threads
// 0.35-0.49 ms, by a one-off sweep on an H100. The launch is sized for the
// f32 tile path's width, the one path that runs this kernel; at B = 1,303 it
// reads about 0.5 ms against 0.30 for a 256-thread block.)

#include <cuda_runtime.h>

#include <cstdint>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    finish_topk_kernel(const float* __restrict__ Sp, long long ld,
                       const float* __restrict__ m, float* __restrict__ out,
                       int B, int K, float kf, float log_eps) {
  // mask words | ids (B, 16 bits, padded to 4 bytes) | candidates
  extern __shared__ unsigned mask[];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int nwords = (B + 31) >> 5;
  uint16_t* ids = reinterpret_cast<uint16_t*>(mask + nwords);
  float* cand_v = reinterpret_cast<float*>(mask + nwords + (B + 1) / 2);
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  const long long r = blockIdx.x;
  const float* row = Sp + r * ld;
  epik::build_mask([row](int b) { return __ldg(row + b) > 0.f; }, B, mask);
  const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
  const float mr = m[r];
  epik::finish_list(
      [row, ids, mr, kf, log_eps](int i) {
        return epik::correct(__ldg(row + ids[i]), mr, kf, log_eps);
      },
      ids, n, B, K, mr, kf, log_eps, scratch, out + r * (2LL * K + 3));
}

}  // namespace

// Sp: f32 rows of stride `ld` floats, B used columns; m: f32 (R,) window
// counts; out: f32 (R, 2K+3). B <= 2^16, 1 <= K <= min(64, B). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int epik_finish_topk(const void* Sp, long long ld, const void* m,
                                void* out, int R, int B, int K, int k,
                                float log_eps, void* stream) {
  const size_t smem = (static_cast<size_t>((B + 31) / 32) + (B + 1) / 2) * sizeof(int) +
                      epik::cand_bytes(kThreads, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        finish_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (R > 0) {
    finish_topk_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Sp), ld, static_cast<const float*>(m),
        static_cast<float*>(out), B, K, static_cast<float>(k), log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}
