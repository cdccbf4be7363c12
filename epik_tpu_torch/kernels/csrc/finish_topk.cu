// Placement finish over a score matrix in device memory: score correction,
// LWR log-sum over all branches and top-K, written straight into the slim
// result pack [scores K | idx K | log_sum | n | zero_sum].
//
// Replaces the finish epilogue of the TPU kernel
// epik_tpu/ops/pallas/accumulate.py::segment_accumulate_packed_topk (the last
// grid step of `_kernel_packed_topk`), and on the dense main path the XLA
// finish of epik_tpu/engine/placer.py: finish_scores_shifted + _lwr_topk +
// _pack_outputs_slim. The math, the tie rule and the rounding rules are those
// of finish_row.cuh, which accumulate_packed_topk.cu shares.
//
// Bound on the H100: neither bytes nor operations to speak of -- one read of
// the (R, B) score matrix, B * 4 bytes per read, plus K passes over a row held
// in shared memory. At D652 widths it is a small share of the step next to the
// row gather; a later change fuses it into the gather's epilogue so the
// (R, B) matrix never reaches HBM.
//
// Design: one block per read; `corrected` lives in shared memory (B floats:
// 5.2 KB at B = 1303; up to ~57k branches within 227 KB).

#include <cuda_runtime.h>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    finish_topk_kernel(const float* __restrict__ Sp, long long ld,
                       const float* __restrict__ m, float* __restrict__ out,
                       int B, int K, float kf, float log_eps) {
  extern __shared__ float corr[];  // B corrected scores of this read
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const long long r = blockIdx.x;
  const float* row = Sp + r * ld;
  epik::finish_row([row](int b) { return row[b]; }, corr, B, K, m[r], kf,
                   log_eps, red_f, red_i, out + r * (2LL * K + 3));
}

}  // namespace

// Sp: f32 rows of stride `ld` floats, B used columns; m: f32 (R,) window
// counts; out: f32 (R, 2K+3). K <= B. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_finish_topk(const void* Sp, long long ld, const void* m,
                                void* out, int R, int B, int K, int k,
                                float log_eps, void* stream) {
  const size_t smem = static_cast<size_t>(B) * sizeof(float);
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
