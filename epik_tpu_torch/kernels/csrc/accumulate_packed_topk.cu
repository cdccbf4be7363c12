// Packed posting-tile accumulate fused with the placement finish: for each
// read, the exact integer sums Sq[b] = sum of q over the read's cells
// (branch << 16) | q with that branch, then Sp = Sq / scale and the finish of
// finish_row.cuh into the slim pack [scores K | idx K | log_sum | n | zero_sum].
//
// Replaces the TPU kernel epik_tpu/ops/pallas/accumulate.py::
// segment_accumulate_packed_topk (body `_kernel_packed_topk`), the device step
// of the big-tree posting-tile path (engine/placer.py::_place_batch_tiles_bytes,
// packed payload). On the TPU the sums ran as bf16 digit matmuls over 128-lane
// one-hots, and the finish had a per-lane top-2 fast path; both work around
// the MXU and the VPU and are not carried over.
//
// Bound on the H100: the cells, PP * 4 bytes per read (about 10 KB for a
// 150 bp read at the 10k-taxa widths), read once from HBM, and the shared-
// memory atomics that add them; then the finish's K + 2 passes over the B
// sums in shared memory. Only the (2K+3)-float pack leaves the block, as on the
// TPU, so the (R, B) score matrix never reaches HBM.
//
// Design: one block per read. Its B sums are int32 in shared memory (B < 2^15,
// so at most 128 KB); every thread walks the cells with a stride and adds q
// with a shared-memory atomicAdd. Integer sums do not depend on the order of
// the adds, so they are exact and the same on every run. Cells whose branch is
// >= B (the trash column bw - 1 of the padding) are skipped, as the TPU
// kernel's `lane < B` mask drops them. The block then reads each sum once,
// converts it to Sp = (float)Sq / scale (correctly rounded, like the plain
// version's f32 divide) and overwrites it with the corrected score in place.

#include <cuda_runtime.h>

#include <cstdint>

#include "finish_row.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    accumulate_packed_topk_kernel(const int32_t* __restrict__ p, int PP,
                                  const float* __restrict__ m,
                                  float* __restrict__ out,
                                  int32_t* __restrict__ sq_out, int B, int K,
                                  float kf, float log_eps, float scale) {
  extern __shared__ int sq[];  // B sums; then B corrected scores
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const long long r = blockIdx.x;
  const int32_t* prow = p + r * PP;
  for (int b = threadIdx.x; b < B; b += blockDim.x) sq[b] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < PP; c += blockDim.x) {
    const uint32_t v = static_cast<uint32_t>(prow[c]);
    const int b = static_cast<int>(v >> 16);
    const int q = static_cast<int>(v & 0xFFFFu);
    if (b < B && q != 0) atomicAdd(&sq[b], q);
  }
  __syncthreads();
  if (sq_out != nullptr) {  // the integer sums, for checking only
    for (int b = threadIdx.x; b < B; b += blockDim.x) sq_out[r * B + b] = sq[b];
  }
  const int* sums = sq;
  epik::finish_row(
      [sums, scale](int b) { return __fdiv_rn(__int2float_rn(sums[b]), scale); },
      reinterpret_cast<float*>(sq), B, K, m[r], kf, log_eps, red_f, red_i,
      out + r * (2LL * K + 3));
}

}  // namespace

// p: int32 (R, PP) packed cells; m: f32 (R,) window counts; out: f32
// (R, 2K+3); sq: int32 (R, B) for the integer sums, or null. B < 2^15,
// K <= B. Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_accumulate_packed_topk(const void* p, const void* m,
                                           void* out, void* sq, int R, int PP,
                                           int B, int K, int k, float log_eps,
                                           float scale, void* stream) {
  const size_t smem = static_cast<size_t>(B) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        accumulate_packed_topk_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (R > 0) {
    accumulate_packed_topk_kernel<<<R, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(p), PP, static_cast<const float*>(m),
        static_cast<float*>(out), static_cast<int32_t*>(sq), B, K,
        static_cast<float>(k), log_eps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
