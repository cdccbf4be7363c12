// Segment accumulate over (branch, score) cells: for each read r and branch
// b < B, S[r, b] = the f32 sum of the scores of the read's cells with branch
// b, taken in increasing cell order, and, with the counts flag, C[r, b] = the
// number of such cells.
//
// Replaces two TPU kernels of epik_tpu/ops/pallas/accumulate.py:
// segment_accumulate_sums (body `_kernel_s_only`; the f32-payload posting-tile
// step, engine/placer.py::_place_batch_tiles_bytes) and segment_accumulate
// (body `_kernel`, sums and counts; the CSR fallback
// engine/placer.py::accumulate_exact_dense). On the TPU both were one-hot MXU
// matmuls at HIGHEST precision; a cell whose branch is >= B (the trash column
// of the padding) counts into a column that is sliced away, so here it is
// simply skipped.
//
// Bound on the H100: the cells, PP * 8 bytes per read, read from HBM once
// and from L1 by the other warps, and one shared-memory read-add-write per
// cell. A few MB per batch: small next to the work around it.
//
// Design: no float atomics, so the sums are bit-equal to the plain version's
// column-by-column adds and the same on every run. Block (r, t) owns the
// branch tile [t * tile_w, (t+1) * tile_w) of read r, with its sums (and
// counts) in shared memory. Warp w of the block owns the tile's branches
// j = w (mod warps): each warp scans all the read's cells, 32 at a time, in
// increasing order. Within a chunk of 32, the lanes whose cells hit the same
// owned branch form a group (__match_any_sync); the group's lowest lane adds
// the group's scores to the branch's sum in lane order, i.e. cell order.
// Different groups touch different branches, and different warps different
// branches, so every branch's sum is taken in cell order and nothing races.
// The wrapper sizes the tiles to the shared memory: one tile up to ~24k
// branches with counts and ~48k without, more tiles beyond.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
    accumulate_sums_kernel(const int32_t* __restrict__ b,
                           const float* __restrict__ s, float* __restrict__ S,
                           int32_t* __restrict__ C, int PP, int B,
                           int tile_w) {
  extern __shared__ float ssum[];  // tile_w sums, then tile_w counts
  __shared__ float stage[kWarps][32];
  int* scnt = reinterpret_cast<int*>(ssum + tile_w);
  const long long r = blockIdx.x;
  const int lo = blockIdx.y * tile_w;
  const int n = min(B - lo, tile_w);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    ssum[j] = 0.f;
    if (kCounts) scnt[j] = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* brow = b + r * PP;
  const float* srow = s + r * PP;
  for (int c0 = 0; c0 < PP; c0 += 32) {
    const int c = c0 + lane;
    int j = -1;
    float v = 0.f;
    if (c < PP) {
      j = brow[c] - lo;
      v = srow[c];
    }
    const bool mine = j >= 0 && j < n && j % kWarps == warp;
    // lanes of other warps' branches get distinct keys: they form no group
    const unsigned key = mine ? static_cast<unsigned>(j) : 0x80000000u | lane;
    const unsigned grp = __match_any_sync(0xffffffffu, key);
    stage[warp][lane] = v;
    __syncwarp();
    if (mine && lane == __ffs(grp) - 1) {
      float acc = ssum[j];
      for (unsigned g = grp; g != 0; g &= g - 1) {
        acc = __fadd_rn(acc, stage[warp][__ffs(g) - 1]);
      }
      ssum[j] = acc;
      if (kCounts) scnt[j] += __popc(grp);
    }
    __syncwarp();  // the chunk's stage is read before the next overwrites it
  }
  __syncthreads();
  float* Srow = S + r * B + lo;
  int32_t* Crow = kCounts ? C + r * B + lo : nullptr;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    Srow[j] = ssum[j];
    if (kCounts) Crow[j] = scnt[j];
  }
}

template <bool kCounts>
int launch(const void* b, const void* s, void* S, void* C, int R, int PP,
           int B, int tile_w, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile_w) * (kCounts ? 8 : 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        accumulate_sums_kernel<kCounts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(R, (B + tile_w - 1) / tile_w);
  accumulate_sums_kernel<kCounts><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(b), static_cast<const float*>(s),
      static_cast<float*>(S), static_cast<int32_t*>(C), PP, B, tile_w);
  return 0;
}

}  // namespace

// b: int32 (R, PP) branch ids (< B, or >= B for trash); s: f32 (R, PP);
// S: f32 (R, B); C: int32 (R, B), written only when `counts` != 0. The
// branch range is split into tiles of `tile_w` (the block's shared memory
// holds tile_w sums, and as many counts). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_accumulate_sums(const void* b, const void* s, void* S,
                                    void* C, int R, int PP, int B, int tile_w,
                                    int counts, void* stream) {
  if (R > 0 && B > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = counts ? launch<true>(b, s, S, C, R, PP, B, tile_w, st)
                           : launch<false>(b, s, S, C, R, PP, B, tile_w, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
