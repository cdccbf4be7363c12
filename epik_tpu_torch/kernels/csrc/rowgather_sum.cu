// Row gather + sum over a dense plane: Sp[r] = sum_w plane[rows[r, w]].
//
// Replaces the TPU kernel epik_tpu/ops/pallas/rowgather_mq.py::rowgather_sum_mq
// (body `_kernel`), which computes the function of
// epik_tpu/engine/placer.py::dense_sums_shifted, the hot loop of the dense
// placement steps. The TPU kernel was bound by the rate at which its scalar
// core could issue one DMA per plane row; on Hopper a row read is a run of
// ordinary coalesced loads, so there is no issue limit to design around. The
// TPU's 16-sublane staging (`stage_plane`) is not carried over.
//
// Bound on the H100: HBM bytes. Each window slot reads one whole plane row of
// bw * sizeof(cell) bytes (5,632 B at the D652 width bw = 1408 in f32, 80,384 B
// at config 4's bw = 20,096) and the rows of one read are scattered over a
// multi-GB plane, so the 50 MB L2 gives little reuse. The roofline yardstick
// is the distinct rows a batch names, read once.
//
// Design: one block per read. The block stages its row offsets (int64, so
// planes beyond 2^31 cells address correctly) in shared memory, a tile at a
// time; its threads span the row four cells at a time (16-byte loads of f32,
// 8-byte loads of int16 or bf16, neighbouring threads on neighbouring
// addresses); each thread adds the rows in window order, one after another, in
// registers. That is the order of the plain version's
// `acc += plane.index_select(0, rows[:, w])` loop, with no multiply, so the
// result is bit-equal to it. Misses point at the all-zero row. The plane's
// cell type is a template parameter:
// * f32 (the shifted and classic planes): f32 adds;
// * int16 (precision="int16", the quantized shifted plane): exact int32 adds,
//   then one correctly rounded __int2float_rn and __fdiv_rn by the plane
//   scale, as `Sp.astype(f32) / f32(plane_scale)` (placer.py:670-671);
// * bf16 (precision="bf16", classic only): each cell widened to f32 exactly
//   (its 16 bits are the top half of the f32), then f32 adds.
//
// Entry points:
// * epik_rowgather_sum (f32, int16): the (R, bw) f32 sums;
// * epik_rowgather_sum_counts (f32, bf16): the classic plane's sums S and the
//   exact counts C of the cells != 0 (dense_sums_from_rows, placer.py:757), as
//   f32 and int32 (R, bw);
// * epik_rowgather_sum_topk (f32, int16): the placement finish in the same
//   block (#2's finish in #1's epilogue), so the (R, bw) sums never reach HBM:
//   - the window-order sums go to shared memory (bw floats) instead of HBM;
//   - a read with an ambiguous (IUPAC) delta row adds it there, one
//     __fadd_rn per branch: the add of epik_tpu/engine/placer.py::_apply_amb;
//   - a warp ballot of Sp > 0 over the B branches, one compaction into the
//     touched ids (16 bits) in ascending order, and finish_row.cuh's list
//     finish write the read's (2K+3) pack.
//   Block i places read i. Shared memory: bw sums + ceil(B / 32) mask words +
//   B 16-bit ids + the warps' top-K candidates (11.3 KB at D652, about 123 KB
//   at config 4's bw = 20,096, B = 19,999: one block per SM there), next to
//   the 8 KB of staged row offsets. That caps B near 37,000 at bw ~ B:
//   epik_rowgather_sum_topk_smem gives a launch's bytes and
//   epik_rowgather_sum_topk_smem_limit the card's opt-in bytes less the
//   kernel's static ones, and the step runs epik_rowgather_sum + the finish
//   kernel apart past that (the same bits). Bound on the H100: the distinct
//   plane rows a batch reads, the row ids, m and the pack (no (R, bw) write).

#include <cuda_runtime.h>

#include <cstdint>

#include "finish_row.cuh"

namespace {

constexpr int kTileW = 1024;  // row offsets staged per shared-memory tile

// bf16 cells as their bits: the kernels widen them to f32 themselves
struct Bf16 {
  uint16_t bits;
};

// The type codes of the C entry points
enum Cell { kF32 = 0, kI16 = 1, kBf16 = 2 };

// Four cells of a row starting at cell 4 * i, as f32 or int32 addends.
__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}
__device__ __forceinline__ int4 load4(const int16_t* p, long long i) {
  const short4 v = __ldg(reinterpret_cast<const short4*>(p) + i);
  return make_int4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float4 load4(const Bf16* p, long long i) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ void add4(float4& a, float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
__device__ __forceinline__ void add4(int4& a, int4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
__device__ __forceinline__ void count4(int4& c, float4 v) {
  c.x += v.x != 0.f;
  c.y += v.y != 0.f;
  c.z += v.z != 0.f;
  c.w += v.w != 0.f;
}

// The sums as f32: as they are, or an int16 plane's dequantized
__device__ __forceinline__ float4 as_sums(float4 a, float) { return a; }
__device__ __forceinline__ float4 as_sums(int4 a, float scale) {
  return make_float4(__fdiv_rn(__int2float_rn(a.x), scale), __fdiv_rn(__int2float_rn(a.y), scale),
                     __fdiv_rn(__int2float_rn(a.z), scale), __fdiv_rn(__int2float_rn(a.w), scale));
}

template <class T>
struct Acc {
  using type = float4;
};
template <>
struct Acc<int16_t> {
  using type = int4;
};

// Thread c of the block adds the four cells of column group c (c < bw4) of
// the read's rows in window order into `acc` (and, with kCounts, the cells
// != 0 into `cnt`); `off` is the block's shared tile of row offsets. Every
// thread of the block must call it.
template <bool kCounts, class T, class A>
__device__ __forceinline__ void gather_column(const T* __restrict__ plane,
                                              const int32_t* __restrict__ rrow, int W,
                                              int bw4, int c, long long* off, A& acc,
                                              int4& cnt) {
  for (int w0 = 0; w0 < W; w0 += kTileW) {
    const int nw = min(kTileW, W - w0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < nw; i += blockDim.x) {
      off[i] = static_cast<long long>(rrow[w0 + i]) * bw4;
    }
    __syncthreads();
    if (c < bw4) {
#pragma unroll 8
      for (int i = 0; i < nw; ++i) {
        const auto v = load4(plane, off[i] + c);
        add4(acc, v);
        if constexpr (kCounts) count4(cnt, v);
      }
    }
  }
}

template <class T>
__global__ void rowgather_sum_kernel(const T* __restrict__ plane,
                                     const int32_t* __restrict__ rows,
                                     float4* __restrict__ out, int W, int bw4, float scale) {
  __shared__ long long off[kTileW];
  const long long r = blockIdx.x;
  const int32_t* rrow = rows + r * W;
  for (int c0 = 0; c0 < bw4; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    typename Acc<T>::type acc{};
    int4 cnt{};
    gather_column<false>(plane, rrow, W, bw4, c, off, acc, cnt);
    if (c < bw4) out[r * bw4 + c] = as_sums(acc, scale);
  }
}

template <class T>
__global__ void rowgather_sum_counts_kernel(const T* __restrict__ plane,
                                            const int32_t* __restrict__ rows,
                                            float4* __restrict__ S, int4* __restrict__ C,
                                            int W, int bw4) {
  __shared__ long long off[kTileW];
  const long long r = blockIdx.x;
  const int32_t* rrow = rows + r * W;
  for (int c0 = 0; c0 < bw4; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float4 acc{};
    int4 cnt{};
    gather_column<true>(plane, rrow, W, bw4, c, off, acc, cnt);
    if (c < bw4) {
      S[r * bw4 + c] = acc;
      C[r * bw4 + c] = cnt;
    }
  }
}

template <class T>
__global__ void rowgather_sum_topk_kernel(
    const T* __restrict__ plane, const int32_t* __restrict__ rows,
    const float* __restrict__ m, const int32_t* __restrict__ slot,
    const float* __restrict__ delta, float* __restrict__ out, int W, int bw4, int B,
    int K, float kf, float log_eps, float scale) {
  // bw sums | mask words | ids (B, 16 bits, padded to 4 bytes) | candidates
  extern __shared__ float4 sums4[];
  __shared__ long long off[kTileW];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int nwords = (B + 31) >> 5;
  float* sums = reinterpret_cast<float*>(sums4);
  unsigned* mask = reinterpret_cast<unsigned*>(sums + 4 * bw4);
  uint16_t* ids = reinterpret_cast<uint16_t*>(mask + nwords);
  float* cand_v = reinterpret_cast<float*>(mask + nwords + (B + 1) / 2);
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  const long long r = blockIdx.x;
  const int32_t* rrow = rows + r * W;
  for (int c0 = 0; c0 < bw4; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    typename Acc<T>::type acc{};
    int4 cnt{};
    gather_column<false>(plane, rrow, W, bw4, c, off, acc, cnt);
    if (c < bw4) sums4[c] = as_sums(acc, scale);
  }
  const int a = slot != nullptr ? slot[r] : -1;
  if (a >= 0) {  // the ambiguous first-hit delta row of this read
    __syncthreads();
    const float* drow = delta + static_cast<long long>(a) * B;
    for (int b = threadIdx.x; b < B; b += blockDim.x) sums[b] = __fadd_rn(sums[b], drow[b]);
  }
  __syncthreads();
  epik::build_mask([sums](int b) { return sums[b] > 0.f; }, B, mask);
  const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
  const float mr = m[r];
  epik::finish_list(
      [sums, ids, mr, kf, log_eps](int i) {
        return epik::correct(sums[ids[i]], mr, kf, log_eps);
      },
      ids, n, B, K, mr, kf, log_eps, scratch, out + r * (2LL * K + 3));
}

// Threads of a block: one per column group of four cells up to 1,024, else
// 512 looping over the groups; whole warps (the finish's shuffles and ballots
// need them).
int gather_threads(int bw4) {
  const int t = bw4 <= 1024 ? bw4 : 512;
  return (t + 31) / 32 * 32;
}

// Dynamic shared memory of a rowgather_sum_topk launch (see the header).
size_t topk_smem(int bw, int B, int K) {
  return static_cast<size_t>(bw) * sizeof(float) +
         (static_cast<size_t>((B + 31) / 32) + (B + 1) / 2) * sizeof(int) +
         epik::cand_bytes(gather_threads(bw / 4), K);
}

template <class T>
long long topk_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, rowgather_sum_topk_kernel<T>) != cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

template <class T>
int launch_sum(const void* plane, const void* rows, void* out, int R, int W, int bw,
               float scale, cudaStream_t stream) {
  const int bw4 = bw / 4;
  if (R > 0 && bw4 > 0) {
    rowgather_sum_kernel<T><<<R, gather_threads(bw4), 0, stream>>>(
        static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
        static_cast<float4*>(out), W, bw4, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_counts(const void* plane, const void* rows, void* S, void* C, int R, int W, int bw,
                  cudaStream_t stream) {
  const int bw4 = bw / 4;
  if (R > 0 && bw4 > 0) {
    rowgather_sum_counts_kernel<T><<<R, gather_threads(bw4), 0, stream>>>(
        static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
        static_cast<float4*>(S), static_cast<int4*>(C), W, bw4);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_topk(const void* plane, const void* rows, const void* m, const void* slot,
                const void* delta, void* out, int R, int W, int bw, int B, int K, int k,
                float log_eps, float scale, cudaStream_t stream) {
  if (B > (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);  // 16-bit ids
  const int bw4 = bw / 4;
  const int threads = gather_threads(bw4);
  const size_t smem = topk_smem(bw, B, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowgather_sum_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (R > 0 && bw4 > 0) {
    rowgather_sum_topk_kernel<T><<<R, threads, smem, stream>>>(
        static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
        static_cast<const float*>(m), static_cast<const int32_t*>(slot),
        static_cast<const float*>(delta), static_cast<float*>(out), W, bw4, B, K,
        static_cast<float>(k), log_eps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plane: (n_rows, bw) cells of type `cell` (kF32 or kI16), bw % 4 == 0, rows
// 16-byte aligned; rows: int32 (R, W); out: f32 (R, bw), an int16 plane's sums
// divided by `scale`. Launches on `stream`; returns cudaGetLastError().
extern "C" int epik_rowgather_sum(const void* plane, int cell, const void* rows, void* out,
                                  int R, int W, int bw, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == kF32) return launch_sum<float>(plane, rows, out, R, W, bw, scale, s);
  if (cell == kI16) return launch_sum<int16_t>(plane, rows, out, R, W, bw, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// plane: (n_rows, bw) cells of type `cell` (kF32 or kBf16), as above; rows:
// int32 (R, W); S: f32 (R, bw); C: int32 (R, bw). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int epik_rowgather_sum_counts(const void* plane, int cell, const void* rows,
                                         void* S, void* C, int R, int W, int bw,
                                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == kF32) return launch_counts<float>(plane, rows, S, C, R, W, bw, s);
  if (cell == kBf16) return launch_counts<Bf16>(plane, rows, S, C, R, W, bw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// plane: (n_rows, bw) cells of type `cell` (kF32 or kI16), as above; rows:
// int32 (R, W); m: f32 (R,) window counts; slot: int32 (R,), the read's row of
// `delta` or -1, or null; delta: f32 (A, B); out: f32 (R, 2K+3). B <= bw,
// B <= 2^16, 1 <= K <= min(64, B), and epik_rowgather_sum_topk_smem(bw, B, K)
// <= epik_rowgather_sum_topk_smem_limit(cell). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_topk(const void* plane, int cell, const void* rows,
                                       const void* m, const void* slot, const void* delta,
                                       void* out, int R, int W, int bw, int B, int K, int k,
                                       float log_eps, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == kF32) {
    return launch_topk<float>(plane, rows, m, slot, delta, out, R, W, bw, B, K, k, log_eps,
                              scale, s);
  }
  if (cell == kI16) {
    return launch_topk<int16_t>(plane, rows, m, slot, delta, out, R, W, bw, B, K, k, log_eps,
                                scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a rowgather_sum_topk launch at (bw, B, K) asks.
extern "C" long long epik_rowgather_sum_topk_smem(int bw, int B, int K) {
  return static_cast<long long>(topk_smem(bw, B, K));
}

// Bytes of dynamic shared memory a rowgather_sum_topk block may take on the
// current device: the opt-in limit less the kernel's static shared memory.
// Negative: minus a CUDA error code.
extern "C" long long epik_rowgather_sum_topk_smem_limit(int cell) {
  if (cell == kF32) return topk_smem_limit<float>();
  if (cell == kI16) return topk_smem_limit<int16_t>();
  return -static_cast<long long>(cudaErrorInvalidValue);
}

extern "C" const char* epik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
