// A layout of kernel #5's row-pointer form (epik_accumulate_sums_csr of
// epik_tpu_torch/kernels/csrc/accumulate_sums.cu) that the port does not
// ship: kernel_sweep.py builds it and times it against the shipped block.
//
// It is the owner-warp block of the (R, PP) forms given a row pointer (each
// warp owns the branches j = w mod kWarps of the tile and drains its queue of
// the chunk's cells in cell order; the sums bit-equal to the plain version,
// no float atomics), laid out for overlap:
// * each read's branch range is cut into n_tiles tiles (2-4 of 40-80 KB of
//   sums and counts at B = 19,999), so that several blocks share an SM
//   (8 warps: 4 blocks an SM at 4 tiles, 2 at 2) and one block's zero fill,
//   barriers and write-out overlap another's loads;
// * each block walks all of its read's cells and keeps its own tile's: the
//   read's other tiles find the cells in L2, and with `cluster` the tiles of
//   one read are one thread block cluster, so they run at the same time;
// * with `bulk`, the tile's sums and counts leave shared memory by
//   cp.async.bulk (one thread, 16-byte aligned runs; the scalar head and tail
//   as before), so the block does not wait on its own stores.
// n_tiles 1, 32 warps, no cluster and no bulk copy is the layout the row-pointer
// form had before the sorted block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -o tiles.so accumulate_sums_tiles.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRounds = 4;  // rounds of 32 cells per warp and chunk

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

template <int kWarps>
size_t smem_bytes(int tile_w) {
  const size_t tile = static_cast<size_t>(((tile_w + 3) & ~3) + 4) * 4;
  return 2 * tile + static_cast<size_t>(kWarps * 32 * kRounds) * 8 +
         static_cast<size_t>(kWarps * kWarps + kWarps) * 4;
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))), "r"(bytes)
               : "memory");
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    tiles_kernel(const int32_t* __restrict__ b, const float* __restrict__ s,
                 const long long* __restrict__ ptr, float* __restrict__ S,
                 int32_t* __restrict__ C, int B, int tile_w, int n_tiles, int bulk) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kChunk = kWarps * 32 * kRounds;
  extern __shared__ float4 smem[];
  const int tile4 = ((tile_w + 3) & ~3) + 4;
  float* sum_base = reinterpret_cast<float*>(smem);
  int* cnt_base = reinterpret_cast<int*>(sum_base + tile4);
  int* qj = cnt_base + tile4;
  float* qv = reinterpret_cast<float*>(qj + kChunk);
  int* hist = reinterpret_cast<int*>(qv + kChunk);  // [warp][owner]
  int* tot = hist + kWarps * kWarps;                // [owner]

  const long long r = blockIdx.x / n_tiles;
  const int lo = static_cast<int>(blockIdx.x - r * n_tiles) * tile_w;
  const int n = min(B - lo, tile_w);
  const long long out0 = r * B + lo;
  const int shift = static_cast<int>(out0 & 3);
  float* ssum = sum_base + shift;
  int* scnt = cnt_base + shift;
  for (int i = threadIdx.x; i < tile4 / 4; i += kThreads) {
    smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<int4*>(cnt_base)[i] = make_int4(0, 0, 0, 0);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long c_begin = ptr[r];
  const int len = static_cast<int>(ptr[r + 1] - c_begin);
  const int32_t* brow = b + c_begin;
  const float* srow = s + c_begin;
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    // 1. load, drop, rank among the slice's cells of the same owner
    if (lane < kWarps) hist[warp * kWarps + lane] = 0;
    __syncwarp();
    const int cw = c0 + warp * 32 * kRounds + lane;
    int jv[kRounds];
    float vv[kRounds];
    int rk[kRounds];
#pragma unroll
    for (int v = 0; v < kRounds; ++v) {
      const int c = cw + v * 32;
      jv[v] = c < len ? __ldg(brow + c) - lo : -1;
      if (static_cast<unsigned>(jv[v]) >= static_cast<unsigned>(n)) jv[v] = -1;
    }
#pragma unroll
    for (int v = 0; v < kRounds; ++v) vv[v] = jv[v] >= 0 ? __ldg(srow + cw + v * 32) : 0.f;
    bool kept_any = false;
#pragma unroll
    for (int v = 0; v < kRounds; ++v) {
      const bool kept = jv[v] >= 0;
      rk[v] = 0;
      if (__ballot_sync(0xffffffffu, kept) == 0u) continue;
      kept_any = true;
      const int o = jv[v] & (kWarps - 1);
      const unsigned key = kept ? static_cast<unsigned>(o) : 0x80000000u | lane;
      const unsigned grp = __match_any_sync(0xffffffffu, key);
      int* h = hist + warp * kWarps + o;
      if (kept) rk[v] = *h + __popc(grp & below);
      __syncwarp();
      if (kept && lane == __ffs(grp) - 1) *h += __popc(grp);
      __syncwarp();
    }
    if (!__syncthreads_or(kept_any)) continue;

    // 2. warp o scans owner o's counts over the warps: offsets, total
    {
      const int x = lane < kWarps ? hist[lane * kWarps + warp] : 0;
      const int incl = warp_inclusive_scan(x, lane);
      if (lane < kWarps) hist[lane * kWarps + warp] = incl - x;
      if (lane == 31) tot[warp] = incl;
    }
    __syncthreads();

    // 3. the stable partition into the owners' queues
    const int cnt = lane < kWarps ? tot[lane] : 0;
    const int qbase = warp_inclusive_scan(cnt, lane) - cnt;
    const int start = lane < kWarps ? qbase + hist[warp * kWarps + lane] : 0;
#pragma unroll
    for (int v = 0; v < kRounds; ++v) {
      const int at = __shfl_sync(0xffffffffu, start, jv[v] >= 0 ? jv[v] & (kWarps - 1) : 0);
      if (jv[v] >= 0) {
        qj[at + rk[v]] = jv[v];
        qv[at + rk[v]] = vv[v];
      }
    }
    const int q0 = __shfl_sync(0xffffffffu, qbase, warp);
    const int qn = __shfl_sync(0xffffffffu, cnt, warp);
    __syncthreads();

    // 4. each warp drains its own queue, in cell order
    for (int i = 0; i < qn; i += 32) {
      const bool has = i + lane < qn;
      const int j = has ? qj[q0 + i + lane] : -1;
      const unsigned key = has ? static_cast<unsigned>(j) : 0x80000000u | lane;
      const unsigned grp = __match_any_sync(0xffffffffu, key);
      if (has && lane == __ffs(grp) - 1) {
        float acc = ssum[j];
        for (unsigned g = grp; g != 0u; g &= g - 1u) acc = __fadd_rn(acc, qv[q0 + i + __ffs(g) - 1]);
        ssum[j] = acc;
        scnt[j] += __popc(grp);
      }
      __syncwarp();
    }
  }

  // write-out: scalars up to a 16-byte boundary of S, then 16-byte runs
  float* Srow = S + out0;
  int32_t* Crow = C + out0;
  const int head = min(n, (4 - shift) & 3);
  const int n4 = (n - head) >> 2;
  if (bulk) {
    // the generic proxy's shared-memory writes, seen by the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  for (int j = threadIdx.x; j < head; j += kThreads) {
    Srow[j] = ssum[j];
    Crow[j] = scnt[j];
  }
  for (int j = head + 4 * n4 + threadIdx.x; j < n; j += kThreads) {
    Srow[j] = ssum[j];
    Crow[j] = scnt[j];
  }
  if (bulk) {
    if (threadIdx.x == 0 && n4 > 0) {
      bulk_store(Srow + head, ssum + head, 16u * n4);
      bulk_store(Crow + head, scnt + head, 16u * n4);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // shared memory stays the block's until the copies have read it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    return;
  }
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    reinterpret_cast<float4*>(Srow + head)[i] = reinterpret_cast<const float4*>(ssum + head)[i];
    reinterpret_cast<int4*>(Crow + head)[i] = reinterpret_cast<const int4*>(scnt + head)[i];
  }
}

template <int kWarps>
cudaError_t launch(const void* b, const void* s, const void* ptr, void* S, void* C, int R,
                   int B, int n_tiles, int cluster, int bulk, cudaStream_t stream) {
  const auto kernel = tiles_kernel<kWarps>;
  const int tile_w = (B + n_tiles - 1) / n_tiles;
  const int nt = (B + tile_w - 1) / tile_w;  // n_tiles, or fewer where B is small
  const size_t smem = smem_bytes<kWarps>(tile_w);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(R) * nt));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nt);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(b),
                            static_cast<const float*>(s), static_cast<const long long*>(ptr),
                            static_cast<float*>(S), static_cast<int32_t*>(C), B, tile_w, nt,
                            bulk);
}

}  // namespace

// The arguments of epik_accumulate_sums_csr, then the layout: n_tiles tiles
// of equal width (the last ragged), `warps` owner warps a block (8, 16 or
// 32), `cluster` nonzero for one cluster of n_tiles blocks a read (n_tiles
// <= 8), `bulk` nonzero for the cp.async.bulk write-out. Returns a
// cudaError_t.
extern "C" int epik_accumulate_sums_csr_tiles(const void* b, const void* s, const void* ptr,
                                              void* S, void* C, int R, int B, int n_tiles,
                                              int warps, int cluster, int bulk, void* stream) {
  if (R <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  if (n_tiles < 1 || n_tiles > B || (cluster && n_tiles > 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (warps) {
    case 8: err = launch<8>(b, s, ptr, S, C, R, B, n_tiles, cluster, bulk, st); break;
    case 16: err = launch<16>(b, s, ptr, S, C, R, B, n_tiles, cluster, bulk, st); break;
    case 32: err = launch<32>(b, s, ptr, S, C, R, B, n_tiles, cluster, bulk, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
