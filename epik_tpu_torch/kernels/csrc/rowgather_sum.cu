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
// Design of the fused kernels (the slice layout of epik_rowgather_sum and
// epik_rowgather_sum_counts follows the list of entry points): one block per
// read. The block stages its row offsets (int64, so
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
// * epik_rowgather_sum (f32, int16): the (R, bw) f32 sums, in the slice
//   layout (below);
// * epik_rowgather_sum_counts (f32, bf16): the classic plane's sums S and the
//   exact counts C of the cells != 0 (dense_sums_from_rows, placer.py:757), as
//   f32 and int32 (R, bw), in the slice layout;
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
// * epik_rowgather_sum_counts_topk (f32, bf16): the same for the classic plane,
//   what the classic dense steps compute end to end (dense_sums_from_rows,
//   then _apply_amb(shifted=False), finish_scores with _lwr_topk and the body
//   of _pack_outputs, placer.py:757, :814, :464, :1461), so neither S nor C
//   reaches HBM, in the group layout (below):
//   - the window-order sums S and the exact counts C of each read go to
//     shared memory (bw f32 + bw int32 a read), by the slice gather of
//     epik_rowgather_sum_counts (S bit-equal, C exact);
//   - a read with an ambiguous first hit adds it there: S[b] = S[b] + dS[b]
//     (one __fadd_rn) and C[b] += hit[b], the adds of ops/dense.py::
//     amb_classic;
//   - a warp ballot of C > 0 (not S > 0: a classic sum can be negative, and
//     the plane's 1e-37 nudges mark presence), the compaction into 16-bit ids
//     and finish_row.cuh's list finish with the count-aware correction
//     (correct_counts: m - C wrapped to 2^64 where negative, quirk Q1) write
//     the read's full (4K+2) row [scores | wr | idx | counts | n | zero_sum],
//     counts = C[idx], 0 in the slots past n.
//   Past the group layout's limit (B near 22,000 at bw ~ B, or past B =
//   2^16) the step runs epik_rowgather_sum_counts + epik_finish_topk_counts
//   (the same bits). Bound on the H100: the distinct plane rows, the row ids,
//   m, the ambiguous rows and the pack (no S/C write).
// * epik_rowgather_sum_cols (f32, the shifted sums): one model shard of a
//   column-sharded dense step (epik_tpu/parallel/sharding.py::
//   _sharded_dense_*_step: dense_sums_shifted over the shard's bwl columns,
//   _apply_amb, then the shard's half of finish_scores_cols_shifted +
//   _lwr_topk_cols), so the shard's (R, bwl) sums never reach HBM:
//   - the same gather and delta add as epik_rowgather_sum_topk, at B = bwl;
//   - finish_cols.cu's finish over the read's touched columns (Sp > 0),
//     through finish_row.cuh's cols_list: the read's partial pack row
//     [values Kl | global ids Kl | n_s | max_s | e_s] with e_s against the
//     shard's own max_s.
//   Shared memory: the layout of rowgather_sum_topk at B = bwl (about 9 KB at
//   D652's bwl 1,408, 123 KB at config 4's bwl 20,096), so bwl near 37,000 at
//   most: epik_rowgather_sum_cols_smem and _smem_limit state it, and past it
//   the sharded step runs the gather, the same add and finish_cols.cu's
//   launch apart (the same bits but e_s's order of adds). Bound on the H100:
//   the distinct plane rows, the row ids, m, the delta rows and the partial
//   pack (no (R, bwl) write), as for the fused kernels at the same shape.
// * epik_rowgather_sum_counts_cols (f32, the classic sums with counts): the
//   same shard over its classic plane (dense_sums_from_rows, S + dS, C +
//   hit, finish_scores_cols :321), in the group layout: the counts epilogue
//   of epik_rowgather_sum_counts_topk at B = bwl with cols_list's finish
//   (touched C > 0, correct_counts) into the partial pack and the
//   candidates' counts (int32 (R, Kl)); past the layout's limit (bwl near
//   22,000) the shard runs epik_rowgather_sum_counts, the adds and
//   finish_cols.cu's counts form apart.
//
// The group layout (epik_rowgather_sum_counts_topk and
// epik_rowgather_sum_counts_cols: one kernel template,
// rowgather_counts_group_kernel). The one-block-a-read kernel that it
// replaced streamed whole rows, 352 threads x one float4, in read order, so
// every slot read its row at the HBM rate: 3.71-3.92 ms at D652 in f32
// (2.34 M slots x 5,632 B = 13.2 GB) on an H100, slower than the slice
// gather 1c and the finish apart. A block now takes G consecutive reads of
// the locality order and walks 256-byte column slices one after another, 16
// threads a (read, slice) pair, slice-major, so that the reads of a group
// that share rows fetch them from L1/L2: each (read, column) is added in
// window order by one thread in registers, as in the slice layout, and the
// slice's S and C go to the block's shared memory (G x bw x 8 bytes). The
// group's row ids are staged once for all slices, kGroupRowIds / G windows a
// read a tile (a read longer than that carries its S and C over tiles in
// shared memory: an f32 reload adds no rounding). After the last slice the
// block adds each read's first hit, and each warp finishes one read of the
// group (finish_row.cuh's warp finish: no block barrier, the same scores,
// ids and counts as the list finish; the exp-sums add in another order), so
// the G finishes run side by side; at G = 1 (the widest trees) the whole
// block runs the list finish. Shared memory: G x bw sums and counts + the
// row-id tile + ceil(B / 32) mask words + B 16-bit ids + the candidates
// (epik_rowgather_counts_group_smem). The wrapper chooses G: the largest up
// to its maximum of which EPIK_GROUP_MIN_BLOCKS blocks fit an SM, down to G =
// 1 at the widest trees, whose block is the one-block-a-read kernel's bytes
// but its candidates (B ~ 22,000 at bw ~ B, the same limit). The kernel's
// register budget names those blocks an SM, so that each thread's
// kGroupUnroll loads in flight fit and the other blocks' gathers hide one
// block's finishes. On an H100 at D652 (kernel_sweep.py): G = 4 at 3 blocks
// an SM with 16 loads in flight a thread, 2.66 ms in f32 and 1.51 ms in bf16
// against 2.76 and 1.53 for G = 8 at 2, 3.84 for the same layout in read
// order; 8 loads in flight, 2.59 and 1.49 (the L2, not the latency, bounds
// it); finishing the reads in turn with the whole block took 3.09 and 1.92
// (G = 8).

// The slice layout (epik_rowgather_sum_counts and epik_rowgather_sum: one
// kernel template, rowgather_slices_kernel). One block per read walking the
// whole row read every slot's row from HBM: at D652's classic rows (16,381 x
// 143, bw 1,408) 2.34 M slots x 5,632 B = 13.2 GB, 3.9 ms at 3.35 TB/s,
// where the 404,344 distinct rows are 2.3 GB: each row came from HBM about
// 5.8 times. Two changes move the repeats to the 50 MB L2:
// * read order: the wrapper sorts the reads, stably, by their least row id
//   (a miss is the zero row, the plane's last). Two reads that overlap on the
//   reference by all but d of their W windows share it with probability
//   about (W - d) / (W + d), so the reads of one key sit in one or two
//   neighbouring blocks. Block g gathers reads perm[16 g .. 16 g + 15] and
//   writes their own rows of S and C, so the outputs stay in read order;
// * column slices, slice outermost: block (s, g), s the slower index, adds
//   only the slice's 256 bytes of each row (64 f32 or 128 bf16 columns; 64
//   of a bf16 plane whose width is not a multiple of 8), 16 threads a read,
//   one 16-byte load each. A slice's pass touches 404,344 x 256 B = 104 MB at
//   D652 (207 MB at 512 B, 2.3 GB for whole rows) against the 50 MB L2; the
//   resident blocks (8 of 256 threads an SM, 1,056 on 132 SMs) ask 1,056 x
//   16 x 256 B = 4.3 MB a window step, so a key's reads fetch the rows they
//   share once, and the rows that reads of different keys share come back
//   from L2 as long as the pass' recent footprint fits it. 128-byte slices
//   (52 MB a pass) fit the L2 better but pay twice the passes over the row
//   ids and measured slower on the H100.
// Each slot still moves its slice from L2 to the SM: 13.2 GB at D652 in f32,
// 6.6 GB in bf16. With the repeats out of HBM, that L2 traffic bounds the
// kernel, well above the HBM bound of the distinct rows.
// At the wide shifted tree (283,494 distinct rows of 160,256 B a batch of
// 4,096 reads: 73 MB a 256-byte slice's pass, past the L2) the same layout
// gives the gather alone its locality: on an H100, 20.1 ms in f32 against
// 21.7 in read order. Skewing each read's windows so that the reads of one
// key name their shared rows at one step measured slower (23.5 ms; the
// skewed loop compiled to 50 registers against 88, fewer loads in flight).
// A block stages its reads' row ids a tile of 128 windows at a time (8 KB);
// each thread keeps 16 of its loads in flight, which takes ~90 registers
// (two blocks an SM): the kernel names a minimum of EPIK_SLICE_MIN_BLOCKS
// (1) blocks an SM, so ptxas may spend them. On an H100 the wide tree's f32
// gather alone took 20.1 ms so, 25.9 capped at 32 registers for 8 blocks an
// SM. The sums stay bit-equal to
// the plain version: each (read, column) is added in window order by one
// thread, with no FMA and no atomics.
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
  using scalar = float;
};
template <>
struct Acc<int16_t> {
  using type = int4;
  using scalar = int;
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

// The slice layout's block (epik_rowgather_sum and epik_rowgather_sum_counts):
// kSliceReads reads of the locality order by kSliceLanes threads, each
// thread one vector of V cells (16 bytes, or 8 for a bf16 or int16 plane of
// a width that is not a multiple of 8) of the slice. The macros let
// kernel_sweep.py build other slice widths.
#ifndef EPIK_SLICE_LANES
#define EPIK_SLICE_LANES 16
#endif
#ifndef EPIK_SLICE_READS
#define EPIK_SLICE_READS 16
#endif
#ifndef EPIK_SLICE_MIN_BLOCKS
#define EPIK_SLICE_MIN_BLOCKS 1
#endif

constexpr int kSliceLanes = EPIK_SLICE_LANES;
constexpr int kSliceReads = EPIK_SLICE_READS;
constexpr int kSliceTileW = 128;  // steps of row ids staged a tile

// V cells of a row starting at cell `i` (a multiple of V), as their addends:
// f32 and bf16 widened to f32, int16 to int32
__device__ __forceinline__ void load_vec(const float* p, long long i, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const Bf16* p, long long i, float (&v)[4]) {
  const float4 x = load4(p, i >> 2);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const Bf16* p, long long i, float (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(u[e] << 16);
    v[2 * e + 1] = __uint_as_float(u[e] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load_vec(const int16_t* p, long long i, int (&v)[4]) {
  const int4 x = load4(p, i >> 2);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const int16_t* p, long long i, int (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = static_cast<int16_t>(u[e] & 0xFFFFu);
    v[2 * e + 1] = static_cast<int16_t>(u[e] >> 16);
  }
}

// One sum as f32: as it is, or an int16 plane's dequantized (as_sums' rule)
__device__ __forceinline__ float as_sum(float a, float) { return a; }
__device__ __forceinline__ float as_sum(int a, float scale) {
  return __fdiv_rn(__int2float_rn(a), scale);
}

// The slice layout. Block (s, g), s the slower index, gathers slice s of the
// reads perm[kSliceReads g ..] (read order where perm is null) and writes their
// own rows of S (and with kCounts of C); each read adds its windows in window
// order, so its sums keep their bits whatever the order of the reads.
template <class T, int V, bool kCounts>
__global__ void __launch_bounds__(kSliceReads * kSliceLanes, EPIK_SLICE_MIN_BLOCKS)
    rowgather_slices_kernel(const T* __restrict__ plane, const int32_t* __restrict__ rows,
                            const int32_t* __restrict__ perm, float* __restrict__ S,
                            int* __restrict__ C, int R, int W, int bw, int n_groups,
                            float scale) {
  using A = typename Acc<T>::scalar;
  __shared__ int32_t srow[kSliceReads * kSliceTileW];
  __shared__ int32_t sread[kSliceReads];
  const int slice = blockIdx.x / n_groups;
  const int r0 = (blockIdx.x - slice * n_groups) * kSliceReads;
  const int nr = min(kSliceReads, R - r0);
  const int j = threadIdx.x / kSliceLanes;
  const int col = (slice * kSliceLanes + threadIdx.x % kSliceLanes) * V;
  const bool active = j < nr && col < bw;
  if (threadIdx.x < nr) {
    sread[threadIdx.x] = perm != nullptr ? perm[r0 + threadIdx.x] : r0 + threadIdx.x;
  }
  __syncthreads();
  A acc[V];
  int cnt[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc[e] = 0;
    cnt[e] = 0;
  }
  const int32_t* my = srow + j * kSliceTileW;
  for (int w0 = 0; w0 < W; w0 += kSliceTileW) {
    const int nw = min(kSliceTileW, W - w0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < nr * nw; i += blockDim.x) {
      const int jj = i / nw;
      srow[jj * kSliceTileW + i - jj * nw] =
          rows[static_cast<long long>(sread[jj]) * W + w0 + i - jj * nw];
    }
    __syncthreads();
    if (active) {
#pragma unroll 16
      for (int i = 0; i < nw; ++i) {
        A v[V];
        load_vec(plane, static_cast<long long>(my[i]) * bw + col, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[e] += v[e];
          if constexpr (kCounts) cnt[e] += v[e] != 0;
        }
      }
    }
  }
  if (active) {
    const long long o = static_cast<long long>(sread[j]) * bw + col;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(S + o + e) =
          make_float4(as_sum(acc[e], scale), as_sum(acc[e + 1], scale),
                      as_sum(acc[e + 2], scale), as_sum(acc[e + 3], scale));
      if constexpr (kCounts) {
        *reinterpret_cast<int4*>(C + o + e) =
            make_int4(cnt[e], cnt[e + 1], cnt[e + 2], cnt[e + 3]);
      }
    }
  }
}

// The group layout's block (rowgather_counts_group_kernel): kGroupThreads
// threads, 16 a (read, slice) pair, with a register budget of
// EPIK_GROUP_MIN_BLOCKS blocks an SM; kGroupRowIds row ids staged a tile,
// shared by the group's G reads; G at most kMaxGroup. The macros let
// kernel_sweep.py build other blocks; kernels/rowgather.py states the same
// numbers (GROUP_THREADS, GROUP_ROW_IDS, GROUP_MIN_BLOCKS) for its choice of
// G.
#ifndef EPIK_GROUP_THREADS
#define EPIK_GROUP_THREADS 256
#endif
#ifndef EPIK_GROUP_MIN_BLOCKS
#define EPIK_GROUP_MIN_BLOCKS 3
#endif
#ifndef EPIK_GROUP_UNROLL
#define EPIK_GROUP_UNROLL 8
#endif

constexpr int kGroupThreads = EPIK_GROUP_THREADS;
constexpr int kGroupUnroll = EPIK_GROUP_UNROLL;  // loads in flight a thread
constexpr int kGroupLanes = 16;
constexpr int kGroupRowIds = 2048;
constexpr int kMaxGroup = 32;

// Dynamic shared memory of a group-layout block of G reads at (bw, B, K):
// G x bw sums and counts | the row-id tile | ceil(B / 32) mask words | B
// 16-bit ids (padded to 4 bytes) | the candidates.
size_t group_smem(int G, int bw, int B, int K) {
  return (2 * static_cast<size_t>(G) * bw + kGroupRowIds + (B + 31) / 32 + (B + 1) / 2) *
             sizeof(int) +
         epik::cand_bytes(kGroupThreads, K);
}

// G consecutive reads of the order `perm` a block: the classic plane's sums S
// and counts C of each read in shared memory (each (read, column) added in
// window order by one thread), the first hits added, then each read's finish
// in turn: kCols, the shard's column finish into its partial pack row and
// candidate counts; else the full pack's body row. B <= bw columns finish.
template <class T, int V, bool kCols>
__global__ void __launch_bounds__(kGroupThreads, EPIK_GROUP_MIN_BLOCKS)
    rowgather_counts_group_kernel(const T* __restrict__ plane, const int32_t* __restrict__ rows,
                                  const int32_t* __restrict__ perm, const float* __restrict__ m,
                                  const int32_t* __restrict__ slot,
                                  const float* __restrict__ dS, const uint8_t* __restrict__ hit,
                                  float* __restrict__ out, int* __restrict__ cnt_out, int R,
                                  int W, int bw, int B, int K, int G, int col0, float kf,
                                  float log_eps) {
  extern __shared__ float4 group_smem4[];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  __shared__ int32_t sread[kMaxGroup];
  float* S = reinterpret_cast<float*>(group_smem4);
  int* Cn = reinterpret_cast<int*>(S + static_cast<long long>(G) * bw);
  int32_t* srow = Cn + static_cast<long long>(G) * bw;
  unsigned* mask = reinterpret_cast<unsigned*>(srow + kGroupRowIds);
  const int nwords = (B + 31) >> 5;
  uint16_t* ids = reinterpret_cast<uint16_t*>(mask + nwords);
  float* cand_v = reinterpret_cast<float*>(mask + nwords + (B + 1) / 2);
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (kGroupThreads >> 5) * K};
  const int r0 = blockIdx.x * G;
  const int nr = min(G, R - r0);
  if (threadIdx.x < nr) sread[threadIdx.x] = perm[r0 + threadIdx.x];

  // ---- the gather: (read, slice) pairs slice-major, 16 threads a pair -------
  constexpr int kPairs = kGroupThreads / kGroupLanes;
  const int q = threadIdx.x / kGroupLanes;
  const int lane = threadIdx.x % kGroupLanes;
  const int n_pairs = nr * ((bw + kGroupLanes * V - 1) / (kGroupLanes * V));
  const int tw = kGroupRowIds / G;  // windows a read a tile
  for (int w0 = 0; w0 < W; w0 += tw) {
    const int nw = min(tw, W - w0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < nr * nw; i += kGroupThreads) {
      const int j = i / nw;
      srow[j * tw + i - j * nw] = rows[static_cast<long long>(sread[j]) * W + w0 + i - j * nw];
    }
    __syncthreads();
    for (int p = q; p < n_pairs; p += kPairs) {
      const int s = p / nr;
      const int j = p - s * nr;
      const int col = (s * kGroupLanes + lane) * V;
      if (col >= bw) continue;
      float* sj = S + j * bw + col;
      int* cj = Cn + j * bw + col;
      float acc[V];
      int cnt[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e] = w0 == 0 ? 0.f : sj[e];
        cnt[e] = w0 == 0 ? 0 : cj[e];
      }
      const int32_t* my = srow + j * tw;
#pragma unroll(kGroupUnroll)
      for (int i = 0; i < nw; ++i) {
        float v[V];
        load_vec(plane, static_cast<long long>(my[i]) * bw + col, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[e] += v[e];
          cnt[e] += v[e] != 0.f;
        }
      }
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        *reinterpret_cast<float4*>(sj + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        *reinterpret_cast<int4*>(cj + e) = make_int4(cnt[e], cnt[e + 1], cnt[e + 2], cnt[e + 3]);
      }
    }
  }
  if (W == 0) {  // no window: every sum and count is 0
    for (int i = threadIdx.x; i < nr * bw; i += kGroupThreads) {
      S[i] = 0.f;
      Cn[i] = 0;
    }
  }
  __syncthreads();

  // ---- the first hits: S + dS (one __fadd_rn), C + hit ---------------------
  if (slot != nullptr) {
    for (int j = 0; j < nr; ++j) {
      const int a = slot[sread[j]];
      if (a < 0) continue;
      const float* drow = dS + static_cast<long long>(a) * B;
      const uint8_t* hrow = hit + static_cast<long long>(a) * B;
      for (int b = threadIdx.x; b < B; b += kGroupThreads) {
        S[j * bw + b] = __fadd_rn(S[j * bw + b], drow[b]);
        Cn[j * bw + b] += hrow[b];
      }
    }
    __syncthreads();
  }

  // ---- the finishes, each read into its own row -----------------------------
  if (G == 1) {  // the widest trees: the whole block finishes the one read
    const long long r = sread[0];
    const float mr = m[r];
    epik::build_mask([Cn](int b) { return Cn[b] > 0; }, B, mask);
    const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
    const auto corr = [S, Cn, ids, mr, kf, log_eps](int i) {
      return epik::correct_counts(S[ids[i]], Cn[ids[i]], mr, kf, log_eps);
    };
    const auto count = [Cn](int b) { return Cn[b]; };
    if constexpr (kCols) {
      epik::cols_list(corr, ids, n, K, col0, scratch, out + r * (2LL * K + 3), cnt_out + r * K,
                      count);
    } else {
      epik::finish_list(corr, ids, n, B, K, mr, kf, log_eps, scratch,
                        epik::full_row(out + r * (4LL * K + 2), K, count));
    }
    return;
  }
  // a warp a read, its scores corrected in place first (each lane its own
  // branches)
  const int lane32 = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < nr; j += kGroupThreads >> 5) {
    const long long r = sread[j];
    float* sums = S + j * bw;
    const int* cnts = Cn + j * bw;
    const float mr = m[r];
    for (int b = lane32; b < B; b += 32) {
      if (cnts[b] > 0) sums[b] = epik::correct_counts(sums[b], cnts[b], mr, kf, log_eps);
    }
    const auto touched = [cnts](int b) { return cnts[b] > 0; };
    const auto corr = [sums](int b) { return sums[b]; };
    const auto count = [cnts](int b) { return cnts[b]; };
    if constexpr (kCols) {
      epik::warp_cols(touched, corr, B, K, col0, out + r * (2LL * K + 3), cnt_out + r * K,
                      count);
    } else {
      epik::warp_finish(touched, corr, B, K, mr, kf, log_eps,
                        epik::full_row(out + r * (4LL * K + 2), K, count));
    }
  }
}

// The shared memory of a fused kernel's block: bw sums | bw counts (kCounts)
// | mask words | ids (B, 16 bits, padded to 4 bytes) | candidates.
template <bool kCounts>
struct FusedSmem {
  float4* sums4;
  int4* cnts4;
  unsigned* mask;
  uint16_t* ids;
  epik::FinishScratch scratch;
  __device__ FusedSmem(float4* base, int bw4, int B, int K, float* red_f) {
    const int nwords = (B + 31) >> 5;
    sums4 = base;
    cnts4 = reinterpret_cast<int4*>(base + bw4);
    mask = reinterpret_cast<unsigned*>(reinterpret_cast<float*>(base) + (kCounts ? 8 : 4) * bw4);
    ids = reinterpret_cast<uint16_t*>(mask + nwords);
    float* cand_v = reinterpret_cast<float*>(mask + nwords + (B + 1) / 2);
    scratch = {red_f, cand_v, reinterpret_cast<int*>(cand_v) + (blockDim.x >> 5) * K};
  }
};

// Read r's sums (an int16 plane's dequantized) and, kCounts, its counts into
// the block's shared memory, in window order; then the read's ambiguous first
// hit, if `slot` gives it one: the delta row added with one __fadd_rn per
// branch b < B (and, kCounts, `hit` added to the counts). Every thread of the
// block must call it; ends synchronised.
template <bool kCounts, class T>
__device__ void stage_read(const T* __restrict__ plane, const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ slot, const float* __restrict__ delta,
                           const uint8_t* __restrict__ hit, long long r, int W, int bw4, int B,
                           float scale, long long* off, float4* sums4, int4* cnts4) {
  const int32_t* rrow = rows + r * W;
  for (int c0 = 0; c0 < bw4; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    typename Acc<T>::type acc{};
    int4 cnt{};
    gather_column<kCounts>(plane, rrow, W, bw4, c, off, acc, cnt);
    if (c < bw4) {
      sums4[c] = as_sums(acc, scale);
      if constexpr (kCounts) cnts4[c] = cnt;
    }
  }
  const int a = slot != nullptr ? slot[r] : -1;
  if (a >= 0) {  // the ambiguous first hit of this read
    __syncthreads();
    float* sums = reinterpret_cast<float*>(sums4);
    const float* drow = delta + static_cast<long long>(a) * B;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      sums[b] = __fadd_rn(sums[b], drow[b]);
      if constexpr (kCounts) {
        reinterpret_cast<int*>(cnts4)[b] += hit[static_cast<long long>(a) * B + b];
      }
    }
  }
  __syncthreads();
}

// The placement finish fused after the gather. kCounts: the classic plane's
// sums and counts into the full pack's body; else the shifted sums into the
// slim pack.
template <class T, bool kCounts>
__global__ void rowgather_sum_topk_kernel(
    const T* __restrict__ plane, const int32_t* __restrict__ rows,
    const float* __restrict__ m, const int32_t* __restrict__ slot,
    const float* __restrict__ delta, const uint8_t* __restrict__ hit,
    float* __restrict__ out, int W, int bw4, int B, int K, float kf, float log_eps,
    float scale) {
  extern __shared__ float4 sums4[];
  __shared__ long long off[kTileW];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const FusedSmem<kCounts> sm(sums4, bw4, B, K, red_f);
  const int nwords = (B + 31) >> 5;
  const float* sums = reinterpret_cast<const float*>(sums4);
  const int* cnts = reinterpret_cast<const int*>(sm.cnts4);
  unsigned* mask = sm.mask;
  uint16_t* ids = sm.ids;
  const epik::FinishScratch scratch = sm.scratch;
  const long long r = blockIdx.x;
  stage_read<kCounts>(plane, rows, slot, delta, hit, r, W, bw4, B, scale, off, sums4,
                      sm.cnts4);
  const float mr = m[r];
  if constexpr (kCounts) {
    epik::build_mask([cnts](int b) { return cnts[b] > 0; }, B, mask);
    const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
    epik::finish_list(
        [sums, cnts, ids, mr, kf, log_eps](int i) {
          return epik::correct_counts(sums[ids[i]], cnts[ids[i]], mr, kf, log_eps);
        },
        ids, n, B, K, mr, kf, log_eps, scratch,
        epik::full_row(out + r * (4LL * K + 2), K, [cnts](int b) { return cnts[b]; }));
  } else {
    epik::build_mask([sums](int b) { return sums[b] > 0.f; }, B, mask);
    const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
    epik::finish_list(
        [sums, ids, mr, kf, log_eps](int i) {
          return epik::correct(sums[ids[i]], mr, kf, log_eps);
        },
        ids, n, B, K, mr, kf, log_eps, scratch, epik::SlimRow{out + r * (2LL * K + 3), K});
  }
}

// One model shard's gather, ambiguous adds and column finish, over an f32
// plane of bw = 4 bw4 columns (B = bw): the partial pack row of
// finish_row.cuh's cols_list (f32 (R, 2K+3)) and, kCounts, the candidates'
// counts (int32 (R, K)).
template <bool kCounts>
__global__ void rowgather_sum_cols_kernel(
    const float* __restrict__ plane, const int32_t* __restrict__ rows,
    const float* __restrict__ m, const int32_t* __restrict__ slot,
    const float* __restrict__ delta, const uint8_t* __restrict__ hit,
    float* __restrict__ out, int* __restrict__ cnt_out, int W, int bw4, int K, int col0,
    float kf, float log_eps) {
  extern __shared__ float4 sums4[];
  __shared__ long long off[kTileW];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  const int bw = 4 * bw4;
  const FusedSmem<kCounts> sm(sums4, bw4, bw, K, red_f);
  const int nwords = (bw + 31) >> 5;
  const float* sums = reinterpret_cast<const float*>(sums4);
  const int* cnts = reinterpret_cast<const int*>(sm.cnts4);
  uint16_t* ids = sm.ids;
  const long long r = blockIdx.x;
  stage_read<kCounts>(plane, rows, slot, delta, hit, r, W, bw4, bw, 1.f, off, sums4,
                      sm.cnts4);
  const float mr = m[r];
  float* orow = out + r * (2LL * K + 3);
  if constexpr (kCounts) {
    epik::build_mask([cnts](int b) { return cnts[b] > 0; }, bw, sm.mask);
    const int n = epik::compact_mask(sm.mask, nwords, ids, red_i, false);
    epik::cols_list(
        [sums, cnts, ids, mr, kf, log_eps](int i) {
          return epik::correct_counts(sums[ids[i]], cnts[ids[i]], mr, kf, log_eps);
        },
        ids, n, K, col0, sm.scratch, orow, cnt_out + r * K, [cnts](int b) { return cnts[b]; });
  } else {
    epik::build_mask([sums](int b) { return sums[b] > 0.f; }, bw, sm.mask);
    const int n = epik::compact_mask(sm.mask, nwords, ids, red_i, false);
    epik::cols_list(
        [sums, ids, mr, kf, log_eps](int i) {
          return epik::correct(sums[ids[i]], mr, kf, log_eps);
        },
        ids, n, K, col0, sm.scratch, orow, nullptr, [](int) { return 0; });
  }
}

// Threads of a block: one per column group of four cells up to 1,024, else
// 512 looping over the groups; whole warps (the finish's shuffles and ballots
// need them).
int gather_threads(int bw4) {
  const int t = bw4 <= 1024 ? bw4 : 512;
  return (t + 31) / 32 * 32;
}

// Dynamic shared memory of a rowgather_sum_topk launch (kCounts: of a
// rowgather_sum_counts_topk launch; see the header).
size_t topk_smem(int bw, int B, int K, bool counts) {
  return static_cast<size_t>(bw) * (counts ? 2 : 1) * sizeof(float) +
         (static_cast<size_t>((B + 31) / 32) + (B + 1) / 2) * sizeof(int) +
         epik::cand_bytes(gather_threads(bw / 4), K);
}

template <class T, bool kCounts>
long long topk_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, rowgather_sum_topk_kernel<T, kCounts>) != cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

template <bool kCounts>
long long cols_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, rowgather_sum_cols_kernel<kCounts>) != cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

template <bool kCounts>
int launch_cols(const void* plane, const void* rows, const void* m, const void* slot,
                const void* delta, const void* hit, void* out, void* cnt, int R, int W, int bw,
                int K, int col0, int k, float log_eps, cudaStream_t stream) {
  if (bw > (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);  // 16-bit ids
  const int bw4 = bw / 4;
  const size_t smem = topk_smem(bw, bw, K, kCounts);
  // always: the 8 KB of staged row offsets count against the 48 KB default
  const cudaError_t err = cudaFuncSetAttribute(rowgather_sum_cols_kernel<kCounts>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && bw4 > 0) {
    rowgather_sum_cols_kernel<kCounts><<<R, gather_threads(bw4), smem, stream>>>(
        static_cast<const float*>(plane), static_cast<const int32_t*>(rows),
        static_cast<const float*>(m), static_cast<const int32_t*>(slot),
        static_cast<const float*>(delta), static_cast<const uint8_t*>(hit),
        static_cast<float*>(out), static_cast<int*>(cnt), W, bw4, K, col0,
        static_cast<float>(k), log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// One slice-layout launch: 1c (kCounts) or 1d.
template <class T, int V, bool kCounts>
int launch_slices(const void* plane, const void* rows, const void* perm, void* S, void* C,
                  int R, int W, int bw, float scale, cudaStream_t stream) {
  if (R > 0 && bw > 0) {
    constexpr int cols = kSliceLanes * V;
    const long long n_groups = (R + kSliceReads - 1) / kSliceReads;
    const long long blocks = n_groups * ((bw + cols - 1) / cols);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    rowgather_slices_kernel<T, V, kCounts>
        <<<static_cast<unsigned>(blocks), kSliceReads * kSliceLanes, 0, stream>>>(
            static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
            static_cast<const int32_t*>(perm), static_cast<float*>(S), static_cast<int*>(C), R,
            W, bw, static_cast<int>(n_groups), scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T, int V>
int launch_counts(const void* plane, const void* rows, const void* perm, void* S, void* C, int R,
                  int W, int bw, cudaStream_t stream) {
  return launch_slices<T, V, true>(plane, rows, perm, S, C, R, W, bw, 1.f, stream);
}

template <class T, int V>
int launch_sum(const void* plane, const void* rows, const void* perm, void* out, int R, int W,
               int bw, float scale, cudaStream_t stream) {
  return launch_slices<T, V, false>(plane, rows, perm, out, nullptr, R, W, bw, scale, stream);
}

template <class T, bool kCounts>
int launch_topk(const void* plane, const void* rows, const void* m, const void* slot,
                const void* delta, const void* hit, void* out, int R, int W, int bw, int B,
                int K, int k, float log_eps, float scale, cudaStream_t stream) {
  if (B > (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);  // 16-bit ids
  const int bw4 = bw / 4;
  const int threads = gather_threads(bw4);
  const size_t smem = topk_smem(bw, B, K, kCounts);
  // always: the 48 KB a launch may take without opting in count the 8 KB of
  // staged row offsets too
  const cudaError_t err = cudaFuncSetAttribute(
      rowgather_sum_topk_kernel<T, kCounts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && bw4 > 0) {
    rowgather_sum_topk_kernel<T, kCounts><<<R, threads, smem, stream>>>(
        static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
        static_cast<const float*>(m), static_cast<const int32_t*>(slot),
        static_cast<const float*>(delta), static_cast<const uint8_t*>(hit),
        static_cast<float*>(out), W, bw4, B, K, static_cast<float>(k), log_eps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// One group-layout launch (kCols: the shard's column finish) of G reads a
// block.
template <class T, int V, bool kCols>
int launch_group(const void* plane, const void* rows, const void* perm, const void* m,
                 const void* slot, const void* dS, const void* hit, void* out, void* cnt, int R,
                 int W, int bw, int B, int K, int G, int col0, int k, float log_eps,
                 cudaStream_t stream) {
  if (B > (1 << 16) || G < 1 || G > kMaxGroup) {  // 16-bit ids; the staged read ids
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = group_smem(G, bw, B, K);
  // always: a block within 48 KB with the static bytes beside it must opt in too
  const cudaError_t err = cudaFuncSetAttribute(rowgather_counts_group_kernel<T, V, kCols>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && bw > 0) {
    rowgather_counts_group_kernel<T, V, kCols><<<(R + G - 1) / G, kGroupThreads, smem, stream>>>(
        static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(perm), static_cast<const float*>(m),
        static_cast<const int32_t*>(slot), static_cast<const float*>(dS),
        static_cast<const uint8_t*>(hit), static_cast<float*>(out), static_cast<int*>(cnt), R, W,
        bw, B, K, G, col0, static_cast<float>(k), log_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plane: (n_rows, bw) cells of type `cell` (kF32 or kI16), bw % 4 == 0, rows
// 16-byte aligned; rows: int32 (R, W); perm: int32 (R,), a permutation of the
// reads (the locality order: block g gathers reads perm[kSliceReads g ..]), or
// null for read order; out: f32 (R, bw), read r's sums in row r whatever the
// order, an int16 plane's divided by `scale`. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum(const void* plane, int cell, const void* rows,
                                  const void* perm, void* out, int R, int W, int bw, float scale,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == kF32) return launch_sum<float, 4>(plane, rows, perm, out, R, W, bw, scale, s);
  if (cell == kI16) {
    return bw % 8 == 0 ? launch_sum<int16_t, 8>(plane, rows, perm, out, R, W, bw, scale, s)
                       : launch_sum<int16_t, 4>(plane, rows, perm, out, R, W, bw, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// plane: (n_rows, bw) cells of type `cell` (kF32 or kBf16), as above; rows:
// int32 (R, W); perm: int32 (R,), a permutation of the reads (the locality
// order: block g gathers reads perm[16 g ..]); S: f32 (R, bw); C: int32
// (R, bw), read r's sums and counts in row r whatever the order. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int epik_rowgather_sum_counts(const void* plane, int cell, const void* rows,
                                         const void* perm, void* S, void* C, int R, int W,
                                         int bw, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == kF32) return launch_counts<float, 4>(plane, rows, perm, S, C, R, W, bw, s);
  if (cell == kBf16) {
    return bw % 8 == 0 ? launch_counts<Bf16, 8>(plane, rows, perm, S, C, R, W, bw, s)
                       : launch_counts<Bf16, 4>(plane, rows, perm, S, C, R, W, bw, s);
  }
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
    return launch_topk<float, false>(plane, rows, m, slot, delta, nullptr, out, R, W, bw, B,
                                     K, k, log_eps, scale, s);
  }
  if (cell == kI16) {
    return launch_topk<int16_t, false>(plane, rows, m, slot, delta, nullptr, out, R, W, bw,
                                       B, K, k, log_eps, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// plane: (n_rows, bw) cells of type `cell` (kF32 or kBf16), as above; rows:
// int32 (R, W); perm: int32 (R,), a permutation of the reads (the locality
// order: block g takes reads perm[G g .. G g + G - 1]); m: f32 (R,) window
// counts; slot: int32 (R,), the read's row of `delta` and `hit` or -1, or
// null; delta: f32 (A, B), the ambiguous first hits' contributions (0 where
// no hit); hit: uint8 (A, B), 1 where a first hit lands; out: f32 (R, 4K+2),
// the full pack's body, read r's in row r whatever the order. B <= bw, B <=
// 2^16, 1 <= K <= min(64, B), 1 <= G <= 32, and
// epik_rowgather_counts_group_smem(G, bw, B, K) <=
// epik_rowgather_counts_group_smem_limit(). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_counts_topk(const void* plane, int cell, const void* rows,
                                              const void* perm, const void* m, const void* slot,
                                              const void* delta, const void* hit, void* out,
                                              int R, int W, int bw, int B, int K, int k,
                                              float log_eps, int G, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == kF32) {
    return launch_group<float, 4, false>(plane, rows, perm, m, slot, delta, hit, out, nullptr,
                                         R, W, bw, B, K, G, 0, k, log_eps, s);
  }
  if (cell == kBf16) {
    return bw % 8 == 0
               ? launch_group<Bf16, 8, false>(plane, rows, perm, m, slot, delta, hit, out,
                                              nullptr, R, W, bw, B, K, G, 0, k, log_eps, s)
               : launch_group<Bf16, 4, false>(plane, rows, perm, m, slot, delta, hit, out,
                                              nullptr, R, W, bw, B, K, G, 0, k, log_eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a rowgather_sum_topk launch at (bw, B, K) asks.
extern "C" long long epik_rowgather_sum_topk_smem(int bw, int B, int K) {
  return static_cast<long long>(topk_smem(bw, B, K, false));
}

// Bytes of dynamic shared memory a rowgather_sum_topk block may take on the
// current device: the opt-in limit less the kernel's static shared memory.
// Negative: minus a CUDA error code.
extern "C" long long epik_rowgather_sum_topk_smem_limit(int cell) {
  if (cell == kF32) return topk_smem_limit<float, false>();
  if (cell == kI16) return topk_smem_limit<int16_t, false>();
  return -static_cast<long long>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a group-layout launch (rowgather_sum_counts_topk,
// rowgather_sum_counts_cols at B = bw) of G reads a block at (bw, B, K) asks.
extern "C" long long epik_rowgather_counts_group_smem(int G, int bw, int B, int K) {
  return static_cast<long long>(group_smem(G, bw, B, K));
}

// Bytes of dynamic shared memory a group-layout block may take on the current
// device: the opt-in limit less the kernel's static shared memory (the same
// for every instance). Negative: minus a CUDA error code.
extern "C" long long epik_rowgather_counts_group_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, rowgather_counts_group_kernel<float, 4, false>) !=
          cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// Blocks of a group-layout launch of G reads at (bw, B, K) that an SM holds
// at once over a plane of type `cell` (kF32 or kBf16; `cols`: the column
// form), as the card's occupancy calculator gives them for the compiled
// kernel. Negative: minus a CUDA error code.
extern "C" int epik_rowgather_counts_group_blocks_per_sm(int G, int bw, int B, int K, int cell,
                                                         int cols) {
  const size_t smem = group_smem(G, bw, B, K);
  const void* fn = cols               ? reinterpret_cast<const void*>(
                                            rowgather_counts_group_kernel<float, 4, true>)
                   : cell == kF32     ? reinterpret_cast<const void*>(
                                            rowgather_counts_group_kernel<float, 4, false>)
                   : bw % 8 == 0      ? reinterpret_cast<const void*>(
                                            rowgather_counts_group_kernel<Bf16, 8, false>)
                                      : reinterpret_cast<const void*>(
                                            rowgather_counts_group_kernel<Bf16, 4, false>);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kGroupThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// plane: f32 (n_rows, bw), as above; rows: int32 (R, W); m: f32 (R,) window
// counts; slot: int32 (R,), the read's row of `delta` or -1, or null; delta:
// f32 (A, bw), the shifted delta rows; out: f32 (R, 2K+3), the shard's
// partial pack; col0: the shard's first global column. bw <= 2^16, 1 <= K <=
// min(64, bw), and epik_rowgather_sum_cols_smem(bw, K) <=
// epik_rowgather_sum_cols_smem_limit(). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_cols(const void* plane, const void* rows, const void* m,
                                       const void* slot, const void* delta, void* out, int R,
                                       int W, int bw, int K, int col0, int k, float log_eps,
                                       void* stream) {
  return launch_cols<false>(plane, rows, m, slot, delta, nullptr, out, nullptr, R, W, bw, K,
                            col0, k, log_eps, static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory a rowgather_sum_cols launch at (bw, K) asks:
// the fused kernels' layout at B = bw.
extern "C" long long epik_rowgather_sum_cols_smem(int bw, int K) {
  return static_cast<long long>(topk_smem(bw, bw, K, false));
}

// Bytes of dynamic shared memory a rowgather_sum_cols block may take on the
// current device: the opt-in limit less the kernel's static shared memory.
// Negative: minus a CUDA error code.
extern "C" long long epik_rowgather_sum_cols_smem_limit() { return cols_smem_limit<false>(); }

// plane: f32 (n_rows, bw), as above; rows: int32 (R, W); perm: int32 (R,), a
// permutation of the reads (block g takes reads perm[G g ..]); m: f32 (R,)
// window counts; slot: int32 (R,), the read's row of `delta` and `hit` or -1,
// or null; delta: f32 (A, bw), the classic first hits' contributions; hit:
// uint8 (A, bw), where a first hit lands; out: f32 (R, 2K+3), the shard's
// partial pack; cnt: int32 (R, K), the candidates' counts, read r's in row r
// whatever the order; col0: the shard's first global column. bw <= 2^16, 1 <=
// K <= min(64, bw), 1 <= G <= 32, and epik_rowgather_counts_group_smem(G, bw,
// bw, K) <= epik_rowgather_counts_group_smem_limit(). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int epik_rowgather_sum_counts_cols(const void* plane, const void* rows,
                                              const void* perm, const void* m, const void* slot,
                                              const void* delta, const void* hit, void* out,
                                              void* cnt, int R, int W, int bw, int K, int col0,
                                              int k, float log_eps, int G, void* stream) {
  if (cnt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group<float, 4, true>(plane, rows, perm, m, slot, delta, hit, out, cnt, R, W,
                                      bw, bw, K, G, col0, k, log_eps,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* epik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
