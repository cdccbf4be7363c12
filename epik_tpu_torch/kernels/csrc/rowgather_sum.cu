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
// Bound on the H100: HBM bytes. Each window slot names one whole plane row of
// bw * sizeof(cell) bytes (5,632 B at the D652 width bw = 1408 in f32, 80,384 B
// at config 4's bw = 20,096), the rows of one read scattered over a multi-GB
// plane. The roofline yardstick is the distinct rows a batch names, read once;
// the layouts below move the repeats to the 50 MB L2.
//
// Every kernel adds each (read, column) in window order, one thread in
// registers: the order of the plain version's `acc += plane.index_select(0,
// rows[:, w])` loop, with no multiply and no atomics, so the sums are
// bit-equal to it whatever order the reads run in. Misses point at the
// all-zero row. The plane's cell type is a template parameter:
// * f32 (the shifted and classic planes): f32 adds;
// * int16 (precision="int16", the quantized shifted plane): exact int32 adds,
//   then one correctly rounded __int2float_rn and __fdiv_rn by the plane
//   scale, as `Sp.astype(f32) / f32(plane_scale)` (placer.py:670-671);
// * bf16 (precision="bf16", classic only): each cell widened to f32 exactly
//   (its 16 bits are the top half of the f32), then f32 adds.
//
// Entry points, in two layouts (below):
// * epik_rowgather_sum (f32, int16; the slice layout): the (R, bw) f32 sums;
// * epik_rowgather_sum_counts (f32, bf16; the slice layout): the classic
//   plane's sums S and the exact counts C of the cells != 0
//   (dense_sums_from_rows, placer.py:757), as f32 and int32 (R, bw);
// * epik_rowgather_sum_topk (f32, int16; the group layout, shifted form): the
//   dense shifted steps' device work after the tokenizer, so the (R, bw) sums
//   never reach HBM: the sums, a read's ambiguous (IUPAC) delta row added
//   with one __fadd_rn per branch (epik_tpu/engine/placer.py::_apply_amb),
//   then finish_row.cuh's finish over the touched branches (Sp > 0) into the
//   read's slim (2K+3) pack row [scores K | idx K | log_sum | n | zero_sum];
// * epik_rowgather_sum_cols (f32; the group layout, shifted form): one model
//   shard of a column-sharded dense step (epik_tpu/parallel/sharding.py::
//   _sharded_dense_*_step: dense_sums_shifted over the shard's bwl columns,
//   _apply_amb, then the shard's half of finish_scores_cols_shifted +
//   _lwr_topk_cols) at B = bwl: the same gather and delta add, then the
//   read's partial pack row [values Kl | global ids Kl | n_s | max_s | e_s]
//   with e_s against the shard's own max_s (finish_row.cuh's cols_list);
// * epik_rowgather_sum_counts_topk (f32, bf16; the group layout, counts
//   form): the classic dense steps' device work (dense_sums_from_rows, then
//   _apply_amb(shifted=False), finish_scores with _lwr_topk and the body of
//   _pack_outputs, placer.py:757, :814, :464, :1461), so neither S nor C
//   reaches HBM: S and C, a read's ambiguous first hit added (S[b] + dS[b] by
//   one __fadd_rn, C[b] + hit[b]: ops/dense.py::amb_classic), then the finish
//   over the touched branches (C > 0: a classic sum can be negative, and the
//   plane's 1e-37 nudges mark presence) with the count-aware correction
//   (correct_counts: m - C wrapped to 2^64 where negative, quirk Q1) into the
//   read's full (4K+2) row [scores | wr | idx | counts | n | zero_sum];
// * epik_rowgather_sum_counts_cols (f32; the group layout, counts form): the
//   same shard over its classic plane (finish_scores_cols :321) into the
//   partial pack and the candidates' counts (int32 (R, Kl)).
// The fused entry points' shared memory grows with bw and B:
// epik_rowgather_{shifted,counts}_group_smem give a launch's bytes and
// epik_rowgather_group_smem_limit the card's opt-in bytes less the kernel's
// static ones. Past that (B near 36,400 at bw ~ B shifted, 22,016 counts; B
// past 2^16) the steps run epik_rowgather_sum[_counts] and the finish kernels
// apart (the same bits; e_s and log_sum add in another order), and below it
// kernels/rowgather.py routes each width to whichever of the two the H100
// measured faster (the shifted forms: fused up to 1,408 columns, where the
// fused kernel won every shape; from 2,112 the pair). Bound of a
// fused kernel on the H100: the distinct plane rows, the row ids, m, the
// delta rows and the pack (no S/C write).
//
// The shifted forms on an H100 (kernel_sweep.py --only shifted, NVIDIA H100
// 80GB HBM3 at 700 W), against the one-block-a-read kernel they replaced and
// their unfused pair (1d, the delta add, finish_topk / finish_cols_partial),
// at D652's 1,408 columns: the pair plane's rows (16,381 x 72) 1.94 ms
// against 1.97 and 2.30, as one shard 1.95 against 1.97 and 2.02; the
// unpaired rows (16,378 x 143) 2.38 f32 against 3.71 and 2.77, 1.29 int16
// against 1.88 and 1.76; config 2's rows 0.77 against 0.87 and 1.00. What
// made the shifted form: 512-byte slices (256: 2.82 f32, 1.35 int16; 1,024:
// 3.10, 1.53) and 3 blocks an SM (4: 2.56 f32). A variant that staged each
// thread's loads through a ring of 4 or 8 slots of shared memory by
// cp.async.cg took 4-5x as long and was removed. At config 4's 20,096
// columns (G = 1) the fused kernel took 13.7 ms against the pair's 12.4.

// The group layout (one kernel template, rowgather_group_kernel; kCounts the
// classic form, kCols the shard's column finish). The one-block-a-read
// kernels that it replaced streamed whole rows, one block a read of up to
// 1,024 threads x one 16-byte load, in read order, and finished each read
// with the whole block (about ten block barriers a read) while its gather
// stalled. A block now takes G consecutive reads of the read order it is
// given (the locality order, or read order for the pair planes' rows) and
// walks column slices one after another (256 bytes, 16 threads a (read, slice) pair, in
// the counts form; 512 bytes, 32 threads a pair, in the shifted form),
// slice-major, so that the reads of a group that share rows fetch them from
// L1/L2. Each (read, column) is added in window order by one thread in
// registers, kGroupUnroll loads in flight, and the slice goes to the block's
// shared memory (G x bw sums, and with kCounts G x bw counts). The group's
// row ids are staged once for all slices, kGroupRowIds / G windows a read a
// tile; a read longer than that carries its sums over tiles in shared memory
// (an f32 reload adds no rounding; an int16 plane's exact int32 partial sums
// are carried as they are and divided by the scale once, after the last
// tile). After the last slice the block adds each read's delta row (or first
// hit), and each warp finishes one read of the group (finish_row.cuh's warp
// finish: no block barrier, the same scores, ids and counts as the list
// finish; the exp-sums add in another order), so the G finishes run side by
// side; at G = 1 (the widest trees) the whole block runs the list finish. The
// shifted form corrects its touched sums in place first and marks the rest
// -inf (a corrected score is finite), so touched is "not -inf" after that.
// Shared memory: G x bw sums (and counts) + the row-id tile + ceil(B / 32)
// mask words + B 16-bit ids + the candidates (group_smem). The wrapper
// chooses G: the largest up to its maximum of which the kernel's named blocks
// an SM fit an SM, down to G = 1 at the widest trees. The register budget
// names those blocks an SM (EPIK_GROUP_MIN_BLOCKS, both forms), so that
// each thread's loads in flight fit and the other blocks' gathers hide one
// block's finishes. On an H100 at D652's classic rows (kernel_sweep.py
// --only group): G = 4 at 3 blocks an SM with 16 loads in flight a thread,
// 2.66 ms in f32 and 1.51 ms in bf16 against 2.76 and 1.53 for G = 8 at 2,
// 3.84 for the same layout in read order; 8 loads in flight, 2.59 and 1.49
// (the L2, not the latency, bounds it); finishing the reads in turn with the
// whole block took 3.09 and 1.92 (G = 8).

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
#include <math_constants.h>

#include <cstdint>

#include "finish_row.cuh"
#include "slot_map.cuh"

namespace {

// bf16 cells as their bits: the kernels widen them to f32 themselves
struct Bf16 {
  uint16_t bits;
};

// The type codes of the C entry points
enum Cell { kF32 = 0, kI16 = 1, kBf16 = 2 };

// The addend type of a cell: int32 for an int16 plane (exact), else f32
template <class T>
struct Acc {
  using scalar = float;
};
template <>
struct Acc<int16_t> {
  using scalar = int;
};

// 16 bytes of a row as their V addends: f32 and bf16 widened to f32, int16 to
// int32
__device__ __forceinline__ void unpack(uint4 x, float (&v)[4]) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(uint4 x, int (&v)[8]) {
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = static_cast<int16_t>(u[e] & 0xFFFFu);
    v[2 * e + 1] = static_cast<int16_t>(u[e] >> 16);
  }
}
__device__ __forceinline__ void unpack(uint4 x, float (&v)[8]) {  // bf16
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(u[e] << 16);
    v[2 * e + 1] = __uint_as_float(u[e] & 0xFFFF0000u);
  }
}

// V cells of a row starting at cell `i` (a multiple of V), as their addends:
// 16-byte loads, or 8-byte ones for a bf16 or int16 plane of a width that is
// not a multiple of 8
template <class T, class A, int V>
__device__ __forceinline__ void load_vec(const T* p, long long i, A (&v)[V]) {
  static_assert(sizeof(T) * V == 16, "16-byte vectors");
  unpack(__ldg(reinterpret_cast<const uint4*>(p + i)), v);
}
__device__ __forceinline__ void load_vec(const Bf16* p, long long i, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + i));
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load_vec(const int16_t* p, long long i, int (&v)[4]) {
  const short4 x = __ldg(reinterpret_cast<const short4*>(p + i));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// One sum as f32: as it is, or an int16 plane's dequantized: one correctly
// rounded conversion and one correctly rounded divide by the scale
__device__ __forceinline__ float as_sum(float a, float) { return a; }
__device__ __forceinline__ float as_sum(int a, float scale) {
  return __fdiv_rn(__int2float_rn(a), scale);
}

// Four partial sums into shared memory as they are (an int16 plane's int32)
__device__ __forceinline__ void store_raw(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_raw(int* p, const int* a) {
  *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
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

// The group layout's block (rowgather_group_kernel): kGroupThreads threads,
// 16 (the counts form) or EPIK_SHIFTED_LANES (the shifted form) a (read,
// slice) pair, with a register budget of EPIK_GROUP_MIN_BLOCKS blocks an SM
// (both forms); kGroupRowIds row ids staged a tile, shared by the group's G
// reads; G at most kMaxGroup. The macros let kernel_sweep.py build other
// blocks; kernels/rowgather.py states the same numbers (GROUP_THREADS,
// GROUP_ROW_IDS, GROUP_MIN_BLOCKS) for its choice of G.
#ifndef EPIK_GROUP_THREADS
#define EPIK_GROUP_THREADS 256
#endif
#ifndef EPIK_GROUP_MIN_BLOCKS
#define EPIK_GROUP_MIN_BLOCKS 3
#endif
#ifndef EPIK_GROUP_UNROLL
#define EPIK_GROUP_UNROLL 8
#endif
#ifndef EPIK_SHIFTED_LANES
#define EPIK_SHIFTED_LANES 32
#endif

constexpr int kGroupThreads = EPIK_GROUP_THREADS;
constexpr int kGroupUnroll = EPIK_GROUP_UNROLL;  // loads in flight a thread
// threads a (read, slice) pair: the counts form's, the shifted form's
constexpr int kGroupLanes = 16;
constexpr int kShiftedLanes = EPIK_SHIFTED_LANES;
constexpr int kGroupRowIds = 2048;
constexpr int kMaxGroup = 32;

// Dynamic shared memory of a group-layout block of G reads at (bw, B, K):
// G x bw sums (and with `counts` G x bw counts) | the row-id tile |
// ceil(B / 32) mask words | B 16-bit ids (padded to 4 bytes) | the
// candidates.
size_t group_smem(int G, int bw, int B, int K, bool counts) {
  return ((counts ? 2 : 1) * static_cast<size_t>(G) * bw + kGroupRowIds + (B + 31) / 32 +
          (B + 1) / 2) * sizeof(int) +
         epik::cand_bytes(kGroupThreads, K);
}

// The adds of one (read, slice) pair over the tile's nw windows: acc (and
// with kCounts cnt) += the V cells at column `col` of the rows `my` names,
// kGroupUnroll loads in flight.
template <bool kCounts, class T, class A, int V>
__device__ __forceinline__ void add_windows(const T* __restrict__ plane, const int32_t* my,
                                            int nw, int bw, int col, A (&acc)[V], int (&cnt)[V]) {
#pragma unroll(kGroupUnroll)
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

// G consecutive reads of the order `perm` (read order where perm is null) a
// block, each read's finish into its own row. kCounts: the classic plane's
// sums S and counts C, the first hits (delta = dS, hit) added, the counts
// finish; else the shifted plane's sums (an int16 plane's dequantized by
// `scale`), the delta rows added, the finish over Sp > 0. kCols: the shard's
// column finish into its partial pack row (and with kCounts the candidates'
// counts); else the slim (kCounts: the full pack's body) row. B <= bw
// columns finish.
template <class T, int V, bool kCounts, bool kCols>
__global__ void __launch_bounds__(kGroupThreads, EPIK_GROUP_MIN_BLOCKS)
    rowgather_group_kernel(const T* __restrict__ plane, const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ perm, const float* __restrict__ m,
                           const int32_t* __restrict__ slot, const float* __restrict__ delta,
                           const uint8_t* __restrict__ hit, float* __restrict__ out,
                           int* __restrict__ cnt_out, int R, int W, int bw, int B, int K, int G,
                           int col0, float kf, float log_eps, float scale) {
  using A = typename Acc<T>::scalar;
  extern __shared__ float4 group_smem4[];
  __shared__ float red_f[32];
  __shared__ int red_i[32];
  __shared__ int32_t sread[kMaxGroup];
  float* S = reinterpret_cast<float*>(group_smem4);
  int* Cn = reinterpret_cast<int*>(S + static_cast<long long>(G) * bw);  // kCounts only
  int32_t* srow = reinterpret_cast<int32_t*>(S + (kCounts ? 2LL : 1LL) * G * bw);
  unsigned* mask = reinterpret_cast<unsigned*>(srow + kGroupRowIds);
  const int nwords = (B + 31) >> 5;
  uint16_t* ids = reinterpret_cast<uint16_t*>(mask + nwords);
  float* cand_v = reinterpret_cast<float*>(mask + nwords + (B + 1) / 2);
  const epik::FinishScratch scratch{red_f, cand_v,
                                    reinterpret_cast<int*>(cand_v) + (kGroupThreads >> 5) * K};
  const int r0 = blockIdx.x * G;
  const int nr = min(G, R - r0);
  if (threadIdx.x < nr) {
    sread[threadIdx.x] = perm != nullptr ? perm[r0 + threadIdx.x] : r0 + threadIdx.x;
  }

  // ---- the gather: (read, slice) pairs slice-major, kLanes threads a pair ----
  constexpr int kLanes = kCounts ? kGroupLanes : kShiftedLanes;
  constexpr int kPairs = kGroupThreads / kLanes;
  const int q = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int n_slices = (bw + kLanes * V - 1) / (kLanes * V);
  const int n_pairs = nr * n_slices;
  const int tw = kGroupRowIds / G;  // windows a read a tile
  for (int w0 = 0; w0 < W; w0 += tw) {
    const int nw = min(tw, W - w0);
    const bool last = w0 + nw >= W;
    __syncthreads();  // the previous tile has been read by every thread
    for (int i = threadIdx.x; i < nr * nw; i += kGroupThreads) {
      const int j = i / nw;
      srow[j * tw + i - j * nw] = rows[static_cast<long long>(sread[j]) * W + w0 + i - j * nw];
    }
    __syncthreads();
    for (int p = q; p < n_pairs; p += kPairs) {
      const int s = p / nr;
      const int j = p - s * nr;
      const int col = (s * kLanes + lane) * V;
      if (col >= bw) continue;
      float* sj = S + j * bw + col;
      A* aj = reinterpret_cast<A*>(sj);  // the partial sums between tiles
      int* cj = Cn + j * bw + col;
      A acc[V];
      int cnt[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e] = w0 == 0 ? A(0) : aj[e];
        if constexpr (kCounts) cnt[e] = w0 == 0 ? 0 : cj[e];
      }
      add_windows<kCounts>(plane, srow + j * tw, nw, bw, col, acc, cnt);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        if (last) {
          *reinterpret_cast<float4*>(sj + e) =
              make_float4(as_sum(acc[e], scale), as_sum(acc[e + 1], scale),
                          as_sum(acc[e + 2], scale), as_sum(acc[e + 3], scale));
        } else {
          store_raw(aj + e, acc + e);
        }
        if constexpr (kCounts) {
          *reinterpret_cast<int4*>(cj + e) = make_int4(cnt[e], cnt[e + 1], cnt[e + 2], cnt[e + 3]);
        }
      }
    }
  }
  if (W == 0) {  // no window: every sum and count is 0
    for (int i = threadIdx.x; i < nr * bw; i += kGroupThreads) {
      S[i] = 0.f;
      if constexpr (kCounts) Cn[i] = 0;
    }
  }
  __syncthreads();

  // ---- the delta rows (kCounts: the first hits): S + delta (one __fadd_rn),
  // C + hit --------------------------------------------------------------------
  if (slot != nullptr) {
    for (int j = 0; j < nr; ++j) {
      const int a = slot[sread[j]];
      if (a < 0) continue;
      const float* drow = delta + static_cast<long long>(a) * B;
      for (int b = threadIdx.x; b < B; b += kGroupThreads) {
        S[j * bw + b] = __fadd_rn(S[j * bw + b], drow[b]);
        if constexpr (kCounts) Cn[j * bw + b] += hit[static_cast<long long>(a) * B + b];
      }
    }
    __syncthreads();
  }

  // ---- the finishes, each read into its own row -----------------------------
  const auto count = [Cn](int b) { return kCounts ? Cn[b] : 0; };
  if (G == 1) {  // the widest trees: the whole block finishes the one read
    const long long r = sread[0];
    const float mr = m[r];
    if constexpr (kCounts) {
      epik::build_mask([Cn](int b) { return Cn[b] > 0; }, B, mask);
    } else {
      epik::build_mask([S](int b) { return S[b] > 0.f; }, B, mask);
    }
    const int n = epik::compact_mask(mask, nwords, ids, red_i, false);
    const auto corr = [S, Cn, ids, mr, kf, log_eps](int i) {
      return kCounts ? epik::correct_counts(S[ids[i]], Cn[ids[i]], mr, kf, log_eps)
                     : epik::correct(S[ids[i]], mr, kf, log_eps);
    };
    if constexpr (kCols) {
      epik::cols_list(corr, ids, n, K, col0, scratch, out + r * (2LL * K + 3),
                      kCounts ? cnt_out + r * K : nullptr, count);
    } else if constexpr (kCounts) {
      epik::finish_list(corr, ids, n, B, K, mr, kf, log_eps, scratch,
                        epik::full_row(out + r * (4LL * K + 2), K, count));
    } else {
      epik::finish_list(corr, ids, n, B, K, mr, kf, log_eps, scratch,
                        epik::SlimRow{out + r * (2LL * K + 3), K});
    }
    return;
  }
  // a warp a read, its touched scores corrected in place first (each lane its
  // own branches; the shifted form marks the untouched ones -inf)
  const int lane32 = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < nr; j += kGroupThreads >> 5) {
    const long long r = sread[j];
    float* sums = S + j * bw;
    const int* cnts = Cn + j * bw;
    const float mr = m[r];
    for (int b = lane32; b < B; b += 32) {
      if constexpr (kCounts) {
        if (cnts[b] > 0) sums[b] = epik::correct_counts(sums[b], cnts[b], mr, kf, log_eps);
      } else {
        sums[b] = sums[b] > 0.f ? epik::correct(sums[b], mr, kf, log_eps) : -CUDART_INF_F;
      }
    }
    const auto touched = [sums, cnts](int b) {
      return kCounts ? cnts[b] > 0 : sums[b] != -CUDART_INF_F;
    };
    const auto corr = [sums](int b) { return sums[b]; };
    const auto count_j = [cnts](int b) { return kCounts ? cnts[b] : 0; };
    if constexpr (kCols) {
      epik::warp_cols(touched, corr, B, K, col0, out + r * (2LL * K + 3),
                      kCounts ? cnt_out + r * K : nullptr, count_j);
    } else if constexpr (kCounts) {
      epik::warp_finish(touched, corr, B, K, mr, kf, log_eps,
                        epik::full_row(out + r * (4LL * K + 2), K, count_j));
    } else {
      epik::warp_finish(touched, corr, B, K, mr, kf, log_eps,
                        epik::SlimRow{out + r * (2LL * K + 3), K});
    }
  }
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

// One group-layout launch of G reads a block.
template <class T, int V, bool kCounts, bool kCols>
int launch_group(const void* plane, const void* rows, const void* perm, const void* m,
                 const void* slot, const void* delta, const void* hit, void* out, void* cnt,
                 int R, int W, int bw, int B, int K, int G, int col0, int k, float log_eps,
                 float scale, cudaStream_t stream) {
  if (B > (1 << 16) || G < 1 || G > kMaxGroup) {  // 16-bit ids; the staged read ids
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = group_smem(G, bw, B, K, kCounts);
  // always: a block within 48 KB with the static bytes beside it must opt in too
  const cudaError_t err =
      cudaFuncSetAttribute(rowgather_group_kernel<T, V, kCounts, kCols>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && bw > 0) {
    rowgather_group_kernel<T, V, kCounts, kCols>
        <<<(R + G - 1) / G, kGroupThreads, smem, stream>>>(
            static_cast<const T*>(plane), static_cast<const int32_t*>(rows),
            static_cast<const int32_t*>(perm), static_cast<const float*>(m),
            static_cast<const int32_t*>(slot), static_cast<const float*>(delta),
            static_cast<const uint8_t*>(hit), static_cast<float*>(out), static_cast<int*>(cnt), R,
            W, bw, B, K, G, col0, static_cast<float>(k), log_eps, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the group kernel `fn` with `smem` bytes of dynamic shared memory
// that an SM holds at once, as the card's occupancy calculator gives them.
// Negative: minus a CUDA error code.
int blocks_per_sm(const void* fn, size_t smem) {
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kGroupThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <class T, int V, bool kCounts, bool kCols>
const void* group_fn() {
  return reinterpret_cast<const void*>(rowgather_group_kernel<T, V, kCounts, kCols>);
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
  if (cell == kF32) {
    return launch_slices<float, 4, false>(plane, rows, perm, out, nullptr, R, W, bw, scale, s);
  }
  if (cell == kI16) {
    return bw % 8 == 0
               ? launch_slices<int16_t, 8, false>(plane, rows, perm, out, nullptr, R, W, bw,
                                                  scale, s)
               : launch_slices<int16_t, 4, false>(plane, rows, perm, out, nullptr, R, W, bw,
                                                  scale, s);
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
  if (cell == kF32) return launch_slices<float, 4, true>(plane, rows, perm, S, C, R, W, bw, 1.f, s);
  if (cell == kBf16) {
    return bw % 8 == 0 ? launch_slices<Bf16, 8, true>(plane, rows, perm, S, C, R, W, bw, 1.f, s)
                       : launch_slices<Bf16, 4, true>(plane, rows, perm, S, C, R, W, bw, 1.f, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// plane: (n_rows, bw) cells of type `cell` (kF32 or kI16), as above; rows:
// int32 (R, W); perm: int32 (R,), a permutation of the reads (block g takes
// reads perm[G g .. G g + G - 1]), or null for read order; m: f32 (R,) window
// counts; amb: the A reads with a delta row (distinct ids, int64 where amb64,
// else int32), or null where A == 0; slot: int32 (R,) scratch, which the
// launch fills with each read's row of `delta` or -1 (on `stream`, before the
// kernel); delta: f32 (A, B); out: f32 (R, 2K+3), read r's slim pack row in
// row r whatever the order; an int16 plane's sums divided by `scale`. B <=
// bw, B <= 2^16, 1 <= K <= min(64, B), 1 <= G <= 32, and
// epik_rowgather_shifted_group_smem(G, bw, B, K) <=
// epik_rowgather_group_smem_limit(). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_topk(const void* plane, int cell, const void* rows,
                                       const void* perm, const void* m, const void* amb,
                                       int amb64, int A, void* slot, const void* delta, void* out,
                                       int R, int W, int bw, int B, int K, int k, float log_eps,
                                       float scale, int G, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell != kF32 && cell != kI16) return static_cast<int>(cudaErrorInvalidValue);
  const void* map = nullptr;
  if (const int err = map_slots(amb, amb64, A, slot, R, s, &map)) return err;
  if (cell == kF32) {
    return launch_group<float, 4, false, false>(plane, rows, perm, m, map, delta, nullptr, out,
                                                nullptr, R, W, bw, B, K, G, 0, k, log_eps, scale,
                                                s);
  }
  return bw % 8 == 0
             ? launch_group<int16_t, 8, false, false>(plane, rows, perm, m, map, delta, nullptr,
                                                      out, nullptr, R, W, bw, B, K, G, 0, k,
                                                      log_eps, scale, s)
             : launch_group<int16_t, 4, false, false>(plane, rows, perm, m, map, delta, nullptr,
                                                      out, nullptr, R, W, bw, B, K, G, 0, k,
                                                      log_eps, scale, s);
}

// plane: (n_rows, bw) cells of type `cell` (kF32 or kBf16), as above; rows:
// int32 (R, W); perm: int32 (R,), a permutation of the reads (the locality
// order: block g takes reads perm[G g .. G g + G - 1]); m: f32 (R,) window
// counts; amb, amb64, A, slot: the reads with a first hit and the slot
// scratch, as for epik_rowgather_sum_topk; delta: f32 (A, B), the ambiguous
// first hits' contributions (0 where no hit); hit: uint8 (A, B), 1 where a
// first hit lands; out: f32 (R, 4K+2), the full pack's body, read r's in row
// r whatever the order. B <= bw, B <= 2^16, 1 <= K <= min(64, B), 1 <= G <=
// 32, and epik_rowgather_counts_group_smem(G, bw, B, K) <=
// epik_rowgather_group_smem_limit(). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_counts_topk(const void* plane, int cell, const void* rows,
                                              const void* perm, const void* m, const void* amb,
                                              int amb64, int A, void* slot, const void* delta,
                                              const void* hit, void* out, int R, int W, int bw,
                                              int B, int K, int k, float log_eps, int G,
                                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell != kF32 && cell != kBf16) return static_cast<int>(cudaErrorInvalidValue);
  const void* map = nullptr;
  if (const int err = map_slots(amb, amb64, A, slot, R, s, &map)) return err;
  if (cell == kF32) {
    return launch_group<float, 4, true, false>(plane, rows, perm, m, map, delta, hit, out,
                                               nullptr, R, W, bw, B, K, G, 0, k, log_eps, 1.f, s);
  }
  return bw % 8 == 0
             ? launch_group<Bf16, 8, true, false>(plane, rows, perm, m, map, delta, hit, out,
                                                  nullptr, R, W, bw, B, K, G, 0, k, log_eps, 1.f,
                                                  s)
             : launch_group<Bf16, 4, true, false>(plane, rows, perm, m, map, delta, hit, out,
                                                  nullptr, R, W, bw, B, K, G, 0, k, log_eps, 1.f,
                                                  s);
}

// plane: f32 (n_rows, bw), as above; rows: int32 (R, W); perm: int32 (R,), a
// permutation of the reads (block g takes reads perm[G g ..]), or null for
// read order; m: f32 (R,) window counts; amb, amb64, A, slot: the reads with
// a delta row and the slot scratch, as for epik_rowgather_sum_topk; delta:
// f32 (A, bw), the shifted delta rows; out: f32 (R, 2K+3), the shard's
// partial pack, read r's in row r whatever the order; col0: the shard's first
// global column. bw <= 2^16, 1 <= K <= min(64, bw), 1 <= G <= 32, and
// epik_rowgather_shifted_group_smem(G, bw, bw, K) <=
// epik_rowgather_group_smem_limit(). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_cols(const void* plane, const void* rows, const void* perm,
                                       const void* m, const void* amb, int amb64, int A,
                                       void* slot, const void* delta, void* out, int R, int W,
                                       int bw, int K, int col0, int k, float log_eps, int G,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const void* map = nullptr;
  if (const int err = map_slots(amb, amb64, A, slot, R, s, &map)) return err;
  return launch_group<float, 4, false, true>(plane, rows, perm, m, map, delta, nullptr, out,
                                             nullptr, R, W, bw, bw, K, G, col0, k, log_eps, 1.f,
                                             s);
}

// plane: f32 (n_rows, bw), as above; rows: int32 (R, W); perm: int32 (R,), a
// permutation of the reads (block g takes reads perm[G g ..]); m: f32 (R,)
// window counts; amb, amb64, A, slot: the reads with a first hit and the
// slot scratch, as for epik_rowgather_sum_topk; delta: f32 (A, bw), the
// classic first hits' contributions; hit: uint8 (A, bw), where a first hit
// lands; out: f32 (R, 2K+3), the shard's partial pack; cnt: int32 (R, K), the
// candidates' counts, read r's in row r whatever the order; col0: the shard's
// first global column. bw <= 2^16, 1 <= K <= min(64, bw), 1 <= G <= 32, and
// epik_rowgather_counts_group_smem(G, bw, bw, K) <=
// epik_rowgather_group_smem_limit(). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_rowgather_sum_counts_cols(const void* plane, const void* rows,
                                              const void* perm, const void* m, const void* amb,
                                              int amb64, int A, void* slot, const void* delta,
                                              const void* hit, void* out, void* cnt, int R, int W,
                                              int bw, int K, int col0, int k, float log_eps,
                                              int G, void* stream) {
  if (cnt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const void* map = nullptr;
  if (const int err = map_slots(amb, amb64, A, slot, R, s, &map)) return err;
  return launch_group<float, 4, true, true>(plane, rows, perm, m, map, delta, hit, out, cnt, R,
                                            W, bw, bw, K, G, col0, k, log_eps, 1.f, s);
}

// Bytes of dynamic shared memory a group-layout launch of G reads a block at
// (bw, B, K) asks: the shifted form (rowgather_sum_topk, rowgather_sum_cols
// at B = bw) and the counts form (rowgather_sum_counts_topk,
// rowgather_sum_counts_cols at B = bw).
extern "C" long long epik_rowgather_shifted_group_smem(int G, int bw, int B, int K) {
  return static_cast<long long>(group_smem(G, bw, B, K, false));
}
extern "C" long long epik_rowgather_counts_group_smem(int G, int bw, int B, int K) {
  return static_cast<long long>(group_smem(G, bw, B, K, true));
}

// Bytes of dynamic shared memory a group-layout block may take on the current
// device: the opt-in limit less the kernel's static shared memory (the same
// for every instance). Negative: minus a CUDA error code.
extern "C" long long epik_rowgather_group_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, rowgather_group_kernel<float, 4, true, false>) !=
          cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// Blocks of a group-layout launch of G reads at (bw, B, K) that an SM holds
// at once, as the card's occupancy calculator gives them for the compiled
// kernel: the shifted form over a plane of type `cell` (kF32 or kI16; `cols`:
// the column form, f32), the counts form over kF32 or kBf16. Negative: minus
// a CUDA error code.
extern "C" int epik_rowgather_shifted_group_blocks_per_sm(int G, int bw, int B, int K, int cell,
                                                          int cols) {
  const void* fn = cols             ? group_fn<float, 4, false, true>()
                   : cell == kF32   ? group_fn<float, 4, false, false>()
                   : bw % 8 == 0    ? group_fn<int16_t, 8, false, false>()
                                    : group_fn<int16_t, 4, false, false>();
  return blocks_per_sm(fn, group_smem(G, bw, B, K, false));
}
extern "C" int epik_rowgather_counts_group_blocks_per_sm(int G, int bw, int B, int K, int cell,
                                                         int cols) {
  const void* fn = cols             ? group_fn<float, 4, true, true>()
                   : cell == kF32   ? group_fn<float, 4, true, false>()
                   : bw % 8 == 0    ? group_fn<Bf16, 8, true, false>()
                                    : group_fn<Bf16, 4, true, false>();
  return blocks_per_sm(fn, group_smem(G, bw, B, K, true));
}

extern "C" const char* epik_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
