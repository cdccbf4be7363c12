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
// Bound on the H100: bytes. The CSR batch of 4,096 400 bp reads hands it
// (4,096 x 16,384) cells, 537 MB of branch ids and scores, and takes back
// 655 MB of sums and counts (B = 19,999): 0.36 ms at the HBM rate. There is
// about one add per cell, so the operations never bound it. What costs is the
// order: each sum must be taken in cell order with no float atomics, so the
// result is bit-equal to the plain version and the same on every run.
//
// Design: block (r, t) owns the branch tile [t * tile_w, (t+1) * tile_w) of
// read r, with its sums (and counts) in shared memory; one tile holds B =
// 19,999 with counts (160 KB), so every cell is read from HBM once. Warp w
// owns the tile's branches j = w (mod kWarps): only warp w ever adds into
// branch j, which keeps each branch's adds in the order the warp takes them.
// The block walks the read's cells in chunks of kChunk:
//   1. each warp loads its slice of the chunk (kRounds coalesced rounds of 32
//      cells), drops trash cells and cells outside the tile at the load (a
//      trash cell costs its branch id's 4 bytes, not its score's), and ranks
//      each kept cell among the slice's cells of the same owner warp
//      (__match_any_sync, a per-warp count per owner in shared memory). Lane
//      l takes cells 32 v + l, not four neighbours in one 16-byte load: each
//      round is still one 128-byte line per warp, and round order is cell
//      order, which the rank of step 1 needs;
//   2. a block-wide exclusive scan over (owner, warp) of those counts gives
//      each owner a queue in shared memory, and each (warp, owner) its offset
//      in it;
//   3. each kept cell is written to its owner's queue at offset + rank: a
//      stable partition, so every queue is in cell order;
//   4. each warp drains its own queue 32 entries a step: the lanes whose
//      entries hit the same branch form a group (__match_any_sync) and the
//      group's lowest lane adds the group's scores in lane order, i.e. cell
//      order, then the group's size into the count. Only the owner warp
//      touches a branch, so the count needs no atomic either.
// A chunk with no kept cell anywhere in the block skips steps 2-4. The drain
// of one chunk overlaps the loads of the next in other warps: the barriers of
// steps 1 and 2 already order the next chunk's queue writes after this
// chunk's drains. The sums are stored at a shift of (r * B + lo) mod 4 in
// shared memory so that the write-out moves float4s on both sides.
//
// The row-pointer form (epik_accumulate_sums_csr, at the end) takes the flat
// cells of the scatter engine (engine/placer.py::accumulate_exact, whose XLA
// scatter-add into (R+1, B) it replaces) with an int64 (R+1) row pointer:
// read r's cells are [ptr[r], ptr[r+1]) of the flat arrays. It reads only the
// batch's postings, no padding: the 400 bp batch's 18.2 M cells are 145 MB
// against the 655 MB of sums and counts it writes, so the writes bound it
// (0.239 ms on the H100).
//
// It has its own block: the same tile of sums and counts in shared
// memory, but the cell-order adds come from a stable block radix sort
// instead of the owner warps, whose __match_any_sync per 32 queued cells (the
// drain) and per 32 loaded cells (the ranks) held the owner-warp block at
// 0.8 ms on the 400 bp batch. Each chunk of kChunk cells is
//   1. loaded in blocked order (thread t holds cells kItems t .. kItems t +
//      kItems - 1 of the chunk), a cell outside the tile keyed past every
//      branch of it (its score is never read);
//   2. sorted by branch with cub::BlockRadixSort, which is stable: the cells
//      of one branch stay in cell order;
//   3. written to shared memory, sorted; the thread holding the first cell of
//      a branch's run adds the run's scores in order into the branch's sum
//      and its length into the count. Each branch has one run a chunk, so
//      one thread adds into it: no atomics.
// A chunk of 5,120 cells (1,024 threads x 5) holds a 400 bp read's ~4,400
// cells whole (at 4,096, most reads take a second chunk); a chunk with no
// cell in the tile skips the sort, whose passes take 5 bits each (3 at B =
// 19,999). The tiles are the fewest whose block fits the card's shared
// memory: one at B = 19,999 (160 KB of sums and counts and 68 KB of the
// sort's storage, most of it the 5-bit digit counters), so one block an SM.
// Past B ~ 20,320 that block would split the tile in two, each loading and
// sorting every cell; there the block takes 4-bit passes instead (37 KB of
// counters, under the 40 KB of the sorted chunk), one more pass but one tile
// up to B ~ 23,900 (the wide classic tree's 22,199 branches under
// accumulate="scatter").
// With one block an SM, a block that owns one (read, tile) item runs its
// zero fill, loads, sort passes and 160 KB write-out one after another, and
// the SM's share of HBM idles through the sort. So the grid is as many
// blocks as the card holds at once, each taking items in turn; the tile
// leaves shared memory by cp.async.bulk (one thread, the 16-byte runs of S
// and of C), and the block loads and sorts the next item's first chunk,
// which touches only the scratch, before it waits for the copy to have read
// the tile and zeroes it: one item's write-out overlaps the next one's
// loads and sort. kernel_sweep.py times these choices against each other,
// and the owner warps with 2-4 tiles a read and several blocks an SM
// (kernel_variants/accumulate_sums_tiles.cu). The (R, PP) forms keep the
// owner warps.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cub/block/block_radix_sort.cuh>

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
__host__ __device__ constexpr int chunk_cells() {
  return kWarps * 32 * kRounds;
}

// bytes of dynamic shared memory: the tile's sums (and counts), each padded
// to a multiple of 4 plus 4 for the write-out shift, the queues, the
// (warp, owner) table and the owner totals
template <int kWarps, bool kCounts>
size_t smem_bytes(int tile_w) {
  const size_t tile = static_cast<size_t>(((tile_w + 3) & ~3) + 4) * 4;
  return tile * (kCounts ? 2 : 1) + static_cast<size_t>(chunk_cells<kWarps>()) * 8 +
         static_cast<size_t>(kWarps * kWarps + kWarps) * 4;
}

template <int kWarps, bool kCounts>
__global__ void __launch_bounds__(kWarps * 32)
    accumulate_sums_kernel(const int32_t* __restrict__ b,
                           const float* __restrict__ s,
                           float* __restrict__ S, int32_t* __restrict__ C,
                           int PP, int B, int tile_w, int n_tiles) {
  static_assert(kWarps <= 32 && (kWarps & (kWarps - 1)) == 0,
                "owners are lanes of one warp and a mask of the branch id");
  constexpr int kThreads = kWarps * 32;
  constexpr int kChunk = chunk_cells<kWarps>();
  extern __shared__ float4 smem[];
  const int tile4 = ((tile_w + 3) & ~3) + 4;
  float* sum_base = reinterpret_cast<float*>(smem);
  int* cnt_base = reinterpret_cast<int*>(sum_base + tile4);
  int* qj = cnt_base + (kCounts ? tile4 : 0);
  float* qv = reinterpret_cast<float*>(qj + kChunk);
  int* hist = reinterpret_cast<int*>(qv + kChunk);  // [warp][owner]
  int* tot = hist + kWarps * kWarps;                // [owner]

  const long long r = blockIdx.x / n_tiles;
  const int lo = static_cast<int>(blockIdx.x - r * n_tiles) * tile_w;
  const int n = min(B - lo, tile_w);
  const long long out0 = r * B + lo;  // element offset of the tile's outputs
  const int shift = static_cast<int>(out0 & 3);
  float* ssum = sum_base + shift;
  int* scnt = cnt_base + shift;
  for (int i = threadIdx.x; i < tile4 / 4; i += kThreads) {
    smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kCounts) reinterpret_cast<int4*>(cnt_base)[i] = make_int4(0, 0, 0, 0);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int32_t* brow = b + r * PP;
  const float* srow = s + r * PP;
  for (int c0 = 0; c0 < PP; c0 += kChunk) {
    // ---- 1. load, drop, rank among the slice's cells of the same owner ----
    if (lane < kWarps) hist[warp * kWarps + lane] = 0;
    __syncwarp();
    const int cw = c0 + warp * 32 * kRounds + lane;
    int jv[kRounds];
    float vv[kRounds];
    int rk[kRounds];
#pragma unroll
    for (int v = 0; v < kRounds; ++v) {
      const int c = cw + v * 32;
      jv[v] = c < PP ? __ldg(brow + c) - lo : -1;
      if (static_cast<unsigned>(jv[v]) >= static_cast<unsigned>(n)) jv[v] = -1;
    }
#pragma unroll
    for (int v = 0; v < kRounds; ++v) {
      vv[v] = jv[v] >= 0 ? __ldg(srow + cw + v * 32) : 0.f;
    }
    bool kept_any = false;
#pragma unroll
    for (int v = 0; v < kRounds; ++v) {
      const bool kept = jv[v] >= 0;
      rk[v] = 0;
      if (__ballot_sync(0xffffffffu, kept) == 0u) continue;
      kept_any = true;
      const int o = jv[v] & (kWarps - 1);
      // dropped lanes get distinct keys: they form no group
      const unsigned key = kept ? static_cast<unsigned>(o) : 0x80000000u | lane;
      const unsigned grp = __match_any_sync(0xffffffffu, key);
      int* h = hist + warp * kWarps + o;
      if (kept) rk[v] = *h + __popc(grp & below);
      __syncwarp();
      if (kept && lane == __ffs(grp) - 1) *h += __popc(grp);
      __syncwarp();
    }
    if (!__syncthreads_or(kept_any)) continue;  // no kept cell in the chunk

    // ---- 2. warp o scans owner o's counts over the warps: offsets, total ----
    {
      const int x = lane < kWarps ? hist[lane * kWarps + warp] : 0;
      const int incl = warp_inclusive_scan(x, lane);
      if (lane < kWarps) hist[lane * kWarps + warp] = incl - x;
      if (lane == 31) tot[warp] = incl;
    }
    __syncthreads();

    // ---- 3. the stable partition into the owners' queues -------------------
    const int cnt = lane < kWarps ? tot[lane] : 0;
    const int qbase = warp_inclusive_scan(cnt, lane) - cnt;  // owner `lane`'s queue
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

    // ---- 4. each warp drains its own queue, in cell order ------------------
    for (int i = 0; i < qn; i += 32) {
      const bool has = i + lane < qn;
      const int j = has ? qj[q0 + i + lane] : -1;
      const unsigned key = has ? static_cast<unsigned>(j) : 0x80000000u | lane;
      const unsigned grp = __match_any_sync(0xffffffffu, key);
      if (has && lane == __ffs(grp) - 1) {
        float acc = ssum[j];
        for (unsigned g = grp; g != 0u; g &= g - 1u) {
          acc = __fadd_rn(acc, qv[q0 + i + __ffs(g) - 1]);
        }
        ssum[j] = acc;
        if (kCounts) scnt[j] += __popc(grp);
      }
      __syncwarp();  // this step's sums are written before the next reads them
    }
  }
  __syncthreads();

  // ---- write-out: scalars up to a 16-byte boundary of S, then float4s -------
  float* Srow = S + out0;
  int32_t* Crow = kCounts ? C + out0 : nullptr;
  const int head = min(n, (4 - shift) & 3);
  for (int j = threadIdx.x; j < head; j += kThreads) {
    Srow[j] = ssum[j];
    if (kCounts) Crow[j] = scnt[j];
  }
  const int n4 = (n - head) >> 2;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    reinterpret_cast<float4*>(Srow + head)[i] = reinterpret_cast<const float4*>(ssum + head)[i];
    if (kCounts) {
      reinterpret_cast<int4*>(Crow + head)[i] = reinterpret_cast<const int4*>(scnt + head)[i];
    }
  }
  for (int j = head + 4 * n4 + threadIdx.x; j < n; j += kThreads) {
    Srow[j] = ssum[j];
    if (kCounts) Crow[j] = scnt[j];
  }
}

// ---- the row-pointer form: cell-order adds by a stable block radix sort ----

// Threads and cells a thread of the row-pointer form's block, and the bits a
// pass of its radix sort takes: 5,120 cells a chunk, 3 passes at B = 19,999;
// 4 bits where the 5-bit block would need more tiles. The macros let
// kernel_sweep.py build the other choices.
#ifndef EPIK_SORT_ITEMS
#define EPIK_SORT_ITEMS 5
#endif
#ifndef EPIK_SORT_BITS
#define EPIK_SORT_BITS 5
#endif
#ifndef EPIK_SORT_BITS_SMALL
#define EPIK_SORT_BITS_SMALL 4
#endif
constexpr int kSortThreads = 1024;
constexpr int kSortItems = EPIK_SORT_ITEMS;
constexpr int kSortBits = EPIK_SORT_BITS;
constexpr int kSortBitsSmall = EPIK_SORT_BITS_SMALL;

template <int kThreads, int kItems, int kBits>
struct SortedBlock {
  static constexpr int kChunk = kThreads * kItems;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, float, kBits>;
  // the sort's storage, then (after it) the chunk's sorted cells
  union Scratch {
    typename Sort::TempStorage sort;
    struct {
      uint32_t key[kChunk];
      float val[kChunk];
    } run;
  };
};

// bytes of dynamic shared memory: the tile's sums and counts, each padded to
// a multiple of 4 plus 4 for the write-out shift, and the scratch
template <int kThreads, int kItems, int kBits>
size_t sorted_smem_bytes(int tile_w) {
  const size_t tile = static_cast<size_t>(((tile_w + 3) & ~3) + 4) * 4;
  return 2 * tile + sizeof(typename SortedBlock<kThreads, kItems, kBits>::Scratch);
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))), "r"(bytes)
               : "memory");
}

// One chunk of a read's cells: loaded, sorted by branch, then added.
template <int kThreads, int kItems, int kBits>
struct SortedChunk {
  using Block = SortedBlock<kThreads, kItems, kBits>;
  uint32_t key[kItems];
  float val[kItems];

  // cells c0 .. c0 + kChunk - 1 of [0, len), in blocked order; a cell
  // outside the tile [lo, lo + n) is keyed n, past every branch of it (its
  // score is never read). Whether the block kept any (a barrier: it also
  // orders this chunk's sort after the previous chunk's adds).
  __device__ bool load(const int32_t* brow, const float* srow, int c0, int len, int lo, int n) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int c = c0 + threadIdx.x * kItems + k;
      const int j = c < len ? __ldg(brow + c) - lo : -1;
      const bool kept = static_cast<unsigned>(j) < static_cast<unsigned>(n);
      key[k] = kept ? static_cast<uint32_t>(j) : static_cast<uint32_t>(n);
      val[k] = kept ? __ldg(srow + c) : 0.f;
      any |= kept;
    }
    return __syncthreads_or(any);
  }

  // the stable sort by branch, the sorted cells staged in the scratch
  __device__ void sort(typename Block::Scratch& scratch, int n) {
    typename Block::Sort(scratch.sort).Sort(key, val, 0, 32 - __clz(n));
    __syncthreads();  // the sort's storage is free
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      scratch.run.key[threadIdx.x * kItems + k] = key[k];
      scratch.run.val[threadIdx.x * kItems + k] = val[k];
    }
  }

  // the head of each branch's run adds the run, in cell order, into the
  // branch's sum and its length into the count (after a barrier past sort)
  __device__ void add(const typename Block::Scratch& scratch, int n, float* ssum,
                      int* scnt) const {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x * kItems + k;
      const uint32_t j = key[k];
      if (j == static_cast<uint32_t>(n) || (i > 0 && scratch.run.key[i - 1] == j)) continue;
      float acc = ssum[j];
      int m = i;
      for (; m < Block::kChunk && scratch.run.key[m] == j; ++m) {
        acc = __fadd_rn(acc, scratch.run.val[m]);
      }
      ssum[j] = acc;
      scnt[j] += m - i;
    }
  }
};

// A block takes (read, tile) items blockIdx.x, blockIdx.x + gridDim.x, ...
// in turn. The tile leaves shared memory by cp.async.bulk, and the block
// loads and sorts the next item's first chunk (which touches only the
// scratch) before it waits for that copy to have read the tile, so one
// item's write-out overlaps the next one's loads and sort.
template <int kThreads, int kItems, int kBits>
__global__ void __launch_bounds__(kThreads)
    accumulate_sums_sorted_kernel(const int32_t* __restrict__ b, const float* __restrict__ s,
                                  const long long* __restrict__ ptr, float* __restrict__ S,
                                  int32_t* __restrict__ C, long long n_items, int B, int tile_w,
                                  int n_tiles) {
  using Chunk = SortedChunk<kThreads, kItems, kBits>;
  constexpr int kChunk = Chunk::Block::kChunk;
  extern __shared__ float4 smem[];
  const int tile4 = ((tile_w + 3) & ~3) + 4;
  float* sum_base = reinterpret_cast<float*>(smem);
  int* cnt_base = reinterpret_cast<int*>(sum_base + tile4);
  auto& scratch = *reinterpret_cast<typename Chunk::Block::Scratch*>(cnt_base + tile4);

  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long r = item / n_tiles;
    const int lo = static_cast<int>(item - r * n_tiles) * tile_w;
    const int n = min(B - lo, tile_w);
    const long long out0 = r * B + lo;  // element offset of the tile's outputs
    const int shift = static_cast<int>(out0 & 3);
    float* ssum = sum_base + shift;
    int* scnt = cnt_base + shift;
    const long long c_begin = ptr[r];
    const int len = static_cast<int>(ptr[r + 1] - c_begin);
    const int32_t* brow = b + c_begin;
    const float* srow = s + c_begin;

    // the first chunk, while the previous item's tile is still being copied
    Chunk chunk;
    const bool first = chunk.load(brow, srow, 0, len, lo, n);
    if (first) chunk.sort(scratch, n);
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    for (int i = threadIdx.x; i < tile4 / 4; i += kThreads) {
      smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<int4*>(cnt_base)[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    if (first) chunk.add(scratch, n, ssum, scnt);
    for (int c0 = kChunk; c0 < len; c0 += kChunk) {
      if (!chunk.load(brow, srow, c0, len, lo, n)) continue;
      chunk.sort(scratch, n);
      __syncthreads();
      chunk.add(scratch, n, ssum, scnt);
    }

    // ---- write-out: scalars up to a 16-byte boundary of S, then one bulk
    // copy each of S's and C's 16-byte runs --------------------------------
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    float* Srow = S + out0;
    int32_t* Crow = C + out0;
    const int head = min(n, (4 - shift) & 3);
    const int n4 = (n - head) >> 2;
    for (int j = threadIdx.x; j < head; j += kThreads) {
      Srow[j] = ssum[j];
      Crow[j] = scnt[j];
    }
    for (int j = head + 4 * n4 + threadIdx.x; j < n; j += kThreads) {
      Srow[j] = ssum[j];
      Crow[j] = scnt[j];
    }
    if (threadIdx.x == 0 && n4 > 0) {
      bulk_store(Srow + head, ssum + head, 16u * n4);
      bulk_store(Crow + head, scnt + head, 16u * n4);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // shared memory stays the block's until the last copies have read it
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// How a call at width B is cut: n_tiles tiles of tile_w branches, one block
// of `threads` threads and `smem` bytes of shared memory per (read, tile);
// the row-pointer form's radix bits a pass (0 for the owner warps).
struct Layout {
  int tile_w;
  int n_tiles;
  int threads;
  size_t smem;
  int radix_bits;
};

// the fewest tiles of equal width, the last ragged, whose block's `smem`
// bytes fit the current device's opt-in shared memory per block (227 KB on
// the H100)
template <class Smem>
cudaError_t plan(int B, int threads, Smem smem, Layout* out) {
  int dev, limit;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (B < 1 || smem(1) > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  int n_tiles = 1;
  while (smem((B + n_tiles - 1) / n_tiles) > static_cast<size_t>(limit)) ++n_tiles;
  out->tile_w = (B + n_tiles - 1) / n_tiles;
  out->n_tiles = (B + out->tile_w - 1) / out->tile_w;
  out->threads = threads;
  out->smem = smem(out->tile_w);
  out->radix_bits = 0;
  return cudaSuccess;
}

template <int kWarps, bool kCounts>
cudaError_t plan_owners(int B, Layout* out) {
  return plan(B, kWarps * 32, smem_bytes<kWarps, kCounts>, out);
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, const Layout& how) {
  // always: the 48 KB default counts static bytes too
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(how.smem));
}

// kSortBits' block, or kSortBitsSmall's where that takes fewer tiles
cudaError_t plan_sorted(int B, Layout* out) {
  Layout small;
  cudaError_t err = plan(B, kSortThreads, sorted_smem_bytes<kSortThreads, kSortItems, kSortBits>,
                         out);
  if (err == cudaSuccess) {
    err = plan(B, kSortThreads, sorted_smem_bytes<kSortThreads, kSortItems, kSortBitsSmall>,
               &small);
  }
  if (err != cudaSuccess) return err;
  out->radix_bits = kSortBits;
  if (small.n_tiles < out->n_tiles) {
    *out = small;
    out->radix_bits = kSortBitsSmall;
  }
  return cudaSuccess;
}

// The row-pointer form's grid: EPIK_SORT_PERSISTENT (the default) as many
// blocks as the card holds at once, each taking items in turn; 0, one block
// an item (kernel_sweep.py builds it).
#ifndef EPIK_SORT_PERSISTENT
#define EPIK_SORT_PERSISTENT 1
#endif

template <int kBits>
cudaError_t launch_sorted(const void* b, const void* s, const void* ptr, void* S, void* C,
                          int R, int B, const Layout& how, cudaStream_t stream) {
  const auto kernel = accumulate_sums_sorted_kernel<kSortThreads, kSortItems, kBits>;
  cudaError_t err = opt_in(kernel, how);
  const long long items = static_cast<long long>(R) * how.n_tiles;
  long long blocks = items;
  if (err == cudaSuccess && EPIK_SORT_PERSISTENT) {
    int dev, sms, per_sm;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, how.threads, how.smem);
    }
    if (err == cudaSuccess) blocks = std::min(items, static_cast<long long>(sms) * std::max(per_sm, 1));
  }
  if (err != cudaSuccess) return err;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), how.threads, how.smem, stream>>>(
      static_cast<const int32_t*>(b), static_cast<const float*>(s),
      static_cast<const long long*>(ptr), static_cast<float*>(S), static_cast<int32_t*>(C), items,
      B, how.tile_w, how.n_tiles);
  return cudaSuccess;
}

template <int kWarps, bool kCounts>
int launch(const void* b, const void* s, void* S, void* C, int R, int PP, int B,
           cudaStream_t stream) {
  Layout how;
  cudaError_t err = plan_owners<kWarps, kCounts>(B, &how);
  if (err == cudaSuccess) err = opt_in(accumulate_sums_kernel<kWarps, kCounts>, how);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(R) * how.n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  accumulate_sums_kernel<kWarps, kCounts>
      <<<static_cast<unsigned>(blocks), how.threads, how.smem, stream>>>(
          static_cast<const int32_t*>(b), static_cast<const float*>(s), static_cast<float*>(S),
          static_cast<int32_t*>(C), PP, B, how.tile_w, how.n_tiles);
  return 0;
}

// Owner warps per block. With counts (160 KB of sums and counts at B =
// 19,999, one block per SM) 32 warps; without (80 KB, two blocks per SM) 16.
// Each was the faster of 512 and 1,024 threads on the H100 (PERF.md).
constexpr int kWarpsCounts = 32;
constexpr int kWarpsSums = 16;

}  // namespace

// The layout epik_accumulate_sums (`row_ptr` 0) or epik_accumulate_sums_csr
// (`row_ptr` 1, counts only) takes at width B on the current device: out =
// {tile_w, n_tiles, threads per block, shared memory bytes per block, radix
// bits a pass of the row-pointer form's sort (0 for the (R, PP) forms)}.
// Returns a cudaError_t (cudaErrorInvalidValue for B < 1).
extern "C" int epik_accumulate_sums_layout(int B, int counts, int row_ptr, int* out) {
  Layout how;
  if (row_ptr && !counts) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = row_ptr  ? plan_sorted(B, &how)
                          : counts ? plan_owners<kWarpsCounts, true>(B, &how)
                                   : plan_owners<kWarpsSums, false>(B, &how);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = how.tile_w;
  out[1] = how.n_tiles;
  out[2] = how.threads;
  out[3] = static_cast<int>(how.smem);
  out[4] = how.radix_bits;
  return 0;
}

// b: int32 (R, PP) branch ids (< B, or >= B for trash); s: f32 (R, PP);
// S: f32 (R, B) and C: int32 (R, B), both 16-byte aligned; C is written only
// when `counts` != 0. The branch range is cut as epik_accumulate_sums_layout
// says, one block per (read, tile). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int epik_accumulate_sums(const void* b, const void* s, void* S,
                                    void* C, int R, int PP, int B, int counts,
                                    void* stream) {
  if (R > 0 && B > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = counts ? launch<kWarpsCounts, true>(b, s, S, C, R, PP, B, st)
                           : launch<kWarpsSums, false>(b, s, S, C, R, PP, B, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// The row-pointer form with counts: b int32 and s f32 flat cells, ptr int64
// (R+1) nondecreasing offsets into them (read r's cells are [ptr[r],
// ptr[r+1]), each read at most 2^31 - 1 cells); S f32 (R, B) and C int32
// (R, B), both 16-byte aligned. Its own block
// (epik_accumulate_sums_layout(B, 1, 1)), one per (read, tile). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int epik_accumulate_sums_csr(const void* b, const void* s, const void* ptr,
                                        void* S, void* C, int R, int B, void* stream) {
  if (R > 0 && B > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    Layout how;
    cudaError_t err = plan_sorted(B, &how);
    if (err == cudaSuccess) {
      err = how.radix_bits == kSortBits
                ? launch_sorted<kSortBits>(b, s, ptr, S, C, R, B, how, st)
                : launch_sorted<kSortBitsSmall>(b, s, ptr, S, C, R, B, how, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
