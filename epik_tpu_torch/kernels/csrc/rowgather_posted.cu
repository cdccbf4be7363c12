// The gather 1d over a shifted f32 plane's posted cells: Sp[r] = sum_w
// plane[rows[r, w]], read from a row-compressed copy of the plane's non-zero
// cells instead of its rows.
//
// Where a shifted plane is wide and sparse (a genome-scale tree: 21,248
// columns, ~12 of a row's cells posted, 0.056%), 1d (rowgather_sum.cu's slice
// layout) moves a whole 85 KB row for every window, ~1,500 bytes for each
// byte that changes a sum. A shifted cell is above zero where the key has a
// posting and exactly 0 where it has none, so a sum over the posted cells
// alone, added in window order from +0, has the bits of 1d's: x + 0.0 == x
// for every x >= 0, and a row's posted columns are distinct, so the adds of
// one window to one read never meet on a column.
//
// The index (engine/state.py::build_posted, read back from the finished
// plane): int64 off (n_rows + 1), a row's cells in [off[row], off[row + 1]),
// the all-zero row's range empty; int2 cells (nnz), (column, f32 value bits),
// a row's in column order.
//
// One block a read (kPostedThreads threads): the read's bw f32 sums in
// dynamic shared memory, zeroed; its windows a tile of kPostedThreads at a
// time (one row id a thread, its range's start and length, a block scan of
// the lengths); the tile's cells, in window order, kPostedCells at a time:
// each thread loads kPerThread consecutive ones into registers (all its loads
// in flight at once), the block sorts them by column with a stable radix sort
// (cub::BlockRadixSort over the column's 16 bits), so each column's cells
// stay in window order, and the first thread of each column's run adds the
// run to its sum in that order, one __fadd_rn each (no FMA, no atomics; a
// run's columns are its own, so no two threads meet); last, the whole row out
// with 16-byte stores. No read order: each read's cells are read once, so
// there is nothing for an order to share.
// Bound on the H100: the read's cells (8 bytes each, ~1,700 a 150 bp read at
// ~12 a key) and its bw sums written, 4 bytes each; at wol10k's 2,000 x 141
// windows and 21,248 columns ~27 MB of cells and 170 MB of sums: 0.059 ms.
// On an H100 (kernel_sweep.py --only posted, the wol10k cell's shapes) the
// first design, one warp adding the staged cells window after window (a
// __syncwarp between windows), took 0.24 ms against 1d's 7.7: its adds, a
// chain of ~141 windows a read with two blocks an SM, were half of it (0.12
// ms; the write-out 0.05, the staging 0.025, the rest 0.03). In one later
// call the sort took 0.190 ms against that design's 0.306 and 1d's 7.0;
// tiles of 1,024 cells 0.176 against 2,048's 0.190 (4,096: 0.339, one block
// an SM), 128 and 512 threads 0.306 and 0.206.
// Shared memory: bw sums + the sorted tile + the window tile's starts and
// scan (posted_smem), and the sort's own; 2 blocks an SM at 21,248 columns;
// the widest plane a block takes is epik_rowgather_posted_smem_limit's, and
// the columns' ids must fit the sort's 16 bits.
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include <cstdint>

// The block: threads (one window of the tile a thread), cells a tile, and the
// blocks an SM the register budget names. The macros let kernel_sweep.py
// build other blocks.
#ifndef EPIK_POSTED_THREADS
#define EPIK_POSTED_THREADS 256
#endif
#ifndef EPIK_POSTED_CELLS
#define EPIK_POSTED_CELLS 1024
#endif
#ifndef EPIK_POSTED_MIN_BLOCKS
#define EPIK_POSTED_MIN_BLOCKS 2
#endif

namespace {

constexpr int kPostedThreads = EPIK_POSTED_THREADS;
constexpr int kPostedCells = EPIK_POSTED_CELLS;
// a tile's cells a thread, consecutive ones, all loads of them in flight
constexpr int kPerThread = kPostedCells / kPostedThreads;
static_assert(kPerThread * kPostedThreads == kPostedCells, "whole cells a thread");
// the sort's key bits: a column id below 2^16 (the largest key pads a tile)
constexpr int kColumnBits = 16;
constexpr unsigned kPadKey = (1u << kColumnBits) - 1;

// Dynamic shared memory of a block at width bw: the bw sums | the tile's
// sorted cells | the window tile's starts (int64) | its scan (one past it).
size_t posted_smem(int bw) {
  return static_cast<size_t>(bw) * sizeof(float) + kPostedCells * sizeof(int2) +
         kPostedThreads * sizeof(long long) + (kPostedThreads + 1) * sizeof(int);
}

// The last window w of the tile with pos[w] <= g (pos[0] == 0 <= g < pos[nw]):
// the window that holds the tile's cell g (an empty window never does).
__device__ __forceinline__ int window_of(const int* pos, int nw, int g) {
  int lo = 0, hi = nw;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pos[mid] <= g) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Block r sums read r: out[r] = the adds of its windows' posted cells, in
// window order for each column, into zeros.
__global__ void __launch_bounds__(kPostedThreads, EPIK_POSTED_MIN_BLOCKS)
    rowgather_posted_kernel(const long long* __restrict__ off, const int2* __restrict__ cells,
                            const int32_t* __restrict__ rows, float* __restrict__ out, int W,
                            int bw) {
  using Scan = cub::BlockScan<int, kPostedThreads>;
  using Sort = cub::BlockRadixSort<unsigned, kPostedThreads, kPerThread, int>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Sort::TempStorage sort;
  } tmp;
  extern __shared__ float4 posted_smem4[];
  float* S = reinterpret_cast<float*>(posted_smem4);
  int2* staged = reinterpret_cast<int2*>(S + bw);
  long long* start = reinterpret_cast<long long*>(staged + kPostedCells);
  int* pos = reinterpret_cast<int*>(start + kPostedThreads);
  const int t = threadIdx.x;
  const int n4 = bw >> 2;
  for (int i = t; i < n4; i += kPostedThreads) posted_smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int32_t* my = rows + static_cast<long long>(blockIdx.x) * W;
  for (int w0 = 0; w0 < W; w0 += kPostedThreads) {
    const int nw = min(kPostedThreads, W - w0);
    long long st = 0;
    int len = 0;
    if (t < nw) {
      const int row = my[w0 + t];
      st = off[row];
      len = static_cast<int>(off[row + 1] - st);
    }
    int p, total;
    Scan(tmp.scan).ExclusiveSum(len, p, total);
    start[t] = st;
    pos[t] = p;
    if (t == 0) pos[kPostedThreads] = total;  // so pos[nw] == total
    __syncthreads();  // also: the zeroed sums, before the first add
    for (int c0 = 0; c0 < total; c0 += kPostedCells) {
      const int n = min(kPostedCells, total - c0);
      // this thread's cells, [f0, f0 + kPerThread) of the tile, in window order
      const int f0 = t * kPerThread;
      unsigned key[kPerThread];
      int val[kPerThread];
      int w = f0 < n ? window_of(pos, nw, c0 + f0) : 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int g = c0 + f0 + j;
        key[j] = kPadKey;
        val[j] = 0;
        if (f0 + j < n) {
          while (pos[w + 1] <= g) ++w;
          const int2 c = __ldg(cells + start[w] + (g - pos[w]));
          key[j] = static_cast<unsigned>(c.x);
          val[j] = c.y;
        }
      }
      // stable: a column's cells keep their window order
      Sort(tmp.sort).Sort(key, val, 0, kColumnBits);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        staged[f0 + j] = make_int2(static_cast<int>(key[j]), val[j]);
      }
      __syncthreads();
      // the first cell of each column's run adds the run, in its order
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = f0 + j;
        const int col = static_cast<int>(key[j]);
        if (i < n && (i == 0 || staged[i - 1].x != col)) {
          float acc = S[col];
          for (int r = i; r < n && staged[r].x == col; ++r) {
            acc = __fadd_rn(acc, __int_as_float(staged[r].y));
          }
          S[col] = acc;
        }
      }
      __syncthreads();  // the tile is added before the next one is staged
    }
    // the scan's storage and the tile's starts are reused by the next tile
    __syncthreads();
  }
  float4* o = reinterpret_cast<float4*>(out + static_cast<long long>(blockIdx.x) * bw);
  for (int i = t; i < n4; i += kPostedThreads) o[i] = posted_smem4[i];
}

}  // namespace

// off: int64 (n_rows + 1) and cells: int2 (nnz) (column, f32 bits), the
// plane's posted cells row by row; rows: int32 (R, W) plane rows, each in
// [0, n_rows); out: f32 (R, bw), bw % 4 == 0, bw <= 2^16. Launches on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for a width
// not a multiple of 4 or past the sort's 16 bits, an invalid configuration
// error past the shared memory a block may take).
extern "C" int epik_rowgather_sum_posted(const void* off, const void* cells, const void* rows,
                                         void* out, int R, int W, int bw, void* stream) {
  if (bw <= 0 || bw % 4 != 0 || bw > (1 << kColumnBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = posted_smem(bw);
  const cudaError_t err = cudaFuncSetAttribute(
      rowgather_posted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0) {
    rowgather_posted_kernel<<<R, kPostedThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(off), static_cast<const int2*>(cells),
        static_cast<const int32_t*>(rows), static_cast<float*>(out), W, bw);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a launch at width bw asks.
extern "C" long long epik_rowgather_posted_smem(int bw) {
  return static_cast<long long>(posted_smem(bw));
}

// Bytes of dynamic shared memory a block may take on the current device: the
// opt-in limit less the kernel's static shared memory. Negative: minus a CUDA
// error code.
extern "C" long long epik_rowgather_posted_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, rowgather_posted_kernel) != cudaSuccess) {
    return -static_cast<long long>(cudaGetLastError());
  }
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// Blocks an SM holds at width bw, as the card's occupancy calculator gives
// them for the compiled kernel. Negative: minus a CUDA error code.
extern "C" int epik_rowgather_posted_blocks_per_sm(int bw) {
  const size_t smem = posted_smem(bw);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(rowgather_posted_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rowgather_posted_kernel,
                                                        kPostedThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
