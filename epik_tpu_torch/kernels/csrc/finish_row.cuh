// The per-read placement finish, shared by finish_topk.cu and
// accumulate_packed_topk.cu: score correction, LWR log-sum over all branches
// and top-K, written into one row of the slim result pack
// [scores K | idx K | log_sum | n | zero_sum]. Math, per read over b < B:
//
//   corrected[b] = (Sp[b] + m * log_eps) / k   where Sp[b] > 0, else -inf
//   n            = #touched;  n_not = B - n;  npl_exp = m * log_eps / k
//   max_t        = max(max_b corrected, n_not > 0 ? npl_exp : -inf)
//   log_sum      = max_t + log(sum_touched 10^(c - max_t)
//                             + n_not * 10^(npl_exp - max_t)) / ln 10   (Q4)
//   zero_sum     = max_c < -323.6 and (npl_exp < -323.6 or n_not <= 0)  (Q3)
//   top-K        ordered by value descending, then branch index ascending
//                (jax.lax.top_k's tie rule; torch.topk does not promise it)
//
// One block finishes one read. `corr` is B floats of shared memory; count,
// max and sum use warp-shuffle block reductions. Top-K runs as K rounds;
// round j takes the best element strictly after round j-1's pick in the
// (value desc, index asc) total order, so -inf slots of a read with n < K
// still come out with distinct, in-range indices (the lowest untouched
// branches), as a stable sort gives.
//
// Rounding: every float operation of the correction is an explicit
// round-to-nearest intrinsic (and the library is built with -fmad=false), so
// no multiply-add is contracted into an FMA and the scores are bit-equal to
// the plain PyTorch version. exp and log are the full-precision expf/logf.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace epik {

constexpr float kPow10Zero = -323.6f;  // where IEEE-double 10^x rounds to 0
constexpr float kLn10 = 2.302585092994046f;

// total order of the top-K: value descending, then branch index ascending
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ inline float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline int block_sum_int(int x, int* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < (blockDim.x >> 5) ? red[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < (blockDim.x >> 5) ? red[lane] : -CUDART_INF_F;
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

// block-wide first element of the (value desc, index asc) order
__device__ inline void block_best(float& v, int& i, float* red_v, int* red_i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (lane < (blockDim.x >> 5)) {
    v = red_v[lane];
    i = red_i[lane];
  } else {
    v = -CUDART_INF_F;
    i = INT_MAX;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Finish one read with the whole block. `sp(b)` returns the read's shifted
// sum at branch b; it may read the same shared memory that `corr` overwrites,
// since each thread reads index b before it writes index b. `red_f` and
// `red_i` are 32-entry shared scratch; `orow` is the read's (2K+3) output row.
template <class ShiftedSum>
__device__ void finish_row(ShiftedSum sp, float* corr, int B, int K, float mr,
                           float kf, float log_eps, float* red_f, int* red_i,
                           float* orow) {
  const float ninf = -CUDART_INF_F;
  int n_loc = 0;
  float max_loc = ninf;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float s = sp(b);
    float c = ninf;
    if (s > 0.f) {
      c = __fdiv_rn(__fadd_rn(s, __fmul_rn(mr, log_eps)), kf);
      ++n_loc;
      max_loc = fmaxf(max_loc, c);
    }
    corr[b] = c;
  }
  const int n = block_sum_int(n_loc, red_i);
  const float max_c = block_max(max_loc, red_f);

  // ---- LWR over ALL branches (quirk Q4), underflow flag (quirk Q3) ---------
  const float npl_exp = __fdiv_rn(__fmul_rn(mr, log_eps), kf);
  const float n_not = __fsub_rn(static_cast<float>(B), static_cast<float>(n));
  const float max_t = fmaxf(max_c, n_not > 0.f ? npl_exp : ninf);
  float sum_loc = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float c = corr[b];
    if (c > ninf) sum_loc += expf(__fmul_rn(__fsub_rn(c, max_t), kLn10));
  }
  const float touched_sum = block_sum(sum_loc, red_f);
  const float untouched =
      n_not > 0.f
          ? __fmul_rn(n_not, expf(__fmul_rn(__fsub_rn(npl_exp, max_t), kLn10)))
          : 0.f;
  const float sum10 = __fadd_rn(touched_sum, untouched);
  const float log_sum = __fadd_rn(max_t, __fdiv_rn(logf(sum10), kLn10));
  const bool zero_sum =
      max_c < kPow10Zero && (npl_exp < kPow10Zero || n_not <= 0.f);

  // ---- top-K: K rounds, each the first element after the previous pick ----
  float pv = CUDART_INF_F;
  int pi = -1;
  for (int j = 0; j < K; ++j) {
    float bv = ninf;
    int bi = INT_MAX;
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
      const float c = corr[b];
      if (before(pv, pi, c, b) && before(c, b, bv, bi)) {
        bv = c;
        bi = b;
      }
    }
    block_best(bv, bi, red_f, red_i);
    if (threadIdx.x == 0) {
      orow[j] = bv;
      orow[K + j] = static_cast<float>(bi);
    }
    pv = bv;
    pi = bi;
  }
  if (threadIdx.x == 0) {
    orow[2 * K] = log_sum;
    orow[2 * K + 1] = static_cast<float>(n);
    orow[2 * K + 2] = zero_sum ? 1.f : 0.f;
  }
}

}  // namespace epik
