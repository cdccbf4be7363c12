// The per-read placement finish, shared by finish_topk.cu,
// accumulate_packed_topk.cu, rowgather_sum.cu (the group layout's
// rowgather_sum_topk, rowgather_sum_cols, rowgather_sum_counts_topk and
// rowgather_sum_counts_cols: a warp a read through warp_finish / warp_cols,
// the list finish and cols_list at G = 1), rowgather_posted.cu (the posted
// gather with the finish fused in: the list finish, warp_finish past the
// list's room) and, through cols_list, finish_cols.cu (the column-sharded
// finish of one shard): score correction, LWR log-sum
// over all branches and top-K, written into one row of the slim result pack
// [scores K | idx K | log_sum | n | zero_sum] (SlimRow) or of the full pack's
// body [scores K | wr K | idx K | counts K | n | zero_sum] (FullRow). Math,
// per read over b < B:
//
//   corrected[b] = (Sp[b] + m * log_eps) / k   where Sp[b] > 0, else -inf
//   (with exact counts C, the classic plane and the CSR steps:
//    corrected[b] = (S[b] + diff * log_eps) / k where C[b] > 0, diff = m - C[b]
//    wrapped to 2^64 where negative, quirk Q1: correct_counts)
//   n            = #touched;  n_not = B - n;  npl_exp = m * log_eps / k
//   max_t        = max(max_b corrected, n_not > 0 ? npl_exp : -inf)
//   log_sum      = max_t + log(sum_touched 10^(c - max_t)
//                             + n_not * 10^(npl_exp - max_t)) / ln 10   (Q4)
//   zero_sum     = max_c < -323.6 and (npl_exp < -323.6 or n_not <= 0)  (Q3)
//   top-K        ordered by value descending, then branch index ascending
//                (jax.lax.top_k's tie rule; torch.topk does not promise it)
//   wr[j]        10^(score[j] - log_sum), 0 where zero_sum or score[j] < -323.6
//   counts[j]    C[idx[j]] (0 in the slots past n)
//
// Only the touched branches (Sp > 0, or C > 0) carry a score; every untouched branch is
// -inf and enters the log-sum only through the one (B - n) product. So the
// finish runs over a list of the touched branch ids, in ascending order:
//
// * build_mask / compact_mask: one bit per branch (a warp ballot of Sp > 0,
//   or bits set by the caller), then one block-wide exclusive scan of the
//   words' popcounts writes the ids in index order. The list's order does not
//   depend on the order in which any thread ran, so the log-sum's order of
//   adds, and with it its bits, is the same from launch to launch.
// * finish_list: max (list_max), exp-sum (warp shuffles, one block reduction
//   each) and top-K (topk_list) over the list. Each warp runs K rounds of a
//   shuffle arg-best over
//   its own list entries, each round the best element strictly after the
//   previous pick in the (value desc, index asc) order; one warp then merges
//   the warps' K candidates. No block barrier per round. Where n < K the
//   remaining slots take -inf and the lowest untouched ids in ascending
//   order, as the plain version's stable sort gives.
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

constexpr float kU64 = 18446744073709551616.f;  // 2^64, the wrapped size_t (quirk Q1)

// the corrected score of a touched branch (s > 0)
__device__ __forceinline__ float correct(float s, float mr, float kf, float log_eps) {
  return __fdiv_rn(__fadd_rn(s, __fmul_rn(mr, log_eps)), kf);
}

// the corrected score of a touched branch from its sum s and its exact count
// c > 0, in the operation order of placer.py::finish_scores: diff = m - c,
// 2^64 where negative (c > m only through the ambiguous fan-out: the
// reference's size_t wraps, quirk Q1), then (s + diff * log_eps) / k
__device__ __forceinline__ float correct_counts(float s, int c, float mr, float kf,
                                                float log_eps) {
  float diff = __fsub_rn(mr, __int2float_rn(c));
  if (diff < 0.f) diff = kU64;
  return __fdiv_rn(__fadd_rn(s, __fmul_rn(diff, log_eps)), kf);
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

// Block-wide exclusive prefix sum of x in thread order; `total` gets the sum.
// `red` is 32 ints of shared scratch. Every thread of the block must call it.
__device__ inline int block_exclusive_scan(int x, int* red, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int w = lane < nw ? red[lane] : 0;
  int winc = w;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, winc, o);
    if (lane >= o) winc += y;
  }
  total = __shfl_sync(0xffffffffu, winc, 31);
  const int before_warp = __shfl_sync(0xffffffffu, winc - w, warp);
  return before_warp + inc - x;
}

// mask[w] bit j = touched(32 w + j), for the ceil(B / 32) words; one ballot
// per word, words spread over the warps. Does not synchronise.
template <class Touched>
__device__ void build_mask(Touched touched, int B, unsigned* mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5, nwords = (B + 31) >> 5;
  constexpr int kUnroll = 8;  // loads in flight per lane
  for (int w0 = warp * kUnroll; w0 < nwords; w0 += nw * kUnroll) {
    bool t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = (w0 + u) * 32 + lane;
      t[u] = b < B && touched(b);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned bal = __ballot_sync(0xffffffffu, t[u]);
      if (lane == 0 && w0 + u < nwords) mask[w0 + u] = bal;
    }
  }
}

// The set bits of mask[0 .. nwords) as ids (int, or 16 bits where B <= 2^16)
// in ascending order; returns their
// count n (in every thread). Thread t takes a contiguous run of words, so a
// block scan of the runs' popcounts places every id. With `clear`, the words
// are zeroed as they are read. Starts and ends synchronised.
template <class Id>
__device__ int compact_mask(unsigned* mask, int nwords, Id* ids, int* red, bool clear) {
  __syncthreads();  // the mask is complete
  const int per = (nwords + blockDim.x - 1) / blockDim.x;
  const int w0 = threadIdx.x * per, w1 = min(nwords, w0 + per);
  int cnt = 0;
  for (int w = w0; w < w1; ++w) cnt += __popc(mask[w]);
  int n;
  int at = block_exclusive_scan(cnt, red, n);
  for (int w = w0; w < w1; ++w) {
    unsigned bits = mask[w];
    if (clear) mask[w] = 0u;
    while (bits) {
      ids[at++] = static_cast<Id>(w * 32 + __ffs(bits) - 1);
      bits &= bits - 1u;
    }
  }
  __syncthreads();
  return n;
}

// Scratch of finish_list: a 32-entry reduction array and the warps' top-K
// candidates (blockDim / 32 * K values and ids).
struct FinishScratch {
  float* red_f;
  float* cand_v;
  int* cand_i;
};

// The largest corrected score of the list (-inf when n == 0), in every
// thread.
template <class Corr>
__device__ float list_max(Corr corr, int n, float* red_f) {
  float max_loc = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) max_loc = fmaxf(max_loc, corr(i));
  return block_max(max_loc, red_f);
}

// The top-K of a read's touched list by (value desc, index asc): `ids` holds
// the n touched ids (< B) in ascending order, `corr(i)` the corrected score of
// entry i (finite). Lane 0 of warp 0 calls emit(j, value, id) for j = 0 .. K-1
// in order; where n < K the slots past n take -inf and the lowest untouched ids
// in ascending order, as the plain version's stable sort gives. Every thread of
// the block must call it; it returns true in warp 0, false in the other warps
// right after the block barrier that hands warp 0 the candidates. The caller
// synchronises before reusing the list or the scratch.
template <class Corr, class Id, class Emit>
__device__ bool topk_list(Corr corr, const Id* ids, int n, int K, FinishScratch s,
                          Emit emit) {
  const float ninf = -CUDART_INF_F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ---- per warp: K rounds of a shuffle arg-best over its entries -------------
  float pv = CUDART_INF_F;
  int pi = -1;
  for (int j = 0; j < K; ++j) {
    float bv = ninf;
    int bi = INT_MAX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float c = corr(i);
      const int b = static_cast<int>(ids[i]);
      if (before(pv, pi, c, b) && before(c, b, bv, bi)) {
        bv = c;
        bi = b;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s.cand_v[warp * K + j] = bv;
      s.cand_i[warp * K + j] = bi;
    }
    pv = bv;
    pi = bi;
  }
  __syncthreads();
  if (warp != 0) return false;

  // ---- warp 0 merges the candidates, then fills the slots past n ------------
  const int nc = (blockDim.x >> 5) * K;
  const int live = min(n, K);
  pv = CUDART_INF_F;
  pi = -1;
  for (int j = 0; j < live; ++j) {
    float bv = ninf;
    int bi = INT_MAX;
    for (int i = lane; i < nc; i += 32) {
      const float c = s.cand_v[i];
      const int b = s.cand_i[i];
      if (b != INT_MAX && before(pv, pi, c, b) && before(c, b, bv, bi)) {
        bv = c;
        bi = b;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) emit(j, bv, bi);
    pv = bv;
    pi = bi;
  }
  if (lane == 0) {
    // n < K: -inf at the lowest untouched ids, walking the sorted list
    int j = live, p = 0;
    for (int b = 0; j < K; ++b) {
      if (p < n && static_cast<int>(ids[p]) == b) {
        ++p;
      } else {
        emit(j, ninf, b);
        ++j;
      }
    }
  }
  return true;
}

// Where finish_list writes a read's result: slot(j, value, id, log_sum,
// zero_sum) for each of the K top-K slots, then tail(log_sum, n, zero_sum),
// all from lane 0 of warp 0.
//
// SlimRow: the slim pack row [scores K | idx K | log_sum | n | zero_sum].
struct SlimRow {
  float* row;
  int K;
  __device__ void slot(int j, float v, int b, float, bool) const {
    row[j] = v;
    row[K + j] = static_cast<float>(b);
  }
  __device__ void tail(float log_sum, int n, bool zero_sum) const {
    row[2 * K] = log_sum;
    row[2 * K + 1] = static_cast<float>(n);
    row[2 * K + 2] = zero_sum ? 1.f : 0.f;
  }
};

// FullRow: the full pack's body row [scores K | wr K | idx K | counts K | n |
// zero_sum] (placer.py::_pack_outputs), `count(b)` giving branch b's exact
// count. wr in the plain version's order: exp((score - log_sum) * ln 10).
template <class Count>
struct FullRow {
  float* row;
  int K;
  Count count;
  __device__ void slot(int j, float v, int b, float log_sum, bool zero_sum) const {
    row[j] = v;
    row[K + j] = zero_sum || v < kPow10Zero
                     ? 0.f
                     : expf(__fmul_rn(__fsub_rn(v, log_sum), kLn10));
    row[2 * K + j] = static_cast<float>(b);
    row[3 * K + j] = __int2float_rn(count(b));
  }
  __device__ void tail(float, int n, bool zero_sum) const {
    row[4 * K] = static_cast<float>(n);
    row[4 * K + 1] = zero_sum ? 1.f : 0.f;
  }
};

template <class Count>
__device__ FullRow<Count> full_row(float* row, int K, Count count) {
  return FullRow<Count>{row, K, count};
}

// Finish one read with the whole block from its touched list: `ids` holds the
// n touched branch ids in ascending order, and `corr(i)` returns the corrected
// score of entry i (finite). `out` (SlimRow or FullRow) takes the read's row.
// Ends with the output written by warp 0; the caller synchronises before
// reusing the list or the scratch.
template <class Corr, class Id, class Row>
__device__ void finish_list(Corr corr, const Id* ids, int n, int B, int K,
                            float mr, float kf, float log_eps, FinishScratch s,
                            Row out) {
  const float ninf = -CUDART_INF_F;
  const float max_c = list_max(corr, n, s.red_f);

  // ---- LWR over ALL branches (quirk Q4), underflow flag (quirk Q3) ---------
  const float npl_exp = __fdiv_rn(__fmul_rn(mr, log_eps), kf);
  const float n_not = __fsub_rn(static_cast<float>(B), static_cast<float>(n));
  const float max_t = fmaxf(max_c, n_not > 0.f ? npl_exp : ninf);
  float sum_loc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sum_loc += expf(__fmul_rn(__fsub_rn(corr(i), max_t), kLn10));
  }
  // every thread holds the same block sum, so the same log-sum bits
  const float touched_sum = block_sum(sum_loc, s.red_f);
  const float untouched =
      n_not > 0.f ? __fmul_rn(n_not, expf(__fmul_rn(__fsub_rn(npl_exp, max_t), kLn10)))
                  : 0.f;
  const float log_sum =
      __fadd_rn(max_t, __fdiv_rn(logf(__fadd_rn(touched_sum, untouched)), kLn10));
  const bool zero_sum = max_c < kPow10Zero && (npl_exp < kPow10Zero || n_not <= 0.f);

  // ---- top-K into the row's slots --------------------------------------------
  const bool lead = topk_list(corr, ids, n, K, s, [out, log_sum, zero_sum](int j, float v,
                                                                          int b) {
    out.slot(j, v, b, log_sum, zero_sum);
  });
  if (lead && (threadIdx.x & 31) == 0) out.tail(log_sum, n, zero_sum);
}

// The column-sharded finish of one read over one shard's touched list, the
// per-shard half of epik_tpu/parallel/sharding.py::_lwr_topk_cols: `ids`
// holds the shard's n touched local columns in ascending order and `corr(i)`
// the corrected score of entry i (finite). Lane 0 of warp 0 writes the
// shard's partial pack row [values K | global ids K | n_s | max_s | e_s]:
// the top K as topk_list gives them (ties to the lowest column; past n the
// lowest untouched columns at -inf), each id written as local + col0; max_s
// the list's largest score (-inf when n == 0); e_s = sum over the list of
// 10^(corrected - max_s) (0 when n == 0), one block reduction. The merge
// rescales each e_s by 10^(max_s - max_t), exactly 1 where max_s = max_t.
// With `crow`, the candidates' exact counts count(local id) go there (the
// classic form; 0 for the untouched slots). Ends with the output written by
// warp 0; the caller synchronises before reusing the list or the scratch.
template <class Corr, class Id, class Count>
__device__ void cols_list(Corr corr, const Id* ids, int n, int K, int col0, FinishScratch s,
                          float* orow, int* crow, Count count) {
  const float max_s = list_max(corr, n, s.red_f);
  float sum_loc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sum_loc += expf(__fmul_rn(__fsub_rn(corr(i), max_s), kLn10));
  }
  const float e_s = block_sum(sum_loc, s.red_f);
  const bool lead = topk_list(corr, ids, n, K, s, [orow, crow, count, K, col0](int j, float v,
                                                                              int b) {
    orow[j] = v;
    orow[K + j] = static_cast<float>(b + col0);
    if (crow != nullptr) crow[j] = count(b);
  });
  if (lead && threadIdx.x == 0) {
    orow[2 * K] = static_cast<float>(n);
    orow[2 * K + 1] = max_s;
    orow[2 * K + 2] = e_s;
  }
}

// ---- one read by one warp ------------------------------------------------------
// For a block that holds several reads' sums at once (rowgather_sum.cu's group
// layout), each warp finishes its own read with no block barrier. The warp
// walks the read's B branches directly, lane l taking branches l, l + 32, ...:
// `touched(b)` says whether branch b carries a score and `corr(b)` gives it
// (finite where touched). The same values, top-K order and slots past n as
// the list finish above; the exp-sums add in another order (lane by lane,
// then a shuffle tree), within the tolerances the list finish keeps.

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// n, the touched branches, and max_c, their largest score (-inf when n == 0),
// in every lane.
template <class Touched, class Corr>
__device__ void warp_count_max(Touched touched, Corr corr, int B, int& n, float& max_c) {
  int n_loc = 0;
  float max_loc = -CUDART_INF_F;
  for (int b = threadIdx.x & 31; b < B; b += 32) {
    if (touched(b)) {
      ++n_loc;
      max_loc = fmaxf(max_loc, corr(b));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    n_loc += __shfl_xor_sync(0xffffffffu, n_loc, o);
    max_loc = fmaxf(max_loc, __shfl_xor_sync(0xffffffffu, max_loc, o));
  }
  n = n_loc;
  max_c = max_loc;
}

// sum over the touched branches of 10^(corr - max), in every lane.
template <class Touched, class Corr>
__device__ float warp_expsum(Touched touched, Corr corr, int B, float max) {
  float sum_loc = 0.f;
  for (int b = threadIdx.x & 31; b < B; b += 32) {
    if (touched(b)) sum_loc += expf(__fmul_rn(__fsub_rn(corr(b), max), kLn10));
  }
  return warp_sum(sum_loc);
}

// The top-K of one read by one warp: K rounds of a lane scan and a shuffle
// arg-best, each round the best branch strictly after the previous pick in
// the (value desc, index asc) order; where n < K the slots past n take -inf
// and the lowest untouched branches in ascending order. emit(j, value, b) once
// a slot, from some lane of the warp.
template <class Touched, class Corr, class Emit>
__device__ void warp_topk(Touched touched, Corr corr, int B, int n, int K, Emit emit) {
  const int lane = threadIdx.x & 31;
  const int live = min(n, K);
  float pv = CUDART_INF_F;
  int pi = -1;
  for (int j = 0; j < live; ++j) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int b = lane; b < B; b += 32) {
      if (!touched(b)) continue;
      const float c = corr(b);
      if (before(pv, pi, c, b) && before(c, b, bv, bi)) {
        bv = c;
        bi = b;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) emit(j, bv, bi);
    pv = bv;
    pi = bi;
  }
  // n < K: -inf at the lowest untouched branches, 32 at a time
  for (int b0 = 0, j = live; j < K && b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const bool un = b < B && !touched(b);
    const unsigned bal = __ballot_sync(0xffffffffu, un);
    const int slot = j + __popc(bal & ((1u << lane) - 1u));
    if (un && slot < K) emit(slot, -CUDART_INF_F, b);
    j += __popc(bal);
  }
}

// finish_list's result for one read by one warp, into `out` (SlimRow or
// FullRow). Every lane of the warp must call it.
template <class Touched, class Corr, class Row>
__device__ void warp_finish(Touched touched, Corr corr, int B, int K, float mr, float kf,
                            float log_eps, Row out) {
  int n;
  float max_c;
  warp_count_max(touched, corr, B, n, max_c);
  const float npl_exp = __fdiv_rn(__fmul_rn(mr, log_eps), kf);
  const float n_not = __fsub_rn(static_cast<float>(B), static_cast<float>(n));
  const float max_t = fmaxf(max_c, n_not > 0.f ? npl_exp : -CUDART_INF_F);
  const float touched_sum = warp_expsum(touched, corr, B, max_t);
  const float untouched =
      n_not > 0.f ? __fmul_rn(n_not, expf(__fmul_rn(__fsub_rn(npl_exp, max_t), kLn10)))
                  : 0.f;
  const float log_sum =
      __fadd_rn(max_t, __fdiv_rn(logf(__fadd_rn(touched_sum, untouched)), kLn10));
  const bool zero_sum = max_c < kPow10Zero && (npl_exp < kPow10Zero || n_not <= 0.f);
  warp_topk(touched, corr, B, n, K, [out, log_sum, zero_sum](int j, float v, int b) {
    out.slot(j, v, b, log_sum, zero_sum);
  });
  if ((threadIdx.x & 31) == 0) out.tail(log_sum, n, zero_sum);
}

// cols_list's result for one read by one warp: the shard's partial pack row
// [values K | global ids K | n_s | max_s | e_s] and, with `crow`, the
// candidates' counts. Every lane of the warp must call it.
template <class Touched, class Corr, class Count>
__device__ void warp_cols(Touched touched, Corr corr, int B, int K, int col0, float* orow,
                          int* crow, Count count) {
  int n;
  float max_s;
  warp_count_max(touched, corr, B, n, max_s);
  const float e_s = warp_expsum(touched, corr, B, max_s);
  warp_topk(touched, corr, B, n, K, [orow, crow, count, K, col0](int j, float v, int b) {
    orow[j] = v;
    orow[K + j] = static_cast<float>(b + col0);
    if (crow != nullptr) crow[j] = count(b);
  });
  if ((threadIdx.x & 31) == 0) {
    orow[2 * K] = static_cast<float>(n);
    orow[2 * K + 1] = max_s;
    orow[2 * K + 2] = e_s;
  }
}

// Bytes of dynamic shared memory FinishScratch's candidates take.
__host__ __device__ inline size_t cand_bytes(int threads, int K) {
  return static_cast<size_t>(threads / 32) * K * (sizeof(float) + sizeof(int));
}

}  // namespace epik
