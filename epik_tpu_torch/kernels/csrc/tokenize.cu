// The pair-plane slot tokenizer: from the packed read buffer to one combo-table
// row per 2-window slot, each read's length and its window count m, in one
// launch. It computes what ops/tokenize.py::tokenize_combo and
// engine/step.py::_m_f32 compute together, bit for bit.
//
// Replaces no TPU kernel: the JAX package's device_tokenize_combo
// (epik_tpu/engine/placer.py:1038) is XLA ops, ported as torch ops. On the
// card those ran as ~60 launches over (R, W) int64 tensors a batch (the k
// passes of the key build, the unpacks, the bad-window cumsum, the pads and
// the gather), most of the card's time beside the row gather.
//
// The row (staging.pack_reads): Lmax / 4 code bytes, char i in bits
// 2 (i % 4) of byte i / 4; Lmax / 8 bad-bit bytes, char i in bit i % 8 of
// byte i / 8; the length as two little-endian bytes. Lmax is a multiple of 8.
//
// Slot j holds windows 2j and 2j + 1 of W = Lmax - k + 1 (an odd W's last
// slot holds window 2j alone). Its combo index is the (k+1)-mer key of chars
// 2j .. 2j + k where both windows are exact, else 4**(k+1) plus the key of
// the one exact window (2j first), else the miss cell 4**(k+1) + 4**k; the
// slot row is combo[index].
//
// Bound on the H100: the packed rows read once (59 bytes a 150 bp read), one
// int32 gather a slot from the combo table (21 MB at k = 10, in the L2) and
// the slot rows written once: ~1.2 MB for 2,000 reads, 0.35 us at 3.35 TB/s.
// The launch and one dependent gather a thread set the time: 2.7 us at 2,000
// 150 bp reads, 10.5 us at 16,381 (an H100 at 700 W).
//
// Design: one thread a slot, over all R * ceil(W / 2) slots of the batch (a
// long read's slots spread over the card like a short read's). The k + 1
// chars of a slot lie in 4 code bytes at a bit offset of 0 or 4 (28 bits for
// k <= 13): one 32-bit word, its 2-bit groups reversed so the first char is
// the most significant, gives the (k+1)-mer key, and the two k-mer keys are
// its top and its bottom 2k bits. The bad bits of the slot lie in 3 bytes at
// an offset of 0-6: a window is exact where its k bits are 0. No int64 key, no
// scan, no temporary in device memory; byte loads past a region's end read 0
// (only the chars of an odd W's missing window lie there). Stores of
// neighbouring slots are neighbouring words. The thread of slot 0 writes the
// read's length and m: (len - (k - 1)) as float32, plus 2**64 where negative
// (quirk Q1), the plain version's f32 add.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // a grid-stride loop takes the rest
constexpr float kU64 = 18446744073709551616.f;  // 2^64, the wrapped size_t (quirk Q1)

// Four bytes of p from byte i, little-endian; a byte at or past n reads 0.
__device__ __forceinline__ uint32_t word_at(const uint8_t* __restrict__ p, int i, int n) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (i + b < n) w |= static_cast<uint32_t>(__ldg(p + i + b)) << (8 * b);
  }
  return w;
}

// The 16 2-bit groups of x in reverse order.
__device__ __forceinline__ uint32_t reverse_pairs(uint32_t x) {
  x = __brev(x);
  return ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
}

__global__ void __launch_bounds__(kThreads)
    tokenize_combo_kernel(const uint8_t* __restrict__ buf, const int32_t* __restrict__ combo,
                          int32_t* __restrict__ rows, int32_t* __restrict__ lens,
                          float* __restrict__ m, int R, int Lmax, int k) {
  const int L4 = Lmax / 4, L8 = Lmax / 8, nbytes = L4 + L8 + 2;
  const int W = Lmax - k + 1, Wp = (W + 1) / 2;
  const uint32_t n11 = 1u << (2 * (k + 1));
  const uint32_t miss = n11 + (1u << (2 * k));
  const uint32_t key_mask = (1u << (2 * k)) - 1u;
  const uint32_t bad_mask = (1u << k) - 1u;
  const int shift = 32 - 2 * (k + 1);
  const long long total = static_cast<long long>(R) * Wp;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; s < total;
       s += static_cast<long long>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(s / Wp);
    const int j = static_cast<int>(s - static_cast<long long>(r) * Wp);
    const uint8_t* row = buf + static_cast<size_t>(r) * nbytes;
    const int c0 = 2 * j;  // the first char of window 2j
    const uint32_t codes = word_at(row, c0 >> 2, L4) >> (2 * (c0 & 3));
    const uint32_t key11 = reverse_pairs(codes) >> shift;
    const uint32_t bad = word_at(row + L4, c0 >> 3, L8) >> (c0 & 7);
    const bool ok0 = (bad & bad_mask) == 0;
    const bool ok1 = c0 + 1 < W && ((bad >> 1) & bad_mask) == 0;
    const uint32_t idx = ok0 && ok1 ? key11
                         : ok0      ? n11 + (key11 >> 2)
                         : ok1      ? n11 + (key11 & key_mask)
                                    : miss;
    rows[s] = __ldg(combo + idx);
    if (j == 0) {
      const int len = row[L4 + L8] | (row[L4 + L8 + 1] << 8);
      const float ms = static_cast<float>(len - (k - 1));
      lens[r] = len;
      m[r] = ms >= 0.f ? ms : ms + kU64;
    }
  }
}

}  // namespace

extern "C" int epik_tokenize_combo(const void* buf, const void* combo, void* rows, void* lens,
                                   void* m, int R, int Lmax, int k, void* stream) {
  if (k < 1 || 2 * (k + 1) > 28 || Lmax % 8 != 0 || Lmax < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(R) * ((Lmax - k + 2) / 2);
  if (total > 0) {
    const long long blocks = std::min((total + kThreads - 1) / kThreads, kMaxBlocks);
    tokenize_combo_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<const int32_t*>(combo),
        static_cast<int32_t*>(rows), static_cast<int32_t*>(lens), static_cast<float*>(m), R,
        Lmax, k);
  }
  return static_cast<int>(cudaGetLastError());
}
