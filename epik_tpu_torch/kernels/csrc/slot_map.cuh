// The slot map of the kernels that add the ambiguous reads' delta rows (the
// group layout's entry points in rowgather_sum.cu, the posted gather with the
// finish fused in, rowgather_posted.cu): slot[r] = the row of read r among the
// delta rows, or -1. Made on the stream by the launch itself, a memset and one
// small kernel, where three PyTorch calls would sit on the host's path to it.
// Each source that includes it gets its own copy (an unnamed namespace).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// slot[amb[i]] = i for the A ambiguous reads (distinct read ids, int64 where
// amb64, else int32); every other read's entry is left as it is.
__global__ void slot_map_kernel(const void* __restrict__ amb, int amb64, int A,
                                int32_t* __restrict__ slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A) return;
  const long long r = amb64 ? static_cast<const long long*>(amb)[i]
                            : static_cast<long long>(static_cast<const int32_t*>(amb)[i]);
  slot[r] = i;
}

// Fills the int32 (R,) `slot` on `stream` from the A ambiguous reads `amb`
// (-1 for every other read); *map: the slot map the kernel reads, null where
// A == 0.
int map_slots(const void* amb, int amb64, int A, void* slot, int R, cudaStream_t stream,
              const void** map) {
  *map = nullptr;
  if (A <= 0) return 0;
  if (amb == nullptr || slot == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(slot, 0xff, static_cast<size_t>(R) * sizeof(int32_t),
                                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  slot_map_kernel<<<(A + 255) / 256, 256, 0, stream>>>(amb, amb64, A,
                                                       static_cast<int32_t*>(slot));
  *map = slot;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
