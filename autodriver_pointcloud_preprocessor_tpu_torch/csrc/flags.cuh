// Flag counting shared by K1 and K2: each of their CTAs counts the set
// flags of its scan outside its own tile itself, so a launch needs no
// scratch, no memset and no protocol between CTAs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apc {

// This thread's share of the set flags in f[lo, hi) (bool bytes, 0 or 1):
// 16-byte loads between the unaligned head and tail bytes. A byte holds 0
// or 1, so the popcount of a word is its count of set flags.
__device__ __forceinline__ int flag_count_share(const uint8_t* __restrict__ f,
                                                int lo, int hi) {
  if (lo >= hi) return 0;
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(f + lo) & 15);
  const int head = min((16 - misalign) & 15, hi - lo);
  const int words = (hi - lo - head) >> 4;
  const int tail = lo + head + (words << 4);
  const uint4* w = reinterpret_cast<const uint4*>(f + lo + head);
  int c = 0;
  for (int j = threadIdx.x; j < head; j += blockDim.x) c += f[lo + j];
#pragma unroll 4
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    const uint4 v = __ldg(w + j);
    c += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  for (int j = tail + threadIdx.x; j < hi; j += blockDim.x) c += f[j];
  return c;
}

}  // namespace apc
