// Three-phase stream scan over flag rows, of the compaction kernel (K1;
// K2 ranks its run starts inside its one kernel). Every phase runs per
// batch element: the
// flags are [batch, n], element b's row starting at b * n, and each
// element's ranks count within its own row only.
//
//   1. tile_count_kernel, grid (tiles, batch): each 256-thread block counts
//      the set flags of its 1024-column tile (__syncthreads_count, 4 columns
//      per thread) into counts[b * tiles + tile].
//   2. tile_scan_kernel, grid (batch): one 1024-thread block per element
//      turns its tile counts into exclusive tile offsets (warp-shuffle scan,
//      serial over chunks of 1024 tiles); offsets[b * (tiles + 1) + tiles]
//      holds the element's total.
//   3. tile_ranks (called by each kernel's own scatter phase, grid (tiles,
//      batch)): a block re-ranks its tile's columns with warp ballots, in
//      column order, and adds its tile offset -> the exclusive rank, within
//      the element, of every set flag.
//
// Phase 1 and 3 read the flag rows once each (1 byte per column); phase 2
// touches 4 bytes per 1024 columns. The scan is bound by the launch
// latency of its three kernels at the main path's sizes (65536-131072
// columns a scan), not by bytes; a batch shares the three launches.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apc {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // columns per block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanBlock = 1024;  // threads of the tile-offset scan

inline int scan_tiles(int n) { return (n + kScanTile - 1) / kScanTile; }

// Flag of column `col`; columns below `skip_first` and past `n` count as 0.
__device__ __forceinline__ bool scan_flag(const uint8_t* flags, int col, int n,
                                          int skip_first) {
  return col < n && col >= skip_first && flags[col] != 0;
}

// Element blockIdx.y of a (tiles, batch) grid: its flag row and tile counts.
__global__ void tile_count_kernel(const uint8_t* __restrict__ flags, int n,
                                  int skip_first, int* __restrict__ counts) {
  flags += (size_t)blockIdx.y * n;
  counts += (size_t)blockIdx.y * gridDim.x;
  const int base = blockIdx.x * kScanTile;
  int total = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int col = base + i * kScanThreads + threadIdx.x;
    total += __syncthreads_count(scan_flag(flags, col, n, skip_first));
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Element blockIdx.x of a (batch) grid.
__global__ void tile_scan_kernel(const int* __restrict__ counts, int num_tiles,
                                 int* __restrict__ offsets) {
  counts += (size_t)blockIdx.x * num_tiles;
  offsets += (size_t)blockIdx.x * (num_tiles + 1);
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < num_tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < num_tiles ? counts[i] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += y;
      }
      warp_sums[lane] = s;  // inclusive over warps
    }
    __syncthreads();
    if (i < num_tiles) offsets[i] = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    const int chunk_total = warp_sums[nwarps - 1];
    __syncthreads();
    if (threadIdx.x == 0) carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[num_tiles] = carry;
}

// Exclusive rank, within its element, of each of this thread's kScanItems
// columns among the set flags (valid where flag[i] is true). ``flags`` is
// the element's own row. Every thread of the block must call it.
__device__ __forceinline__ void tile_ranks(const uint8_t* __restrict__ flags,
                                           int n, int skip_first,
                                           int tile_offset,
                                           bool (&flag)[kScanItems],
                                           int (&rank)[kScanItems]) {
  __shared__ int warp_counts[kScanWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int base = blockIdx.x * kScanTile;
  int running = tile_offset;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int col = base + i * kScanThreads + threadIdx.x;
    const bool f = scan_flag(flags, col, n, skip_first);
    const unsigned ballot = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      const int c = warp_counts[w];
      before += w < warp ? c : 0;
      total += c;
    }
    flag[i] = f;
    rank[i] = running + before + __popc(ballot & lanes_below);
    running += total;
    __syncthreads();
  }
}

}  // namespace apc
