// K1 masked compaction and K2 segmented sums.
//
// Replace the TPU kernel _make_kernel of
// autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py, which
// served both through masked_compact_pallas (compact=True) and
// segmented_sums_pallas (compact=False). The TPU version computed ranks
// and run ids with triangular and one-hot MXU matmuls and carried open
// runs across a sequential grid; none of that carries over. Here both are
// a three-phase flag scan (scan.cuh) followed by a scatter or a per-run
// sum.
//
// K1 apc_masked_compact: out[:, rank(j)] = values[:, j] for every live
//   column j with rank(j) < capacity, rank = exclusive count of live
//   columns before j. Values are copied as 32-bit words, so floats (NaN
//   included) and int32 rows pass bit for bit; dead columns are never
//   read into the output. Bound on the H100: bytes (C reads and C writes
//   of 4 bytes per live column, 1 byte of mask per column, twice) and, at
//   the main path's 131072 x 5, the launch latency of its three kernels.
//   Writes of consecutive ranks are consecutive addresses within a warp.
//
// K2 apc_segmented_sums: out[:, s] = sum of values[:, j] over run s, runs
//   delimited by run_start (element 0's flag ignored: it always opens run
//   0); columns past the last run stay as the caller allocated them
//   (zeros). The scan yields each run's start column; then one thread per
//   run sums its columns in column order, with no atomics, so results are
//   deterministic and equal, bit for bit, to an in-order sum. Bound: the
//   longest run, which one thread walks serially. The voxel stage keeps
//   runs short by making each dead column a run of its own, so at the main
//   path the longest run is one voxel's points; splitting long runs across
//   a warp with a fixed-order tree would lift the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace apc {
namespace {

constexpr int kMaxChannels = 8;
constexpr int kRunThreads = 256;

// grid (tiles, batch); element b = blockIdx.y.
__global__ void masked_compact_scatter(const uint32_t* __restrict__ values,
                                       const uint8_t* __restrict__ mask,
                                       const int* __restrict__ offsets,
                                       uint32_t* __restrict__ out, int c, int n,
                                       int capacity) {
  const size_t b = blockIdx.y;
  values += b * c * n;
  mask += b * n;
  offsets += b * (gridDim.x + 1);
  out += b * c * capacity;
  bool flag[kScanItems];
  int rank[kScanItems];
  tile_ranks(mask, n, 0, offsets[blockIdx.x], flag, rank);
  const int base = blockIdx.x * kScanTile;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (!flag[i] || rank[i] >= capacity) continue;
    const int col = base + i * kScanThreads + threadIdx.x;
    for (int ch = 0; ch < c; ++ch) {
      out[(size_t)ch * capacity + rank[i]] = values[(size_t)ch * n + col];
    }
  }
}

// starts[b * n + s] = first column of element b's run s (run 0 starts at
// column 0); grid (tiles, batch).
__global__ void run_starts_scatter(const uint8_t* __restrict__ run_start,
                                   const int* __restrict__ offsets, int n,
                                   int* __restrict__ starts) {
  const size_t b = blockIdx.y;
  run_start += b * n;
  offsets += b * (gridDim.x + 1);
  starts += b * n;
  bool flag[kScanItems];
  int rank[kScanItems];
  tile_ranks(run_start, n, 1, offsets[blockIdx.x], flag, rank);
  if (blockIdx.x == 0 && threadIdx.x == 0) starts[0] = 0;
  const int base = blockIdx.x * kScanTile;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (flag[i]) starts[rank[i] + 1] = base + i * kScanThreads + threadIdx.x;
  }
}

// grid (ceil(n / kRunThreads), batch); num_flags[b * flag_stride] is
// element b's count of run-start flags.
__global__ void run_sums(const float* __restrict__ values,
                         const int* __restrict__ starts,
                         const int* __restrict__ num_flags, int flag_stride,
                         float* __restrict__ out, int c, int n) {
  const size_t b = blockIdx.y;
  values += b * c * n;
  starts += b * n;
  out += b * c * n;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int runs = num_flags[b * flag_stride] + 1;
  if (s >= runs) return;
  const int begin = starts[s];
  const int end = s + 1 < runs ? starts[s + 1] : n;
  float acc[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) acc[ch] = 0.0f;
  for (int j = begin; j < end; ++j) {
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) acc[ch] += values[(size_t)ch * n + j];
    }
  }
#pragma unroll
  for (int ch = 0; ch < kMaxChannels; ++ch) {
    if (ch < c) out[(size_t)ch * n + s] = acc[ch];
  }
}

}  // namespace
}  // namespace apc

// values [batch, c, n], mask [batch, n], out [batch, c, capacity];
// scratch: int32[batch * (2 * tiles + 1)] (tile counts, then tile offsets
// + total per element).
extern "C" int apc_masked_compact(const void* values, const void* mask,
                                  void* out, void* scratch, int batch, int c,
                                  int n, int capacity, void* stream) {
  using namespace apc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = scan_tiles(n);
  if (batch > 0 && tiles > 0 && capacity > 0) {
    int* counts = static_cast<int*>(scratch);
    int* offsets = counts + (size_t)batch * tiles;
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    const dim3 grid(tiles, batch);
    tile_count_kernel<<<grid, kScanThreads, 0, s>>>(m, n, 0, counts);
    tile_scan_kernel<<<batch, kScanBlock, 0, s>>>(counts, tiles, offsets);
    masked_compact_scatter<<<grid, kScanThreads, 0, s>>>(
        static_cast<const uint32_t*>(values), m, offsets,
        static_cast<uint32_t*>(out), c, n, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}

// values and out [batch, c, n], run_start [batch, n]; scratch:
// int32[batch * (2 * tiles + 1 + n)] (tile counts, tile offsets + total,
// run starts, per element).
extern "C" int apc_segmented_sums(const void* values, const void* run_start,
                                  void* out, void* scratch, int batch, int c,
                                  int n, void* stream) {
  using namespace apc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = scan_tiles(n);
  if (batch > 0 && tiles > 0) {
    int* counts = static_cast<int*>(scratch);
    int* offsets = counts + (size_t)batch * tiles;
    int* starts = offsets + (size_t)batch * (tiles + 1);
    const uint8_t* f = static_cast<const uint8_t*>(run_start);
    const dim3 grid(tiles, batch);
    tile_count_kernel<<<grid, kScanThreads, 0, s>>>(f, n, 1, counts);
    tile_scan_kernel<<<batch, kScanBlock, 0, s>>>(counts, tiles, offsets);
    run_starts_scatter<<<grid, kScanThreads, 0, s>>>(f, offsets, n, starts);
    const dim3 run_grid((n + kRunThreads - 1) / kRunThreads, batch);
    run_sums<<<run_grid, kRunThreads, 0, s>>>(
        static_cast<const float*>(values), starts, offsets + tiles, tiles + 1,
        static_cast<float*>(out), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}
