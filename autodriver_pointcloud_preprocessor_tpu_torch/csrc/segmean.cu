// K1 masked compaction and K2 segmented sums.
//
// Replace the TPU kernel _make_kernel of
// autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py, which
// served both through masked_compact_pallas (compact=True) and
// segmented_sums_pallas (compact=False). The TPU version computed ranks
// and run ids with triangular and one-hot MXU matmuls and carried open
// runs across a sequential grid; none of that carries over. K1 is a
// three-phase flag scan (scan.cuh) followed by a scatter; K2 is one
// kernel.
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
//   0); the kernel writes zeros into the columns past the last run, so the
//   caller allocates `out` uninitialised. One launch on a (tiles, batch)
//   grid of 1024-thread CTAs, 2048 columns a tile, and no scratch: each CTA
//   counts the run-start flags of its row before and after its own tile
//   itself (16-byte loads, at most n bytes from L2 per CTA; no inter-CTA
//   protocol and no memset), ranks its tile's flags with a block scan in
//   shared memory, and then the thread that owns a run start sums that run
//   in column order, past the tile's end where the run crosses it, into
//   column `rank`. No atomics: results are deterministic and equal, bit for
//   bit, to an in-order sum. Bound on the H100: one launch's latency at the
//   main path's 6 x 65536 (1.6 MB), and the longest run, which one thread
//   walks serially. The voxel stage keeps runs short by making each dead
//   column a run of its own, so at the main path the longest run is one
//   voxel's points. Splitting long runs across a warp would change the
//   order of addition, so it is not done.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "scan.cuh"

namespace apc {
namespace {

constexpr int kMaxChannels = 8;
constexpr int kSumThreads = 1024;
constexpr int kSumTile = 2048;  // columns per CTA
constexpr int kSumItems = kSumTile / kSumThreads;
constexpr int kSumWarps = kSumThreads / 32;
static_assert(kSumItems == 2, "each thread ranks one 16-bit word of flags");

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

// This thread's share of the set flags in f[lo, hi) (bool bytes, 0 or 1):
// 16-byte loads between the unaligned head and tail bytes.
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

// K2, grid (tiles of kSumTile columns, batch), kSumThreads threads; element
// b = blockIdx.y. Run s of an element is the s-th run start in column order
// (column 0, then every flagged column past it); its sum goes to column s.
// Thread t loads columns t and t + kSumThreads of the tile (coalesced) and
// ranks columns 2t and 2t + 1 (consecutive, for the scan).
__global__ void __launch_bounds__(kSumThreads)
segmented_sums_kernel(const float* __restrict__ values,
                      const uint8_t* __restrict__ run_start,
                      float* __restrict__ out, int c, int n) {
  __shared__ __align__(16) uint8_t sflag[kSumTile];  // the tile's flags
  __shared__ int srank[kSumTile];  // run index of each column of the tile
  __shared__ int warp_part[kSumWarps][3];
  __shared__ int totals[3];
  const size_t b = blockIdx.y;
  values += b * c * n;
  run_start += b * n;
  out += b * c * n;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int base = blockIdx.x * kSumTile;
  const int end = min(base + kSumTile, n);

  // this thread's columns: flags (column 0's dropped: it always opens run
  // 0) and values, all loads issued before any is used
  float v[kSumItems][kMaxChannels];
#pragma unroll
  for (int i = 0; i < kSumItems; ++i) {
    const int col = base + i * kSumThreads + t;
    const bool in = col < n;
    sflag[i * kSumThreads + t] = (col > 0 && in && run_start[col] != 0) ? 1 : 0;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      v[i][ch] = (in && ch < c) ? __ldg(values + (size_t)ch * n + col) : 0.0f;
    }
  }
  // flags before and after the tile
  const int before = flag_count_share(run_start, 1, base);
  const int after = flag_count_share(run_start, end, n);
  __syncthreads();
  const uint32_t word = reinterpret_cast<const uint16_t*>(sflag)[t];
  const int own = __popc(word);
  int incl = own;  // inclusive scan of `own` within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int wb = __reduce_add_sync(0xffffffffu, before);
  const int wa = __reduce_add_sync(0xffffffffu, after);
  if (lane == 31) {
    warp_part[warp][0] = incl;
    warp_part[warp][1] = wb;
    warp_part[warp][2] = wa;
  }
  __syncthreads();
  if (warp == 0) {
    int s = warp_part[lane][0];  // kSumWarps == 32
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_part[lane][0] = s - warp_part[lane][0];  // exclusive over warps
    const int tb = __reduce_add_sync(0xffffffffu, warp_part[lane][1]);
    const int ta = __reduce_add_sync(0xffffffffu, warp_part[lane][2]);
    if (lane == 31) {
      totals[0] = tb;
      totals[1] = s;  // the tile's flags
      totals[2] = ta;
    }
  }
  __syncthreads();
  const int runs = totals[0] + totals[1] + totals[2] + 1;
  int running = totals[0] + warp_part[warp][0] + incl - own;
#pragma unroll
  for (int i = 0; i < kSumItems; ++i) {
    running += (word >> (8 * i)) & 1u;
    srank[kSumItems * t + i] = running;
  }
  __syncthreads();

  // the owner of each run start sums its run in column order
#pragma unroll
  for (int i = 0; i < kSumItems; ++i) {
    const int local = i * kSumThreads + t;
    const int col = base + local;
    if (col >= n || (col > 0 && !sflag[local])) continue;
    float acc[kMaxChannels];
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) acc[ch] = 0.0f + v[i][ch];
    for (int j = col + 1; j < n; ++j) {
      const bool starts_run = j < end ? sflag[j - base] != 0 : run_start[j] != 0;
      if (starts_run) break;
#pragma unroll
      for (int ch = 0; ch < kMaxChannels; ++ch) {
        if (ch < c) acc[ch] += values[(size_t)ch * n + j];
      }
    }
    const int rank = srank[local];
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) out[(size_t)ch * n + rank] = acc[ch];
    }
  }
  // columns past the element's last run are zero
  for (int col = max(base, runs) + t; col < end; col += kSumThreads) {
    for (int ch = 0; ch < c; ++ch) out[(size_t)ch * n + col] = 0.0f;
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

// values and out [batch, c, n] (out need not be initialised), run_start
// [batch, n] bool bytes (0 or 1); one launch.
extern "C" int apc_segmented_sums(const void* values, const void* run_start,
                                  void* out, int batch, int c, int n,
                                  void* stream) {
  using namespace apc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kSumTile - 1) / kSumTile, batch);
    segmented_sums_kernel<<<grid, kSumThreads, 0, s>>>(
        static_cast<const float*>(values), static_cast<const uint8_t*>(run_start),
        static_cast<float*>(out), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers, resident CTAs an SM and local memory (spills) a thread of
// this file's kernel instantiation `index` (0: K1's tile counts, 1: K1's
// offset scan, 2: K1's scatter, 3: K2), at the block size each is launched
// with. Returns 0, -1 past the last one, or a CUDA error code.
extern "C" int apc_segmean_info(int index, char* name, int name_len, int* regs,
                                int* blocks_per_sm, int* local_bytes) {
  using namespace apc;
  struct Entry {
    const char* name;
    const void* fn;
    int threads;
  };
  const Entry table[] = {
      {"K1 tile_count_kernel", reinterpret_cast<const void*>(&tile_count_kernel), kScanThreads},
      {"K1 tile_scan_kernel", reinterpret_cast<const void*>(&tile_scan_kernel), kScanBlock},
      {"K1 masked_compact_scatter", reinterpret_cast<const void*>(&masked_compact_scatter), kScanThreads},
      {"K2 segmented_sums_kernel", reinterpret_cast<const void*>(&segmented_sums_kernel), kSumThreads},
  };
  if (index < 0 || index >= static_cast<int>(sizeof(table) / sizeof(table[0]))) return -1;
  const Entry& e = table[index];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, e.fn);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, e.fn, e.threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  snprintf(name, name_len, "%s", e.name);
  return 0;
}
