// K1 masked compaction and K2 segmented sums.
//
// Replace the TPU kernel _make_kernel of
// autodriver_pointcloud_preprocessor_tpu/ops/pallas_segmean.py, which
// served both through masked_compact_pallas (compact=True) and
// segmented_sums_pallas (compact=False). The TPU version computed ranks
// and run ids with triangular and one-hot MXU matmuls and carried open
// runs across a sequential grid; none of that carries over. Each is one
// launch on a (tiles, batch) grid of 1024-thread CTAs with no scratch and
// no memset: a CTA counts the flags of its scan outside its own tile
// itself (flags.cuh: 16-byte loads, from L2 after the first CTA), so it
// knows its tile's offset and the scan's total without any protocol
// between CTAs, and writes the zeros of its share of the output.
//
// K1 apc_masked_compact: for each of up to 16 rows of 32-bit words (a row
//   table of source and destination pointers with a batch stride each,
//   passed by value as a kernel parameter), dst[rank(j)] = src[j] for every
//   live column j with rank(j) < capacity, rank = exclusive count of live
//   columns before j in the same scan; columns from min(live, capacity) to
//   capacity are zero, and mask_out[r] = r < min(live, capacity). Words are
//   copied as they are, so floats (NaN included) and int32 rows pass bit
//   for bit. A CTA holds APC_K1_TILE columns (default 2048, 64 CTAs a
//   131072-column scan; a build flag, so kernel_ab.py can time others):
//   thread t owns columns t + 1024 i, starts the loads of its words of the
//   first rows before it counts (so they overlap the counting), ranks them
//   with warp ballots and one warp's scan of the per-(column group, warp)
//   counts, and stores them: a warp's store covers 32 consecutive columns,
//   whose live ones have consecutive ranks, so consecutive addresses.
//   Bound on the H100: bytes (each row read once and written once at
//   capacity, the mask read once), but at the main path's 5 x 131072 ->
//   65536 (4 MB a scan) one launch's latency and each CTA's chain of
//   dependent steps (loads, the mask count, which reads N bytes from L2 a
//   CTA, two block barriers, the stores). Wider tiles read less of the
//   mask (N^2 / T bytes a scan) but leave SMs idle on one scan.
//
// K2 apc_segmented_sums: out[:, s] = sum of values[:, j] over run s, runs
//   delimited by run_start (element 0's flag ignored: it always opens run
//   0); the kernel writes zeros into the columns past the last run, so the
//   caller allocates `out` uninitialised. 2048 columns a tile: each CTA
//   counts the run-start flags of its row before and after its own tile,
//   ranks its tile's flags with a block scan in shared memory, and then
//   the thread that owns a run start sums that run in column order, past
//   the tile's end where the run crosses it, into column `rank`. No
//   atomics: results are deterministic and equal, bit for bit, to an
//   in-order sum. Bound on the H100: one launch's latency at the main
//   path's 6 x 65536 (1.6 MB), and the longest run, which one thread walks
//   serially. The voxel stage keeps runs short by making each dead column
//   a run of its own, so at the main path the longest run is one voxel's
//   points. Splitting long runs across a warp would change the order of
//   addition, so it is not done.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "flags.cuh"

#ifndef APC_K1_TILE
#define APC_K1_TILE 2048
#endif
#define APC_STR_(x) #x
#define APC_STR(x) APC_STR_(x)

namespace apc {
namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxRows = 16;  // rows of one K1 launch
constexpr int kK1Threads = 1024;
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kK1Tile = APC_K1_TILE;  // columns per CTA
constexpr int kK1Items = kK1Tile / kK1Threads;  // columns per thread
// rows whose words a thread holds at once: 32 words (16 at 8 columns a
// thread), inside the 64 registers a thread of 1024 has
constexpr int kK1Words = kK1Items <= 4 ? 32 : 16;
constexpr int kK1Group = kK1Words / kK1Items < kMaxRows ? kK1Words / kK1Items : kMaxRows;
static_assert(kK1Tile % kK1Threads == 0 && kK1Items >= 1 && kK1Items <= 8,
              "APC_K1_TILE must be 1024, 2048, 3072, ... or 8192");
static_assert(kK1Warps == 32, "one warp scans the per-(column group, warp) counts");

// K1's row table: row r of scan b is src[r] + b * src_stride[r] (words),
// its output dst[r] + b * dst_stride[r].
struct RowTable {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
  long long src_stride[kMaxRows];
  long long dst_stride[kMaxRows];
};

constexpr int kMaxChannels = 8;
constexpr int kSumThreads = 1024;
constexpr int kSumTile = 2048;  // columns per CTA
constexpr int kSumItems = kSumTile / kSumThreads;
constexpr int kSumWarps = kSumThreads / 32;
static_assert(kSumItems == 2, "each thread ranks one 16-bit word of flags");

// Words of rows g .. g + kK1Group - 1 (those below `rows`) at this thread's
// columns of the tile at `base`; 0 past n. `g` is a compile-time constant
// at every call (the callers' loops unroll), so the table, a
// __grid_constant__ parameter, is indexed statically and never copied.
__device__ __forceinline__ void load_rows(const RowTable& table, int g, int rows,
                                          long long b, int base, int n,
                                          uint32_t (&v)[kK1Group][kK1Items]) {
#pragma unroll
  for (int j = 0; j < kK1Group; ++j) {
    const int r = g + j;
    if (r >= rows) break;
    const uint32_t* s = table.src[r] + b * table.src_stride[r];
#pragma unroll
    for (int i = 0; i < kK1Items; ++i) {
      const int col = base + i * kK1Threads + static_cast<int>(threadIdx.x);
      v[j][i] = col < n ? __ldg(s + col) : 0u;
    }
  }
}

// K1, grid (tiles of kK1Tile columns, batch), kK1Threads threads; scan
// b = blockIdx.y. mask [batch, n] bool bytes; mask_out [batch, capacity]
// or null.
__global__ void __launch_bounds__(kK1Threads)
masked_compact_kernel(const __grid_constant__ RowTable table, int rows,
                      const uint8_t* __restrict__ mask, uint8_t* __restrict__ mask_out,
                      int n, int capacity) {
  __shared__ int part[kK1Items * kK1Warps];  // live count of (i, warp), then its prefix
  __shared__ int outside[kK1Warps][2];
  __shared__ int totals[3];  // live before the tile, in it, after it
  const long long b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int base = blockIdx.x * kK1Tile;
  mask += b * n;

  // the first rows' words and the ballots of this warp's flags (columns
  // base + i * kK1Threads + 32 warp + lane), in flight while the CTA counts
  uint32_t v[kK1Group][kK1Items];
  load_rows(table, 0, rows, b, base, n, v);
  unsigned ballot[kK1Items];
#pragma unroll
  for (int i = 0; i < kK1Items; ++i) {
    const int col = base + i * kK1Threads + t;
    ballot[i] = __ballot_sync(kFull, col < n && mask[col] != 0);
  }
  int before = flag_count_share(mask, 0, base);
  int after = flag_count_share(mask, min(base + kK1Tile, n), n);

  // ranks: one warp scans the kK1Items x 32 ballot counts in column order
  // (i major, warp minor)
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kK1Items; ++i) part[i * kK1Warps + warp] = __popc(ballot[i]);
  }
  before = __reduce_add_sync(kFull, before);
  after = __reduce_add_sync(kFull, after);
  if (lane == 0) {
    outside[warp][0] = before;
    outside[warp][1] = after;
  }
  __syncthreads();
  if (warp == 0) {
    int c[kK1Items];
    int own = 0;
#pragma unroll
    for (int j = 0; j < kK1Items; ++j) {
      c[j] = part[lane * kK1Items + j];
      own += c[j];
    }
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int running = incl - own;
#pragma unroll
    for (int j = 0; j < kK1Items; ++j) {
      part[lane * kK1Items + j] = running;
      running += c[j];
    }
    const int tb = __reduce_add_sync(kFull, outside[lane][0]);
    const int ta = __reduce_add_sync(kFull, outside[lane][1]);
    if (lane == 31) {
      totals[0] = tb;
      totals[1] = incl;
      totals[2] = ta;
    }
  }
  __syncthreads();
  const int offset = totals[0];
  const int total = offset + totals[1] + totals[2];
  const unsigned below = (1u << lane) - 1u;
  int rank[kK1Items];
  unsigned keep = 0;
#pragma unroll
  for (int i = 0; i < kK1Items; ++i) {
    rank[i] = offset + part[i * kK1Warps + warp] + __popc(ballot[i] & below);
    if ((ballot[i] >> lane & 1u) && rank[i] < capacity) keep |= 1u << i;
  }

  // the tile's live words go to [offset, offset + its count), row by row
#pragma unroll
  for (int g = 0; g < kMaxRows; g += kK1Group) {
    if (g >= rows) break;
    if (g > 0) load_rows(table, g, rows, b, base, n, v);
#pragma unroll
    for (int j = 0; j < kK1Group; ++j) {
      const int r = g + j;
      if (r >= rows) break;
      uint32_t* d = table.dst[r] + b * table.dst_stride[r];
#pragma unroll
      for (int i = 0; i < kK1Items; ++i) {
        if (keep >> i & 1u) d[rank[i]] = v[j][i];
      }
    }
  }

  // this tile's share of the output columns: zeros from the total on, and
  // the output mask
  const int out_end = min(base + kK1Tile, capacity);
  const int zero_lo = max(base, total);
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r >= rows) break;
    uint32_t* d = table.dst[r] + b * table.dst_stride[r];
    for (int j = zero_lo + t; j < out_end; j += kK1Threads) d[j] = 0u;
  }
  if (mask_out != nullptr) {
    uint8_t* m = mask_out + b * capacity;
    for (int j = base + t; j < out_end; j += kK1Threads) m[j] = j < total ? 1 : 0;
  }
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

// table: `rows` (<= 16) entries of 4 int64s, each (source row, its stride
// between scans in words, output row, its stride): the host packs them into
// the kernel's parameter struct, so no pointer table is copied to the
// device. mask [batch, n] bool bytes; mask_out [batch, capacity] bool or
// null; outputs need not be initialised. One launch.
extern "C" int apc_masked_compact(const long long* table, int rows, const void* mask,
                                  void* mask_out, int batch, int n, int capacity,
                                  void* stream) {
  using namespace apc;
  if (rows < 1 || rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  RowTable rt = {};
  for (int r = 0; r < rows; ++r) {
    rt.src[r] = reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(table[4 * r]));
    rt.src_stride[r] = table[4 * r + 1];
    rt.dst[r] = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(table[4 * r + 2]));
    rt.dst_stride[r] = table[4 * r + 3];
  }
  if (batch > 0 && n > 0 && capacity > 0) {
    const dim3 grid((n + kK1Tile - 1) / kK1Tile, batch);
    masked_compact_kernel<<<grid, kK1Threads, 0, static_cast<cudaStream_t>(stream)>>>(
        rt, rows, static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(mask_out), n,
        capacity);
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
// this file's kernel instantiation `index` (0: K1, 1: K2), at the block
// size each is launched with. Returns 0, -1 past the last one, or a CUDA error code.
extern "C" int apc_segmean_info(int index, char* name, int name_len, int* regs,
                                int* blocks_per_sm, int* local_bytes) {
  using namespace apc;
  struct Entry {
    const char* name;
    const void* fn;
    int threads;
  };
  const Entry table[] = {
      {"K1 masked_compact_kernel T=" APC_STR(APC_K1_TILE),
       reinterpret_cast<const void*>(&masked_compact_kernel), kK1Threads},
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
