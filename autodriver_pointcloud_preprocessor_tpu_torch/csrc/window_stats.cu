// K3 windowed neighbourhood statistics over curve-sorted rows.
//
// Replaces the TPU kernel _kernel of
// autodriver_pointcloud_preprocessor_tpu/ops/pallas_window.py (reached
// through window_stats_pallas). For every query row, over the candidate
// window of its 128-row block, it computes:
//   * the mean distance to the k nearest valid candidates (kmode 0
//     'sweep': exact; kmode 1 'csel': the own-block k-th as threshold, 2
//     refinement bisections and the at-threshold correction, with the
//     band-midpoint stand-in when the own block is sparse; kmode 2
//     'bisect': 13 bisections of count(d2 <= t) >= k on the untruncated
//     d2 from the own block's max distance, or the window's when the own
//     block holds fewer than k valid rows, and the same correction);
//   * the k-select count (hits, at most k);
//   * when moments != 0, the 10 raw moments [n, Sx, Sy, Sz, Sxx, Syy, Szz,
//     Sxy, Sxz, Syz] of the in-radius valid candidates, about the block
//     origin (the mean of the block's 128 sanitized query rows, summed as
//     a fixed-order tree that the plain PyTorch version repeats);
//   * when count2 is not null, the count of valid candidates within the
//     second radius (the reference's output row 12, for radius outliers).
// Batch axis: rows are [batch, n], with a moment radius and a second
// radius per scan or one for all (the reference's per-scan SMEM table,
// pallas_window.py:461-467, squared in the kernel); the grid is
// (n / 128 * kSplit, batch) and each element's window stops at its own row
// ends, so no window reaches into the neighbouring scan. This is the
// reference's custom_vmap rule (_make_window_stats) as a grid dimension.
// Windows: wb >= 1 is wb blocks each side; wb == 0 is the own block plus
// the next one (direction 0) or the previous one (direction 1).
// Out-of-range rows, invalid rows and non-finite rows are excluded as
// candidates; non-finite coordinates are zeroed in the block origin and
// the query.
//
// Semantics kept from the reference: distances are compared with the low
// 11 mantissa bits cleared and ties broken by window row (the key is
// (bits(d2) & ~2047) | row). Not kept: the TPU's distance matmul
// (|c|^2 + |q|^2 - 2 c.q on the MXU, 'highest' or 'fast3' bf16 splits).
// Here d2 is the plain f32 sum of squared differences of centered
// coordinates, for both modes.
//
// Design for the H100. The work is compares and integer min/max over
// (query, candidate) pairs, not bytes: a pass reads 13 bytes and writes at
// most 52 bytes a row. What bounds it is instructions a pair and enough
// warps in flight to hide shared-memory and dependency latency.
//   * A lane group of kG = 8 lanes of one warp serves one query, each lane
//     the window rows r = lane + 8 i; a 256-thread CTA serves 32 queries,
//     so kSplit = 4 CTAs share a 128-row block (1,600 CTAs at production's
//     51,200 rows). Each CTA stages the window (x, y, z: 12 bytes a row,
//     4.5 KB at wb=1) in shared memory, with NaN coordinates on every row
//     that is no candidate, so that each compare with its d2 fails and the
//     walks need no valid flag; it recomputes the block origin with the
//     same fixed-order tree, so no output depends on the split.
//   * csel and bisect keep each query's d2 row in shared memory (50 KB a
//     CTA at wb=1, 4 CTAs an SM; only up to wb=2) and walk it with 8-byte
//     loads for their 3 and 14 threshold walks. On an H100 (kernel_ab.py)
//     recomputing d2 in each walk instead took 1.9x the time for config
//     2's bisect and 1.1-1.3x for production's csel, and 1.03x for the
//     QUALITY preset's wb=2 csel, where the cache allows 2 CTAs an SM.
//     csel's truncated compare trunc(d2) <= t is the plain compare
//     d2 <= bits(t) | 2047.
//   * Counts (the threshold walks, the moment count, the second-radius
//     count) are exact integer sums over the group (__reduce_add_sync).
//     Moment and distance sums accumulate in double in each lane and
//     across the group, which makes them independent of the order of
//     addition to float rounding.
//   * The top-k (sweep: the whole window; csel: the own block) keeps, in
//     each lane, its lane_cap(MAXK) smallest keys (8, 16 for MAXK = 64) in
//     a sorted register array. The k-th key of the group comes from k
//     rounds of a group-wide min, the owner popping its head; only then
//     does each lane add the distances of its keys at or below it, in
//     double (the plain version adds the k distances in ascending float
//     order: the two agree to float rounding). A lane whose share held
//     more candidates than its list and whose list ends below the k-th key
//     may have dropped one of the k: the group then finds the k-th exactly
//     by k walks for the next smallest key (rare).
//   * No tensor cores: d2 has depth 3, and the port keeps the difference
//     form (the reference's |c|^2 + |q|^2 - 2 c.q matmul cancels on wide
//     windows), so wgmma would gain nothing.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kB = 128;
constexpr int kThreads = 256;
constexpr int kG = 8;                     // lanes per query
constexpr int kQ = kThreads / kG;         // queries per CTA
constexpr int kSplit = kB / kQ;           // CTAs per 128-row block
constexpr int kMaxWb = 7;
// csel and bisect keep each query's d2 row in shared memory for their
// threshold walks up to this window (wb <= 2); built with
// -DAPC_D2_CACHE_ROWS=0 they recompute it in every walk (kernel_ab.py
// times the two against each other)
#ifndef APC_D2_CACHE_ROWS
#define APC_D2_CACHE_ROWS (5 * 128)
#endif
constexpr int kCacheSpan = APC_D2_CACHE_ROWS;
constexpr float kHalfBig = 5e29f;             // the reference's _BIG / 2
constexpr uint32_t kInvalidKey = 0x7F800000u;  // +inf: after every finite d2
constexpr uint32_t kTrunc = ~2047u;
constexpr int kCselIters = 2;
constexpr int kBisectIters = 13;
static_assert(kG < 32 && 32 % kG == 0 && kB % kQ == 0, "lane groups tile warps and blocks");

// per-lane list capacity of the fast top-k
__host__ __device__ constexpr int lane_cap(int maxk) {
  return maxk < 8 ? maxk : (2 * maxk / kG > 8 ? 2 * maxk / kG : 8);
}

__host__ __device__ constexpr int window_span(int wb) { return wb > 0 ? (2 * wb + 1) * kB : 2 * kB; }

__host__ __device__ constexpr bool d2_cached(int kmode, int span) {
  return kmode != 0 && span <= kCacheSpan;
}

// floats of shared memory before the window's rows: the queries' d2 rows
// ([kQ][kG][span / kG + 2]: a row of 2 (mod 32) more than a multiple of 16
// floats puts the 8 lanes of a group, and the two groups of a half-warp,
// on distinct banks for 8-byte loads), or, without them, the [3][kB] tree
// of the block origin (which the d2 rows otherwise overlay)
__host__ __device__ constexpr int lead_floats(int kmode, int span) {
  return d2_cached(kmode, span) ? kQ * kG * (span / kG + 2) : 3 * kB;
}

template <int CAP>
__device__ __forceinline__ void topk_insert(uint32_t (&top)[CAP], uint32_t v) {
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    const uint32_t lo = min(v, top[j]);
    v = max(v, top[j]);
    top[j] = lo;
  }
}

__device__ __forceinline__ double group_sum(unsigned gmask, double v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(gmask, v, o);
  return v;  // a + b == b + a: every lane holds the same bits
}

__device__ __forceinline__ float group_max(unsigned gmask, float v) {
  // v >= 0: non-negative floats order as their bits
  return __uint_as_float(__reduce_max_sync(gmask, __float_as_uint(v)));
}

// The group's minimum: by shuffles or by one warp reduction. Which is
// faster depends on the mode's register pressure (measured on the H100:
// shuffles for csel, the reduction for sweep).
template <bool SHUFFLE>
__device__ __forceinline__ uint32_t group_min(unsigned gmask, uint32_t v) {
  if (!SHUFFLE) return __reduce_min_sync(gmask, v);
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(gmask, v, o));
  return v;
}

// The k-th smallest key of the group's sorted lists, or kInvalidKey when
// they hold fewer than k: k rounds of a group-wide min, the owner popping
// its head (keys are distinct; an empty list pops nothing but +inf).
template <bool SHUFFLE, int CAP>
__device__ __forceinline__ uint32_t group_kth(unsigned gmask, uint32_t (&top)[CAP], int k) {
  uint32_t m = kInvalidKey;
  for (int j = 0; j < k; ++j) {
    m = group_min<SHUFFLE>(gmask, top[0]);
    const bool pop = top[0] == m;
#pragma unroll
    for (int i = 0; i + 1 < CAP; ++i) top[i] = pop ? top[i + 1] : top[i];
    top[CAP - 1] = pop ? kInvalidKey : top[CAP - 1];
  }
  return m;
}

// A key counts as one of the k nearest (a hit) when it is at or below the
// k-th key and its distance is below the reference's _BIG / 2.
__device__ __forceinline__ bool hit_key(uint32_t key, uint32_t kth) {
  return key <= kth && __uint_as_float(key) < kHalfBig;
}

// KMODE (0 sweep, 1 csel, 2 bisect) and COUNT2 (the second radius's count
// on or off) are template parameters: each instantiation carries only its
// own mode's state (a runtime mode switch cost csel 36 more registers).
// Grid (n / 128 * kSplit, batch), kThreads threads; dynamic shared memory
// window_smem(wb, KMODE).
template <int MAXK, int KMODE, bool COUNT2>
__global__ void __launch_bounds__(kThreads, 4)  // 64 registers: 4 CTAs an SM
window_stats_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ z,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ rad, int rad_stride,
                    const float* __restrict__ rad2, int rad2_stride,
                    float* __restrict__ mean_out, float* __restrict__ cnt_out,
                    float* __restrict__ mom_out, float* __restrict__ cnt2_out,
                    int n, int k, int wb, int direction, int moments_on) {
  constexpr int CAP = lane_cap(MAXK);
  constexpr bool csel = KMODE == 1;
  constexpr bool bisect = KMODE == 2;
  extern __shared__ __align__(16) float smem[];
  const int span = window_span(wb);
  const int qoff = wb > 0 ? wb * kB : (direction == 0 ? 0 : kB);
  const int per_lane = span / kG;  // window rows of one lane: r = lane + kG * i
  const bool cached = d2_cached(KMODE, span);
  const int seg = per_lane + 2;    // a lane's d2 row, padded (see lead_floats)
  float* dcache = smem;            // [kQ][kG][seg] when cached
  float* red = smem;               // [3][kB], before the d2 rows are written
  float* sx = smem + lead_floats(KMODE, span);
  float* sy = sx + span;
  float* sz = sy + span;
  const int t = threadIdx.x;
  const int block = blockIdx.x / kSplit;
  const int start = block * kB - qoff;
  const size_t elem = blockIdx.y;
  x += elem * n;
  y += elem * n;
  z += elem * n;
  valid += elem * n;
  mean_out += elem * n;
  cnt_out += elem * n;
  mom_out += elem * 10 * n;
  if (COUNT2) cnt2_out += elem * n;

  // the window: sanitized rows, NaN where a row is no candidate (out of
  // range, invalid or non-finite), so that every compare with its d2 fails
  const float kNaN = __uint_as_float(0x7FC00000u);
  for (int r = t; r < span; r += kThreads) {
    const int g = start + r;
    float fx = kNaN, fy = kNaN, fz = kNaN;
    if (g >= 0 && g < n && valid[g] != 0) {
      const float ax = x[g], ay = y[g], az = z[g];
      if (isfinite(ax) && isfinite(ay) && isfinite(az)) {
        fx = ax;
        fy = ay;
        fz = az;
      }
    }
    sx[r] = fx;
    sy[r] = fy;
    sz[r] = fz;
  }
  // block origin: tree sum of the 128 sanitized query rows (non-finite
  // coordinates zeroed, invalid rows kept), pairs (t, t + s)
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (t < kB) {
    const int g = block * kB + t;
    const float ax = x[g], ay = y[g], az = z[g];
    if (isfinite(ax) && isfinite(ay) && isfinite(az)) {
      ox = ax;
      oy = ay;
      oz = az;
    }
    red[t] = ox;
    red[kB + t] = oy;
    red[2 * kB + t] = oz;
  }
  __syncthreads();
  for (int s = kB / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[t] += red[t + s];
      red[kB + t] += red[kB + t + s];
      red[2 * kB + t] += red[2 * kB + t + s];
    }
    __syncthreads();
  }
  const float c0x = red[0] * (1.0f / kB);
  const float c0y = red[kB] * (1.0f / kB);
  const float c0z = red[2 * kB] * (1.0f / kB);
  for (int r = t; r < span; r += kThreads) {
    sx[r] = sx[r] - c0x;
    sy[r] = sy[r] - c0y;
    sz[r] = sz[r] - c0z;
  }
  __syncthreads();  // the window is centred; red may be overwritten

  // this lane's query (its sanitized row, centred: finite even when the
  // query is no candidate), its group of kG lanes and its d2 row
  const int lane = t & (kG - 1);
  const unsigned gmask = ((1u << kG) - 1u) << ((t & 31) & ~(kG - 1));
  const int q = (blockIdx.x % kSplit) * kQ + t / kG;
  float qx, qy, qz;
  {
    const int g = block * kB + q;
    const float ax = x[g], ay = y[g], az = z[g];
    const bool fin = isfinite(ax) && isfinite(ay) && isfinite(az);
    qx = (fin ? ax : 0.0f) - c0x;
    qy = (fin ? ay : 0.0f) - c0y;
    qz = (fin ? az : 0.0f) - c0z;
  }
  float* dl = dcache + ((t / kG) * kG + lane) * seg;  // this lane's d2 row
  const float r2 = rad[elem * rad_stride] * rad[elem * rad_stride];
  const float r2b = COUNT2 ? rad2[elem * rad2_stride] * rad2[elem * rad2_stride] : 0.0f;
  // the top-k runs over the whole window (sweep), the own block (csel) or
  // nothing (bisect): lane steps [sel_lo, sel_hi)
  const int sel_lo = csel ? qoff / kG : 0;
  const int sel_hi = bisect ? 0 : (csel ? (qoff + kB) / kG : per_lane);
  // d2 of this lane's window row r = lane + kG * i (NaN: no candidate)
  auto d2_at = [&](int i) -> float {
    if (cached) return dl[i];
    const int r = lane + kG * i;
    const float dx = sx[r] - qx, dy = sy[r] - qy, dz = sz[r] - qz;
    return dx * dx + dy * dy + dz * dz;
  };

  // sums of up to 1920 candidates accumulate in double: the result is then
  // (all but surely) the correctly rounded float sum whatever the order, so
  // the kernel and the plain version agree bit for bit
  double m[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) m[i] = 0.0;
  uint32_t top[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) top[j] = kInvalidKey;
  float hi_full = 0.0f;  // the window's max valid d2
  float hi_own = 0.0f;   // the own block's max valid d2 (bisect)
  int n_own = 0;         // the own block's valid rows (bisect)
  int n_sel = 0;         // this lane's valid rows in the top-k range
  int cnt2 = 0;

  for (int i = 0; i < per_lane; ++i) {
    const int r = lane + kG * i;
    const float cx = sx[r], cy = sy[r], cz = sz[r];
    const float dx = cx - qx, dy = cy - qy, dz = cz - qz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (cached) dl[i] = d2;
    const bool ok = d2 == d2;  // a candidate
    hi_full = fmaxf(hi_full, d2);  // fmaxf drops NaN
    if (COUNT2) cnt2 += d2 <= r2b ? 1 : 0;
    if (moments_on && d2 <= r2) {
      m[0] += 1.0;
      m[1] += cx;
      m[2] += cy;
      m[3] += cz;
      m[4] += cx * cx;  // float products, double sums
      m[5] += cy * cy;
      m[6] += cz * cz;
      m[7] += cx * cy;
      m[8] += cx * cz;
      m[9] += cy * cz;
    }
    if (bisect && r >= qoff && r < qoff + kB) {
      hi_own = fmaxf(hi_own, d2);
      n_own += ok ? 1 : 0;
    }
    if (!bisect && i >= sel_lo && i < sel_hi) {
      n_sel += ok ? 1 : 0;
      const uint32_t key = (__float_as_uint(d2) & kTrunc) | (uint32_t)r;  // NaN: > kInvalidKey
      if (key < top[CAP - 1]) topk_insert<CAP>(top, key);
    }
  }
  hi_full = group_max(gmask, hi_full);
  if (COUNT2) cnt2 = __reduce_add_sync(gmask, cnt2);
  if (moments_on) {
#pragma unroll
    for (int i = 0; i < 10; ++i) m[i] = group_sum(gmask, m[i]);
  }

  const float kf = (float)k;
  float mean, cnt;
  uint32_t kth = kInvalidKey;
  double sum_k = 0.0;  // sweep: the distances of the k nearest
  int hits = 0;
  if (!bisect) {
    const uint32_t last = top[CAP - 1];
    uint32_t kept[CAP];
#pragma unroll
    for (int j = 0; j < CAP; ++j) kept[j] = top[j];
    kth = group_kth<csel>(gmask, top, k);
    if (__any_sync(gmask, n_sel > CAP && last < kth)) {
      // a lane dropped keys below the k-th: find it exactly by k walks for
      // the next smallest key (rare; no list to hold), and sum by a walk
      uint32_t floor_key = 0;  // keys below it are taken
      for (int j = 0; j < k; ++j) {
        uint32_t best = kInvalidKey;
        for (int i = sel_lo; i < sel_hi; ++i) {
          const uint32_t key = (__float_as_uint(d2_at(i)) & kTrunc) | (uint32_t)(lane + kG * i);
          if (key >= floor_key && key < best) best = key;
        }
        kth = group_min<csel>(gmask, best);
        floor_key = kth + 1;
      }
      if (KMODE == 0) {
        for (int i = sel_lo; i < sel_hi; ++i) {
          const uint32_t key = (__float_as_uint(d2_at(i)) & kTrunc) | (uint32_t)(lane + kG * i);
          if (hit_key(key, kth)) {
            ++hits;
            sum_k += sqrtf(fmaxf(__uint_as_float(key & kTrunc), 0.0f));
          }
        }
      }
    } else if (KMODE == 0) {
#pragma unroll
      for (int j = 0; j < CAP; ++j) {
        if (hit_key(kept[j], kth)) {
          ++hits;
          sum_k += sqrtf(fmaxf(__uint_as_float(kept[j] & kTrunc), 0.0f));
        }
      }
    }
    if (KMODE == 0) {
      hits = __reduce_add_sync(gmask, hits);
      sum_k = group_sum(gmask, sum_k);
    }
  }
  if (KMODE == 0) {
    cnt = (float)hits;
    mean = (float)sum_k / fmaxf(cnt, 1.0f);
  } else {
    // threshold select: narrow t until count(d2 <= t) ~= k, then one
    // masked sum with the at-threshold correction. csel compares the
    // truncated d2 (as its own-block k-th is truncated), bisect the
    // untruncated one. For d2, t >= 0: trunc(d2) <= t exactly when
    // d2 <= bits(t) | 2047, so both compare d2 itself; NaN never counts.
    auto limit = [](float thr) {
      const uint32_t bits = __float_as_uint(thr);
      return csel && bits < 0x7F800000u ? __uint_as_float(bits | 2047u) : thr;
    };
    auto count_le = [&](float thr) -> int {
      const float lim = limit(thr);
      int c = 0;
      if (cached) {
        const float2* row = reinterpret_cast<const float2*>(dl);
#pragma unroll 4
        for (int i = 0; i < per_lane / 2; ++i) {
          const float2 v = row[i];
          c += (v.x <= lim ? 1 : 0) + (v.y <= lim ? 1 : 0);
        }
      } else {
        for (int i = 0; i < per_lane; ++i) c += d2_at(i) <= lim ? 1 : 0;
      }
      return __reduce_add_sync(gmask, c);
    };
    bool sparse = false;
    float lo = 0.0f, hi;
    constexpr int iters = csel ? kCselIters : kBisectIters;
    if (csel) {
      sparse = __uint_as_float(kth) >= kHalfBig;
      hi = sparse ? hi_full : __uint_as_float(kth & kTrunc);
    } else {
      hi_own = group_max(gmask, hi_own);
      n_own = __reduce_add_sync(gmask, n_own);
      hi = n_own >= k ? hi_own : hi_full;
    }
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      const bool enough = count_le(mid) >= k;
      lo = enough ? lo : mid;
      hi = enough ? mid : hi;
    }
    const float lim = limit(hi);
    int inside = 0;
    double sum_d = 0.0;
#pragma unroll 4
    for (int i = 0; i < per_lane; ++i) {
      const float d2 = d2_at(i);
      if (d2 <= lim) {
        ++inside;
        sum_d += sqrtf(fmaxf(d2, 0.0f));
      }
    }
    inside = __reduce_add_sync(gmask, inside);
    sum_d = group_sum(gmask, sum_d);
    const float cntf = (float)inside;
    const float extra = fmaxf(cntf - kf, 0.0f);
    const float thr_d = sqrtf(fmaxf(hi, 0.0f));
    const float stand_in =
        sparse ? 0.5f * (thr_d + sqrtf(fmaxf(lo, 0.0f))) : thr_d;
    const float sum_f = (float)sum_d;
    mean = cntf >= kf ? (sum_f - extra * stand_in) / kf
                      : sum_f / fmaxf(cntf, 1.0f);
    mean = fmaxf(mean, 0.0f);
    cnt = fminf(cntf, kf);
  }

  // every lane of the group holds the results; they share the stores
  const int g = block * kB + q;
  if (lane == 0) mean_out[g] = mean;
  if (lane == 1) cnt_out[g] = cnt;
  if (COUNT2 && lane == 2) cnt2_out[g] = (float)cnt2;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i % kG == lane) mom_out[(size_t)i * n + g] = (float)m[i];
  }
}

// dynamic shared memory of a CTA: the queries' d2 rows when they are kept
// (else room for the origin's tree), then the window's x, y, z rows
size_t window_smem(int wb, int kmode) {
  const int span = window_span(wb);
  return ((size_t)lead_floats(kmode, span) + 3 * span) * sizeof(float);
}

// devices whose attributes are remembered as set (others set them at every launch)
constexpr int kMaxDevices = 64;

template <int MAXK, int KMODE, bool COUNT2>
cudaError_t set_attributes() {
  // once per instantiation and device: a function attribute is set in the
  // current device's context only, so a kernel set up on one card would
  // fail to launch on another with its shared memory over 48 KB
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool remembered = device >= 0 && device < kMaxDevices;
  if (remembered && done[device]) return cudaSuccess;
  auto kernel = window_stats_kernel<MAXK, KMODE, COUNT2>;
  size_t most = 0;
  for (int w = 0; w <= kMaxWb; ++w) {
    const size_t bytes = window_smem(w, KMODE);
    most = bytes > most ? bytes : most;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (remembered) done[device] = err == cudaSuccess;
  return err;
}

// The launch arguments of apc_window_stats.
struct Args {
  const float *x, *y, *z;
  const uint8_t* valid;
  const float* rad;
  int rad_stride;
  const float* rad2;
  int rad2_stride;
  float *mean, *cnt, *mom, *cnt2;
  int batch, n, k, wb, direction, moments;
};

template <int MAXK, int KMODE, bool COUNT2>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const cudaError_t err = set_attributes<MAXK, KMODE, COUNT2>();
  if (err != cudaSuccess) return err;
  window_stats_kernel<MAXK, KMODE, COUNT2>
      <<<dim3(a.n / kB * kSplit, a.batch), kThreads, window_smem(a.wb, KMODE), stream>>>(
          a.x, a.y, a.z, a.valid, a.rad, a.rad_stride, a.rad2, a.rad2_stride, a.mean, a.cnt,
          a.mom, a.cnt2, a.n, a.k, a.wb, a.direction, a.moments);
  return cudaGetLastError();
}

template <int MAXK, int KMODE>
cudaError_t launch_count2(const Args& a, cudaStream_t stream) {
  return a.cnt2 != nullptr ? launch<MAXK, KMODE, true>(a, stream)
                           : launch<MAXK, KMODE, false>(a, stream);
}

template <int MAXK>
cudaError_t launch_mode(const Args& a, int kmode, cudaStream_t stream) {
  switch (kmode) {
    case 0:
      return launch_count2<MAXK, 0>(a, stream);
    case 1:
      return launch_count2<MAXK, 1>(a, stream);
    default:
      return launch_count2<MAXK, 2>(a, stream);
  }
}

}  // namespace

// Rows x, y, z, valid, mean, cnt [batch, n], mom [batch, 10, n], cnt2
// [batch, n] or null (no second-radius count); rad and rad2 float32 on the
// device, scan b's moment radius at rad[b * rad_stride] (stride 0: one
// radius for all) and its second radius likewise (rad2 may be null without
// cnt2); n % 128 == 0, 1 <= k <= 64, 0 <= wb <= 7, kmode 0 sweep, 1 csel,
// 2 bisect.
extern "C" int apc_window_stats(const void* x, const void* y, const void* z,
                                const void* valid, const void* rad, int rad_stride,
                                const void* rad2, int rad2_stride, void* mean,
                                void* cnt, void* mom, void* cnt2, int batch,
                                int n, int k, int wb, int direction, int kmode,
                                int moments, void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(y),
               static_cast<const float*>(z), static_cast<const uint8_t*>(valid),
               static_cast<const float*>(rad), rad_stride,
               static_cast<const float*>(rad2), rad2_stride,
               static_cast<float*>(mean), static_cast<float*>(cnt),
               static_cast<float*>(mom), static_cast<float*>(cnt2),
               batch, n, k, wb, direction, moments};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < kB || batch < 1) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (k <= 8) {
    err = launch_mode<8>(a, kmode, s);
  } else if (k <= 16) {
    err = launch_mode<16>(a, kmode, s);
  } else if (k <= 32) {
    err = launch_mode<32>(a, kmode, s);
  } else {
    err = launch_mode<64>(a, kmode, s);
  }
  return static_cast<int>(err);
}

// Registers, resident CTAs an SM and local memory (spills) a thread of
// K3's instantiation `index` (0..23: MAXK 8, 16, 32, 64 x kmode sweep,
// csel, bisect x count2 off, on), with the shared memory of window `wb`.
// Returns 0, -1 past the last one, or a CUDA error code.
extern "C" int apc_window_stats_info(int index, char* name, int name_len, int* regs,
                                     int* blocks_per_sm, int* local_bytes, int wb) {
#define APC_K3(M, K, C)                                                        \
  {M, K, C, reinterpret_cast<const void*>(&window_stats_kernel<M, K, C>), \
   &set_attributes<M, K, C>}
  struct Entry {
    int maxk, kmode;
    bool count2;
    const void* fn;
    cudaError_t (*prepare)();
  };
  const Entry table[] = {
      APC_K3(8, 0, false), APC_K3(8, 0, true), APC_K3(8, 1, false), APC_K3(8, 1, true),
      APC_K3(8, 2, false), APC_K3(8, 2, true), APC_K3(16, 0, false), APC_K3(16, 0, true),
      APC_K3(16, 1, false), APC_K3(16, 1, true), APC_K3(16, 2, false), APC_K3(16, 2, true),
      APC_K3(32, 0, false), APC_K3(32, 0, true), APC_K3(32, 1, false), APC_K3(32, 1, true),
      APC_K3(32, 2, false), APC_K3(32, 2, true), APC_K3(64, 0, false), APC_K3(64, 0, true),
      APC_K3(64, 1, false), APC_K3(64, 1, true), APC_K3(64, 2, false), APC_K3(64, 2, true),
  };
#undef APC_K3
  if (index < 0 || index >= static_cast<int>(sizeof(table) / sizeof(table[0]))) return -1;
  const Entry& e = table[index];
  cudaFuncAttributes attr;
  cudaError_t err = e.prepare();  // the launch's shared-memory attributes
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, e.fn);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, e.fn, kThreads,
                                                        window_smem(wb, e.kmode));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  static const char* const modes[] = {"sweep", "csel", "bisect"};
  snprintf(name, name_len, "K3 window_stats<MAXK=%d,%s%s>", e.maxk, modes[e.kmode],
           e.count2 ? ",count2" : "");
  return 0;
}
