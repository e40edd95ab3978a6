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
// Batch axis: rows are [batch, n] and r2 is [batch, 2] (each scan's squared
// moment radius and squared second radius, the reference's per-scan SMEM
// table, pallas_window.py:461-467); the
// grid is (n / 128, batch) and each element's window stops at its own row
// ends, so no window reaches into the neighbouring scan. This is the
// reference's custom_vmap rule (_make_window_stats) as a grid dimension.
// Windows: wb >= 1 is wb blocks each side; wb == 0 is the own block plus
// the next one (direction 0) or the previous one (direction 1).
// Out-of-range rows, invalid rows and non-finite rows are excluded as
// candidates; non-finite coordinates are zeroed before any arithmetic.
//
// Semantics kept from the reference: distances are compared with the low
// 11 mantissa bits cleared and ties broken by window row (the key is
// (bits(d2) & ~2047) | row). Not kept: the TPU's distance matmul
// (|c|^2 + |q|^2 - 2 c.q on the MXU, 'highest' or 'fast3' bf16 splits).
// Here d2 is the plain f32 sum of squared differences of centered
// coordinates, for both modes.
//
// Design for the H100: one 128-thread CTA per 128-query block stages the
// sanitized, centered window (x, y, z, valid) in shared memory: 13 bytes a
// row, 5 KB at wb=1 and 25 KB at wb=7. One thread per query walks the
// window from shared memory; the k smallest keys live in a register array
// (sorted insertion, MAXK >= k slots, fully unrolled), so nothing but the
// window and the outputs touch device memory. The second-radius count is
// one compare per candidate in the same walk. The moment and csel/bisect
// distance sums accumulate in double, which makes them independent of the
// order of addition to float rounding. Bound: the per-thread compare work
// (span x MAXK integer min/max for the top-k; 3 more window walks for
// csel, 14 for bisect), not bytes: the whole pass reads 13 bytes and writes
// at most 52 bytes per row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;
constexpr float kHalfBig = 5e29f;             // the reference's _BIG / 2
constexpr uint32_t kInvalidKey = 0x7F800000u;  // +inf: after every finite d2
constexpr uint32_t kTrunc = ~2047u;
constexpr int kCselIters = 2;
constexpr int kBisectIters = 13;

__device__ __forceinline__ float trunc_d2(float d2) {
  return __uint_as_float(__float_as_uint(d2) & kTrunc);
}

template <int MAXK>
__device__ __forceinline__ void topk_insert(uint32_t (&top)[MAXK], uint32_t v) {
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    const uint32_t lo = min(v, top[j]);
    v = max(v, top[j]);
    top[j] = lo;
  }
}

// KMODE (0 sweep, 1 csel, 2 bisect) and COUNT2 (the second radius's count
// on or off) are template parameters: each instantiation carries only its
// own mode's state, which keeps the csel instantiation of the production
// path at the registers it had before the other modes were added (a
// runtime mode switch cost 36 more registers and one block per SM).
template <int MAXK, int KMODE, bool COUNT2>
__global__ void __launch_bounds__(kB)
window_stats_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ z,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ r2_ptr,
                    float* __restrict__ mean_out, float* __restrict__ cnt_out,
                    float* __restrict__ mom_out, float* __restrict__ cnt2_out,
                    int n, int k, int wb, int direction, int moments_on) {
  extern __shared__ float smem[];
  __shared__ float red[3][kB];
  const int span = wb > 0 ? (2 * wb + 1) * kB : 2 * kB;
  const int qoff = wb > 0 ? wb * kB : (direction == 0 ? 0 : kB);
  float* sx = smem;
  float* sy = sx + span;
  float* sz = sy + span;
  uint8_t* sv = reinterpret_cast<uint8_t*>(sz + span);
  const int t = threadIdx.x;
  const int start = blockIdx.x * kB - qoff;
  const size_t elem = blockIdx.y;
  x += elem * n;
  y += elem * n;
  z += elem * n;
  valid += elem * n;
  mean_out += elem * n;
  cnt_out += elem * n;
  mom_out += elem * 10 * n;
  if (COUNT2) cnt2_out += elem * n;

  for (int r = t; r < span; r += kB) {
    const int g = start + r;
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    uint8_t ok = 0;
    if (g >= 0 && g < n) {
      const float ax = x[g], ay = y[g], az = z[g];
      const bool fin = isfinite(ax) && isfinite(ay) && isfinite(az);
      if (fin) {
        fx = ax;
        fy = ay;
        fz = az;
      }
      ok = (fin && valid[g] != 0) ? 1 : 0;
    }
    sx[r] = fx;
    sy[r] = fy;
    sz[r] = fz;
    sv[r] = ok;
  }
  __syncthreads();

  // block origin: tree sum of the 128 query rows, pairs (t, t + s)
  red[0][t] = sx[qoff + t];
  red[1][t] = sy[qoff + t];
  red[2][t] = sz[qoff + t];
  __syncthreads();
  for (int s = kB / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[0][t] += red[0][t + s];
      red[1][t] += red[1][t + s];
      red[2][t] += red[2][t + s];
    }
    __syncthreads();
  }
  const float c0x = red[0][0] * (1.0f / kB);
  const float c0y = red[1][0] * (1.0f / kB);
  const float c0z = red[2][0] * (1.0f / kB);
  for (int r = t; r < span; r += kB) {
    sx[r] = sx[r] - c0x;
    sy[r] = sy[r] - c0y;
    sz[r] = sz[r] - c0z;
  }
  __syncthreads();

  const float qx = sx[qoff + t], qy = sy[qoff + t], qz = sz[qoff + t];
  const float r2 = r2_ptr[2 * elem];
  const float r2b = r2_ptr[2 * elem + 1];
  constexpr bool csel = KMODE == 1;
  constexpr bool bisect = KMODE == 2;
  // the top-k runs over the whole window (sweep), the own block (csel) or
  // nothing (bisect)
  const int sel_lo = csel ? qoff : 0;
  const int sel_hi = bisect ? 0 : (csel ? qoff + kB : span);

  // sums of up to 1920 candidates accumulate in double: the result is then
  // (all but surely) the correctly rounded float sum whatever the order, so
  // the kernel and the plain version agree bit for bit
  double m[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) m[i] = 0.0;
  uint32_t top[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) top[j] = kInvalidKey;
  float hi_full = 0.0f;  // the window's max valid d2
  float hi_own = 0.0f;   // the own block's max valid d2 (bisect)
  int n_own = 0;         // the own block's valid rows (bisect)
  int cnt2 = 0;

  for (int r = 0; r < span; ++r) {
    if (!sv[r]) continue;
    const float cx = sx[r], cy = sy[r], cz = sz[r];
    const float dx = cx - qx, dy = cy - qy, dz = cz - qz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    hi_full = fmaxf(hi_full, d2);
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
      ++n_own;
    }
    if (r >= sel_lo && r < sel_hi) {
      const uint32_t key = (__float_as_uint(d2) & kTrunc) | (uint32_t)r;
      if (key < top[MAXK - 1]) topk_insert<MAXK>(top, key);
    }
  }

  const float kf = (float)k;
  float mean, cnt;
  if (KMODE == 0) {
    float acc = 0.0f, hits = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXK; ++j) {
      if (j < k) {
        const bool hit = __uint_as_float(top[j]) < kHalfBig;
        const float dist2 = __uint_as_float(top[j] & kTrunc);
        acc += hit ? sqrtf(fmaxf(dist2, 0.0f)) : 0.0f;
        hits += hit ? 1.0f : 0.0f;
      }
    }
    mean = acc / fmaxf(hits, 1.0f);
    cnt = hits;
  } else {
    // threshold select: narrow t until count(d2 <= t) ~= k, then one
    // masked sum with the at-threshold correction. csel compares the
    // truncated d2 (as its own-block k-th is truncated), bisect the
    // untruncated one.
    bool sparse = false;
    float lo = 0.0f, hi;
    constexpr int iters = csel ? kCselIters : kBisectIters;
    if (csel) {
      uint32_t kth = kInvalidKey;
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        if (j == k - 1) kth = top[j];
      }
      sparse = __uint_as_float(kth) >= kHalfBig;
      hi = sparse ? hi_full : __uint_as_float(kth & kTrunc);
    } else {
      hi = n_own >= k ? hi_own : hi_full;
    }
    for (int it = 0; it < iters; ++it) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
      for (int r = 0; r < span; ++r) {
        if (!sv[r]) continue;
        const float dx = sx[r] - qx, dy = sy[r] - qy, dz = sz[r] - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        c += (csel ? trunc_d2(d2) : d2) <= mid ? 1 : 0;
      }
      const bool enough = c >= k;
      lo = enough ? lo : mid;
      hi = enough ? mid : hi;
    }
    int inside = 0;
    double sum_d = 0.0;
    for (int r = 0; r < span; ++r) {
      if (!sv[r]) continue;
      const float dx = sx[r] - qx, dy = sy[r] - qy, dz = sz[r] - qz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if ((csel ? trunc_d2(d2) : d2) <= hi) {
        ++inside;
        sum_d += sqrtf(fmaxf(d2, 0.0f));
      }
    }
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

  const int g = blockIdx.x * kB + t;
  mean_out[g] = mean;
  cnt_out[g] = cnt;
#pragma unroll
  for (int i = 0; i < 10; ++i) mom_out[(size_t)i * n + g] = (float)m[i];
  if (COUNT2) cnt2_out[g] = (float)cnt2;
}

template <int MAXK, int KMODE, bool COUNT2>
cudaError_t launch(const float* x, const float* y, const float* z,
                   const uint8_t* valid, const float* r2, float* mean,
                   float* cnt, float* mom, float* cnt2, int batch, int n,
                   int k, int wb, int direction, int moments,
                   cudaStream_t stream) {
  const int span = wb > 0 ? (2 * wb + 1) * kB : 2 * kB;
  const size_t smem = (size_t)span * (3 * sizeof(float) + 1);
  window_stats_kernel<MAXK, KMODE, COUNT2><<<dim3(n / kB, batch), kB, smem, stream>>>(
      x, y, z, valid, r2, mean, cnt, mom, cnt2, n, k, wb, direction, moments);
  return cudaGetLastError();
}

template <int MAXK, int KMODE>
cudaError_t launch_count2(const float* x, const float* y, const float* z,
                          const uint8_t* valid, const float* r2, float* mean,
                          float* cnt, float* mom, float* cnt2, int batch,
                          int n, int k, int wb, int direction, int moments,
                          cudaStream_t stream) {
  if (cnt2 != nullptr) {
    return launch<MAXK, KMODE, true>(x, y, z, valid, r2, mean, cnt, mom, cnt2,
                                     batch, n, k, wb, direction, moments, stream);
  }
  return launch<MAXK, KMODE, false>(x, y, z, valid, r2, mean, cnt, mom, cnt2,
                                    batch, n, k, wb, direction, moments, stream);
}

template <int MAXK>
cudaError_t launch_mode(const float* x, const float* y, const float* z,
                        const uint8_t* valid, const float* r2, float* mean,
                        float* cnt, float* mom, float* cnt2, int batch, int n,
                        int k, int wb, int direction, int kmode, int moments,
                        cudaStream_t stream) {
  switch (kmode) {
    case 0:
      return launch_count2<MAXK, 0>(x, y, z, valid, r2, mean, cnt, mom, cnt2,
                                    batch, n, k, wb, direction, moments, stream);
    case 1:
      return launch_count2<MAXK, 1>(x, y, z, valid, r2, mean, cnt, mom, cnt2,
                                    batch, n, k, wb, direction, moments, stream);
    default:
      return launch_count2<MAXK, 2>(x, y, z, valid, r2, mean, cnt, mom, cnt2,
                                    batch, n, k, wb, direction, moments, stream);
  }
}

}  // namespace

// Rows x, y, z, valid, mean, cnt [batch, n], mom [batch, 10, n], cnt2
// [batch, n] or null (no second-radius count); r2 float32[batch, 2] on the
// device (each scan's squared moment radius and squared second radius);
// n % 128 == 0, 1 <= k <= 64, 0 <= wb <= 7, kmode 0 sweep, 1 csel, 2 bisect.
extern "C" int apc_window_stats(const void* x, const void* y, const void* z,
                                const void* valid, const void* r2, void* mean,
                                void* cnt, void* mom, void* cnt2, int batch,
                                int n, int k, int wb, int direction, int kmode,
                                int moments, void* stream) {
  const float* fx = static_cast<const float*>(x);
  const float* fy = static_cast<const float*>(y);
  const float* fz = static_cast<const float*>(z);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* fr2 = static_cast<const float*>(r2);
  float* fm = static_cast<float*>(mean);
  float* fc = static_cast<float*>(cnt);
  float* fo = static_cast<float*>(mom);
  float* fc2 = static_cast<float*>(cnt2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < kB || batch < 1) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (k <= 8) {
    err = launch_mode<8>(fx, fy, fz, v, fr2, fm, fc, fo, fc2, batch, n, k, wb, direction, kmode, moments, s);
  } else if (k <= 16) {
    err = launch_mode<16>(fx, fy, fz, v, fr2, fm, fc, fo, fc2, batch, n, k, wb, direction, kmode, moments, s);
  } else if (k <= 32) {
    err = launch_mode<32>(fx, fy, fz, v, fr2, fm, fc, fo, fc2, batch, n, k, wb, direction, kmode, moments, s);
  } else {
    err = launch_mode<64>(fx, fy, fz, v, fr2, fm, fc, fo, fc2, batch, n, k, wb, direction, kmode, moments, s);
  }
  return static_cast<int>(err);
}
