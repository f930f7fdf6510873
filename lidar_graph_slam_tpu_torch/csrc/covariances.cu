// GICP's per-point covariances for Hopper (sm_90a): the sorted-window sums and the plane
// regularization of `registration/gicp.py:estimate_covariances`.
//
// Replaces what the JAX package leaves to XLA inside its jitted `estimate_covariances`
// (lidar_graph_slam_tpu/registration/gicp.py:61-90; it has no Pallas kernel for it):
//
//  * `window_covariances_kernel` ports `window_covariances`
//    (lidar_graph_slam_tpu/ops/neighbors.py:212-245): for each row sorted by cell key, the
//    count, mean and covariance of the same-cell rows among the +-16 sorted rows around it,
//    itself included. The port's plain version (`ops/neighbors.py:window_covariances`)
//    runs 16 shifts x 2 directions of ~25 elementwise torch ops, ~800 launches a cloud,
//    each a pass over [N] float32 or float64 tensors. Here a block of 128 threads takes
//    128 consecutive sorted rows and stages them with their 2 x 16 window rows in shared
//    memory (the key, xyz and xyz in float64), wrapping at both ends as `torch.roll`
//    does: row i's shift-s neighbour is row (i - s) mod N, so for N < 160 the stage wraps
//    more than once and a row may meet itself or one neighbour several times, as the
//    plain version does. Each thread then walks its row's window in the plain version's
//    column order (the row itself, then shifts +1, -1, +2, -2, ... +16, -16).
//  * `plane_covariances_kernel` ports the rest of `estimate_covariances`
//    (lidar_graph_slam_tpu/registration/gicp.py:77-90): the identity where fewer than 5
//    points were summed, the one-thread Jacobi eigensolve of `eigh3x3.cuh`, the
//    eigenvalues snapped to (1e-3, 1, 1) as V diag(1e-3, 1, 1) V^T, and the scatter back
//    to the original row order with the caller's mask; one thread a row. The plain
//    version (`ops/neighbors.py:plane_covariances_plain`) is two `where`s, the ~950-op
//    unrolled eigensolve, the product's ~10 ops and two scatters.
//
// Bit-equal to the plain versions on the card. Every float32 operation is theirs, in
// their order, rounded once (`__f*_rn`, so nvcc contracts nothing into an FMA); the count
// and the first moments add `w` and `w x` in float32. Each second moment is the plain
// version's `addcmul` into float64 followed by `copy_` into float32: the product w x_i
// x_j is exact in float64 (a product of two float32 values), the add is rounded once in
// float64 and the sum again to float32 (`__fmaf_rn` would round once, and differs where
// the float64 sum lies on a float32 tie). The covariance is E[x x^T] - mu mu^T the same
// way: the quotient in float32, the product and the difference in float64, then float32.
// The product V diag(1e-3, 1, 1) V^T is `ops/voxel.py:_scaled_gram`'s: entry (i, j) the
// sum k = 0, 1, 2 of (V[i, k] d[k]) V[j, k], each product and add rounded once, as
// `ndt_finalize` sums its inverse. (The reference's batched `@` sums in cuBLAS's order on
// the card, which changes with the batch: an FMA chain k = 0, 1, 2 at N >= 5, another
// order at N = 1, measured on an H100; so the plain version writes the order out.)
// Nothing waits on the host; no atomics.
//
// What bounds them on this card. `window_covariances` reads 16 B a row (key, xyz) and
// writes 52 B (mean, covariance, count): 44.6 MB on the dense ring's 655,360 rows, 13 us
// at 3.35 TB/s. Its arithmetic is fixed by the plain version's rounding: each of a row's
// window rows of the same cell takes each of the 6 second moments from float32 to
// float64 and back, 12 conversions, which the H100 runs at 16 a clock on each SM (a
// quarter of its float64 rate): up to ~60 us for the dense ring at 1.98 GHz, the bound.
// A window row of another cell adds +-0 (or NaN), which a float32 add would give bit for
// bit; this kernel converts for it all the same (every slot takes one path), so on a
// sparse cloud it runs well above that bound. The stage in float64 makes a window row's
// xyz and w x a load and a float64 multiply, not 6 more conversions.
// `plane_covariances` reads 49 B a row (covariance, count, order, mask) and writes 37 B;
// a row with 5 or more points runs the eigensolve, ~1,740 instructions: issue slots.

#include <cuda_runtime.h>
#include <stdint.h>

#include "eigh3x3.cuh"

namespace {

constexpr int kInvalidKey = 0x7fffffff;  // ops/voxel.py:INVALID_KEY
constexpr int kCovThreads = 128;         // sorted rows (and threads) a block
constexpr int kCovWindow = 16;           // +-16 sorted rows (estimate_covariances' window)
constexpr int kCovStaged = kCovThreads + 2 * kCovWindow;
constexpr int kPlaneThreads = 128;
constexpr float kMinPoints = 5.0f;       // a covariance from fewer points is the identity

// Second moment m = 0..5 is (moment_i(m), moment_j(m)), the plain version's order:
// (0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2).
__host__ __device__ constexpr int moment_i(int m) { return m < 3 ? 0 : (m < 5 ? 1 : 2); }
__host__ __device__ constexpr int moment_j(int m) { return m < 3 ? m : (m < 5 ? m - 2 : 2); }

__global__ void __launch_bounds__(kCovThreads)
window_covariances_kernel(const int* __restrict__ keys, const float* __restrict__ pts,
                          long long n, float* __restrict__ mu, float* __restrict__ cov,
                          float* __restrict__ count) {
  __shared__ int skey[kCovStaged];
  __shared__ float sx[3][kCovStaged];
  __shared__ double sd[3][kCovStaged];
  const long long i0 = static_cast<long long>(blockIdx.x) * kCovThreads;
  // Slot t holds sorted row (i0 - kCovWindow + t) mod n: row i's shift-s neighbour, row
  // (i - s) mod n, is slot (i - i0) + kCovWindow - s. For n >= kCovStaged,
  // i0 - kCovWindow + t lies in [-kCovWindow, n + kCovStaged), one wrap at most.
  for (int t = threadIdx.x; t < kCovStaged; t += kCovThreads) {
    long long g = i0 - kCovWindow + t;
    if (n < kCovStaged) {
      g %= n;
      if (g < 0) g += n;
    } else if (g < 0) {
      g += n;
    } else if (g >= n) {
      g -= n;
    }
    skey[t] = keys[g];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = pts[3 * g + c];
      sx[c][t] = x;
      sd[c][t] = static_cast<double>(x);
    }
  }
  __syncthreads();
  const long long i = i0 + threadIdx.x;
  if (i >= n) return;
  const int me = threadIdx.x + kCovWindow;
  const int key = skey[me];
  const bool valid = key != kInvalidKey;
  // The row itself: torch.where(valid, x, 0.0) and torch.where(valid, x_i * x_j, 0.0).
  float cnt = valid ? 1.0f : 0.0f;
  float s1[3], s2[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) s1[c] = valid ? sx[c][me] : 0.0f;
#pragma unroll
  for (int m = 0; m < 6; ++m)
    s2[m] = valid ? __fmul_rn(sx[moment_i(m)][me], sx[moment_j(m)][me]) : 0.0f;
#pragma unroll
  for (int s = 1; s <= kCovWindow; ++s) {
#pragma unroll
    for (int side = 0; side < 2; ++side) {  // shift +s (slot me - s), then -s (me + s)
      const int slot = side == 0 ? me - s : me + s;
      const bool same = valid && skey[slot] == key;
      const float w = same ? 1.0f : 0.0f;
      // (double)(w * x) as one float64 product: w is 0 or 1, so w * x is exact in both
      // widths, the zero keeps x's sign and an infinite or NaN x gives NaN in both.
      const double wd = same ? 1.0 : 0.0;
      cnt = __fadd_rn(cnt, w);
      double ws[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s1[c] = __fadd_rn(s1[c], __fmul_rn(w, sx[c][slot]));
        ws[c] = __dmul_rn(wd, sd[c][slot]);
      }
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const double p = __dmul_rn(ws[moment_i(m)], sd[moment_j(m)][slot]);  // exact
        s2[m] = __double2float_rn(__dadd_rn(static_cast<double>(s2[m]), p));
      }
    }
  }
  const float denom = fmaxf(cnt, 1.0f);  // torch.clamp(cnt, min=1.0); cnt is never NaN
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mean[c] = __fdiv_rn(s1[c], denom);
    mu[3 * i + c] = mean[c];
  }
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int a = moment_i(m), b = moment_j(m);
    // addcmul(s2 / denom, mu_a, mu_b, value=-1) in float64, then into float32.
    const float c = __double2float_rn(__dadd_rn(
        static_cast<double>(__fdiv_rn(s2[m], denom)),
        -__dmul_rn(static_cast<double>(mean[a]), static_cast<double>(mean[b]))));
    cov[9 * i + 3 * a + b] = c;
    cov[9 * i + 3 * b + a] = c;
  }
  count[i] = cnt;
}

__global__ void __launch_bounds__(kPlaneThreads)
plane_covariances_kernel(const float* __restrict__ cov, const float* __restrict__ count,
                         const long long* __restrict__ order,
                         const uint8_t* __restrict__ mask, long long n,
                         float* __restrict__ covs, uint8_t* __restrict__ ok) {
  const long long i = static_cast<long long>(blockIdx.x) * kPlaneThreads + threadIdx.x;
  if (i >= n) return;
  const bool ok_s = count[i] >= kMinPoints;
  float out[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r][c] = r == c ? 1.0f : 0.0f;
  if (ok_s) {  // the identity elsewhere: torch.where(ok, V diag V^T, the identity)
    const float* m = cov + 9 * i;
    float a[6] = {m[0], m[4], m[8], m[1], m[2], m[5]};
    float w[3], v[3][3];
    eigh3x3(a, w, v);  // v[k][r] = V[r, k]
    const float d[3] = {1.0e-3f, 1.0f, 1.0f};  // ascending eigenvalue order
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float vd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) vd[k] = __fmul_rn(v[k][r], d[k]);  // (V * d)[r, k]
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[r][c] = __fadd_rn(__fadd_rn(__fmul_rn(vd[0], v[0][c]), __fmul_rn(vd[1], v[1][c])),
                              __fmul_rn(vd[2], v[2][c]));
    }
  }
  const long long row = order[i];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) covs[9 * row + 3 * r + c] = out[r][c];
  ok[row] = ok_s && mask[row] != 0;
}

unsigned int cov_blocks(long long rows, int per_block) {
  return static_cast<unsigned int>((rows + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// One launch on `stream` over n >= 1 rows sorted by cell key. keys: [n] i32 (INVALID_KEY
// for invalid rows); pts: [n, 3] f32 in the keys' order. Outputs (fresh, contiguous):
// mu [n, 3] f32, cov [n, 3, 3] f32 and count [n] f32, each row's same-cell window over
// +-16 sorted rows. Returns cudaGetLastError() after the launch (0 = success).
int lgs_window_covariances(const int* keys, const float* pts, long long n, float* mu,
                           float* cov, float* count, void* stream) {
  window_covariances_kernel<<<cov_blocks(n, kCovThreads), kCovThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(keys, pts, n, mu, cov,
                                                                   count);
  return static_cast<int>(cudaGetLastError());
}

// One launch on `stream` over n >= 1 rows in sorted order. cov: [n, 3, 3] f32 and count:
// [n] f32 (`window_covariances`' outputs); order: [n] i64, each row's original index (a
// permutation); mask: [n] u8 in the original order. Outputs (fresh, contiguous), at the
// original indices: covs [n, 3, 3] f32, the plane-regularized covariances (the identity
// where count < 5), and ok [n] u8 (count >= 5 and mask). Returns cudaGetLastError().
int lgs_plane_covariances(const float* cov, const float* count, const long long* order,
                          const uint8_t* mask, long long n, float* covs, uint8_t* ok,
                          void* stream) {
  plane_covariances_kernel<<<cov_blocks(n, kPlaneThreads), kPlaneThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(cov, count, order, mask, n,
                                                                  covs, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
