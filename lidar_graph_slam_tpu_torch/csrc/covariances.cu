// GICP's per-point covariances for Hopper (sm_90a): the whole of
// `registration/gicp.py:estimate_covariances` after the cells' sort, in one launch.
//
// Replaces what the JAX package leaves to XLA inside its jitted `estimate_covariances`
// (lidar_graph_slam_tpu/registration/gicp.py:61-90; it has no Pallas kernel for it):
// `window_covariances` (lidar_graph_slam_tpu/ops/neighbors.py:212-245), for each row sorted
// by cell key the count, mean and covariance of the same-cell rows among the +-16 sorted
// rows around it, itself included; then the identity where fewer than 5 points were
// summed, the Jacobi eigensolve of `eigh3x3.cuh`, the eigenvalues snapped to (1e-3, 1, 1)
// as V diag(1e-3, 1, 1) V^T, and the scatter back to the original row order with the
// caller's mask (:77-90). The port's plain version (`ops/neighbors.py:
// gicp_covariances_plain`) runs ~800 elementwise torch ops for the window sums and ~1,000
// for the rest.
//
// The design. The sorted rows are cut into tiles of 32, one a lane, and the launch has a
// warp for each tile: tile t goes to block t mod G, warp t / G of it (G = gridDim.x, the
// tiles over 4), so the valid rows, which the sort puts first, are dealt over every SM
// and not packed into the first few blocks. A warp stages its tile with its 16 rows on
// each side in its part of shared memory (the key, xyz and xyz in float64), wrapping as
// `torch.roll` does: row i's shift-s neighbour is row (i - s) mod N, so for N < 64 the
// stage wraps more than once and a row may meet itself or one neighbour several times, as
// the plain version does.
// Each lane walks its row's window in the plain version's column order (the row itself,
// then shifts +1, -1, +2, -2, ... +16, -16), solves the covariance in registers and writes
// the result at the row's original index; nothing intermediate goes to device memory. A
// warp whose rows are all invalid stores the identity and converts nothing. The window
// sums are bound by the float64 conversions and the eigensolve by the float32 and
// MUFU pipes' latency: as blocks retire and others start, the warps of an SM are in
// different phases and both pipes are busy at once. (A grid of resident blocks whose
// warps take tile after tile ran every warp of the card in step, all converting, then all
// solving; a summer warp feeding solver warps left too few rows in flight for either; the
// next tile's sums interleaved with this tile's sweeps in one warp gained nothing: the
// split of each design is in PERF.md, section 6.)
//
// Bit-equal to the plain version on the card. Every float32 operation is its own, in its
// order, rounded once (`__f*_rn`, so nvcc contracts nothing into an FMA); the count and
// the first moments add `w` and `w x` in float32. Each second moment is the plain
// version's `addcmul` into float64 followed by `copy_` into float32: the product w x_i
// x_j is exact in float64 (a product of two float32 values), the add is rounded once in
// float64 and the sum again to float32 (`__fmaf_rn` would round once, and differs where
// the float64 sum lies on a float32 tie). Every window column takes that route in every
// lane, w = 0 or 1. (A column no lane shares could add its +-0 in float32 with the same
// bits, but the vote that finds such columns cost more than it saved at every shape:
// PERF.md, section 6.) The covariance is E[x x^T] - mu mu^T the same way: the quotient
// in float32, the product and the difference in float64, then float32. The product
// V diag(1e-3, 1, 1) V^T is `ops/voxel.py:_scaled_gram`'s: entry (i, j) the sum k = 0, 1,
// 2 of (V[i, k] d[k]) V[j, k], each product and add rounded once, as `ndt_finalize` sums
// its inverse. Nothing waits on the host; no atomics, so a launch can be captured in a
// CUDA graph.
//
// What bounds it on this card. It reads 25 B a row (key, xyz, order, mask) and writes 37 B
// (covariance, ok): 40.6 MB on the dense ring's 655,360 rows, 12 us at 3.35 TB/s. Its
// arithmetic is fixed by the plain version's rounding: each same-cell window row of a
// valid row takes each of the 6 second moments from float32 to float64 and back, 12
// conversions, which the H100 runs at 16 a clock on each SM (a quarter of its float64
// rate): ~60 us for the dense ring at 1.98 GHz, its bound (the kernel converts for every
// window column of a tile with a valid row, 32 a row, which the dense ring's 2 m cells
// nearly all share), on another pipe than the eigensolve's ~1,740 float32 and MUFU
// instructions a row of 5 or more points (~35 us). A sparse cloud (the verifier's: 4,858
// valid rows of 16,384) is bound by one tile's chain of dependent conversions, adds and
// the eigensolve's divides and roots.
//
// `scripts/torch_covariances_split.py` builds this file with -DLGS_COV_STEPS=0..3 to time
// a launch cut after each of its parts (`CovStep`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "eigh3x3.cuh"

#ifndef LGS_COV_STEPS
#define LGS_COV_STEPS 4
#endif

namespace {

constexpr int kInvalidKey = 0x7fffffff;  // ops/voxel.py:INVALID_KEY
constexpr int kTileRows = 32;            // sorted rows a tile: a lane a row
constexpr int kCovWindow = 16;           // +-16 sorted rows (estimate_covariances' window)
constexpr int kColumns = 2 * kCovWindow;
constexpr int kTileStaged = kTileRows + 2 * kCovWindow;
constexpr int kCovWarps = 4;             // warps a block
constexpr int kCovThreads = 32 * kCovWarps;
constexpr float kMinPoints = 5.0f;       // a covariance from fewer points is the identity
constexpr unsigned kFullMask = 0xffffffffu;

// How far a launch goes (the split's variants; the library's kernel is kStore): the
// launch floor; the stage alone; the window sums (a tile with no valid row skipped); the
// eigensolve; the store at the original rows with the mask. The variants before kStore
// write what they have at the sorted row, so that nothing they computed is dropped.
enum CovStep { kFloor = 0, kStage, kSums, kSolve, kStore };

// A warp's stage: slot s holds sorted row (t0 - kCovWindow + s) mod n of tile t0.
struct TileStage {
  int key[kTileStaged];
  float x[3][kTileStaged];
  double xd[3][kTileStaged];
};

// Second moment m = 0..5 is (moment_i(m), moment_j(m)), the plain version's order:
// (0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2).
__host__ __device__ constexpr int moment_i(int m) { return m < 3 ? 0 : (m < 5 ? 1 : 2); }
__host__ __device__ constexpr int moment_j(int m) { return m < 3 ? m : (m < 5 ? m - 2 : 2); }

// (g mod n) for g in [-kCovWindow, n + kTileStaged) when n >= kTileStaged; any g else.
__device__ __forceinline__ long long wrap_row(long long g, long long n) {
  if (n < kTileStaged) {
    g %= n;
    return g < 0 ? g + n : g;
  }
  return g < 0 ? g + n : (g >= n ? g - n : g);
}

__device__ __forceinline__ void store_row(float* __restrict__ covs, long long row,
                                          const float (&out)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) covs[9 * row + 3 * r + c] = out[r][c];
}

__device__ __forceinline__ void stage_tile(TileStage& st, const int* __restrict__ keys,
                                           const float* __restrict__ pts, long long t0,
                                           long long n, int lane) {
  for (int s = lane; s < kTileStaged; s += 32)
    st.key[s] = keys[wrap_row(t0 - kCovWindow + s, n)];
  for (int f = lane; f < 3 * kTileStaged; f += 32) {  // consecutive lanes, addresses
    const int s = f / 3, c = f - 3 * s;
    const float x = pts[3 * wrap_row(t0 - kCovWindow + s, n) + c];
    st.x[c][s] = x;
    st.xd[c][s] = static_cast<double>(x);
  }
}

// The stage slot of window column k = 0..31 (shift +s, then -s, s = 1..16) of the row at
// slot `me`.
__device__ __forceinline__ int window_slot(int me, int k) {
  return (k & 1) == 0 ? me - (k / 2 + 1) : me + (k / 2 + 1);
}

// The window covariance of the row at slot `me` into a[] (eigh3x3's order); returns its
// count.
__device__ __forceinline__ float window_covariance(const TileStage& st, int me, int key,
                                                   bool valid, float (&a)[6]) {
  // The row itself: torch.where(valid, x, 0.0) and torch.where(valid, x_i * x_j, 0.0).
  float cnt = valid ? 1.0f : 0.0f;
  float s1[3], s2[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) s1[c] = valid ? st.x[c][me] : 0.0f;
#pragma unroll
  for (int m = 0; m < 6; ++m)
    s2[m] = valid ? __fmul_rn(st.x[moment_i(m)][me], st.x[moment_j(m)][me]) : 0.0f;
#pragma unroll 4
  for (int k = 0; k < kColumns; ++k) {
    const int slot = window_slot(me, k);
    const bool same = valid && st.key[slot] == key;
    const float w = same ? 1.0f : 0.0f;
    cnt = __fadd_rn(cnt, w);
#pragma unroll
    for (int c = 0; c < 3; ++c) s1[c] = __fadd_rn(s1[c], __fmul_rn(w, st.x[c][slot]));
    // (double)(w * x) as one float64 product: w is 0 or 1, so w * x is exact in both
    // widths, and the zero keeps x's sign.
    const double wd = same ? 1.0 : 0.0;
    double ws[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ws[c] = __dmul_rn(wd, st.xd[c][slot]);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const double p = __dmul_rn(ws[moment_i(m)], st.xd[moment_j(m)][slot]);  // exact
      s2[m] = __double2float_rn(__dadd_rn(static_cast<double>(s2[m]), p));
    }
  }
  const float denom = fmaxf(cnt, 1.0f);  // torch.clamp(cnt, min=1.0); cnt is never NaN
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = __fdiv_rn(s1[c], denom);
#pragma unroll
  for (int m = 0; m < 6; ++m)  // addcmul(s2 / denom, mu_i, mu_j, value=-1) in float64
    a[sym(moment_i(m), moment_j(m))] = __double2float_rn(__dadd_rn(
        static_cast<double>(__fdiv_rn(s2[m], denom)),
        -__dmul_rn(static_cast<double>(mean[moment_i(m)]),
                   static_cast<double>(mean[moment_j(m)]))));
  return cnt;
}

// The identity, or where cnt >= kMinPoints V diag(1e-3, 1, 1) V^T of the eigenvectors V
// of a (eigh3x3's order).
__device__ __forceinline__ void plane_covariance(float (&a)[6], float cnt,
                                                 float (&out)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) out[r][c] = r == c ? 1.0f : 0.0f;
  if (cnt >= kMinPoints) {  // the identity elsewhere: torch.where(ok, V diag V^T, eye)
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
}

template <int kSteps>
__global__ void __launch_bounds__(kCovThreads)
gicp_covariances_kernel(const int* __restrict__ keys, const float* __restrict__ pts,
                        const long long* __restrict__ order,
                        const uint8_t* __restrict__ mask, long long n,
                        float* __restrict__ covs, uint8_t* __restrict__ ok) {
  __shared__ TileStage stages[kCovWarps];
  if (kSteps == kFloor) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TileStage& st = stages[warp];
  const long long t = blockIdx.x + static_cast<long long>(gridDim.x) * warp;  // the tile
  if (t * kTileRows >= n) return;  // the whole warp: the last block's spare warps
  const int me = lane + kCovWindow;
  stage_tile(st, keys, pts, t * kTileRows, n, lane);
  // A row past n is a lane with `live` false, which stays for the warp collectives.
  const long long i = t * kTileRows + lane;
  const bool live = i < n;
  long long row = i;  // the original row and its mask, loaded while the tile is summed
  bool keep = false;
  if (kSteps >= kStore && live) {
    row = order[i];
    keep = mask[row] != 0;
  }
  __syncwarp();
  const int key = st.key[me];
  const bool valid = live && key != kInvalidKey;
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, cnt = 0.0f, out[3][3];
  if (kSteps == kStage) {  // what the stage holds, so that no part of it is dropped
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) out[k][c] = st.x[c][lane + 16 * k];
    out[0][0] = __fadd_rn(out[0][0], __double2float_rn(__dadd_rn(st.xd[0][lane],
                                                                st.xd[1][lane + 32])));
    cnt = valid ? kMinPoints : 0.0f;
  } else {
    if (__any_sync(kFullMask, valid))  // a tile of invalid rows: the identity
      cnt = window_covariance(st, me, key, valid, a);
    if (kSteps < kSolve) {  // the window covariance itself
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) out[r][c] = a[sym(r, c)];
    } else {
      plane_covariance(a, cnt, out);
    }
  }
  if (live) {
    store_row(covs, row, out);
    ok[row] = cnt >= kMinPoints && (kSteps < kStore || keep);
  }
}

}  // namespace

extern "C" {

// One launch on `stream` (a warp for each tile of 32 rows, 4 a block) over n >= 1 rows
// sorted by cell key. keys: [n] i32 (INVALID_KEY for invalid rows); pts: [n, 3] f32 in
// the keys' order; order: [n] i64, each row's original index (a permutation); mask: [n]
// u8 in the original order. Outputs (fresh, contiguous), at the original indices: covs
// [n, 3, 3] f32, the plane-regularized covariances of each row's same-cell window over
// +-16 sorted rows (the identity where it holds fewer than 5 points), and ok [n] u8 (5 or
// more points, and mask). Returns
// cudaGetLastError() after the launch (0 = success).
int lgs_gicp_covariances(const int* keys, const float* pts, const long long* order,
                         const uint8_t* mask, long long n, float* covs, uint8_t* ok,
                         void* stream) {
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const unsigned blocks = static_cast<unsigned>((tiles + kCovWarps - 1) / kCovWarps);
  gicp_covariances_kernel<LGS_COV_STEPS>
      <<<blocks, kCovThreads, 0, static_cast<cudaStream_t>(stream)>>>(keys, pts, order, mask,
                                                                      n, covs, ok);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
