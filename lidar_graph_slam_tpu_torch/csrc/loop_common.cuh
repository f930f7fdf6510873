// The device side shared by the two Gauss-Newton loop kernels, `ndt_iteration`
// (`ndt_loop.cu`) and `gicp_iteration` (`gicp_loop.cu`): the carry, the coalesced tile of
// source points, the fixed-order reduction of one launch's sums (a reduce-scatter over the
// lanes, one partial row a block, an acquire-release ticket, the rows summed by the block
// that draws the last ticket) and the 6x6 step in that block's warp 0. Both kernels run
// blocks of kLoopThreads threads, one source point a thread, and accumulate the kQ sums of
// `ndt_common.cuh` (21 H, 6 g, sum_w, n_hit, and two "centre" sums whose ratio is the
// fitness), so one reduction and one step serve both. The step's differences are template
// arguments: NDT caps the step at `step_size` and zeroes it without inliers; GICP takes it
// uncapped and zeroes it below 6 inliers (`registration/gicp.py`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ndt_common.cuh"

namespace {

// Launches of this source's loop kernel that did work (summed over the sequences of a
// batch), for the measurement of dead launches; read and reset by the host entry points.
// One counter per source (the namespace is per translation unit).
__device__ unsigned long long g_worked_launches = 0;

constexpr int kLoopThreads = 128;  // a block: one tile of 128 source points
constexpr int kLoopWarps = kLoopThreads / 32;
constexpr int kRow = 32;    // floats in a partial row: the kQ sums and one pad
constexpr int kChunk = 64;  // partial rows a lane of the last block loads at once
constexpr unsigned kFull = 0xffffffffu;

struct Carry {  // sequence b's fields start at b * 16 (T) or b (the others)
  float* T;
  uint8_t* done;
  int* iters;
  float* fitness;
  int* inliers;
};

struct StepArgs {
  float step_size, epsilon;  // step_size: the cap, when the step takes one
  const float* damping_ptr;  // or by value
  float damping_val;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {  // NaN stays NaN
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_max(float x, float hi) {  // NaN stays NaN
  return x > hi ? hi : x;
}

// One halving of the reduce-scatter: the lanes whose bit W is set keep the upper W of
// their v[0 .. 2W) and send the lower W to the partner lane (lane ^ W), which keeps those;
// each adds what it receives to what it keeps in v[0 .. W).
template <int W>
__device__ __forceinline__ void scatter_half(float (&v)[kRow], bool upper) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// The warp's totals of the kRow quantities, scattered: lane q returns quantity q's sum
// over the 32 lanes (31 shuffles instead of 31 butterflies of 5).
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[kRow]) {
  const int lane = threadIdx.x & 31;
  scatter_half<16>(v, lane & 16);
  scatter_half<8>(v, lane & 8);
  scatter_half<4>(v, lane & 4);
  scatter_half<2>(v, lane & 2);
  scatter_half<1>(v, lane & 1);
  return v[0];
}

__device__ __forceinline__ float norm6(const float (&d)[6]) {
  float s = 0.f;
  for (int i = 0; i < 6; ++i) s += d[i] * d[i];
  return sqrtf(s);
}

// se(3) exp of the twist (omega, v) as core/se3.py computes it: rows 0..2 of [R | t].
__device__ __forceinline__ void se3_exp(const float (&xi)[6], float (&E)[3][4]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta_sq = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta_sq + 1e-16f);  // _EPS * _EPS
  const bool small = theta_sq < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float A = small ? 1.0f - theta_sq / 6.0f : s / theta;
  const float B = small ? 0.5f - theta_sq / 24.0f : (1.0f - c) / theta_sq;
  const float C = small ? (1.0f / 6.0f) - theta_sq / 120.0f
                        : (theta - s) / (theta_sq * theta);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      E[i][j] = (I + A * W[i][j]) + B * W2[i][j];
      V[i][j] = (I + B * W[i][j]) + C * W2[i][j];
    }
  }
  for (int i = 0; i < 3; ++i) E[i][3] = V[i][0] * xi[3] + V[i][1] * xi[4] + V[i][2] * xi[5];
}

// The step from one iteration's totals, in one whole warp: lane q holds total q (the
// quantities of ndt_common.cuh). `Ts` is the carry's T [4,4], `done0` and `iters0` its
// fields, all as the block read them at its start (only this block writes them, below).
// Writes sequence b's carry in place. kCap: scale the step to at most st.step_size
// (NDT); kMinInliers: a step with fewer inliers is zeroed (NDT 1, GICP 6).
template <bool kCap, int kMinInliers>
__device__ __forceinline__ void gn_step_warp(float tot, const float* Ts, float damping,
                                             bool done0, int iters0, float* T, uint8_t* done,
                                             int* iters, float* fitness, int* inliers,
                                             const StepArgs& st, int polish) {
  const int lane = threadIdx.x & 31;
  const int r = lane < 6 ? lane : 5;  // the row of H lane r holds (lanes 6.. copy row 5)
  // (H + damping * clamp(trace(H) / 6, 1e-12) I) delta = -g.
  float a[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) a[j] = __shfl_sync(kFull, tot, tri_index(min(r, j), max(r, j)));
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) tr += __shfl_sync(kFull, tot, tri_index(i, i));
  const float ds = damping * clamp_min(tr / 6.0f, 1e-12f);
#pragma unroll
  for (int j = 0; j < 6; ++j) a[j] += j == r ? ds : 0.f;
  float d = -__shfl_sync(kFull, tot, 21 + r);
  const int n_inliers = (int)__shfl_sync(kFull, tot, 28);
  const float centre_d2 = __shfl_sync(kFull, tot, 29);
  const float centre_n = __shfl_sync(kFull, tot, 30);

  // LU with partial pivoting, row i in lane i; a zero pivot gives a non-finite delta,
  // which the step test below zeroes.
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float col[6];  // column k of every row, in every lane
#pragma unroll
    for (int i = 0; i < 6; ++i) col[i] = __shfl_sync(kFull, a[k], i);
    int piv = k;
    float best = fabsf(col[k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(col[i]) > best) {
        best = fabsf(col[i]);
        piv = i;
      }
    }
    float prow[6];  // the pivot row: row piv, read before the swap (one round of shuffles)
#pragma unroll
    for (int j = k; j < 6; ++j) prow[j] = __shfl_sync(kFull, a[j], piv);
    const int from = lane == k ? piv : (lane == piv ? k : lane);  // swap rows k and piv
#pragma unroll
    for (int j = 0; j < 6; ++j) a[j] = __shfl_sync(kFull, a[j], from);
    d = __shfl_sync(kFull, d, from);
    if (lane > k && lane < 6) {
      const float l = a[k] / prow[k];
      a[k] = l;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) a[j] -= l * prow[j];
    }
  }
  // The substitutions, in every lane alike, on the factors gathered from lanes 0..5.
  float A[6][6], delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = __shfl_sync(kFull, a[j], i);
    delta[i] = __shfl_sync(kFull, d, i);
  }
#pragma unroll
  for (int i = 1; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) delta[i] -= A[i][j] * delta[j];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < 6; ++j) delta[i] -= A[i][j] * delta[j];
    delta[i] /= A[i][i];
  }

  bool finite = true;
  if (kCap) {
    const float scale = clamp_max(st.step_size / clamp_min(norm6(delta), 1e-12f), 1.0f);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      delta[i] *= scale;
      finite = finite && isfinite(delta[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) finite = finite && isfinite(delta[i]);
  }
  const bool step_ok = finite && n_inliers >= kMinInliers;
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = step_ok ? delta[i] : 0.f;
  float E[3][4];
  se3_exp(delta, E);
  // Lane m < 12: entry m = (i, j) of rows 0..2 of E T (E's last row is (0, 0, 0, 1), so
  // T's row 3 stays).
  const int i = lane >> 2, j = lane & 3;
  float e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = i == 0 ? E[0][k] : (i == 1 ? E[1][k] : E[2][k]);
  if (lane < 12) T[lane] = e[0] * Ts[j] + e[1] * Ts[4 + j] + e[2] * Ts[8 + j] + e[3] * Ts[12 + j];
  if (lane == 0) {
    *fitness = centre_d2 / clamp_min(centre_n, 1.0f);
    *inliers = n_inliers;
    if (!polish) {
      *done = done0 || norm6(delta) < st.epsilon;
      *iters = iters0 + 1;
    }
  }
}

// Draws a ticket: counter += 1 at device scope with release and acquire semantics, so
// the block's writes ordered before it (by __syncthreads) are visible to the block that
// draws the last ticket, and that block's reads after it see every block's. One
// instruction, where __threadfence() (a sequentially consistent fence) before and after a
// relaxed atomicAdd costs two fences on the tail's path. Returns the old count.
__device__ __forceinline__ unsigned ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// Tile k's words 3 k kLoopThreads + t + {0, 1, 2} kLoopThreads of `src` and thread t's
// mask byte (point k kLoopThreads + t), zero and false past the end.
__device__ __forceinline__ void fetch_tile(const float* __restrict__ src,
                                           const uint8_t* __restrict__ mask, long long N,
                                           long long k, int t, float (&w)[3], bool& m) {
  const long long base = 3LL * kLoopThreads * k + t;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    w[c] = base + c * kLoopThreads < 3 * N ? src[base + c * kLoopThreads] : 0.f;
  const long long i = kLoopThreads * k + t;
  m = i < N && mask[i];
}

// The end of a launch, in every thread of the block: the block's partial row of its
// threads' sums `acc` (lane q of warp w holds quantity q of the warp, then warp 0 sums the
// warps in order and writes the row, one 128-byte store), the ticket, and in the block
// that draws the last ticket the rows' sum (warp w lane q adds quantity q of rows w, w +
// kLoopWarps, ... in that order, kChunk rows a lane loaded at once, __ldcg past L1: the
// rows are new; then warp 0 the warps in order) and the step in its warp 0. `red` and
// `last` are the kernel's shared memory; T, done and the rest of sequence b's carry are
// written by the step only.
template <bool kCap, int kMinInliers>
__device__ __forceinline__ void reduce_and_step(float (&acc)[kRow],
                                                float (&red)[kLoopWarps][kRow], bool& last,
                                                float* __restrict__ partials,
                                                unsigned int* __restrict__ counter,
                                                long long b, const float* Ts, float damping,
                                                bool done0, int iters0, float* T,
                                                uint8_t* done, const Carry& carry,
                                                const StepArgs& st, int polish) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  red[warp][lane] = warp_reduce_scatter(acc);
  __syncthreads();
  float* rows = partials + b * gridDim.x * kRow;
  if (warp == 0) {
    float s = red[0][lane];
#pragma unroll
    for (int v = 1; v < kLoopWarps; ++v) s += red[v][lane];
    rows[blockIdx.x * kRow + lane] = s;
  }
  __syncthreads();  // the row is written before thread 0 releases it with the ticket
  if (t == 0) last = ticket(counter + b) == gridDim.x - 1;
  __syncthreads();  // ... and the last block reads the rows after thread 0 acquired them
  if (!last) return;
  float s = 0.f;
  for (unsigned base = warp; base < gridDim.x; base += kChunk * kLoopWarps) {
    float v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const unsigned row = base + c * kLoopWarps;
      v[c] = row < gridDim.x ? __ldcg(&rows[row * kRow + lane]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) s += v[c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  float tot = red[0][lane];
#pragma unroll
  for (int v = 1; v < kLoopWarps; ++v) tot += red[v][lane];
  if (lane == 0) counter[b] = 0u;  // ready for the next launch on this stream
  gn_step_warp<kCap, kMinInliers>(tot, Ts, damping, done0, iters0, T, done, carry.iters + b,
                                  carry.fitness + b, carry.inliers + b, st, polish);
  if (lane == 0) atomicAdd(&g_worked_launches, 1ull);
}

// The worked launches since the last reset, after every queued launch of the device
// finished (a device-wide synchronize: for measurement only). Returns the count, or
// -(CUDA error) on failure.
inline long long read_worked_launches(int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  unsigned long long n = 0;
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&n, g_worked_launches, sizeof(n));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_worked_launches, &zero, sizeof(zero));
  }
  return err == cudaSuccess ? static_cast<long long>(n) : -static_cast<long long>(err);
}

}  // namespace
