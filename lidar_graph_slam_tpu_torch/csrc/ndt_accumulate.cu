// NDT / GICP Gauss-Newton normal-equation accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel `ndt_accumulate` / `_ndt_accum_kernel` of
// lidar_graph_slam_tpu/ops/pallas_kernels.py (deleted in commit 4350000; its live
// reference is `ndt_accumulate_xla`, same file, which `ops/kernels.py` ports as the plain
// PyTorch version this kernel is tested against).
//
// Per correspondence k (residual e, inverse covariance W, transformed point p, hit):
//   md2 = e^T W e,  w = w_scale * exp(-0.5 * d2 * md2) if hit else 0,
//   J = [-hat(p) | I]  ->  H += w J^T W J,  g += w J^T W e,  sum_w += w,  n_hit += hit.
// J is expanded analytically (A = -hat(p)): H_ww = A^T W A, H_wv = A^T W, H_vv = W,
// g_w = p x (W e), g_v = W e. H is symmetric for symmetric W; the 21 upper-triangle
// entries are accumulated and mirrored.
//
// What bounds it on this card: each row reads 61 bytes (e 12, W 36, p 12, hit 1) for
// about 80 flops and one expf — about 1.3 flop/byte, far below the H100's ~20 flop/byte
// f32 ridge, so it is bound by memory bytes at large K and by launch time at small K.
// Design: one streaming pass, grid-stride rows per thread, 29 float accumulators in
// registers (21 of H, 6 of g, sum_w, n_hit); a warp-shuffle + shared-memory block
// reduction writes one partial row per block; a second single-block launch sums the
// partials in a fixed order. No float atomics anywhere: for a given K the result is the
// same bit for bit from run to run, which the odometry loop needs (it amplifies FP-level
// noise). d2 and w_scale are read from device pointers (or passed by value), so no host
// sync is needed per iteration.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 29;  // 21 H upper triangle + 6 g + sum_w + n_hit

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
ndt_partials_kernel(const float* __restrict__ e, const float* __restrict__ icov,
                    const float* __restrict__ p, const uint8_t* __restrict__ hit,
                    const float* __restrict__ d2_ptr, float d2_val,
                    const float* __restrict__ ws_ptr, float ws_val, long long K,
                    float* __restrict__ partials) {
  const float d2 = d2_ptr ? *d2_ptr : d2_val;
  const float ws = ws_ptr ? *ws_ptr : ws_val;

  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < K; k += stride) {
    if (!hit[k]) continue;  // w = 0: the row adds nothing, and is not a hit
    const float ex = e[3 * k], ey = e[3 * k + 1], ez = e[3 * k + 2];
    const float x = p[3 * k], y = p[3 * k + 1], z = p[3 * k + 2];
    float W[3][3];
#pragma unroll
    for (int i = 0; i < 9; ++i) W[i / 3][i % 3] = icov[9 * k + i];

    float We[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) We[r] = W[r][0] * ex + W[r][1] * ey + W[r][2] * ez;
    const float md2 = ex * We[0] + ey * We[1] + ez * We[2];
    const float w = ws * expf(-0.5f * d2 * md2);

    // WA = W A with A = -hat(p): columns of A are (0,-z,y), (z,0,-x), (-y,x,0).
    float WA[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      WA[r][0] = -W[r][1] * z + W[r][2] * y;
      WA[r][1] = W[r][0] * z - W[r][2] * x;
      WA[r][2] = -W[r][0] * y + W[r][1] * x;
    }
    // Rows 0..2 of J^T: A^T M for any 3-column block M.
    float Hw[3][6];  // H rows 0..2: [H_ww | H_wv]
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Hw[0][c] = -z * WA[1][c] + y * WA[2][c];
      Hw[1][c] = z * WA[0][c] - x * WA[2][c];
      Hw[2][c] = -y * WA[0][c] + x * WA[1][c];
      Hw[0][3 + c] = -z * W[1][c] + y * W[2][c];
      Hw[1][3 + c] = z * W[0][c] - x * W[2][c];
      Hw[2][3 + c] = -y * W[0][c] + x * W[1][c];
    }
    int q = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j) acc[q++] += w * Hw[i][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j) acc[q++] += w * W[i][j];
    // g_w = p x We, g_v = We.
    acc[21] += w * (y * We[2] - z * We[1]);
    acc[22] += w * (z * We[0] - x * We[2]);
    acc[23] += w * (x * We[1] - y * We[0]);
    acc[24] += w * We[0];
    acc[25] += w * We[1];
    acc[26] += w * We[2];
    acc[27] += w;
    acc[28] += 1.f;
  }

  __shared__ float red[kQ][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) red[q][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kQ) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[threadIdx.x][wi];
    partials[(long long)threadIdx.x * gridDim.x + blockIdx.x] = s;  // [kQ][nblocks]
  }
}

__device__ __forceinline__ int tri_index(int a, int b) {  // a <= b < 6, row-major upper
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

// One block: warp `wi` sums quantities wi, wi + kWarps, ... over the blocks' partials,
// lanes striding the blocks, then a warp shuffle — a fixed order for a given nblocks.
__global__ void __launch_bounds__(kThreads)
ndt_finalize_kernel(const float* __restrict__ partials, int nblocks, float* __restrict__ out) {
  __shared__ float tot[kQ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < kQ; q += kWarps) {
    float s = 0.f;
    for (int b = lane; b < nblocks; b += 32) s += partials[(long long)q * nblocks + b];
    s = warp_sum(s);
    if (lane == 0) tot[q] = s;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 36) {  // H [6, 6] row-major, mirrored from the upper triangle
    const int i = t / 6, j = t % 6;
    out[t] = tot[tri_index(i < j ? i : j, i < j ? j : i)];
  } else if (t < 44) {  // g [6], sum_w, n_hit
    out[t] = tot[21 + (t - 36)];
  }
}

}  // namespace

extern "C" {

int lgs_ndt_threads() { return kThreads; }

int lgs_ndt_quantities() { return kQ; }

// Launches both kernels on `stream`. partials: [29 * nblocks] f32 scratch; out: [44] f32
// = H (36, row-major) | g (6) | sum_w | n_hit. Returns cudaGetLastError() after the
// launches (0 = success).
int lgs_ndt_accumulate(const float* e, const float* icov, const float* p, const uint8_t* hit,
                       const float* d2_ptr, float d2_val, const float* ws_ptr, float ws_val,
                       long long K, float* partials, int nblocks, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ndt_partials_kernel<<<nblocks, kThreads, 0, s>>>(e, icov, p, hit, d2_ptr, d2_val, ws_ptr,
                                                   ws_val, K, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ndt_finalize_kernel<<<1, kThreads, 0, s>>>(partials, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}

const char* lgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
