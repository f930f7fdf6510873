// Device functions shared by the NDT kernels of `ndt_accumulate.cu` and `ndt_loop.cu`:
// the per-row accumulation of the 6x6 normal equations and the voxel cell arithmetic
// (both sources), the DIRECT7 gather of one (point, neighbour) pair and the fixed-order
// block and cross-block reductions (the accumulate kernels; the loop kernel gathers a
// whole point a thread and reduces in its own order, `ndt_loop.cu`). So every kernel
// accumulates a row with the same arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 31;    // 21 H upper triangle + 6 g + sum_w + n_hit + centre |e|^2, count
constexpr int kOut = 46;  // H (36, row-major) | g (6) | sum_w | n_hit | centre |e|^2, count

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Adds one hit row's weighted terms to acc[0..27].
__device__ __forceinline__ void accumulate_row(float* acc, float ex, float ey, float ez,
                                               const float (&W)[3][3], float x, float y,
                                               float z, float d2, float ws) {
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

__device__ __forceinline__ int tri_index(int a, int b) {  // a <= b < 6, row-major upper
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

// Sums each acc[q] over the block's threads in a fixed order (warp shuffles, then the
// warps in order through `red`); thread q < kQ returns quantity q's sum.
__device__ __forceinline__ float block_sum(const float* acc, float (&red)[kQ][kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) red[q][warp] = v;
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < kQ) {
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[threadIdx.x][wi];
  }
  return s;
}

// One partial row per block ([kQ][gridDim.x] in `partials`), then the block that draws
// the last ticket sums all rows: thread t adds blocks t, t + kThreads, ... of every
// quantity (31 independent loads in flight per step), then `block_sum` — a fixed order
// for a given number of blocks. Returns true, in every thread of that block only, with
// tot[q] (shared memory) quantity q's total. `counter` is 0 on entry and is left 0.
__device__ __forceinline__ bool reduce_partials(const float* acc, float* partials,
                                                unsigned int* counter, float* tot) {
  __shared__ float red[kQ][kWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int nblocks = gridDim.x;
  const float s = block_sum(acc, red);
  if (t < kQ) {
    partials[(long long)t * nblocks + blockIdx.x] = s;
    __threadfence();  // the partial is visible device-wide before the ticket is drawn
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(counter, 1u) == (unsigned int)(nblocks - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  float part[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) part[q] = 0.f;
  for (int b = t; b < nblocks; b += kThreads) {  // __ldcg reads past L1: the rows are new
#pragma unroll
    for (int q = 0; q < kQ; ++q) part[q] += __ldcg(&partials[(long long)q * nblocks + b]);
  }
  const float total = block_sum(part, red);
  if (t < kQ) tot[t] = total;
  if (t == 0) *counter = 0u;  // ready for the next launch on this stream
  __syncthreads();
  return true;
}

struct Grid {
  int dx, dy, dz;  // dense table dims (ops/voxel.py:TABLE_DIMS)
  int hx, hy, hz;  // largest packable voxel coordinate per axis (voxel_coords' clamp)
};

// Sequence b = blockIdx.y of a batch of gridDim.y: its points, mask, table, packed rows,
// origin and inv_leaf start at the given strides (in elements) times b, and its partials,
// counter and output row are its own. A single-sequence entry point is the same kernel
// with one sequence, so row b of a batch is the same computation, bit for bit, as a
// launch on sequence b alone with the same number of blocks.
struct Batch {
  long long p, mask, table, packed4, origin;  // per-sequence strides
  int scalars;                                // 1: d2 / w_scale pointers hold one value per
                                              // sequence; 0: one shared value
};

__device__ __forceinline__ int voxel_coord(float v, float o, float inv_leaf, int hi) {
  // floor((v - o) * inv_leaf) in float32, converted rounding down (saturating), then
  // clamped to [0, hi] as in ops/voxel.py:voxel_coords.
  const int c = __float2int_rd(__fmul_rn(__fsub_rn(v, o), inv_leaf));
  return min(max(c, 0), hi);
}

// One (point, neighbour) pair of the DIRECT7 gather (the port of `lookup_direct7`,
// ops/voxel.py) and its accumulation: the point (x, y, z) in map coordinates, its
// DIRECT7 offset o in the order of ops/voxel.py:DIRECT7_OFFSETS — (0,0,0), (+-1,0,0),
// (0,+-1,0), (0,0,+-1). Reads the dense table and the 64-byte packed row (mean | inv_cov
// | valid) as four 16-byte loads; the pair at offset 0 also sums the centre residual's
// |e|^2 and count (NDT's fitness).
__device__ __forceinline__ void direct7_pair(float* acc, float x, float y, float z, int o,
                                             const int* __restrict__ table,
                                             const float4* __restrict__ packed, float ox,
                                             float oy, float oz, float inv_leaf,
                                             const Grid& grid, float d2, float ws) {
  const int cx = voxel_coord(x, ox, inv_leaf, grid.hx) + (o == 1) - (o == 2);
  const int cy = voxel_coord(y, oy, inv_leaf, grid.hy) + (o == 3) - (o == 4);
  const int cz = voxel_coord(z, oz, inv_leaf, grid.hz) + (o == 5) - (o == 6);
  if (cx < 0 || cx >= grid.dx || cy < 0 || cy >= grid.dy || cz < 0 || cz >= grid.dz)
    return;  // outside the table: the reference's overflow slot, which reads -1
  const int idx = __ldg(&table[(cx * grid.dy + cy) * grid.dz + cz]);
  if (idx < 0) return;  // empty cell
  const float4* row = packed + 4 * (long long)idx;
  const float4 r3 = __ldg(row + 3);  // valid | pad
  if (!(r3.x > 0.5f)) return;        // fewer than min_points
  const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  // Row layout: mean (0..2) | inv_cov row-major (3..11) | valid (12) | pad.
  const float W[3][3] = {{r0.w, r1.x, r1.y}, {r1.z, r1.w, r2.x}, {r2.y, r2.z, r2.w}};
  const float ex = x - r0.x, ey = y - r0.y, ez = z - r0.z;
  accumulate_row(acc, ex, ey, ez, W, x, y, z, d2, ws);
  if (o == 0) {
    acc[29] += ex * ex + ey * ey + ez * ez;
    acc[30] += 1.f;
  }
}

}  // namespace
