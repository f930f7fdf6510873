// NDT / GICP Gauss-Newton normal-equation accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel `ndt_accumulate` / `_ndt_accum_kernel` of
// lidar_graph_slam_tpu/ops/pallas_kernels.py (deleted in commit 4350000; its live
// reference is `ndt_accumulate_xla`, same file, which `ops/kernels.py` ports as the plain
// PyTorch version these kernels are tested against).
//
// Per correspondence k (residual e, inverse covariance W, transformed point p, hit):
//   md2 = e^T W e,  w = w_scale * exp(-0.5 * d2 * md2) if hit else 0,
//   J = [-hat(p) | I]  ->  H += w J^T W J,  g += w J^T W e,  sum_w += w,  n_hit += hit.
// J is expanded analytically (A = -hat(p)): H_ww = A^T W A, H_wv = A^T W, H_vv = W,
// g_w = p x (W e), g_v = W e. H is symmetric for symmetric W; the 21 upper-triangle
// entries are accumulated and mirrored.
//
// Two kernels share that per-row routine (`accumulate_row`) and one epilogue, both in
// `ndt_common.cuh`, which `ndt_loop.cu` (one whole NDT iteration a launch) shares:
//
//  * `ndt_direct7_kernel` takes the transformed points and the voxel map and does the
//    DIRECT7 gather itself (the port of `lookup_direct7`, ops/voxel.py): one thread per
//    (point, neighbour) pair computes the point's voxel cell, the neighbour cell and its
//    in-range test, reads the dense table and the 64-byte packed row (mean | inv_cov |
//    valid) as four 16-byte loads, and accumulates the row; the pair at offset 0 also
//    sums the centre residual's |e|^2 and count (NDT's fitness). The N x 7
//    correspondences never reach device memory. The voxel arithmetic is done with
//    __fsub_rn / __fmul_rn and a round-down conversion, the same float32 operations as
//    the plain version's `floor((p - origin) * inv_leaf)`, so nvcc cannot contract them
//    into an FMA and a point on a cell border lands in the same cell on both paths.
//    It takes a batch axis on the grid's y dimension: B sequences, each with its own map
//    and points, in one launch, one output row per sequence (entry point
//    `lgs_ndt_direct7_accumulate_batched`, for the multi-sequence odometry); the
//    single-sequence entry point is the same kernel with B = 1, so a batch row equals
//    the single launch on that sequence bit for bit.
//  * `ndt_rows_kernel` takes gathered rows (e, W, p, hit), the reference's interface; the
//    NDT line search uses it (GICP did until its loop kernel, `gicp_loop.cu`, which runs
//    the same `accumulate_row` on the rows it forms itself).
//
// What bounds it on this card. The gathered-rows form reads 61 bytes per hit row for
// about 157 flops and one expf: far below the H100's ~20 flop/byte f32 ridge, so bytes at
// large K. The fused form streams only p and the mask (13 bytes per point); the table
// (16.8 MB) and the packed rows (4.2 MB at 65,536 voxels) are read at random but fit in
// the 50 MB L2. At the path's sizes (N <= 32,768) its bytes take ~1 us at 3.35 TB/s, so
// the launch and the gathers' latency set its time: 7 threads per point give 7N
// threads (896 blocks of 256 at N = 32,768) to hide that latency. Tensor cores and TMA
// do not help a random gather feeding a 31-sum reduction.
//
// Epilogue (both): 31 float accumulators in registers (21 of H, 6 of g, sum_w, n_hit,
// and the centre sums), a warp-shuffle + shared-memory block reduction, one partial row
// per block, then __threadfence() and a ticket on a counter; the block that draws the
// last ticket sums every block's partials in a fixed order, writes the output and
// resets the counter. One launch per call, no float atomics: for a given N (or K) the
// result is the same bit for bit from run to run, which the odometry loop needs (it
// amplifies FP-level noise). The partials and the counter are the caller's scratch, one
// set per CUDA stream. d2 and w_scale are read from device pointers (or passed by
// value), so no host sync is needed per iteration.

#include "ndt_common.cuh"

namespace {

// One launch's epilogue: the fixed-order cross-block reduction, then the totals as the
// kOut outputs.
__device__ __forceinline__ void reduce_and_finish(const float* acc, float* partials,
                                                  unsigned int* counter, float* out) {
  __shared__ float tot[kQ];
  if (!reduce_partials(acc, partials, counter, tot)) return;
  const int t = threadIdx.x;
  if (t < 36) {  // H [6, 6], mirrored from the upper triangle
    const int i = t / 6, j = t % 6;
    out[t] = tot[tri_index(i < j ? i : j, i < j ? j : i)];
  } else if (t < kOut) {  // g [6], sum_w, n_hit, centre |e|^2, centre count
    out[t] = tot[21 + (t - 36)];
  }
}

__global__ void __launch_bounds__(kThreads)
ndt_rows_kernel(const float* __restrict__ e, const float* __restrict__ icov,
                const float* __restrict__ p, const uint8_t* __restrict__ hit,
                const float* __restrict__ d2_ptr, float d2_val,
                const float* __restrict__ ws_ptr, float ws_val, long long K,
                float* __restrict__ partials, unsigned int* __restrict__ counter,
                float* __restrict__ out) {
  const float d2 = d2_ptr ? *d2_ptr : d2_val;
  const float ws = ws_ptr ? *ws_ptr : ws_val;
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < K; k += stride) {
    if (!hit[k]) continue;  // w = 0: the row adds nothing, and is not a hit
    float W[3][3];
#pragma unroll
    for (int i = 0; i < 9; ++i) W[i / 3][i % 3] = icov[9 * k + i];
    accumulate_row(acc, e[3 * k], e[3 * k + 1], e[3 * k + 2], W, p[3 * k], p[3 * k + 1],
                   p[3 * k + 2], d2, ws);
  }
  reduce_and_finish(acc, partials, counter, out);
}

__global__ void __launch_bounds__(kThreads)
ndt_direct7_kernel(const float* __restrict__ p, const uint8_t* __restrict__ mask,
                   const int* __restrict__ table, const float4* __restrict__ packed,
                   const float* __restrict__ origin, const float* __restrict__ inv_leaf_ptr,
                   Grid grid, Batch bs, const float* __restrict__ d2_ptr, float d2_val,
                   const float* __restrict__ ws_ptr, float ws_val, long long N,
                   float* __restrict__ partials, unsigned int* __restrict__ counter,
                   float* __restrict__ out) {
  const long long b = blockIdx.y;
  p += b * bs.p;
  mask += b * bs.mask;
  table += b * bs.table;
  packed += b * bs.packed4;
  origin += b * bs.origin;
  const float d2 = d2_ptr ? d2_ptr[b * bs.scalars] : d2_val;
  const float ws = ws_ptr ? ws_ptr[b * bs.scalars] : ws_val;
  const float inv_leaf = inv_leaf_ptr[b];
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;

  const long long K = 7 * N;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < K; k += stride) {
    const long long i = k / 7;
    const int o = (int)(k - 7 * i);
    if (!mask[i]) continue;
    direct7_pair(acc, p[3 * i], p[3 * i + 1], p[3 * i + 2], o, table, packed, ox, oy, oz,
                 inv_leaf, grid, d2, ws);
  }
  reduce_and_finish(acc, partials + b * kQ * gridDim.x, counter + b, out + b * kOut);
}

}  // namespace

extern "C" {

int lgs_ndt_threads() { return kThreads; }

int lgs_ndt_quantities() { return kQ; }

int lgs_ndt_outputs() { return kOut; }

// Both launch one kernel of `nblocks` blocks on `stream`. partials: [kQ * nblocks] f32
// scratch; counter: one u32, 0 between launches (the kernel leaves it 0); out: [kOut] f32.
// Return cudaGetLastError() after the launch (0 = success).
int lgs_ndt_accumulate(const float* e, const float* icov, const float* p, const uint8_t* hit,
                       const float* d2_ptr, float d2_val, const float* ws_ptr, float ws_val,
                       long long K, float* partials, unsigned int* counter, int nblocks,
                       float* out, void* stream) {
  ndt_rows_kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e, icov, p, hit, d2_ptr, d2_val, ws_ptr, ws_val, K, partials, counter, out);
  return static_cast<int>(cudaGetLastError());
}

// B sequences in one launch (grid nblocks x B): p [B, N, 3] f32, mask [B, N] u8, table
// [B, dx * dy * dz] i32, packed [B, rows, 16] f32 (16-byte aligned), origin [B, 3] f32,
// inv_leaf [B] f32; d2 / ws: by value, or pointers to one f32 (scalars_per_sequence 0) or
// to B of them (1). partials: [B * kQ * nblocks] f32; counter: B u32, 0 between launches;
// out: [B, kOut] f32. `rows` is the packed rows' count per sequence.
int lgs_ndt_direct7_accumulate_batched(const float* p, const uint8_t* mask, const int* table,
                                       const float* packed, const float* origin,
                                       const float* inv_leaf, int dx, int dy, int dz, int hx,
                                       int hy, int hz, long long rows, int B,
                                       const float* d2_ptr, float d2_val, const float* ws_ptr,
                                       float ws_val, long long N, int scalars_per_sequence,
                                       float* partials, unsigned int* counter, int nblocks,
                                       float* out, void* stream) {
  const Grid grid{dx, dy, dz, hx, hy, hz};
  const Batch bs{3 * N, N, (long long)dx * dy * dz, 4 * rows, 3, scalars_per_sequence};
  ndt_direct7_kernel<<<dim3(nblocks, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, mask, table, reinterpret_cast<const float4*>(packed), origin, inv_leaf, grid, bs,
      d2_ptr, d2_val, ws_ptr, ws_val, N, partials, counter, out);
  return static_cast<int>(cudaGetLastError());
}

// packed: [rows, 16] f32, 16-byte aligned; table: [dx * dy * dz] i32; origin: [3] f32;
// inv_leaf: one f32 — all on the device.
int lgs_ndt_direct7_accumulate(const float* p, const uint8_t* mask, const int* table,
                               const float* packed, const float* origin,
                               const float* inv_leaf, int dx, int dy, int dz, int hx, int hy,
                               int hz, const float* d2_ptr, float d2_val, const float* ws_ptr,
                               float ws_val, long long N, float* partials,
                               unsigned int* counter, int nblocks, float* out, void* stream) {
  return lgs_ndt_direct7_accumulate_batched(p, mask, table, packed, origin, inv_leaf, dx, dy,
                                            dz, hx, hy, hz, 0, 1, d2_ptr, d2_val, ws_ptr,
                                            ws_val, N, 0, partials, counter, nblocks, out,
                                            stream);
}

const char* lgs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
