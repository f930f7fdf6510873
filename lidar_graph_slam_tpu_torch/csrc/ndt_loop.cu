// One whole NDT Gauss-Newton iteration per launch, for Hopper (sm_90a): the device side
// of the reference's `jax.lax.while_loop` in lidar_graph_slam_tpu/registration/ndt.py
// (`ndt_align`: body :81-122, cond :124-126, polish :144-153) around the DIRECT7 gather of
// lidar_graph_slam_tpu/ops/voxel.py:447 (`lookup_direct7`) and the TPU kernel
// `ndt_accumulate` (ops/pallas_kernels.py, deleted in 4350000; `ndt_accumulate.cu`).
//
// The carry (T [4,4] f32, done u8, iterations i32, fitness f32, inliers i32) lives in
// device memory and is updated in place; `polish` is a launch argument. One launch:
//   1. Each launch is a programmatic dependent of the one before it on the stream: its
//      blocks are scheduled while that one's last block still runs, and wait
//      (griddepcontrol.wait) until it has completed and its writes are visible. The
//      while_loop's cond is the first instruction after that wait: a non-polish launch
//      that finds `done` returns at once, writes nothing and draws no ticket. `done` is
//      written only by the previous launch's last block, so every block of a launch
//      reads the same value and a ticket is never half drawn.
//   2. Gather and accumulation, one source point per thread. A block walks tiles of
//      kLoopThreads points (tile = blockIdx.x, + gridDim.x, ...); a tile's 3 x
//      kLoopThreads floats of `src` are read with coalesced 4-byte loads (consecutive
//      threads, consecutive words) into shared memory, and the next tile's words and mask
//      bytes are loaded into registers while this tile's gathers run. Each thread
//      transforms its point once (p = R x + t from the carry's T,
//      `se3.transform_points`), computes its cell once, then issues the seven DIRECT7
//      table loads together (ops/voxel.py:DIRECT7_OFFSETS order), then the 64-byte packed
//      rows (mean | inv_cov | valid) of every occupied cell together, and only then
//      accumulates the hits in offset order with `accumulate_row` (the arithmetic of
//      `direct7_pair`, the centre |e|^2 and count at offset 0 included).
//   3. Reduction (`reduce_and_step`, shared with GICP's loop kernel in loop_common.cuh), in
//      a fixed order: a reduce-scatter of the 31 sums over the 32 lanes
//      (16 + 8 + 4 + 2 + 1 shuffles, after which lane q holds quantity q's warp total),
//      the warps summed in order through shared memory, one 128-byte partial row per
//      block, then a ticket drawn with release and acquire semantics (one atomic, no
//      sequentially consistent fence). The block that draws the last ticket sums the
//      rows: warp w lane q adds quantity q of rows w, w + kLoopWarps, ... (coalesced rows
//      read past L1, kChunk of them in flight a lane), then the warps in order.
//   4. The step, in warp 0 of that block (`gn_step_warp` with the cap, loop_common.cuh;
//      `ops/kernels.py:ndt_step_plain`): damping by
//      clamp(trace(H) / 6, 1e-12); the 6x6 LU with partial pivoting (the first largest
//      |pivot|, as `torch.linalg.solve_ex`) with row i in lane i (the pivot search over
//      the column every lane holds; the pivot row's broadcast and the swap in one round
//      of shuffles; the elimination in parallel); the two substitutions, the cap, the
//      test and `se3_exp` (`core/se3.py`, its theta^2 < 1e-8 Taylor branch and
//      sqrt(theta^2 + EPS^2)) in every lane alike; lane m < 12 writes entry m of T <-
//      se3_exp(delta) T; lane 0 the fitness (centre |e|^2 / max(centre count, 1)), the
//      inliers and, outside polish, done |= |delta| < epsilon and iterations += 1. A step
//      that is not finite or has no inliers is zeroed; clamps keep NaN as torch.clamp
//      does. Every block reads the carry and the damping into shared memory at its start,
//      so the step makes no global load; every other block read T before it drew its
//      ticket, so the in-place write races with no reader.
//
// The grid is persistent: blocks = min(tiles, SMs x resident blocks per SM of this
// kernel), a function of N and the card only (`ops/kernels.py:loop_blocks`), never of the
// batch. No float atomics anywhere: for a given N and card every sum runs in one order,
// so two runs are bit-identical (the odometry loop amplifies order-dependent rounding).
//
// Entry points: `lgs_ndt_align_loop_batched` enqueues max_iterations non-polish launches
// then polish_iterations polish launches on one stream (B sequences on gridDim.y, each
// with its own map, points, carry, partials and ticket; a finished sequence's blocks exit
// on its own `done`), checking cudaGetLastError() after each; `lgs_ndt_align_loop` is it
// with B = 1, so row b of a batch equals the single loop on sequence b bit for bit.
//
// What bounds it on this card. A working launch's operations take ~0.4 us at N = 32,768
// and its bytes (the source, and table entries and rows that live in the 50 MB L2) less;
// it is latency-bound, by a chain of dependent steps: the launch, the carry's load, the
// tile's, the table's and the rows' (two L2 round trips with seven loads in flight per
// thread, where one thread per (point, offset) pair had four or five in series), the
// reduction, the ticket, the rows' sum and the step's ~1,000 dependent float operations,
// split over six lanes. The design shortens each link: the programmatic launch hides the
// launch behind the previous tail; 128-point tiles put the coarse stage (N = 8,192: 64
// blocks) on half the SMs, and at the path's N every tile fits the resident grid at once
// (two blocks an SM: 264 on an H100 against 256 tiles at N = 32,768), so a block runs
// one tile and the last block sums at most 264 rows in one load round trip; the
// reduce-scatter takes 31 shuffles a warp where 31 butterflies took 155; the step reads
// the carry from shared memory and keeps its LU in registers. Not used: `wgmma`, TMA
// tiles of the map and TF32. The work is a gather at a few percent of a float32 bound,
// not a matrix product; TMA moves dense tiles, not 7N scattered 64-byte rows; and the
// port keeps float32 throughout (Hopper's tensor cores have no float32 path, and TF32
// keeps ~3 digits, which the odometry feedback loop would amplify). An early-exit launch
// is the wait and one load of `done` per block.

#include "loop_common.cuh"

namespace {

// One point's DIRECT7 gather and accumulation: the seven table loads in flight together,
// then the rows of every occupied cell together, then the hits in offset order.
__device__ __forceinline__ void point_sums(float (&acc)[kRow], float x, float y, float z,
                                           const int* __restrict__ table,
                                           const float4* __restrict__ packed, float ox,
                                           float oy, float oz, float inv_leaf,
                                           const Grid& grid, float d2, float ws) {
  const int bx = voxel_coord(x, ox, inv_leaf, grid.hx);
  const int by = voxel_coord(y, oy, inv_leaf, grid.hy);
  const int bz = voxel_coord(z, oz, inv_leaf, grid.hz);
  int idx[7];
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    const int cx = bx + (o == 1) - (o == 2);
    const int cy = by + (o == 3) - (o == 4);
    const int cz = bz + (o == 5) - (o == 6);
    const bool in = cx >= 0 && cx < grid.dx && cy >= 0 && cy < grid.dy && cz >= 0 &&
                    cz < grid.dz;  // outside: the reference's overflow slot, which reads -1
    idx[o] = in ? __ldg(&table[(cx * grid.dy + cy) * grid.dz + cz]) : -1;
  }
  float4 r[7][4];
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    if (idx[o] >= 0) {
      const float4* row = packed + 4 * (long long)idx[o];
#pragma unroll
      for (int k = 0; k < 4; ++k) r[o][k] = __ldg(row + k);
    } else {
      r[o][3].x = 0.f;  // no cell: not valid
    }
  }
#pragma unroll
  for (int o = 0; o < 7; ++o) {
    if (idx[o] < 0 || !(r[o][3].x > 0.5f)) continue;  // empty, or fewer than min_points
    const float4 r0 = r[o][0], r1 = r[o][1], r2 = r[o][2];
    // Row layout: mean (0..2) | inv_cov row-major (3..11) | valid (12) | pad.
    const float W[3][3] = {{r0.w, r1.x, r1.y}, {r1.z, r1.w, r2.x}, {r2.y, r2.z, r2.w}};
    const float ex = x - r0.x, ey = y - r0.y, ez = z - r0.z;
    accumulate_row(acc, ex, ey, ez, W, x, y, z, d2, ws);
    if (o == 0) {
      acc[29] += ex * ex + ey * ey + ez * ez;
      acc[30] += 1.f;
    }
  }
}

__global__ void __launch_bounds__(kLoopThreads)
ndt_iteration_kernel(const float* __restrict__ src, const uint8_t* __restrict__ mask,
                     const int* __restrict__ table, const float4* __restrict__ packed,
                     const float* __restrict__ origin, const float* __restrict__ inv_leaf_ptr,
                     Grid grid, Batch bs, const float* __restrict__ d2_ptr, float d2_val,
                     const float* __restrict__ ws_ptr, float ws_val, long long N, Carry carry,
                     StepArgs st, int polish, float* __restrict__ partials,
                     unsigned int* __restrict__ counter) {
  const long long b = blockIdx.y;
  float* T = carry.T + 16 * b;
  uint8_t* done = carry.done + b;
  // A programmatic dependent of the previous launch on the stream: wait until it has
  // completed and its writes are visible, then let the next launch's blocks be scheduled
  // (they wait here in turn), so a launch's start-up overlaps its predecessor's tail.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (!polish && *done) return;  // the loop's cond: this sequence is finished
  __shared__ float Ts[16];
  __shared__ float tile[3 * kLoopThreads];
  __shared__ float red[kLoopWarps][kRow];
  __shared__ float damping;
  __shared__ int iters0;
  __shared__ bool done0, last;
  const int t = threadIdx.x;
  // The carry as it stands (the step reads it from here: no load on the tail's path).
  if (t < 16) Ts[t] = T[t];
  if (t == 16) damping = st.damping_ptr ? *st.damping_ptr : st.damping_val;
  if (t == 17) iters0 = carry.iters[b];
  if (t == 18) done0 = *done;
  src += b * bs.p;
  mask += b * bs.mask;
  table += b * bs.table;
  packed += b * bs.packed4;
  origin += b * bs.origin;
  const float d2 = d2_ptr ? d2_ptr[b * bs.scalars] : d2_val;
  const float ws = ws_ptr ? ws_ptr[b * bs.scalars] : ws_val;
  const float inv_leaf = inv_leaf_ptr[b];
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  float acc[kRow];
#pragma unroll
  for (int q = 0; q < kRow; ++q) acc[q] = 0.f;

  // The first tile's words and mask byte now; each next tile's while this one's gathers
  // run.
  const long long tiles = (N + kLoopThreads - 1) / kLoopThreads;
  float w[3];
  bool m = false;
  if (blockIdx.x < tiles) fetch_tile(src, mask, N, blockIdx.x, t, w, m);
  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    __syncthreads();  // the previous tile's reads of `tile` are done (and Ts is written)
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[t + c * kLoopThreads] = w[c];
    const bool mine = m;
    __syncthreads();
    if (k + gridDim.x < tiles) fetch_tile(src, mask, N, k + gridDim.x, t, w, m);
    if (mine) {
      const float sx = tile[3 * t], sy = tile[3 * t + 1], sz = tile[3 * t + 2];
      const float x = Ts[0] * sx + Ts[1] * sy + Ts[2] * sz + Ts[3];
      const float y = Ts[4] * sx + Ts[5] * sy + Ts[6] * sz + Ts[7];
      const float z = Ts[8] * sx + Ts[9] * sy + Ts[10] * sz + Ts[11];
      point_sums(acc, x, y, z, table, packed, ox, oy, oz, inv_leaf, grid, d2, ws);
    }
  }

  reduce_and_step<true, 1>(acc, red, last, partials, counter, b, Ts, damping, done0, iters0,
                           T, done, carry, st, polish);
}

}  // namespace

extern "C" {

// Source points a block of the loop kernel takes at a time (its threads).
int lgs_ndt_loop_tile() { return kLoopThreads; }

// Floats of the partials buffer a block of the loop kernel writes per sequence: its row.
int lgs_ndt_loop_row() { return kRow; }

// The loop kernel's registers per thread, static shared memory bytes and local memory
// bytes per thread (out[0..2]); returns the CUDA error (0 = success).
int lgs_ndt_loop_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ndt_iteration_kernel);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.sharedSizeBytes);
    out[2] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(err);
}

// Resident blocks per SM of the loop kernel on the current device (its registers and
// shared memory at kLoopThreads threads a block), or -(CUDA error).
int lgs_ndt_loop_blocks_per_sm() {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ndt_iteration_kernel, kLoopThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The whole loop of B sequences on `stream`: max_iterations launches, then
// polish_iterations polish launches, of `nblocks` x B blocks each. src [B, N, 3] f32, mask
// [B, N] u8, table [B, dx * dy * dz] i32, packed [B, rows, 16] f32 (16-byte aligned),
// origin [B, 3] f32, inv_leaf [B] f32; d2 / ws: by value, or pointers to one f32
// (scalars_per_sequence 0) or to B of them (1); damping by value or a pointer to one f32.
// The carry: T [B, 4, 4] f32, done [B] u8, iters [B] i32, fitness [B] f32, inliers [B]
// i32, updated in place. partials: [B * 32 * nblocks] f32; counter: B u32, 0 between
// launches (the kernel leaves it 0). Returns the first nonzero cudaGetLastError() (0 =
// every launch was accepted).
int lgs_ndt_align_loop_batched(const float* src, const uint8_t* mask, const int* table,
                               const float* packed, const float* origin,
                               const float* inv_leaf, int dx, int dy, int dz, int hx, int hy,
                               int hz, long long rows, int B, const float* d2_ptr,
                               float d2_val, const float* ws_ptr, float ws_val, long long N,
                               int scalars_per_sequence, float step_size, float epsilon,
                               const float* damping_ptr, float damping_val, float* T,
                               uint8_t* done, int* iters, float* fitness, int* inliers,
                               int max_iterations, int polish_iterations, float* partials,
                               unsigned int* counter, int nblocks, void* stream) {
  const Grid grid{dx, dy, dz, hx, hy, hz};
  const Batch bs{3 * N, N, (long long)dx * dy * dz, 4 * rows, 3, scalars_per_sequence};
  const Carry carry{T, done, iters, fitness, inliers};
  const StepArgs st{step_size, epsilon, damping_ptr, damping_val};
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks, B);
  cfg.blockDim = dim3(kLoopThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  for (int it = 0; it < max_iterations + polish_iterations; ++it) {
    cudaLaunchKernelEx(&cfg, ndt_iteration_kernel, src, mask, table,
                       reinterpret_cast<const float4*>(packed), origin, inv_leaf, grid, bs,
                       d2_ptr, d2_val, ws_ptr, ws_val, N, carry, st,
                       it >= max_iterations ? 1 : 0, partials, counter);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One sequence: packed [rows, 16] f32, table [dx * dy * dz] i32, origin [3] f32, inv_leaf
// one f32, the carry's fields one each; otherwise as `lgs_ndt_align_loop_batched`.
int lgs_ndt_align_loop(const float* src, const uint8_t* mask, const int* table,
                       const float* packed, const float* origin, const float* inv_leaf, int dx,
                       int dy, int dz, int hx, int hy, int hz, const float* d2_ptr,
                       float d2_val, const float* ws_ptr, float ws_val, long long N,
                       float step_size, float epsilon, const float* damping_ptr,
                       float damping_val, float* T, uint8_t* done, int* iters, float* fitness,
                       int* inliers, int max_iterations, int polish_iterations,
                       float* partials, unsigned int* counter, int nblocks, void* stream) {
  return lgs_ndt_align_loop_batched(src, mask, table, packed, origin, inv_leaf, dx, dy, dz, hx,
                                    hy, hz, 0, 1, d2_ptr, d2_val, ws_ptr, ws_val, N, 0,
                                    step_size, epsilon, damping_ptr, damping_val, T, done,
                                    iters, fitness, inliers, max_iterations,
                                    polish_iterations, partials, counter, nblocks, stream);
}

// The working launches since the last reset (`read_worked_launches`, loop_common.cuh).
long long lgs_ndt_worked_launches(int reset) { return read_worked_launches(reset); }

}  // extern "C"
