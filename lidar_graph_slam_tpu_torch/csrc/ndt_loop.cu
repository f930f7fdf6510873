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
//   3. Reduction, in a fixed order: a reduce-scatter of the 31 sums over the 32 lanes
//      (16 + 8 + 4 + 2 + 1 shuffles, after which lane q holds quantity q's warp total),
//      the warps summed in order through shared memory, one 128-byte partial row per
//      block, then a ticket drawn with release and acquire semantics (one atomic, no
//      sequentially consistent fence). The block that draws the last ticket sums the
//      rows: warp w lane q adds quantity q of rows w, w + kLoopWarps, ... (coalesced rows
//      read past L1, kChunk of them in flight a lane), then the warps in order.
//   4. The step, in warp 0 of that block (`ops/kernels.py:ndt_step_plain`): damping by
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

#include "ndt_common.cuh"

namespace {

// Launches of this kernel that did work (summed over the sequences of a batch), for the
// measurement of dead launches; read and reset by the host entry points below.
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
  float step_size, epsilon;
  const float* damping_ptr;  // or by value
  float damping_val;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {  // NaN stays NaN
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_max(float x, float hi) {  // NaN stays NaN
  return x > hi ? hi : x;
}

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
// Writes sequence b's carry in place.
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

  const float scale = clamp_max(st.step_size / clamp_min(norm6(delta), 1e-12f), 1.0f);
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    delta[i] *= scale;
    finite = finite && isfinite(delta[i]);
  }
  const bool step_ok = finite && n_inliers > 0;
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
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
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

  // The block's partial row: lane q of warp w holds quantity q of the warp, then warp 0
  // sums the warps in order and writes the row (one 128-byte store).
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
  // The last block: warp w lane q adds quantity q of rows w, w + kLoopWarps, ... in that
  // order, kChunk rows a lane loaded at once (__ldcg reads past L1: the rows are new),
  // then warp 0 the warps in order.
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
  gn_step_warp(tot, Ts, damping, done0, iters0, T, done, carry.iters + b, carry.fitness + b,
               carry.inliers + b, st, polish);
  if (lane == 0) atomicAdd(&g_worked_launches, 1ull);
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

// The working launches since the last reset, after every queued launch of the device
// finished (a device-wide synchronize: for measurement only). Returns the count, or
// -(CUDA error) on failure.
long long lgs_ndt_worked_launches(int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  unsigned long long n = 0;
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&n, g_worked_launches, sizeof(n));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_worked_launches, &zero, sizeof(zero));
  }
  return err == cudaSuccess ? static_cast<long long>(n) : -static_cast<long long>(err);
}

}  // extern "C"
