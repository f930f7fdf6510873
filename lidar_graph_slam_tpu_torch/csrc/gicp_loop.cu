// One whole GICP Gauss-Newton iteration per launch, for Hopper (sm_90a): the device side
// of the reference's `jax.lax.while_loop` in lidar_graph_slam_tpu/registration/gicp.py
// (`gicp_align`: body :146-178, cond :180-182) around its grid nearest-neighbour query
// (lidar_graph_slam_tpu/ops/neighbors.py:103-177, `_candidate_scan` + `nearest`) and the
// accumulation the TPU kernel `ndt_accumulate` did for it (ops/pallas_kernels.py, deleted
// in 4350000; `ndt_accumulate.cu`, which GICP launched once an iteration between torch ops
// before this kernel).
//
// The carry (T [4,4] f32, done u8, iterations i32, fitness f32, inliers i32) lives in
// device memory and is updated in place. One launch:
//   1. The programmatic wait on the launch before it, then the while_loop's cond: a
//      launch that finds `done` returns at once (as `ndt_iteration` does, ndt_loop.cu).
//   2. A block takes tiles of kLoopThreads source points (`fetch_tile`, loop_common.cuh),
//      one point a thread: p = R x + t from the carry's T.
//   3. The forward grid-NN query, a tile at a time (`stage_nearest`): each thread computes
//      its point's cell (`voxel_coord`: the float32 operations of `voxel_coords`, so a
//      point on a cell border lands in the same cell as on the torch path) and loads the
//      dense table's start of each of the C = 7 or 27 neighbour cells (all in flight; out
//      of the table: -1, no candidate). The block de-duplicates those starts in a
//      shared-memory hash and copies each distinct cell's run of B rows once into shared
//      memory, every row a cp.async, all in flight (`Stage`; runs past the stage's size
//      are read from global memory, the same rows). Each thread then scans its point's
//      own cell from the stage; the neighbour cells whose rows can still be as near as
//      that (a bound from the point's distance to the cell's face, `face_gap`) go on a
//      list that the block's threads scan a pair each. A cell is walked eight slots at a
//      time: a row counts only if its key is the cell's, d2 = ((dx dx) + (dy dy)) + dz dz
//      with __fsub_rn / __fmul_rn / __fadd_rn (the plain version's operations in its
//      order, no FMA), and the walk ends at the first batch that leaves the cell's
//      consecutive rows. A point keeps the least (d2, flat index (cell, slot)) of its
//      cells, packed into one 64-bit word (a shared-memory atomicMin merges the list's
//      results): the first minimum over the flattened candidates, which is what
//      `torch.argmin` returns. matched = found & mask & d2 < corr^2 & valid[row]; the
//      row's coordinates are read once, after the scan.
//   4. With kRecip (PCL's reciprocal correspondences, `gicp.py:154-160`): the same query of
//      T^-1 q against the untransformed source's grid, and the match survives only if
//      that grid's `order` of the row found is the point's own index.
//   5. Each matched thread forms its row: e = p - q, M = adj(Cq + R Cp R^T) / det with the
//      1e-12 floor of |det| (the plain version's `inv3x3`; all nine entries of the sum
//      are read, it is not bitwise symmetric), and `accumulate_row` (ndt_common.cuh) with
//      d2 = 0 and w_scale = 1, whose weight is exp(-0) = 1 for a finite row and NaN as in
//      the plain version otherwise; the two centre sums carry the matched d2 and count,
//      so the fitness is their ratio, the plain version's sum(d2) / max(inliers, 1).
//   6. `reduce_and_step` (loop_common.cuh): the fixed-order reduction and the 6x6 step in
//      the last block, without the cap, zeroed when not finite or below 6 inliers.
//
// The grid is persistent (`ops/kernels.py:loop_blocks` of N, the card and this kernel's
// occupancy). No float atomics: two runs are bit-identical.
//
// What bounds it on this card. A working launch at the front end's shape (N = 32,768
// against a 655,360-row target) must read the source (13 bytes a point), the table
// entries and candidate rows its points' cells name (16 bytes a row: ~32,700 distinct rows,
// 0.5 MB, for ~5.1 million candidates, since neighbouring points share cells) and, per
// matched point, two covariances (72 bytes); its operations are ~9 a candidate and ~300 a
// matched row: a bound of about a microsecond, by operations at the front end's shape and
// by bytes at the verifier's. It is latency-bound, as `ndt_iteration` is. The kernel's
// first design walked a warp's 32 queries in 16 dependent rounds of half a warp a query,
// each round a chunk of candidate loads from L2, their arithmetic and two half-warp
// reductions (`scripts/torch_gicp_loop_split.py`: ~8 us of its ~19 us scan in the loads,
// ~1.1 us in each round after a warp's first). This design takes the loads out of the
// scan: a tile's 128 points name few distinct cells (p50 79 at the front end, 56 at the
// verifier, at C = 7), so the block stages them in one pass (two dependent round trips a
// tile: the table, the runs; the copy moves ~10 MB an iteration from L2 at the front
// end); and it takes most of the candidates out: a point's nearest row is nearly always
// in its own cell, and a neighbour cell whose face lies farther than that row is not
// scanned. The tail is `ndt_iteration`'s (loop_common.cuh). The block count stays
// `loop_blocks` of N and the kernel's occupancy (two blocks an SM, set by the stage's
// shared memory), and each point's match, row and sum stay in its own thread in the same
// order, so the carry is bit-identical to the first design's on the same inputs. Not used:
// TMA and wgmma (scattered 512-byte runs, float32 arithmetic), more threads than points a
// block (the reduction takes one point a thread).

#include "nn_stage.cuh"

namespace {

struct GicpArgs {
  const float* src;         // [N, 3] untransformed source points
  const uint8_t* mask;      // [N]
  const float* src_covs;    // [N, 3, 3]
  long long N;
  NnGrid tgt;               // the target's grid
  const float* tcovs;       // [n, 3, 3] target covariances, in the grid's sorted order
  const uint8_t* tvalid;    // [n]
  NnGrid sgrid;             // kRecip: the untransformed source's grid
  const long long* sorder;  // kRecip: [Ns] the original row of each sorted source row
  Grid dims;                // dense table dims and the coordinate clamp
  float corr2;              // the squared correspondence distance
  Carry carry;
  StepArgs st;              // epsilon and damping (no cap)
  float* partials;
  unsigned int* counter;
};

// M = A^-1 by the adjugate, as the plain version's `inv3x3` (ops/kernels.py): a
// determinant below 1e-12 in magnitude is replaced by +1e-12.
__device__ __forceinline__ void inv3x3(const float (&A)[3][3], float (&M)[3][3]) {
  const float a = A[0][0], b = A[0][1], c = A[0][2];
  const float d = A[1][0], e = A[1][1], f = A[1][2];
  const float g = A[2][0], h = A[2][1], i = A[2][2];
  const float A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const float A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const float A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const float det = a * A11 + b * A21 + c * A31;
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  M[0][0] = A11 * inv_det; M[0][1] = A12 * inv_det; M[0][2] = A13 * inv_det;
  M[1][0] = A21 * inv_det; M[1][1] = A22 * inv_det; M[1][2] = A23 * inv_det;
  M[2][0] = A31 * inv_det; M[2][1] = A32 * inv_det; M[2][2] = A33 * inv_det;
}

// One matched point's row: e = p - q and M = (Cq + R Cp R^T)^-1, accumulated with d2 = 0
// and w_scale = 1, and its d2 and count in the two centre sums.
__device__ __forceinline__ void gicp_row(float (&acc)[kRow], float x, float y, float z,
                                         float qx, float qy, float qz, float d2,
                                         const float (&R)[3][3], const float (&Cq)[9],
                                         const float (&Cp)[9]) {
  float RC[3][3], A[3][3], M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      RC[i][j] = R[i][0] * Cp[j] + R[i][1] * Cp[3 + j] + R[i][2] * Cp[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      A[i][j] = Cq[3 * i + j] + (RC[i][0] * R[j][0] + RC[i][1] * R[j][1] + RC[i][2] * R[j][2]);
  inv3x3(A, M);
  accumulate_row(acc, x - qx, y - qy, z - qz, M, x, y, z, 0.f, 1.f);
  acc[29] += d2;
  acc[30] += 1.f;
}

template <int C, int B, bool kRecip>
__global__ void __launch_bounds__(kLoopThreads) gicp_iteration_kernel(const GicpArgs a) {
  // A programmatic dependent of the previous launch on the stream (as ndt_iteration).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (*a.carry.done) return;  // the loop's cond: the alignment is finished
  __shared__ float Ts[16];
  __shared__ float Tinv[12];  // rows 0..2 of T^-1 = [R^T | -R^T t] (kRecip)
  __shared__ float tile[3 * kLoopThreads];
  __shared__ float red[kLoopWarps][kRow];
  __shared__ float damping;
  __shared__ int iters0;
  __shared__ bool last;
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  Stage<C, B>& sm = *reinterpret_cast<Stage<C, B>*>(stage_bytes);
  const int t = threadIdx.x;
  const float* Tg = a.carry.T;
  if (t < 16) Ts[t] = Tg[t];
  if (kRecip && t >= 16 && t < 28) {  // se3.inverse's closed form, entry (i, j)
    const int i = (t - 16) >> 2, j = (t - 16) & 3;
    Tinv[t - 16] = j < 3 ? Tg[4 * j + i]
                         : -(Tg[i] * Tg[3] + Tg[4 + i] * Tg[7] + Tg[8 + i] * Tg[11]);
  }
  if (t == 28) damping = a.st.damping_ptr ? *a.st.damping_ptr : a.st.damping_val;
  if (t == 29) iters0 = *a.carry.iters;
  const float tinv = *a.tgt.inv_cell;
  const float tox = a.tgt.origin[0], toy = a.tgt.origin[1], toz = a.tgt.origin[2];
  float sinv = 0.f, sox = 0.f, soy = 0.f, soz = 0.f;
  if (kRecip) {
    sinv = *a.sgrid.inv_cell;
    sox = a.sgrid.origin[0];
    soy = a.sgrid.origin[1];
    soz = a.sgrid.origin[2];
  }
  float acc[kRow];
#pragma unroll
  for (int q = 0; q < kRow; ++q) acc[q] = 0.f;

  const long long tiles = (a.N + kLoopThreads - 1) / kLoopThreads;
  float w[3];
  bool m = false;
  if (blockIdx.x < tiles) fetch_tile(a.src, a.mask, a.N, blockIdx.x, t, w, m);
  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    __syncthreads();  // the previous tile's reads of `tile` are done (and Ts is written)
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[t + c * kLoopThreads] = w[c];
    const bool mine = m;
    __syncthreads();
    if (k + gridDim.x < tiles) fetch_tile(a.src, a.mask, a.N, k + gridDim.x, t, w, m);
    const long long i = kLoopThreads * k + t;
    const float sx = tile[3 * t], sy = tile[3 * t + 1], sz = tile[3 * t + 2];
    const float x = Ts[0] * sx + Ts[1] * sy + Ts[2] * sz + Ts[3];
    const float y = Ts[4] * sx + Ts[5] * sy + Ts[6] * sz + Ts[7];
    const float z = Ts[8] * sx + Ts[9] * sy + Ts[10] * sz + Ts[11];
    int row = 0;
    float d2 = stage_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, x, y, z, mine, sm, row);
    bool cand = d2 < a.corr2;  // found, masked in, within the gate
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (cand) {
      const float4 q = __ldg(a.tgt.packed + row);
      qx = q.x;
      qy = q.y;
      qz = q.z;
    }
    if (kRecip) {
      const float ux = Tinv[0] * qx + Tinv[1] * qy + Tinv[2] * qz + Tinv[3];
      const float uy = Tinv[4] * qx + Tinv[5] * qy + Tinv[6] * qz + Tinv[7];
      const float uz = Tinv[8] * qx + Tinv[9] * qy + Tinv[10] * qz + Tinv[11];
      int brow = 0;
      const float bd2 = stage_nearest<C, B>(a.sgrid, sinv, sox, soy, soz, a.dims, ux, uy, uz,
                                            cand, sm, brow);
      cand = cand && bd2 < INFINITY && __ldg(&a.sorder[brow]) == i;
    }
    if (cand) {
      float Cq[9], Cp[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        Cq[e] = __ldg(&a.tcovs[9LL * row + e]);
        Cp[e] = __ldg(&a.src_covs[9LL * i + e]);
      }
      if (__ldg(&a.tvalid[row])) {
        const float R[3][3] = {{Ts[0], Ts[1], Ts[2]}, {Ts[4], Ts[5], Ts[6]},
                               {Ts[8], Ts[9], Ts[10]}};
        gicp_row(acc, x, y, z, qx, qy, qz, d2, R, Cq, Cp);
      }
    }
  }

  reduce_and_step<false, 6>(acc, red, last, a.partials, a.counter, 0, Ts, damping, false,
                            iters0, a.carry.T, a.carry.done, a.carry, a.st, 0);
}

template <int C, int B, bool kRecip>
Variant variant_of() {
  return {reinterpret_cast<const void*>(&gicp_iteration_kernel<C, B, kRecip>),
          static_cast<int>(sizeof(Stage<C, B>))};
}

// The instantiation for (neighborhood, bucket_cap, reciprocal) with its stage's bytes
// allowed on the current device (`*err`), or {nullptr, 0} (cudaErrorInvalidValue).
Variant gicp_kernel(int neighborhood, int bucket_cap, int reciprocal, cudaError_t* err) {
  const bool r = reciprocal != 0;
  Variant v = {nullptr, 0};
  if (neighborhood == 7 && bucket_cap == 32)
    v = r ? variant_of<7, 32, true>() : variant_of<7, 32, false>();
  else if (neighborhood == 7 && bucket_cap == 16)
    v = r ? variant_of<7, 16, true>() : variant_of<7, 16, false>();
  else if (neighborhood == 27 && bucket_cap == 32)
    v = r ? variant_of<27, 32, true>() : variant_of<27, 32, false>();
  else if (neighborhood == 27 && bucket_cap == 16)
    v = r ? variant_of<27, 16, true>() : variant_of<27, 16, false>();
  *err = v.fn == nullptr ? cudaErrorInvalidValue
                         : cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                v.smem);
  return v;
}

}  // namespace

extern "C" {

// The kernel's registers per thread, shared memory bytes a block (static and its stage)
// and local memory bytes per thread (out[0..2]), and the runs its stage holds (out[3]),
// for (neighborhood, bucket_cap, reciprocal); returns the CUDA error (0 = success).
int lgs_gicp_loop_attributes(int neighborhood, int bucket_cap, int reciprocal, int* out) {
  cudaError_t err;
  const Variant v = gicp_kernel(neighborhood, bucket_cap, reciprocal, &err);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, v.fn);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes) + v.smem;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = stage_runs(neighborhood, bucket_cap);
  }
  return static_cast<int>(err);
}

// Resident blocks per SM of the kernel for (neighborhood, bucket_cap, reciprocal) on the
// current device, or -(CUDA error).
int lgs_gicp_loop_blocks_per_sm(int neighborhood, int bucket_cap, int reciprocal) {
  cudaError_t err;
  const Variant v = gicp_kernel(neighborhood, bucket_cap, reciprocal, &err);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, v.fn, kLoopThreads, v.smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The whole GICP loop on `stream`: max_iterations launches of `nblocks` blocks each, every
// launch a programmatic dependent of the one before it, cudaGetLastError() checked after
// each. src [N, 3] f32, mask [N] u8, src_covs [N, 3, 3] f32; the target grid (table [dx *
// dy * dz] i32, packed [t_n, 4] f32 16-byte aligned, origin [3] f32, inv_cell one f32) with
// its covs [t_n, 3, 3] f32 and valid [t_n] u8; with s_table not null, the reciprocal test
// against the source grid (the same fields, and order [s_n] i64). damping by value or a
// pointer to one f32. The carry: T [4, 4] f32, done u8, iters i32, fitness f32, inliers
// i32, updated in place. partials: [32 * nblocks] f32; counter: one u32, 0 between
// launches (the kernel leaves it 0). Returns the first nonzero CUDA error (0 = every
// launch was accepted; cudaErrorInvalidValue for a neighborhood or bucket_cap the kernel
// does not take).
int lgs_gicp_align_loop(const float* src, const uint8_t* mask, const float* src_covs,
                        long long N, const int* t_table, const float* t_packed,
                        const float* t_origin, const float* t_inv_cell, int t_n,
                        const float* t_covs, const uint8_t* t_valid, const int* s_table,
                        const float* s_packed, const float* s_origin,
                        const float* s_inv_cell, int s_n, const long long* s_order, int dx,
                        int dy, int dz, int hx, int hy, int hz, int key_sx, int key_sy,
                        int neighborhood, int bucket_cap, float corr2, float epsilon,
                        const float* damping_ptr, float damping_val, float* T,
                        uint8_t* done, int* iters, float* fitness, int* inliers,
                        int max_iterations, float* partials, unsigned int* counter,
                        int nblocks, void* stream) {
  if (key_sx != kKeyX || key_sy != kKeyY) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const Variant v = gicp_kernel(neighborhood, bucket_cap, s_table != nullptr, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  GicpArgs a;
  a.src = src;
  a.mask = mask;
  a.src_covs = src_covs;
  a.N = N;
  a.tgt = NnGrid{t_table, reinterpret_cast<const float4*>(t_packed), t_origin, t_inv_cell,
                 t_n};
  a.tcovs = t_covs;
  a.tvalid = t_valid;
  a.sgrid = NnGrid{s_table, reinterpret_cast<const float4*>(s_packed), s_origin, s_inv_cell,
                   s_n};
  a.sorder = s_order;
  a.dims = Grid{dx, dy, dz, hx, hy, hz};
  a.corr2 = corr2;
  a.carry = Carry{T, done, iters, fitness, inliers};
  a.st = StepArgs{0.f, epsilon, damping_ptr, damping_val};
  a.partials = partials;
  a.counter = counter;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(kLoopThreads);
  cfg.dynamicSmemBytes = v.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  for (int it = 0; it < max_iterations; ++it) {
    cudaLaunchKernelExC(&cfg, v.fn, args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The working launches since the last reset (`read_worked_launches`, loop_common.cuh).
long long lgs_gicp_worked_launches(int reset) { return read_worked_launches(reset); }

}  // extern "C"
