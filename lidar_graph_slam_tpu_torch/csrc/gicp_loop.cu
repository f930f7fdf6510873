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
//   3. The forward grid-NN query, a warp at a time (`warp_nearest`): each lane computes its
//      point's cell (`voxel_coord`: the float32 operations of `voxel_coords`, so a point on
//      a cell border lands in the same cell as on the torch path) and loads the dense
//      table's start of each of the C = 7 or 27 neighbour cells (all in flight; out of the
//      table: -1, no candidate) into shared memory. Then the warp takes its points two a
//      round, half a warp (16 lanes) a point: lane s of a point reads slots s and s + 16
//      (B = 32; slot s at B = 16) of each cell's run of B packed rows from the start
//      clamped to [0, n - B] (coalesced 256-byte runs), keeps a row only if its key is
//      the cell's (a clamped start reads other cells' rows first), computes d2 = ((dx dx)
//      + (dy dy)) + dz dz with __fsub_rn / __fmul_rn / __fadd_rn (the plain version's
//      operations in its order, no FMA) for each of its candidates without a branch, and
//      takes their first minimum in flat order (cell, then slot) by a tree of compares
//      rather than a chain; two reductions over the half warp (redux.sync) on the d2 bits,
//      then on
//      the flat index c B + slot among the lanes that hold the least d2, give the first
//      minimum over the flattened candidates, which is what `torch.argmin` returns. The
//      rounds are software pipelined: a chunk's candidate loads are issued before the
//      previous chunk is consumed. matched = found & mask & d2 < corr^2 & valid[row]; the
//      row's coordinates are read once, after the scan.
//   4. With kRecip (PCL's reciprocal correspondences, `gicp.py:154-160`): the same query of
//      T^-1 q against the untransformed source's grid, and the match survives only if
//      that grid's `order` of the row found is the point's own index.
//   5. Each matched lane forms its row: e = p - q, M = adj(Cq + R Cp R^T) / det with the
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
// entries and candidate rows its points' cells name (16 bytes a row, ~10 MB of packed rows
// and 17 MB of table that mostly stay in the 50 MB L2) and, per matched point, two
// covariances (72 bytes); its operations are ~9 a candidate and ~300 a matched row: a
// bound of about a microsecond (operations at the front end's shape, where many points
// share cells; bytes at the verifier's). It is latency-bound, as `ndt_iteration` is: each
// warp walks its 32 queries in 16 rounds, one after another, each round a chunk of
// candidate loads, their arithmetic and the half-warp reductions, then the reduction and
// the step (`scripts/torch_gicp_loop_split.py` times the scan, the rows and the tail
// apart; the candidates' bytes are a small part of the scan). The design spreads a query's
// candidates over half a warp, so a round is 2 C coalesced loads in flight a lane where
// one thread per point would walk C x B rows; keeps the table's starts in shared memory
// (one round trip for all 32 points of a warp); overlaps each chunk's loads with the
// previous chunk's arithmetic; and never writes the N x C x B candidate tensor (117 MB an
// iteration at the front end's shape) that the torch path gathers. Half-warp queries ran
// faster than whole-warp ones (B lanes a query, 32 rounds) at the front end's shape, at
// more registers a thread: two blocks an SM, which the path's grid (256 blocks at N =
// 32,768) does not exceed; and so did a branch-free consume with a tree minimum against
// a branch and a compare chained through a lane's candidates. Not used: TMA and wgmma
// (scattered 256-byte runs and float32 arithmetic, as in the NDT kernels).

#include "loop_common.cuh"

#include <climits>
#include <cmath>

namespace {

// A HashGrid of ops/neighbors.py on the card.
struct NnGrid {
  const int* table;       // [dx * dy * dz] dense cell -> first sorted row (-1: empty)
  const float4* packed;   // [n]: x, y, z and the cell key's int32 bits
  const float* origin;    // [3]
  const float* inv_cell;  // one f32: 1 / cell_size, the float32 the torch path computes
  int n;                  // rows (the capacity, padding included)
};

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

// The cell key's layout (ops/voxel.py:pack_key): x << kKeyX | y << kKeyY | z.
constexpr int kKeyX = 19, kKeyY = 8;

// Neighbour cell c of ops/neighbors.py's _7_OFFSETS or _27_OFFSETS, in their order.
template <int C>
__device__ __forceinline__ int3 cell_offset(int c) {
  if (C == 7) return make_int3((c == 1) - (c == 2), (c == 3) - (c == 4), (c == 5) - (c == 6));
  return make_int3(c / 9 - 1, (c / 3) % 3 - 1, c % 3 - 1);
}

// The key of neighbour cell c minus its base cell's key: a cell in the table has every
// coordinate in its field, so the two keys differ by the packed offset.
template <int C>
__device__ __forceinline__ int key_offset(int c) {
  const int3 o = cell_offset<C>(c);
  return o.x * (1 << kKeyX) + o.y * (1 << kKeyY) + o.z;
}

// A query takes a segment of kSegment lanes (half a warp): two queries a round. Lane s of
// a segment reads slots s, s + 16, ... of each cell's run: S = B / 16 rows a cell.
constexpr int kSegment = 16;

// Cells whose candidate loads a lane keeps in flight at once, at S rows a cell.
template <int C, int S>
__host__ __device__ constexpr int cell_chunk() {
  return C == 7 ? 7 : (S == 1 ? 9 : 3);
}

template <int C>
struct ScanSmem {
  int start[kLoopWarps][32][C];  // per warp and lane: each cell's table start, or -1
  float d2[kLoopWarps][32];      // per warp and lane: its query's result
  int row[kLoopWarps][32];
};

// One load step of a warp's scan: chunk `ch` (cells ch K .. ch K + K - 1) of the query of
// lane j: for each cell, the start clamped to [0, n - B] (or -1: no such cell) and this
// lane's S slots of its run.
template <int C, int B, int K>
__device__ __forceinline__ void load_chunk(const NnGrid& g, const ScanSmem<C>& sm, int warp,
                                          int j, int ch, int lane16, int (&s)[K],
                                          float4 (&v)[K][B / kSegment]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s0 = sm.start[warp][j][ch * K + k];
    s[k] = s0 < 0 ? -1 : min(s0, g.n - B);  // clamp(start, 0, n - B)
#pragma unroll
    for (int t = 0; t < B / kSegment; ++t)
      v[k][t] = s0 < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                       : __ldg(g.packed + s[k] + lane16 + kSegment * t);
  }
}

// The least (d2, flat) over the lanes of a segment, d2 >= 0 or +inf (whose bits order as
// unsigned integers): the least d2, then among the lanes holding it the least flat index
// — two warp reductions (redux.sync), each segment with its own mask. Returns (d2, flat)
// in every lane of the segment.
__device__ __forceinline__ void segment_argmin(float& best, int& bflat, int seg) {
  const unsigned mask = 0xffffu << (kSegment * seg);
  const unsigned bits = __float_as_uint(best);
  const unsigned least = __reduce_min_sync(mask, bits);
  bflat = (int)__reduce_min_sync(mask, bits == least ? (unsigned)bflat : UINT_MAX);
  best = __uint_as_float(least);
}

// The nearest row of grid g to every lane's query (x, y, z) that is `active`, among the
// rows of the C cells around it (ops/neighbors.py:nearest at neighborhood C and bucket_cap
// B). Every lane of the warp calls it. Returns the squared distance (+inf when no row was
// found or the lane is not active) and, when found, the sorted row in `row`.
//
// The table's starts of every lane's cells are loaded first (all in flight) into `sm`;
// then the warp walks its queries two a round (a half-warp segment each, S = B / 16 rows
// of each cell a lane), each round in chunks of K cells, and loads the next chunk's
// candidates while it consumes this one's (software pipelined: one load latency a chunk,
// overlapped with the previous chunk's arithmetic and the round's argmin). A lane keeps
// only its least d2, the cell and slot it came from and the row; the row's coordinates
// are read once, after the scan.
template <int C, int B>
__device__ __forceinline__ float warp_nearest(const NnGrid& g, float inv, float ox, float oy,
                                              float oz, const Grid& dm, float x, float y,
                                              float z, bool active, ScanSmem<C>& sm,
                                              int& row) {
  constexpr int P = 32 / kSegment;  // queries a round
  constexpr int S = B / kSegment;   // rows of a cell a lane reads
  constexpr int K = cell_chunk<C, S>();
  constexpr int NCH = C / K;  // chunks a round
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / kSegment, lane16 = lane % kSegment;
  const int bx = voxel_coord(x, ox, inv, dm.hx);
  const int by = voxel_coord(y, oy, inv, dm.hy);
  const int bz = voxel_coord(z, oz, inv, dm.hz);
  const int base_key = (bx << kKeyX) | (by << kKeyY) | bz;
  __syncwarp();  // every lane has read the last query's results out of `sm`
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int3 o = cell_offset<C>(c);
    const int cx = bx + o.x, cy = by + o.y, cz = bz + o.z;
    const bool in = active && cx >= 0 && cx < dm.dx && cy >= 0 && cy < dm.dy && cz >= 0 &&
                    cz < dm.dz;  // outside: the reference's overflow slot, which reads -1
    sm.start[warp][lane][c] = in ? __ldg(&g.table[(cx * dm.dy + cy) * dm.dz + cz]) : -1;
  }
  __syncwarp();
  // The rounds that hold a query (warp-uniform), in order.
  const unsigned act = __ballot_sync(kFull, active);
  unsigned todo = 0;
#pragma unroll
  for (int r = 0; r < 32 / P; ++r)
    if ((act >> (r * P)) & ((1u << P) - 1u)) todo |= 1u << r;
  if (todo != 0) {
    int r = __ffs(todo) - 1, ch = 0;
    todo &= todo - 1;
    int s[K];
    float4 v[K][S];
    load_chunk<C, B, K>(g, sm, warp, r * P + seg, 0, lane16, s, v);
    float best = INFINITY;
    int bflat = INT_MAX, brow = 0;
    while (true) {
      // The next chunk: this round's next, or the next round's first (nr < 0: none).
      int nr = r, nch = ch + 1;
      if (nch == NCH) {
        nch = 0;
        nr = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
      }
      int ns[K];
      float4 nv[K][S];
      if (nr >= 0) load_chunk<C, B, K>(g, sm, warp, nr * P + seg, nch, lane16, ns, nv);
      const int j = r * P + seg;  // the lane whose query this segment takes this round
      const float px = __shfl_sync(kFull, x, j), py = __shfl_sync(kFull, y, j),
                  pz = __shfl_sync(kFull, z, j);
      const int jkey = __shfl_sync(kFull, base_key, j);
      // The chunk's K S candidates of this lane, in flat order (cell, then slot), without
      // a branch: one that is not its cell's row reads +inf. Then their first minimum by a
      // tree (the left of two equal ones has the lower flat index), merged with the
      // running one of earlier chunks.
      float d[K * S];
      int at[K * S], rw[K * S];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int key = jkey + key_offset<C>(ch * K + k);
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const float dx = __fsub_rn(v[k][t].x, px), dy = __fsub_rn(v[k][t].y, py),
                      dz = __fsub_rn(v[k][t].z, pz);
          const float d2 =
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          const bool ok = s[k] >= 0 && __float_as_int(v[k][t].w) == key;
          d[k * S + t] = ok ? d2 : INFINITY;
          at[k * S + t] = k * S + t;
          rw[k * S + t] = s[k] + lane16 + kSegment * t;
        }
      }
#pragma unroll
      for (int w = 1; w < K * S; w *= 2) {
#pragma unroll
        for (int i = 0; i + w < K * S; i += 2 * w) {
          const bool right = d[i + w] < d[i];
          d[i] = right ? d[i + w] : d[i];
          at[i] = right ? at[i + w] : at[i];
          rw[i] = right ? rw[i + w] : rw[i];
        }
      }
      if (d[0] < best) {  // strict: earlier chunks hold lower flat indices
        best = d[0];
        bflat = (ch * K + at[0] / S) * B + lane16 + kSegment * (at[0] % S);
        brow = rw[0];
      }
      if (ch == NCH - 1) {  // the round's last chunk: its first minimum over (cell, slot)
        float least = best;
        int flat = bflat;
        segment_argmin(least, flat, seg);
        if (lane16 == 0) sm.d2[warp][j] = least;
        if (least < INFINITY && flat == bflat) sm.row[warp][j] = brow;  // the finder
        best = INFINITY;
        bflat = INT_MAX;
      }
      if (nr < 0) break;
      r = nr;
      ch = nch;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s[k] = ns[k];
#pragma unroll
        for (int t = 0; t < S; ++t) v[k][t] = nv[k][t];
      }
    }
  }
  __syncwarp();
  if (!active) return INFINITY;
  row = sm.row[warp][lane];
  return sm.d2[warp][lane];
}

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
  __shared__ ScanSmem<C> sm;
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
    const float d2 =
        warp_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, x, y, z, mine, sm, row);
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
      const float bd2 =
          warp_nearest<C, B>(a.sgrid, sinv, sox, soy, soz, a.dims, ux, uy, uz, cand, sm, brow);
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
const void* kernel_of() {
  return reinterpret_cast<const void*>(&gicp_iteration_kernel<C, B, kRecip>);
}

// The instantiation for (neighborhood, bucket_cap, reciprocal), or nullptr.
const void* gicp_kernel(int neighborhood, int bucket_cap, int reciprocal) {
  const bool r = reciprocal != 0;
  if (neighborhood == 7 && bucket_cap == 32)
    return r ? kernel_of<7, 32, true>() : kernel_of<7, 32, false>();
  if (neighborhood == 7 && bucket_cap == 16)
    return r ? kernel_of<7, 16, true>() : kernel_of<7, 16, false>();
  if (neighborhood == 27 && bucket_cap == 32)
    return r ? kernel_of<27, 32, true>() : kernel_of<27, 32, false>();
  if (neighborhood == 27 && bucket_cap == 16)
    return r ? kernel_of<27, 16, true>() : kernel_of<27, 16, false>();
  return nullptr;
}

}  // namespace

extern "C" {

// The kernel's registers per thread, static shared memory bytes and local memory bytes
// per thread (out[0..2]) for (neighborhood, bucket_cap, reciprocal); returns the CUDA
// error (0 = success).
int lgs_gicp_loop_attributes(int neighborhood, int bucket_cap, int reciprocal, int* out) {
  const void* fn = gicp_kernel(neighborhood, bucket_cap, reciprocal);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) {
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

// Resident blocks per SM of the kernel for (neighborhood, bucket_cap, reciprocal) on the
// current device, or -(CUDA error).
int lgs_gicp_loop_blocks_per_sm(int neighborhood, int bucket_cap, int reciprocal) {
  const void* fn = gicp_kernel(neighborhood, bucket_cap, reciprocal);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kLoopThreads, 0);
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
  const void* fn = gicp_kernel(neighborhood, bucket_cap, s_table != nullptr);
  if (fn == nullptr || key_sx != kKeyX || key_sy != kKeyY)
    return static_cast<int>(cudaErrorInvalidValue);
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
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  for (int it = 0; it < max_iterations; ++it) {
    cudaLaunchKernelExC(&cfg, fn, args);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The working launches since the last reset (`read_worked_launches`, loop_common.cuh).
long long lgs_gicp_worked_launches(int reset) { return read_worked_launches(reset); }

}  // extern "C"
