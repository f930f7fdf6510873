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

// Runs of B rows a tile's stage holds: every run of the front end's and the verifier's
// tiles at C = 7 (at most 122 and 96, `chip_smoke.stage_counts`), and most of the largest
// run sets at C = 27 (at most 199), within two blocks an SM.
__host__ __device__ constexpr int stage_runs(int, int B) { return 128 * 32 / B; }

// The stage of one query of a tile. A run is the B rows from a cell's table start (rows
// past the table's end read as no cell's); it holds every row of the cell that the plain
// version's scan reads (B rows from the start clamped to [0, n - B]). Each
// distinct run the tile's points name is staged once (kRuns of them; a tile's runs past
// kRuns are read from global memory instead); a staged run takes B + 1 rows, so that the
// same slot of different runs falls on different banks. The hash of the de-duplication,
// kHash slots of a table start and its run's id, shares its bytes with the staged rows:
// it is done with before the copy starts. `work` lists the (point, neighbour cell) pairs
// left to scan after each point's own cell, `best` each point's first minimum so far.
template <int C, int B>
struct Stage {
  static constexpr int kRuns = stage_runs(C, B);
  static constexpr int kStride = B + 1;
  static constexpr int kHashBits = C == 7 ? 11 : 13;
  static constexpr int kHash = 1 << kHashBits;  // at least twice 128 C
  static constexpr unsigned short kNone = 0xffff;
  int start[C][kLoopThreads];           // cell c's table start of point t, or -1
  unsigned short sid[C][kLoopThreads];  // the id of its run (kNone: no run)
  float q[3][kLoopThreads];             // point t's query
  int qkey[kLoopThreads];               // its cell's key
  unsigned long long best[kLoopThreads];  // its least (d2 bits, flat index), packed
  unsigned short work[(C - 1) * kLoopThreads];  // t * 32 + c: point t's cell c to scan
  int runs[kRuns];  // the table start of each staged run
  int nruns;        // the tile's distinct runs, staged or not
  int warp_total[kLoopWarps];
  union {
    float4 rows[kRuns * kStride];
    struct {
      int key[kHash];  // a table start, or -1
      unsigned short id[kHash];
    } hash;
  };
  static_assert(sizeof(hash) <= sizeof(rows), "the hash takes the staged rows' bytes");
  static_assert(kHash >= 2 * kLoopThreads * C, "the hash is at most half full");
};

// The hash slot of a table start (Fibonacci hashing: the product's top bits).
template <int kBits>
__device__ __forceinline__ int hash_slot(int r) {
  return static_cast<int>((static_cast<unsigned>(r) * 0x9e3779b1u) >> (32 - kBits));
}

// cp.async of 16 bytes from global to shared memory, through L2 only.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}

// A row that is no cell's: its key is -1.
__device__ __forceinline__ float4 no_row() {
  return make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
}

// Every staged run's B rows into the stage, all copies in flight at once (a row past the
// table's end is written as no cell's); returns when this thread's have landed (the
// caller's barrier then makes all of them visible).
template <int B, typename S>
__device__ __forceinline__ void copy_runs(S& sm, const float4* __restrict__ packed, int n,
                                          int staged) {
  for (int j = threadIdx.x; j < staged * B; j += kLoopThreads) {
    const int run = j / B, row = sm.runs[run] + j % B;
    float4* dst = &sm.rows[run * S::kStride + j % B];
    if (row < n)
      cp_async16(dst, packed + row);
    else
      *dst = no_row();
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (d2, flat) packed so that the least unsigned value is the least d2 (d2 >= 0 or +inf,
// whose bits order as unsigned integers), then the least flat index among its holders.
__device__ __forceinline__ unsigned long long pack_best(float d2, int flat) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned>(flat);
}

// One cell's candidates for each lane's query (px, py, pz) that `wants` the cell: the B
// slots of its run from its table start (the stage's copy, or with kGlobal a lane's own
// choice of it or of the packed rows, `limit` of which are left), U at a time without a
// branch: a slot whose key is not the cell's reads +inf. Their first minimum by a tree
// of compares (the left of two equal ones has the lower slot). A lane's walk ends with
// the first batch whose last slot is not the cell's: the cell's rows are consecutive
// from its table start, so every later slot's key differs too. The warp walks in step
// while any lane walks. d2 = ((dx dx) + (dy dy)) + dz dz with __fsub_rn / __fmul_rn /
// __fadd_rn, the plain version's operations in its order, no FMA. Returns the cell's
// least (d2, slot) packed, the slot counted from the table start.
template <int B, bool kGlobal>
__device__ __forceinline__ unsigned long long scan_run(const float4* run, int limit, bool wants,
                                                       int key, float px, float py,
                                                       float pz) {
  constexpr int U = 8;
  unsigned long long best = pack_best(INFINITY, 0);
  bool walking = wants;
  for (int s = 0; s < B && __any_sync(kFull, walking); s += U) {
    float d[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 v = !kGlobal || s + u < limit ? run[s + u] : no_row();
      const float dx = __fsub_rn(v.x, px), dy = __fsub_rn(v.y, py), dz = __fsub_rn(v.z, pz);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      d[u] = __float_as_int(v.w) == key ? d2 : INFINITY;
      at[u] = u;
    }
    const bool last = d[U - 1] < INFINITY;  // the batch's last slot is the cell's
#pragma unroll
    for (int w = 1; w < U; w *= 2) {
#pragma unroll
      for (int i = 0; i + w < U; i += 2 * w) {
        const bool right = d[i + w] < d[i];
        d[i] = right ? d[i + w] : d[i];
        at[i] = right ? at[i + w] : at[i];
      }
    }
    const unsigned long long mine = pack_best(d[0], s + at[0]);
    best = walking && mine < best ? mine : best;
    walking = walking && last;
  }
  return best;
}

// The least distance from p, along one axis, to the rows of the neighbour cell at offset
// o (-1, 0, +1) of p's cell k (origin org, cell size cell): 0 for o = 0, else p's distance
// to that cell's near face, moved toward p by a margin that covers the float32 rounding of
// the rows' cells (`voxel_coord`) and of the face itself, so that every row of the cell
// lies at least this far away and each candidate's d2, rounded as the scan rounds it, is
// at least the bound's, rounded alike.
__device__ __forceinline__ float face_gap(int o, int k, float p, float org, float cell) {
  if (o == 0) return 0.f;
  const float face = org + (o > 0 ? k + 1 : k) * cell;
  const float margin = 1e-3f + 1e-5f * (fabsf(org) + (k + 1) * cell);
  const float gap = o > 0 ? __fsub_rn(face - margin, p) : __fsub_rn(p, face + margin);
  return gap > 0.f ? gap : 0.f;
}

// Point p's cell c scanned (the staged run from shared memory; a run past the stage from
// global memory, the warp taking that path if any lane needs it): its least (d2, flat)
// packed, flat = c B + the slot of the plain version's run, which starts at the table
// start clamped to [0, n - B].
template <int C, int B, typename S>
__device__ __forceinline__ unsigned long long scan_cell(const S& sm, const NnGrid& g, int p,
                                                        int c, bool wants) {
  const int s0 = sm.start[c][p];
  const int id = sm.sid[c][p];
  const bool staged = !wants || id < S::kRuns;
  const int key = sm.qkey[p] + key_offset<C>(c);
  const float px = sm.q[0][p], py = sm.q[1][p], pz = sm.q[2][p];
  const float4* run = &sm.rows[(staged && wants ? id : 0) * S::kStride];
  unsigned long long best;
  if (__any_sync(kFull, !staged))
    best = scan_run<B, true>(staged ? run : g.packed + s0, staged ? B : g.n - s0, wants, key,
                             px, py, pz);
  else
    best = scan_run<B, false>(run, B, wants, key, px, py, pz);
  // The slot from the table start, as a flat index of the plain version's candidates.
  return best + (c * B + s0 - min(s0, g.n - B));
}

// The nearest row of grid g to every thread's query (x, y, z) that is `active`, among the
// rows of the C cells around it (ops/neighbors.py:nearest at neighborhood C and bucket_cap
// B). Every thread of the block calls it. Returns the squared distance (+inf when no row
// was found or the thread is not active) and, when found, the sorted row in `row`.
//
//   1. Each thread computes its cell (`voxel_coord`: the float32 operations of
//      `voxel_coords`, so a point on a cell border lands in the same cell as on the torch
//      path) and loads the table's start of each of its C cells, all in flight (out of
//      the table: -1, no candidate), while the block clears the hash.
//   2. The tile's distinct table starts go into the hash: a lane inserts a start unless
//      the lane before it names the same one (neighbouring points share cells), all its
//      atomicCAS at once (linear probing after a collision); a lane that fills a slot
//      numbers its run (a warp draws its block of numbers with one atomicAdd: the
//      numbering varies from run to run, the rows a number stands for do not). Then each
//      lane takes its cells' run ids from the lanes that inserted them.
//   3. The first kRuns runs are copied into the stage, every 16-byte row a cp.async, all
//      in flight: one round trip to L2 for the tile.
//   4. Each thread scans its own cell (`scan_cell`). Then it lists its neighbour cells
//      whose rows can be as near as that cell's best (`face_gap`: a cell whose bound
//      exceeds the best holds no first minimum); the block's threads share the list and
//      scan a pair each, merging into the point's best with a shared-memory atomicMin on
//      the packed (d2, flat): the least d2, then the least flat index (cell, then slot)
//      among its holders, which is what `torch.argmin` returns, whatever the order.
template <int C, int B, typename S>
__device__ __forceinline__ float stage_nearest(const NnGrid& g, float inv, float ox, float oy,
                                               float oz, const Grid& dm, float x, float y,
                                               float z, bool active, S& sm, int& row) {
  constexpr int kOwn = C == 7 ? 0 : 13;  // the offset (0, 0, 0)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int bx = voxel_coord(x, ox, inv, dm.hx);
  const int by = voxel_coord(y, oy, inv, dm.hy);
  const int bz = voxel_coord(z, oz, inv, dm.hz);
  int start[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int3 o = cell_offset<C>(c);
    const int cx = bx + o.x, cy = by + o.y, cz = bz + o.z;
    const bool in = active && cx >= 0 && cx < dm.dx && cy >= 0 && cy < dm.dy && cz >= 0 &&
                    cz < dm.dz;  // outside: the reference's overflow slot, which reads -1
    start[c] = in ? __ldg(&g.table[(cx * dm.dy + cy) * dm.dz + cz]) : -1;
  }
  // A block none of whose threads queries stops here; the barrier also ends the block's
  // use of the last query's stage.
  if (!__syncthreads_or(active)) return INFINITY;
  for (int j = t; j < S::kHash; j += kLoopThreads) sm.hash.key[j] = -1;
  if (t == 0) sm.nruns = 0;
  sm.q[0][t] = x;
  sm.q[1][t] = y;
  sm.q[2][t] = z;
  sm.qkey[t] = (bx << kKeyX) | (by << kKeyY) | bz;
  __syncthreads();
  int h[C], old[C];
  bool head[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sm.start[c][t] = start[c];
    const int prev = __shfl_up_sync(kFull, start[c], 1);  // every lane takes part
    head[c] = start[c] >= 0 && (lane == 0 || prev != start[c]);
    h[c] = hash_slot<S::kHashBits>(start[c]);
    old[c] = head[c] ? atomicCAS(&sm.hash.key[h[c]], -1, start[c]) : start[c];
  }
  int fills = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    while (head[c] && old[c] != -1 && old[c] != start[c]) {  // a collision: the next slot
      h[c] = (h[c] + 1) & (S::kHash - 1);
      old[c] = atomicCAS(&sm.hash.key[h[c]], -1, start[c]);
    }
    fills += head[c] && old[c] == -1;
  }
  // The runs this thread's heads filled slots for are numbered after the warp's lanes
  // before it, the warp's block of numbers drawn by one atomicAdd.
  int filled = fills;  // the warp's fills up to this lane
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kFull, filled, d);
    filled += lane >= d ? up : 0;
  }
  int id = 0;
  if (lane == 31) id = atomicAdd(&sm.nruns, filled);
  id = __shfl_sync(kFull, id, 31) + filled - fills;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (head[c] && old[c] == -1) {
      sm.hash.id[h[c]] = static_cast<unsigned short>(id);
      if (id < S::kRuns) sm.runs[id] = start[c];
      ++id;
    }
  }
  __syncthreads();
  // A lane takes its cell's run id from its group's head: the nearest head lane at or
  // before it (the lanes between name the same start).
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const unsigned heads = __ballot_sync(kFull, head[c]) & upto;
    const int from = heads ? 31 - __clz(heads) : lane;
    const int run = __shfl_sync(kFull, head[c] ? sm.hash.id[h[c]] : 0, from);
    sm.sid[c][t] = start[c] < 0 ? S::kNone : static_cast<unsigned short>(run);
  }
  const int total = sm.nruns;
  __syncthreads();  // the hash is read: its bytes take the staged rows
  copy_runs<B>(sm, g.packed, g.n, min(total, S::kRuns));
  __syncthreads();

  // The own cell, then the list of neighbour cells that can hold the first minimum.
  const unsigned long long own = scan_cell<C, B>(sm, g, t, kOwn, start[kOwn] >= 0);
  const float best = __uint_as_float(static_cast<unsigned>(own >> 32));
  const float cell = 1.0f / inv;
  unsigned wanted = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int3 o = cell_offset<C>(c);
    const float hx = face_gap(o.x, bx, x, ox, cell);
    const float hy = face_gap(o.y, by, y, oy, cell);
    const float hz = face_gap(o.z, bz, z, oz, cell);
    const float bound =
        __fadd_rn(__fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy)), __fmul_rn(hz, hz));
    if (c != kOwn && start[c] >= 0 && !(bound > best)) wanted |= 1u << c;
  }
  sm.best[t] = own;
  const int mine = __popc(wanted);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kFull, incl, d);
    incl += lane >= d ? up : 0;
  }
  if (lane == 31) sm.warp_total[warp] = incl;
  __syncthreads();
  int at = incl - mine, nwork = 0;
#pragma unroll
  for (int w = 0; w < kLoopWarps; ++w) {
    at += w < warp ? sm.warp_total[w] : 0;
    nwork += sm.warp_total[w];
  }
  for (; wanted; wanted &= wanted - 1) sm.work[at++] = t * 32 + __ffs(wanted) - 1;
  __syncthreads();
  for (int j0 = 0; j0 < nwork; j0 += kLoopThreads) {
    const int j = j0 + t;
    const int w = j < nwork ? sm.work[j] : 0;
    const unsigned long long b = scan_cell<C, B>(sm, g, w >> 5, w & 31, j < nwork);
    if (j < nwork) atomicMin(&sm.best[w >> 5], b);
  }
  __syncthreads();
  const unsigned long long b = sm.best[t];
  const float d2 = __uint_as_float(static_cast<unsigned>(b >> 32));
  const int flat = static_cast<int>(b & 0xffffffffu), c = flat / B;
  row = min(sm.start[c][t], g.n - B) + flat % B;
  return active ? d2 : INFINITY;
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

// An instantiation and the dynamic shared memory (its stage) a block of it takes.
struct Variant {
  const void* fn;
  int smem;
};

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
