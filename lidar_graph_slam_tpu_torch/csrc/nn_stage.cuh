// The grid nearest-neighbour query of the loop kernels that match points (`gicp_iteration`
// in `gicp_loop.cu`, `icp_iteration` and `icp_fitness` in `icp_loop.cu`): the device side
// of `ops/neighbors.py:nearest` (the port of lidar_graph_slam_tpu/ops/neighbors.py:103-177,
// `_candidate_scan` + `nearest`) at C = 7 or 27 cells and bucket_cap B = 16 or 32, a tile
// of kLoopThreads queries at a time. `stage_nearest` stages the tile's distinct cell runs
// in dynamic shared memory once (`Stage`), scans each point's own cell, then the
// neighbour cells a face bound cannot rule out; its result is the plain version's (the
// first minimum over the flattened candidates, d2 in its float32 operations and order).
// `gicp_loop.cu`'s header says what bounds it and how it was designed.

#pragma once

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

// An instantiation and the dynamic shared memory (its stage) a block of it takes.
struct Variant {
  const void* fn;
  int smem;
};

}  // namespace
