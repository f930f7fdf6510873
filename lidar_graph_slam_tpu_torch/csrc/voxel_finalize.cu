// The NDT target build's voxel moments and finalize, and the batched symmetric 3x3
// eigensolve, for Hopper (sm_90a).
//
// Replaces what the JAX package leaves to XLA inside its jitted target build (it has no
// Pallas kernel for it): the moments of `_sorted_voxel_stats` and of the coarse merge, and
// `_finalize_ndt` with `regularize_covariance` and `_eigh3x3`
// (lidar_graph_slam_tpu/ops/voxel.py:257-298, :360-436, :300-339, :246-254, :182-245),
// compiled into the programs `build_ndt_map` / `build_ndt_pyramid` (`:341`, `:360`) and,
// through them, `odometry/fused.py:insert_and_rebuild`. The port's plain version
// (`ops/voxel.py:ndt_finalize_plain`) is ~1,100 ATen launches a level: the [N, 13] column
// block, `torch.segment_reduce` over the runs, and the unrolled Jacobi; here it is one
// launch a level, from the rows sorted by voxel key to the map's rows.
//
//  * `ndt_finalize_kernel<false>` (points mode, the fine level), a block of 8 warps for
//    16 consecutive voxel rows: its runs of sorted points are summed a warp a run, one
//    lane a column (the count, the local offsets p - corner, their 6 distinct products:
//    loc_i loc_j = loc_j loc_i exactly, so 6 sums give the 9), each warp taking the
//    block's next run when it finishes one. The warp stages its run in shared memory by
//    `cp.async` in rounds of 128 points, the next round in flight while it sums this one;
//    the whole warp first turns a round into (1, p - corner) rows, so a summing lane's
//    point is two shared loads, a multiply and an add. Each lane adds its column over the
//    run in the run's order from 0.0, as `torch.segment_reduce(initial=0.0)` sums the
//    plain version's columns. The invalid tail and the overflow segment past row C are
//    never read. (Earlier designs, on the dense ring's fine level on an H100: the block's
//    span of points staged in rounds for a thread a run, 1.85 ms — a round's points belong
//    to a few runs, so a few lanes summed while the block waited; three 10-lane groups a
//    warp, 0.62 ms — their runs diverge, so they take turns; a warp a run loading from
//    global memory, 0.33-0.54 ms; 32 rows and 16 warps a block, 64-point rounds, each
//    lane subtracting the corner itself, 81 us. `scripts/torch_finalize_variants.py`
//    times other block and stage shapes.)
//  * `ndt_finalize_kernel<true>` (merge mode, a coarse level): each coarse run sums the
//    fine level's moment rows it covers, in the coarse keys' sorted order, each first
//    shifted to the coarse voxel's corner (`ops/voxel.py:_merged_moments`); a thread a
//    run (a coarse voxel has at most 8 fine children), its rows gathered together.
//  * In both modes a block whose first row is unoccupied holds no occupied row (they are
//    a prefix): it stores the empty segment's rows and leaves, with nothing loaded.
//  * Then, in both modes: the local mean sums / max(n, 1), the world mean from the voxel
//    corner (origin + coord * resolution), the sample covariance (outer - (cnt m_i) m_j) /
//    max(n - 1, 1) on the upper triangle, valid = occupied and n >= min_points. The block's
//    valid rows are packed into full warps through shared memory and only those run the
//    Jacobi eigensolve (`eigh3x3.cuh`), the floor w_reg = max(w, 0.01 max(w_2, 1e-9)) and
//    the inverse V diag(1 / w_reg) V^T summed k = 0, 1, 2; every other row takes the
//    identity, which is what the eigensolve gives the identity bit for bit (a_pq = 0:
//    t = 0, c = 1, w = 1, V = I, the floor 0.01, the inverse I). The moments (seg_keys,
//    [C, 13] stats) and the map's rows (keys, means, inv_covs, valid, packed) are staged
//    in shared memory and written coalesced, the float rows as 16-byte stores.
//  * `eigh3x3_kernel`, one thread a matrix, 32 a block: w ascending and V (eigenvector
//    columns) of `_eigh3x3`, for the FPFH normals (8,192 matrices: 256 blocks over all
//    132 SMs).
//
// Bit-equal to the plain versions: each float operation is theirs, in their order,
// rounded once (`__f*_rn`, so nvcc contracts nothing into an FMA), from the same 0.0; no
// float atomics, since the map feeds the odometry loop. `resolution` is read on the
// device, so nothing waits on the host.
//
// What bounds it on this card. Not bytes: the fine level reads each point of the runs
// once (12 B), a key a run and the runs (16 B a row), and writes 173 B a row, ~20 MB on
// the dense ring, ~6 us at 3.35 TB/s. Not the copy's latency either: four stage slots
// time as two. A run's sum is one dependent chain of adds a column (its order is the
// plain version's), and a full ring's ground voxels hold thousands of points: the warp
// that sums the longest run pays a fixed cost a round (the wait, the warp syncs, the
// (1, p - corner) pass) and ~20 cycles a point, beside the other summing warps
// of its SM. The eigensolve's IEEE divides and square roots take issue slots only for
// the valid rows, packed into full warps. Tensor cores and TMA have nothing to offer a
// per-row 3x3 eigensolve. `eigh3x3` reads 36 B and writes 48 B a matrix, 0.21 us at the
// normals' 8,192; what bounds it there is one warp's dependent chain of rotations, not
// bytes or issue slots (`scripts/torch_eigh3x3_split.py` on the normals' inputs, one
// H100 at 700 W: a 1.80 us launch floor, 0.35 us of loads and stores and 3.19 us of one
// solved warp's 18 rotations make the 5.11 us launch; sweep 1, three general rotations,
// takes 0.74 us). The normals' 1,599 solved matrices already sit in 51 of the 256
// warps, so packing them into full warps would leave that chain as it is. What shortens
// it is the header's shortcuts: the converged rotations of sweeps 3-6 take no divide or
// root (10.24 -> 5.65 us at 256 threads a block). Fewer threads a block spread the
// launch over all SMs: 5.11 us at 32, 5.22 at 64 and 5.65 at 256, where 32 blocks on 32
// SMs take 1.84 us to load and store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "eigh3x3.cuh"

// `scripts/torch_eigh3x3_split.py` builds this file with -DLGS_EIGH_STEPS=-1..5 (the
// `eigh3x3_kernel`'s kSteps) and -DLGS_EIGH_THREADS to time a launch cut after each part.
#ifndef LGS_EIGH_STEPS
#define LGS_EIGH_STEPS 6
#endif
#ifndef LGS_EIGH_THREADS
#define LGS_EIGH_THREADS 32
#endif

namespace {

// Rows and threads a block of `ndt_finalize_kernel`: in points mode kPointRows rows and
// kPointThreads / 32 warps, a warp a run while summing (so a region of long runs spreads
// over many blocks), then a thread a row; in merge mode 128 rows, a thread a row
// throughout. A summing warp stages its run in rounds of kChunk points (a multiple of 4),
// kStages - 1 rounds in flight while it sums one.
constexpr int kPointRows = 16;
constexpr int kPointThreads = 256;
constexpr int kChunk = 128;
constexpr int kStages = 2;
constexpr int kMergeRows = 128, kMergeThreads = 128;
constexpr int kMergeBatch = 8;      // fine rows a merge-mode thread gathers at a time
// The points mode's stage, in dynamic shared memory: each warp's kStages rounds of xyz,
// then each warp's round as (1, p - corner) rows.
constexpr int kPointWarps = kPointThreads / 32;
constexpr int kStageBytes = kPointWarps * (kStages * 3 + 4) * kChunk * 4;
constexpr int kColumns = 10;        // a run's summing lanes: the count, 3 sums, 6 products
constexpr int kStats = 13;          // a row's moments: count | sums (3) | outer sums (9)
constexpr int kRowStride = 17;      // a staged output row: mean | inverse | valid | 0 0 0, + 1
constexpr int kEighThreads = LGS_EIGH_THREADS;
constexpr int kInvalidKey = 0x7fffffff;                 // ops/voxel.py:INVALID_KEY
constexpr int kEmptyKey = static_cast<int>(0x80000000);  // an empty segment's segment_max
constexpr float kPadValue = 1.0e6f;                     // core/pointcloud.py:PAD_VALUE

struct KeyBits {  // unpack_key: (key >> shift_x, (key >> shift_y) & mask_y, key & mask_z)
  int shift_x, shift_y, mask_y, mask_z;
};

struct Runs {  // voxel row r < C is keys[starts[r] .. starts[r] + lengths[r]) (sorted keys)
  const int* keys;
  const long long* starts;
  const long long* lengths;
  long long C;
};

struct Merge {  // a coarse level's source rows: the fine level's moments, in `order`
  const long long* order;
  const int* keys;          // fine seg_keys [C_f]
  const float* stats;       // fine moments [C_f, 13]
  const float* resolution;  // the fine level's, one f32 on the device
  int factor;
};

struct Level {  // outputs, fresh and contiguous
  int* seg_keys;
  float* stats;  // [C, 13]
  int* keys;
  float* means;
  float* inv_covs;
  uint8_t* valid;
  float4* packed;
};

template <int kR, int kT>
struct __align__(16) Shared {
  float stats[kR * kStats];     // the block's moments, as [rows, 13]
  float rows[kR * kRowStride];  // the block's map rows
  float cov[kR][6];             // the valid rows' covariances, packed
  int owner[kR];                // each packed covariance's row in the block
  int warp_valid[kT / 32];
  int next_run;                 // the next run a warp takes (points mode)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}

// A warp's copy of the sorted points [w, end) (w a multiple of 4, so 16-byte aligned in
// the [N, 3] rows; none where end <= w) into `dst` by cp.async, 16 bytes a copy and the
// tail a float at a time; committed as one group (an empty one where there is nothing).
__device__ __forceinline__ void stage_points(float* dst, const float* __restrict__ pts,
                                             long long w, long long end, int lane) {
  const float* src = pts + 3 * w;
  const int nf = end > w ? static_cast<int>(3 * (end - w)) : 0, groups = nf >> 2;
  for (int g = lane; g < groups; g += 32) cp_async16(dst + 4 * g, src + 4 * g);
  for (int f = 4 * groups + lane; f < nf; f += 32) cp_async4(dst + f, src + f);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void unpack(int key, KeyBits bits, int (&c)[3]) {
  c[0] = key >> bits.shift_x;
  c[1] = (key >> bits.shift_y) & bits.mask_y;
  c[2] = key & bits.mask_z;
}

// The point coordinates lane `col` of a warp multiplies: col 0 the count (no product),
// 1-3 the offsets (coordinate i times 1.0, exact), 4-9 the products 00 01 02 11 12 22.
__device__ __forceinline__ void column_axes(int col, int& i, int& j) {
  i = col == 0 ? 0 : col <= 3 ? col - 1 : col <= 6 ? 0 : col <= 8 ? 1 : 2;
  j = col <= 3 ? -1 : col <= 6 ? col - 4 : col <= 8 ? col - 6 : 2;
}

// The block's runs of sorted points summed into sm.stats ([rows, 13]: count, sums, the 9
// outer sums), each in its order from 0.0: a warp a run, one lane a column (lanes 10-31
// stage points and sum nothing: lanes of one warp on different runs would diverge and
// take turns); a warp takes the block's next run when it finishes one, so a long run
// (thousands of points in a ground voxel) holds one warp, not its block. The warp stages
// its run in rounds of kChunk points by cp.async into its kStages slots of `stage`, the
// next kStages - 1 rounds in flight while this one is summed. All 32 lanes first turn
// the round into (1, p - corner) rows of `loc`; then each summing lane adds the product
// of its two factors of each row, one dependent chain of adds, two shared loads, a
// multiply and an add a point.
template <typename S>
__device__ __forceinline__ void sum_points(S& sm, float* stage_all, const Runs& runs,
                                           const float* __restrict__ pts, long long r0,
                                           int nr, const float* __restrict__ origin, float res,
                                           KeyBits bits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane < kColumns ? lane : 0;
  int i, j;
  column_axes(col, i, j);
  // Lane col's factors of a row (1, l_0, l_1, l_2): the count 1 x 1, an offset l_i x 1, a
  // product l_i x l_j; a factor of 1 is exact, as the plain version's count and sums are.
  const int fa = col == 0 ? 0 : i + 1, fb = j < 0 ? 0 : j + 1;
  float* stage = stage_all + warp * kStages * 3 * kChunk;
  float4* loc = reinterpret_cast<float4*>(stage_all + kPointWarps * kStages * 3 * kChunk) +
                warp * kChunk;
  const float* locf = reinterpret_cast<const float*>(loc);
  // Every lane of a warp takes the same runs, lengths and rounds.
  for (int q = warp; q < nr;) {
    const long long s = runs.starts[r0 + q];
    const long long end = s + runs.lengths[r0 + q];
    float acc = 0.0f;
    if (end > s) {
      float corner[3];
      {
        int c[3];
        unpack(runs.keys[s], bits, c);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          corner[d] = __fadd_rn(origin[d], __fmul_rn(__int2float_rn(c[d]), res));
      }
      const long long w0 = s & ~3LL;
      const int rounds = static_cast<int>((end - w0 + kChunk - 1) / kChunk);
      // One group a round, rounds 0 .. kStages - 2 first; round k + kStages - 1 goes into
      // the slot that round k - 1 left, so round k is complete with kStages - 1 pending.
#pragma unroll
      for (int k = 0; k + 1 < kStages; ++k) {
        const long long w = w0 + static_cast<long long>(k) * kChunk;
        stage_points(stage + k * 3 * kChunk, pts, w, min(w + kChunk, end), lane);
      }
      for (int k = 0; k < rounds; ++k) {
        const long long w = w0 + static_cast<long long>(k) * kChunk;
        const int ahead = k + kStages - 1;
        const long long wa = w0 + static_cast<long long>(ahead) * kChunk;
        stage_points(stage + (ahead % kStages) * 3 * kChunk, pts, wa, min(wa + kChunk, end),
                     lane);
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
        __syncwarp();
        const float* buf = stage + (k % kStages) * 3 * kChunk;
        const int u0 = static_cast<int>(max(s, w) - w);
        const int u1 = static_cast<int>(min(w + kChunk, end) - w);
        for (int u = u0 + lane; u < u1; u += 32)
          loc[u] = make_float4(1.0f, __fsub_rn(buf[3 * u], corner[0]),
                               __fsub_rn(buf[3 * u + 1], corner[1]),
                               __fsub_rn(buf[3 * u + 2], corner[2]));
        __syncwarp();
#pragma unroll 8
        for (int u = u0; u < u1; ++u)
          acc = __fadd_rn(acc, __fmul_rn(locf[4 * u + fa], locf[4 * u + fb]));
        __syncwarp();  // the round is read before the next overwrites `loc` and its slot
      }
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the empty tail groups
    }
    if (lane < kColumns) {
      float* st = &sm.stats[kStats * q];
      if (col <= 3) {
        st[col] = acc;
      } else {
        st[4 + 3 * i + j] = acc;
        st[4 + 3 * j + i] = acc;
      }
    }
    int next = 0;
    if (lane == 0) next = atomicAdd(&sm.next_run, 1);
    q = __shfl_sync(0xffffffffu, next, 0);
  }
}

// Sums the fine rows order[s .. s + L) in order into acc, each shifted from its fine
// voxel's corner to its coarse voxel's: sums + n o, outer + o sums^T + sums o^T + n o o^T,
// in `_merged_moments`' order of operations. The rows are gathered kMergeBatch at a time
// (a factor-2 coarse voxel has at most 8 fine rows: one batch), their indices and then
// their keys and moments each loaded together, so a run waits two round trips a batch,
// not two a row.
__device__ __forceinline__ void sum_rows(const Merge& m, KeyBits bits, long long s,
                                         long long L, float (&acc)[kStats]) {
  const float res = *m.resolution;
#pragma unroll 1
  for (long long b = s; b < s + L; b += kMergeBatch) {
    const int nb = static_cast<int>(min(static_cast<long long>(kMergeBatch), s + L - b));
    long long f[kMergeBatch];
    int key[kMergeBatch];
    float row[kMergeBatch][kStats];
#pragma unroll
    for (int q = 0; q < kMergeBatch; ++q) f[q] = q < nb ? m.order[b + q] : 0;
#pragma unroll
    for (int q = 0; q < kMergeBatch; ++q) {
      if (q < nb) {
        key[q] = m.keys[f[q]];
#pragma unroll
        for (int k = 0; k < kStats; ++k) row[q][k] = m.stats[kStats * f[q] + k];
      }
    }
#pragma unroll
    for (int q = 0; q < kMergeBatch; ++q) {
      if (q < nb) {
        int c[3];
        unpack(key[q], bits, c);
        float off[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          off[d] = __fmul_rn(__int2float_rn(c[d] - (c[d] / m.factor) * m.factor), res);
        float* r = row[q];
        const float n = r[0];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j2 = 0; j2 < 3; ++j2)
            r[4 + 3 * i + j2] = __fadd_rn(
                __fadd_rn(__fadd_rn(r[4 + 3 * i + j2], __fmul_rn(off[i], r[1 + j2])),
                          __fmul_rn(r[1 + i], off[j2])),
                __fmul_rn(__fmul_rn(n, off[i]), off[j2]));
#pragma unroll
        for (int d = 0; d < 3; ++d) r[1 + d] = __fadd_rn(r[1 + d], __fmul_rn(n, off[d]));
#pragma unroll
        for (int k = 0; k < kStats; ++k) acc[k] = __fadd_rn(acc[k], r[k]);
      }
    }
  }
}

// dst[0 .. n) = get(i) by a block of kT threads, 16 bytes a store where it can (dst is
// 16-byte aligned).
template <int kT, typename Get>
__device__ __forceinline__ void store_coalesced(float* __restrict__ dst, int n, Get get) {
  const int quads = n >> 2;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < quads; q += kT)
    dst4[q] = make_float4(get(4 * q), get(4 * q + 1), get(4 * q + 2), get(4 * q + 3));
  for (int i = 4 * quads + threadIdx.x; i < n; i += kT) dst[i] = get(i);
}

// Rows [r0, r0 + nr), all unoccupied: the plain version's rows of an empty segment, with
// nothing loaded (seg_key INT32_MIN, zero moments, INVALID_KEY, PAD_VALUE means, the
// identity inverse, valid 0; the packed row mean | inverse | valid | 0 0 0).
template <int kT>
__device__ __forceinline__ void store_unoccupied(const Level& out, long long r0, int nr) {
  for (int i = threadIdx.x; i < nr; i += kT) {
    out.seg_keys[r0 + i] = kEmptyKey;
    out.keys[r0 + i] = kInvalidKey;
    out.valid[r0 + i] = 0;
  }
  store_coalesced<kT>(out.stats + kStats * r0, kStats * nr, [](int) { return 0.0f; });
  store_coalesced<kT>(out.means + 3 * r0, 3 * nr, [](int) { return kPadValue; });
  store_coalesced<kT>(out.inv_covs + 9 * r0, 9 * nr,
                      [](int i) { return i % 9 % 4 == 0 ? 1.0f : 0.0f; });
  store_coalesced<kT>(reinterpret_cast<float*>(out.packed + 4 * r0), 16 * nr, [](int i) {
    const int k = i % 16;
    return k < 3 ? kPadValue : k < 12 && (k - 3) % 4 == 0 ? 1.0f : 0.0f;
  });
}

template <bool kMerge, int kR = kMerge ? kMergeRows : kPointRows,
          int kT = kMerge ? kMergeThreads : kPointThreads>
__global__ void __launch_bounds__(kT)
ndt_finalize_kernel(Runs runs, const float* __restrict__ pts, Merge merge,
                    const float* __restrict__ origin, const float* __restrict__ resolution,
                    float min_points, KeyBits bits, Level out) {
  __shared__ Shared<kR, kT> sm;
  extern __shared__ __align__(16) float stage[];  // points mode: kStageBytes
  const long long r0 = static_cast<long long>(blockIdx.x) * kR;
  const int nr = static_cast<int>(min(static_cast<long long>(kR), runs.C - r0));
  // Occupied rows are a prefix (r < min(num_voxels, C)), so a block whose first row is
  // unoccupied holds none: it stores the constant rows and leaves (block-uniform).
  if (runs.lengths[r0] == 0) {
    store_unoccupied<kT>(out, r0, nr);
    return;
  }
  const int t = threadIdx.x;
  const bool has_row = t < nr;
  const long long r = r0 + t;
  const long long s = has_row ? runs.starts[r] : 0;
  const long long L = has_row ? runs.lengths[r] : 0;
  const bool occupied = L > 0;  // occupied rows are a prefix: r < min(num_voxels, C)
  const int key = occupied ? runs.keys[s] : kEmptyKey;
  const float res = *resolution;
  float corner[3];
  {
    int c[3];
    unpack(key, bits, c);
#pragma unroll
    for (int d = 0; d < 3; ++d)
      corner[d] = __fadd_rn(origin[d], __fmul_rn(__int2float_rn(c[d]), res));
  }

  // -- the run sums ------------------------------------------------------------------
  float acc[kStats];
  if constexpr (kMerge) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) acc[k] = 0.0f;
    sum_rows(merge, bits, s, L, acc);
    if (has_row) {
#pragma unroll
      for (int k = 0; k < kStats; ++k) sm.stats[kStats * t + k] = acc[k];
    }
  } else {
    if (t == 0) sm.next_run = kT / 32;
    __syncthreads();
    sum_points(sm, stage, runs, pts, r0, nr, origin, res, bits);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = has_row ? sm.stats[kStats * t + k] : 0.0f;

  // -- the row: mean, validity, covariance ----------------------------------------------
  const float n = acc[0];
  const float cnt = nan_max(n, 1.0f);
  const float ml[3] = {__fdiv_rn(acc[1], cnt), __fdiv_rn(acc[2], cnt), __fdiv_rn(acc[3], cnt)};
  const bool valid = occupied && n >= min_points;
  if (has_row) {
    float* row = &sm.rows[kRowStride * t];
#pragma unroll
    for (int d = 0; d < 3; ++d) row[d] = occupied ? __fadd_rn(corner[d], ml[d]) : kPadValue;
    row[12] = valid ? 1.0f : 0.0f;
    row[13] = row[14] = row[15] = 0.0f;
    if (!valid) {  // the identity, as the eigensolve and inverse give it for the identity
#pragma unroll
      for (int k = 0; k < 9; ++k) row[3 + k] = k % 4 == 0 ? 1.0f : 0.0f;
    }
  }

  // -- pack the valid rows into full warps -----------------------------------------------
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) sm.warp_valid[warp] = __popc(ballot);
  __syncthreads();
  int slot = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
  for (int w = 0; w < kT / 32; ++w) {
    slot += w < warp ? sm.warp_valid[w] : 0;
    total += sm.warp_valid[w];
  }
  if (valid) {
    const float den = nan_max(__fsub_rn(n, 1.0f), 1.0f);
    const auto cov = [&](int i, int j) {
      return __fdiv_rn(__fsub_rn(acc[4 + 3 * i + j], __fmul_rn(__fmul_rn(cnt, ml[i]), ml[j])),
                       den);
    };
    float* a = sm.cov[slot];
    a[0] = cov(0, 0);
    a[1] = cov(1, 1);
    a[2] = cov(2, 2);
    a[3] = cov(0, 1);
    a[4] = cov(0, 2);
    a[5] = cov(1, 2);
    sm.owner[slot] = t;
  }
  __syncthreads();

  // -- the eigensolve and the floored inverse, on the packed rows only -------------------
  if (t < total) {
    float a[6], w[3], v[3][3];
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = sm.cov[t][k];
    eigh3x3(a, w, v);
    const float floor_w = __fmul_rn(0.01f, nan_max(w[2], 1e-9f));
    float inv_w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) inv_w[k] = __frcp_rn(nan_max(w[k], floor_w));
    // inv[i][j] = sum_k (V[i][k] / w_k) V[j][k], with V[i][k] = v[k][i].
    float* dst = &sm.rows[kRowStride * sm.owner[t] + 3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dst[3 * i + j] = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(v[0][i], inv_w[0]), v[0][j]),
                      __fmul_rn(__fmul_rn(v[1][i], inv_w[1]), v[1][j])),
            __fmul_rn(__fmul_rn(v[2][i], inv_w[2]), v[2][j]));
  }
  __syncthreads();

  // -- the outputs --------------------------------------------------------------------
  if (has_row) {
    out.seg_keys[r] = key;
    out.keys[r] = occupied ? key : kInvalidKey;
    out.valid[r] = valid;
  }
  store_coalesced<kT>(out.stats + kStats * r0, kStats * nr, [&](int i) { return sm.stats[i]; });
  store_coalesced<kT>(out.means + 3 * r0, 3 * nr,
                  [&](int i) { return sm.rows[kRowStride * (i / 3) + i % 3]; });
  store_coalesced<kT>(out.inv_covs + 9 * r0, 9 * nr,
                  [&](int i) { return sm.rows[kRowStride * (i / 9) + 3 + i % 9]; });
  for (int q = t; q < 4 * nr; q += kT) {
    const float* src = &sm.rows[kRowStride * (q >> 2) + 4 * (q & 3)];
    out.packed[4 * r0 + q] = make_float4(src[0], src[1], src[2], src[3]);
  }
}

// kSteps < 0: return at once (the launch floor); 0: load and store, w = the diagonal and V
// = I; 1-6: that many sweeps (6 is the kernel).
template <int kSteps>
__global__ void __launch_bounds__(kEighThreads)
eigh3x3_kernel(const float* __restrict__ A, long long M, float* __restrict__ w_out,
               float* __restrict__ V_out) {
  const long long r = static_cast<long long>(blockIdx.x) * kEighThreads + threadIdx.x;
  if (kSteps < 0 || r >= M) return;
  const float* m = A + 9 * r;
  float a[6] = {m[0], m[4], m[8], m[1], m[2], m[5]};
  float w[3], v[3][3];
  eigh3x3<(kSteps < 0 ? 0 : kSteps)>(a, w, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) w_out[3 * r + k] = w[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) V_out[9 * r + 3 * i + j] = v[j][i];
}

unsigned int blocks(long long rows, int per_block) {
  return static_cast<unsigned int>((rows + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// One launch on `stream` over C >= 1 voxel rows of one level. keys: [N] i32 sorted keys;
// starts, lengths: [C + 1] i64 runs (row r = keys[starts[r] .. + lengths[r]); the
// overflow run C is not read). Points mode (merge_order null): pts [N, 3] f32, 16-byte
// aligned. Merge mode: merge_order [N] i64 (the fine rows in the runs' order), fine_keys
// [C_f] i32, fine_stats [C_f, 13] f32, fine_resolution one f32 on the device, factor.
// origin: [3] f32; resolution: one f32 on the device. Outputs (fresh, contiguous, 16-byte
// aligned): seg_keys [C] i32, stats [C, 13] f32, keys_out [C] i32, means [C, 3], inv_covs
// [C, 3, 3], valid [C] u8, packed [C, 16] f32. Returns cudaGetLastError() after the
// launch (0 = success).
int lgs_ndt_finalize(const int* keys, const long long* starts, const long long* lengths,
                     long long C, const float* pts, const long long* merge_order,
                     const int* fine_keys, const float* fine_stats,
                     const float* fine_resolution, int factor, const float* origin,
                     const float* resolution, float min_points, int shift_x, int shift_y,
                     int mask_y, int mask_z, int* seg_keys, float* stats, int* keys_out,
                     float* means, float* inv_covs, uint8_t* valid, float* packed,
                     void* stream) {
  const Runs runs{keys, starts, lengths, C};
  const Merge merge{merge_order, fine_keys, fine_stats, fine_resolution, factor};
  const KeyBits bits{shift_x, shift_y, mask_y, mask_z};
  const Level out{seg_keys, stats, keys_out, means, inv_covs, valid,
                  reinterpret_cast<float4*>(packed)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (merge_order != nullptr)
    ndt_finalize_kernel<true><<<blocks(C, kMergeRows), kMergeThreads, 0, s>>>(
        runs, pts, merge, origin, resolution, min_points, bits, out);
  else {
    // The stage may pass the 48 KB a block gets without asking (this device's context).
    const cudaError_t e = cudaFuncSetAttribute(
        ndt_finalize_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ndt_finalize_kernel<false><<<blocks(C, kPointRows), kPointThreads, kStageBytes, s>>>(
        runs, pts, merge, origin, resolution, min_points, bits, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch on `stream` over M >= 1 matrices: A [M, 3, 3] f32 (its upper triangle is
// read); w [M, 3] ascending, V [M, 3, 3] with eigenvector columns.
int lgs_eigh3x3(const float* A, long long M, float* w, float* V, void* stream) {
  eigh3x3_kernel<LGS_EIGH_STEPS><<<blocks(M, kEighThreads), kEighThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(A, M, w, V);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
