// The prefilter's passes around its two sorts for Hopper (sm_90a): the cell keys (with
// the distance filter), the sorted runs, the outlier filter's threshold and the
// compaction.
//
// Replaces what the JAX package leaves to XLA inside its jitted prefilter
// (lidar_graph_slam_tpu/filters/prefilter.py:88-119; it has no Pallas kernel for any of
// it), which XLA fuses into a few passes around its two `lax.sort`s. The port ran each as
// a chain of torch operators (~105 launches a call). The sorts stay the library's radix
// sort (`torch.sort(stable=True)`).
//
//  * `cell_keys` ports `min_corner`, `voxel_coords`, `pack_key` and the INVALID_KEY
//    `where` (lidar_graph_slam_tpu/ops/voxel.py:79-97,114-116, ops/neighbors.py:70-73),
//    and with the filter on the prefilter's distance filter and crop with the pad of the
//    rows they drop (filters/prefilter.py:27-40,114-116). Two launches: the first filters
//    (a thread a quad: r = sqrt((x x + y y) + z z) rounded once, r > min_distance, the
//    crop, the mask and the padded row written) and writes its block's minimum corner of
//    the kept rows; the second reduces the G block minima in every block (a minimum is
//    exact in any order; NaN propagates as torch's amin does), takes origin = corner -
//    leaf and 1 / leaf correctly rounded, and writes each row's clamped packed key. No
//    scratch needs clearing: every block of the first launch writes its row of minima.
//  * `sorted_runs` ports the gather of the sorted points and `_sorted_runs` (the
//    first-of-run flags, their cumsum, the clamp, the searchsorted of C + 2 queries and
//    the difference) with `num_voxels`, or alone the gather and pad of the SOR's sort
//    (ops/neighbors.py:81). The first launch gathers and writes each block's record:
//    its first-of-run rows, its valid rows and its last first-of-run row. The second
//    reads all G records in every block (the firsts before the block, the totals, the
//    run the block begins inside), scans the block's rows (a row's run index and its
//    run's first row), and a run's first row writes its start, its last row its length;
//    the rows past the last voxel, up to C, are filled by all blocks (start = the valid
//    rows, length 0; row C takes the invalid rows and every voxel past C).
//
//    Both take 4 consecutive rows (a quad) a thread: one 16-byte load of keys, three of
//    xyz. The first launch lets the second start at once
//    (`griddepcontrol.launch_dependents`); the second, a programmatic dependent, loads its
//    quad (only the call's inputs: the filter is found again from the raw rows) before
//    `griddepcontrol.wait` and reads the records after it, so its launch and its loads
//    overlap the first. One launch of thread-block clusters exchanging the blocks'
//    partials through distributed shared memory was slower at every shape of the path on
//    the H100: a cluster's two barriers cost ~1.7 us over a plain launch, more than the
//    second launch here (`scripts/torch_cluster_floor.py`, PERF.md).
//  * `sor_threshold` ports the tail of `statistical_outlier_mask` (filters/
//    prefilter.py:66-73): has_neighbors, contributes, n_total, mu, the variance, the
//    threshold, the mask and the `pad_points` after it. Three launches: mu's partials,
//    the variance's (each block recomputes mu from the partials), the mask (each block
//    recomputes the threshold). Each block sums its kSumRows rows as a tree (x[i] +=
//    x[i + h], h = kSumRows / 2 .. 1, the rows past N adding 0.0), then the block
//    partials are added in index order from 0.0 by one thread; no float atomics.
//    `ops/neighbors.py:sor_threshold_plain` sums in the same order (its SOR_SUM_ROWS is
//    kSumRows).
//  * `compact_rows` ports `compact` (core/pointcloud.py:67-78): a stable partition, the
//    valid rows to the front in their order, the first `capacity` of them kept, the
//    other output rows PAD_VALUE and false. The first launch counts each block's valid
//    rows; the second scans them (the counts of the blocks before it, then the block's
//    own) and scatters the kept rows, and all blocks fill the rows past the valid count.
//
// Every pass takes kRows = 1,024 consecutive rows a block of 256 threads, in 4 tiles of
// 256 (a thread a row a tile, coalesced; `cell_keys` and `sorted_runs` a quad a thread).
// Bit-equal to the plain versions: the keys, runs, counts and copies are integer or
// copied words, and each float operation is the plain version's, in its order, rounded
// once (`__f*_rn`, so nvcc contracts nothing into an FMA). Nothing is read back, nothing
// but the given buffers is written, and no scratch carries state from one launch to the
// next call, so a call captures into a CUDA graph and two graphs replaying at once share
// nothing.
//
// What bounds them on this card: bytes. `cell_keys` reads 13 B a row twice and writes 4 B
// (and with the filter 13 B more); `sorted_runs` reads a key (and its neighbours, from
// the same lines) twice and with the gather an order (8 B) and a point (12 B) and writes
// 12 B, and 16 B a voxel row; `sor_threshold` reads 13 B a row three times and writes 13
// B; `compact_rows` reads a mask twice and a kept row's point, and writes 13 B an output
// row: each under ~2 us at 3.35 TB/s on the dense bucket's 131,072 rows, so a launch is
// its floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;  // ops/voxel.py:INVALID_KEY
constexpr float kPadValue = 1.0e6f;      // core/pointcloud.py:PAD_VALUE
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 4;
constexpr int kRows = kThreads * kTiles;  // rows a block (ops/neighbors.py:SOR_SUM_ROWS)
constexpr unsigned kFullMask = 0xffffffffu;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>(n <= 0 ? 1 : (n + kRows - 1) / kRows);
}

struct Filter {  // the prefilter's distance filter and crop
  float min_distance, max_distance;
  int use_max, use_crop;
  float lo[3], hi[3];
};

struct KeyBits {  // pack_key's shifts and voxel_coords' clamp
  int shift_x, shift_y;
  int max_c[3];
};

// torch's amin: the smaller, and NaN wherever one takes part.
__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || v != v) ? v : m;
}

__device__ __forceinline__ void warp_min3(float (&m)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[a] = nan_min(m[a], __shfl_xor_sync(kFullMask, m[a], off));
}

// The block's minimum corner into `out` (every thread calls it; the result in out).
__device__ void block_min3(float (&m)[3], float (*red)[kWarps], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_min3(m);
  if (lane == 0)
    for (int a = 0; a < 3; ++a) red[a][warp] = m[a];
  __syncthreads();
  if (threadIdx.x < 3) {
    float v = red[threadIdx.x][0];
    for (int w = 1; w < kWarps; ++w) v = nan_min(v, red[threadIdx.x][w]);
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

// Inclusive prefix sum of v over the block's threads; `total` gets the block's sum.
__device__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return v + before;
}

// Over the block's threads: the exclusive prefix sum of a and the exclusive prefix
// maximum of b (-1 before the first thread).
__device__ void block_scan_sum_max(int a, int b, int (*warp_tot)[kWarps], int& excl_a,
                                   int& excl_b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sa = a, sb = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(kFullMask, sa, off);
    const int ub = __shfl_up_sync(kFullMask, sb, off);
    if (lane >= off) {
      sa += ua;
      sb = max(sb, ub);
    }
  }
  const int prev_b = __shfl_up_sync(kFullMask, sb, 1);
  if (lane == 31) {
    warp_tot[0][warp] = sa;
    warp_tot[1][warp] = sb;
  }
  __syncthreads();
  excl_a = sa - a;
  excl_b = lane > 0 ? prev_b : -1;
  for (int w = 0; w < warp; ++w) {
    excl_a += warp_tot[0][w];
    excl_b = max(excl_b, warp_tot[1][w]);
  }
}

// Sums (and with `kMax`, the max of the third) of up to 4 per-thread values over the
// block, into out[0..3] (every thread calls it).
__device__ void block_totals(long long (&v)[4], long long* red /*[4][kWarps]*/,
                             long long* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v[0] += __shfl_xor_sync(kFullMask, v[0], off);
    v[1] += __shfl_xor_sync(kFullMask, v[1], off);
    v[2] += __shfl_xor_sync(kFullMask, v[2], off);
    v[3] = max(v[3], __shfl_xor_sync(kFullMask, v[3], off));
  }
  if (lane == 0)
    for (int q = 0; q < 4; ++q) red[q * kWarps + warp] = v[q];
  __syncthreads();
  if (threadIdx.x < 4) {
    long long t = red[threadIdx.x * kWarps];
    for (int w = 1; w < kWarps; ++w) {
      const long long u = red[threadIdx.x * kWarps + w];
      t = threadIdx.x == 3 ? max(t, u) : t + u;
    }
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// The rows 4q .. 4q + 3 below n of a [n, 3] f32 array: three 16-byte loads when the whole
// quad lies below n and `vec` (every array 16-byte aligned), else a scalar load a value.
__device__ __forceinline__ void load_xyz4(const float* __restrict__ pts, long long q,
                                          long long n, bool vec, float (&x)[4],
                                          float (&y)[4], float (&z)[4]) {
  const long long r0 = 4 * q;
  if (vec && r0 + 3 < n) {
    const float4* p = reinterpret_cast<const float4*>(pts + 3 * r0);
    const float4 a = p[0], b = p[1], c = p[2];
    x[0] = a.x; y[0] = a.y; z[0] = a.z; x[1] = a.w;
    y[1] = b.x; z[1] = b.y; x[2] = b.z; y[2] = b.w;
    z[2] = c.x; x[3] = c.y; y[3] = c.z; z[3] = c.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long i = r0 + r;
      x[r] = i < n ? pts[3 * i] : 0.0f;
      y[r] = i < n ? pts[3 * i + 1] : 0.0f;
      z[r] = i < n ? pts[3 * i + 2] : 0.0f;
    }
  }
}

// Stores rows 4q .. 4q + 3 below n of a [n, 3] f32 array, as `load_xyz4` loads them.
__device__ __forceinline__ void store_xyz4(float* __restrict__ out, long long q, long long n,
                                           bool vec, const float (&x)[4],
                                           const float (&y)[4], const float (&z)[4]) {
  const long long r0 = 4 * q;
  if (vec && r0 + 3 < n) {
    float4* p = reinterpret_cast<float4*>(out + 3 * r0);
    p[0] = make_float4(x[0], y[0], z[0], x[1]);
    p[1] = make_float4(y[1], z[1], x[2], y[2]);
    p[2] = make_float4(z[2], x[3], y[3], z[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long i = r0 + r;
      if (i < n) {
        out[3 * i] = x[r];
        out[3 * i + 1] = y[r];
        out[3 * i + 2] = z[r];
      }
    }
  }
}

// -- cell_keys -----------------------------------------------------------------------

// Quad q's points and its kept rows (bit r: row 4q + r kept): the mask and, with kFilter,
// the distance filter and crop.
template <bool kFilter>
__device__ __forceinline__ unsigned load_kept4(
    const float* __restrict__ pts, const uint8_t* __restrict__ mask, long long n,
    const Filter& f, bool vec, long long q, float (&x)[4], float (&y)[4], float (&z)[4]) {
  const long long r0 = 4 * q;
  load_xyz4(pts, q, n, vec, x, y, z);
  unsigned m4;
  if (vec && r0 + 3 < n) {
    m4 = *reinterpret_cast<const uint32_t*>(mask + r0);
  } else {
    m4 = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < n) m4 |= static_cast<unsigned>(mask[r0 + r]) << (8 * r);
  }
  unsigned kept = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    bool keep = r0 + r < n && ((m4 >> (8 * r)) & 0xffu) != 0;
    if (kFilter) {
      const float rr = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x[r], x[r]),
                                                      __fmul_rn(y[r], y[r])),
                                            __fmul_rn(z[r], z[r])));
      keep = keep && rr > f.min_distance && (!f.use_max || rr < f.max_distance);
      if (f.use_crop)
        keep = keep && x[r] >= f.lo[0] && y[r] >= f.lo[1] && z[r] >= f.lo[2] &&
               x[r] <= f.hi[0] && y[r] <= f.hi[1] && z[r] <= f.hi[2];
    }
    kept |= static_cast<unsigned>(keep) << r;
  }
  return kept;
}

// The filter's outputs of quad q: the kept mask and the points, PAD_VALUE where not kept.
__device__ __forceinline__ void store_kept4(long long q, long long n, bool vec, unsigned kept,
                                            const float (&x)[4], const float (&y)[4],
                                            const float (&z)[4], uint8_t* __restrict__ mask_out,
                                            float* __restrict__ pts_out) {
  const long long r0 = 4 * q;
  float px[4], py[4], pz[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool keep = (kept >> r) & 1u;
    px[r] = keep ? x[r] : kPadValue;
    py[r] = keep ? y[r] : kPadValue;
    pz[r] = keep ? z[r] : kPadValue;
  }
  store_xyz4(pts_out, q, n, vec, px, py, pz);
  if (vec && r0 + 3 < n) {
    *reinterpret_cast<uint32_t*>(mask_out + r0) =
        (kept & 1u) | ((kept >> 1) & 1u) << 8 | ((kept >> 2) & 1u) << 16 |
        ((kept >> 3) & 1u) << 24;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < n) mask_out[r0 + r] = (kept >> r) & 1u;
  }
}

__device__ __forceinline__ void min_kept4(float (&m)[3], unsigned kept, const float (&x)[4],
                                          const float (&y)[4], const float (&z)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if ((kept >> r) & 1u) {
      m[0] = nan_min(m[0], x[r]);
      m[1] = nan_min(m[1], y[r]);
      m[2] = nan_min(m[2], z[r]);
    }
}

// The clamped packed keys of quad q (INVALID_KEY where not kept), stored.
__device__ __forceinline__ void store_keys4(int* __restrict__ keys, long long q, long long n,
                                            bool vec, unsigned kept, const float (&x)[4],
                                            const float (&y)[4], const float (&z)[4],
                                            const float (&org)[3], float inv,
                                            const KeyBits& kb) {
  int key[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float p[3] = {x[r], y[r], z[r]};
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // floor((p - origin) * inv).to(int32), clamped to [0, COORD_MAX]; the conversion
      // saturates, as torch's on the card.
      const float u = __fmul_rn(__fsub_rn(p[a], org[a]), inv);
      c[a] = min(max(__float2int_rz(floorf(u)), 0), kb.max_c[a]);
    }
    key[r] = ((kept >> r) & 1u) ? (c[0] << kb.shift_x) | (c[1] << kb.shift_y) | c[2]
                                : kInvalidKey;
  }
  const long long r0 = 4 * q;
  if (vec && r0 + 3 < n) {
    *reinterpret_cast<int4*>(keys + r0) = make_int4(key[0], key[1], key[2], key[3]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < n) keys[r0 + r] = key[r];
  }
}

// -- sorted_runs ---------------------------------------------------------------------

// Quad q's first-of-run rows (bit r: row 4q + r) into `first`, its last-of-run rows into
// `last`; returns its valid rows. A valid row is a row below n whose key is not
// INVALID_KEY; it is the first of its run at row 0 or after another key, the last at
// row n - 1 or before another key.
__device__ __forceinline__ int run_flags4(const int* __restrict__ keys, long long q,
                                          long long n, bool vec, unsigned& first,
                                          unsigned& last) {
  const long long r0 = 4 * q;
  int k[6];  // the keys of rows r0 - 1 .. r0 + 4 (INVALID_KEY past either end)
  k[0] = r0 > 0 ? keys[r0 - 1] : kInvalidKey;
  if (vec && r0 + 3 < n) {
    const int4 v = *reinterpret_cast<const int4*>(keys + r0);
    k[1] = v.x; k[2] = v.y; k[3] = v.z; k[4] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) k[r + 1] = r0 + r < n ? keys[r0 + r] : kInvalidKey;
  }
  k[5] = r0 + 4 < n ? keys[r0 + 4] : kInvalidKey;
  first = last = 0;
  int valid = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long i = r0 + r;
    const bool v = i < n && k[r + 1] != kInvalidKey;
    valid += v;
    first |= static_cast<unsigned>(v && (i == 0 || k[r] != k[r + 1])) << r;
    last |= static_cast<unsigned>(v && (i == n - 1 || k[r + 2] != k[r + 1])) << r;
  }
  return valid;
}

// pts_out rows 4q .. 4q + 3 below n = pts[order[row]]; with kPad, PAD_VALUE where the
// row's key is INVALID_KEY (the SOR's cell sort).
template <bool kPad>
__device__ __forceinline__ void gather4(const int* __restrict__ keys,
                                        const long long* __restrict__ order,
                                        const float* __restrict__ pts, long long q,
                                        long long n, bool vec, float* __restrict__ pts_out) {
  const long long r0 = 4 * q;
  long long o[4];
  if (vec && r0 + 3 < n) {
    const longlong2 a = reinterpret_cast<const longlong2*>(order + r0)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(order + r0)[1];
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r] = r0 + r < n ? order[r0 + r] : 0;
  }
  int k[4] = {0, 0, 0, 0};
  if (kPad) {
    if (vec && r0 + 3 < n) {
      const int4 v = *reinterpret_cast<const int4*>(keys + r0);
      k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) k[r] = r0 + r < n ? keys[r0 + r] : 0;
    }
  }
  float x[4], y[4], z[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool live = r0 + r < n && !(kPad && k[r] == kInvalidKey);
    x[r] = live ? pts[3 * o[r]] : kPadValue;
    y[r] = live ? pts[3 * o[r] + 1] : kPadValue;
    z[r] = live ? pts[3 * o[r] + 2] : kPadValue;
  }
  store_xyz4(pts_out, q, n, vec, x, y, z);
}

// The gather alone (C < 0): a thread a quad over a full grid of kThreads-thread blocks.
__global__ void __launch_bounds__(kThreads)
gather_pad_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                  const float* __restrict__ pts, long long n, int vec_i,
                  float* __restrict__ pts_out) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (4 * q < n) gather4<true>(keys, order, pts, q, n, vec_i != 0, pts_out);
}

// The block's quads: each thread's quad q (first / last bits f4, l4; none past n) writes
// the starts and lengths of its rows' runs; `run` is the runs before the block and
// `start` the latest first-of-run row before it (-1: none).
__device__ __forceinline__ void write_runs(unsigned f4, unsigned l4, long long q, long long n,
                                           long long C, int (*scan_tot)[kWarps],
                                           long long run, int start,
                                           long long* __restrict__ starts,
                                           long long* __restrict__ lengths) {
  const int last_first = f4 ? static_cast<int>(4 * q) + 31 - __clz(f4) : -1;
  int excl_runs, excl_start;
  block_scan_sum_max(__popc(f4), last_first, scan_tot, excl_runs, excl_start);
  long long seg = run + excl_runs - 1;  // the run of the row before the quad
  int st = max(start, excl_start);      // its first row
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long i = 4 * q + r;
    if ((f4 >> r) & 1u) {
      ++seg;
      st = static_cast<int>(i);
      if (seg < C) {
        starts[seg] = i;
      } else if (seg == C) {  // the first voxel past C opens the overflow run
        starts[C] = i;
        lengths[C] = n - i;
      }
    }
    if (((l4 >> r) & 1u) && seg < C) lengths[seg] = i + 1 - st;
  }
}

// The keys' first launch over a full grid of kThreads threads a block, a quad a thread:
// each block's corner into rec[3 * block] (with kFilter the kept mask and padded points
// written). It lets the second launch start at once.
template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
cell_corner_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                   long long n, Filter f, int vec_i, uint8_t* __restrict__ mask_out,
                   float* __restrict__ pts_out, float* __restrict__ rec) {
  __shared__ float red[3][kWarps];
  __shared__ float part[3];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const bool vec = vec_i != 0;
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float m[3] = {kPadValue, kPadValue, kPadValue};
  if (4 * q < n) {
    float x[4], y[4], z[4];
    const unsigned kept = load_kept4<kFilter>(pts, mask, n, f, vec, q, x, y, z);
    if (kFilter) store_kept4(q, n, vec, kept, x, y, z, mask_out, pts_out);
    min_kept4(m, kept, x, y, z);
  }
  block_min3(m, red, part);
  if (threadIdx.x < 3) rec[3 * static_cast<long long>(blockIdx.x) + threadIdx.x] =
      part[threadIdx.x];
}

// The keys' second launch, a programmatic dependent of the first: its quad (the raw rows,
// the filter found again) read before `griddepcontrol.wait`, the G = gridDim.x corners
// after it.
template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
cell_keys_pair_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                      long long n, Filter f, int vec_i, const float* __restrict__ leaf_p,
                      KeyBits kb, const float* __restrict__ rec, int* __restrict__ keys,
                      float* __restrict__ origin_out) {
  __shared__ float red[3][kWarps];
  __shared__ float corner[3];
  const bool vec = vec_i != 0;
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float x[4], y[4], z[4];
  const unsigned kept = 4 * q < n ? load_kept4<kFilter>(pts, mask, n, f, vec, q, x, y, z) : 0u;
  const float leaf = *leaf_p;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the corners written
  float m[3] = {kPadValue, kPadValue, kPadValue};
  for (long long g = threadIdx.x; g < gridDim.x; g += kThreads) {
    m[0] = nan_min(m[0], rec[3 * g]);
    m[1] = nan_min(m[1], rec[3 * g + 1]);
    m[2] = nan_min(m[2], rec[3 * g + 2]);
  }
  block_min3(m, red, corner);
  const float inv = __fdiv_rn(1.0f, leaf);
  const float org[3] = {__fsub_rn(corner[0], leaf), __fsub_rn(corner[1], leaf),
                        __fsub_rn(corner[2], leaf)};
  if (blockIdx.x == 0 && threadIdx.x < 3) origin_out[threadIdx.x] = org[threadIdx.x];
  if (4 * q < n) store_keys4(keys, q, n, vec, kept, x, y, z, org, inv, kb);
}

// The runs' first launch over a full grid of kThreads threads a block, a quad a thread
// (with kGather the gather): each block's record (first-of-run rows, valid rows, its last
// first-of-run row) into rec[3 * block]. It lets the second launch start at once.
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
runs_record_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                   const float* __restrict__ pts, long long n, int vec_i,
                   float* __restrict__ pts_out, int* __restrict__ rec) {
  __shared__ long long red[4 * kWarps];
  __shared__ long long tot[4];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const bool vec = vec_i != 0;
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned f4 = 0, l4 = 0;
  int valid = 0;
  if (4 * q < n) {
    valid = run_flags4(keys, q, n, vec, f4, l4);
    if (kGather) gather4<false>(keys, order, pts, q, n, vec, pts_out);
  }
  long long v[4] = {__popc(f4), valid, 0, f4 ? 4 * q + 31 - __clz(f4) : -1};
  block_totals(v, red, tot);
  if (threadIdx.x == 0) {
    rec[3 * static_cast<long long>(blockIdx.x)] = static_cast<int>(tot[0]);
    rec[3 * static_cast<long long>(blockIdx.x) + 1] = static_cast<int>(tot[1]);
    rec[3 * static_cast<long long>(blockIdx.x) + 2] = static_cast<int>(tot[3]);
  }
}

// The runs' second launch, a programmatic dependent of the first: its quad's flags read
// before `griddepcontrol.wait`, the G = gridDim.x records after it (the firsts before the
// block, all firsts, all valid rows, the last first-of-run row before the block); then
// the starts and lengths and the block's share of the fill.
__global__ void __launch_bounds__(kThreads)
runs_write_kernel(const int* __restrict__ keys, long long n, long long C, int vec_i,
                  const int* __restrict__ rec, long long* __restrict__ starts,
                  long long* __restrict__ lengths, long long* __restrict__ num_voxels) {
  __shared__ long long red[4 * kWarps];
  __shared__ long long tot[4];
  __shared__ int scan_tot[2][kWarps];
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned f4 = 0, l4 = 0;
  if (4 * q < n) run_flags4(keys, q, n, vec_i != 0, f4, l4);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the records written
  long long w[4] = {0, 0, 0, -1};
  for (long long g = threadIdx.x; g < gridDim.x; g += kThreads) {
    const long long firsts = rec[3 * g];
    w[1] += firsts;
    w[2] += rec[3 * g + 1];
    if (g < blockIdx.x) {
      w[0] += firsts;
      w[3] = max(w[3], static_cast<long long>(rec[3 * g + 2]));
    }
  }
  block_totals(w, red, tot);
  const long long nv = tot[1], nvalid = tot[2];
  write_runs(f4, l4, q, n, C, scan_tot, tot[0], static_cast<int>(tot[3]), starts,
             lengths);
  if (nv <= C) {  // rows nv .. C: empty, and row C the invalid rows
    for (long long r = nv + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         r <= C; r += static_cast<long long>(gridDim.x) * kThreads) {
      starts[r] = nvalid;
      lengths[r] = r == C ? n - nvalid : 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *num_voxels = nv;
}

// -- sor_threshold -------------------------------------------------------------------

// The tree sum of the block's kRows values (thread t holds rows t, t + 256, t + 512 and
// t + 768 of the block): x[i] + x[i + h] for h = 512, 256, ..., 1. Thread 0 gets it.
__device__ float block_tree_sum(const float (&x)[kTiles], float* sm) {
  const int tid = threadIdx.x;
  const float s = __fadd_rn(__fadd_rn(x[0], x[2]), __fadd_rn(x[1], x[3]));  // h = 512, 256
  sm[tid] = s;
  __syncthreads();
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (tid < h) sm[tid] = __fadd_rn(sm[tid], sm[tid + h]);
    __syncthreads();
  }
  float v = 0.0f;
  if (tid < 32) {
    v = sm[tid];
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFullMask, v, h));
  }
  return v;
}

// Pass 0: mu's block partials and the contributing rows; pass 1: the variance's partials;
// pass 2: the mask and the padded rows.
template <int kPass>
__global__ void __launch_bounds__(kThreads)
sor_threshold_kernel(const float* __restrict__ mean_d, const long long* __restrict__ n_found,
                     const uint8_t* __restrict__ mask, const float* __restrict__ pts,
                     long long n, long long G, const float* __restrict__ stddev_p,
                     float* __restrict__ partials, int* __restrict__ counts,
                     uint8_t* __restrict__ mask_out, float* __restrict__ pts_out) {
  __shared__ float sm[kThreads];
  __shared__ float mu_thresh[2];
  __shared__ int count_red[kWarps];
  if (kPass > 0) {
    if (threadIdx.x == 0) {
      long long contributing = 0;
      float sum = 0.0f;
      for (long long g = 0; g < G; ++g) {  // the block partials in index order
        contributing += counts[g];
        sum = __fadd_rn(sum, partials[g]);
      }
      const float n_total = __int2float_rn(static_cast<int>(max(contributing, 1LL)));
      const float mu = __fdiv_rn(sum, n_total);
      mu_thresh[0] = mu;
      if (kPass == 2) {
        float sq = 0.0f;
        for (long long g = 0; g < G; ++g) sq = __fadd_rn(sq, partials[G + g]);
        const float var = __fdiv_rn(sq, n_total);
        mu_thresh[1] = __fadd_rn(mu, __fmul_rn(*stddev_p, __fsqrt_rn(var)));
      }
    }
    __syncthreads();
  }
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  if (kPass == 2) {
    const float thresh = mu_thresh[1];
    for (int t = 0; t < kTiles; ++t) {
      const long long i = b0 + t * kThreads + threadIdx.x;
      if (i >= n) break;
      const bool out = mask[i] && n_found[i] >= 2 && mean_d[i] <= thresh;
      mask_out[i] = out;
#pragma unroll
      for (int a = 0; a < 3; ++a) pts_out[3 * i + a] = out ? pts[3 * i + a] : kPadValue;
    }
    return;
  }
  float x[kTiles];
  int c = 0;
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    x[t] = 0.0f;
    if (i < n && mask[i] && n_found[i] >= 2) {
      const float md = mean_d[i];
      if (kPass == 0) {
        x[t] = md;
        ++c;
      } else {
        const float d = __fsub_rn(md, mu_thresh[0]);
        x[t] = __fmul_rn(d, d);
      }
    }
  }
  const float s = block_tree_sum(x, sm);
  if (kPass == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFullMask, c, off);
    if ((threadIdx.x & 31) == 0) count_red[threadIdx.x >> 5] = c;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[kPass * G + blockIdx.x] = s;
    if (kPass == 0) {
      int total = 0;
      for (int w = 0; w < kWarps; ++w) total += count_red[w];
      counts[blockIdx.x] = total;
    }
  }
}

// -- compact_rows --------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const uint8_t* __restrict__ mask, long long n, int* __restrict__ rec) {
  __shared__ long long red[4 * kWarps];
  __shared__ long long tot[4];
  long long v[4] = {0, 0, 0, -1};
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    if (i < n && mask[i]) v[0] += 1;
  }
  block_totals(v, red, tot);
  if (threadIdx.x == 0) rec[blockIdx.x] = static_cast<int>(tot[0]);
}

__global__ void __launch_bounds__(kThreads)
compact_write_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                       long long n, long long out_rows, const int* __restrict__ rec,
                       long long G, float* __restrict__ pts_out,
                       uint8_t* __restrict__ mask_out) {
  __shared__ long long red[4 * kWarps];
  __shared__ long long tot[4];
  __shared__ int warp_tot[kWarps];
  long long v[4] = {0, 0, 0, -1};  // valid rows before this block, all valid rows
  for (long long g = threadIdx.x; g < G; g += kThreads) {
    const long long c = rec[g];
    v[1] += c;
    if (g < blockIdx.x) v[0] += c;
  }
  block_totals(v, red, tot);
  long long base = tot[0];
  const long long total = tot[1];
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    const bool valid = i < n && mask[i];
    int tile_valid;
    const int incl = block_scan(valid ? 1 : 0, warp_tot, tile_valid);
    const long long j = base + incl - 1;
    if (valid && j < out_rows) {
#pragma unroll
      for (int a = 0; a < 3; ++a) pts_out[3 * j + a] = pts[3 * i + a];
      mask_out[j] = 1;
    }
    base += tile_valid;
  }
  for (long long j = total + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       j < out_rows; j += static_cast<long long>(gridDim.x) * kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) pts_out[3 * j + a] = kPadValue;
    mask_out[j] = 0;
  }
}

// -- launches -----------------------------------------------------------------------

// One launch of `kernel` on `stream` over `grid` blocks of kThreads, a programmatic
// dependent of the launch before it.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned grid, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// Rows a block of every pass (the plain SOR threshold's tree width).
int lgs_prefilter_pass_rows() { return kRows; }

// Two launches on `stream` over n >= 0 rows, the second a programmatic dependent of the
// first. pts: [n, 3] f32; mask: [n] u8; leaf: one f32 on the device. With `filter` (the
// prefilter's distance filter, and the crop with use_crop), mask_out [n] u8 and pts_out
// [n, 3] f32 get the kept rows and the padded points, and the keys are those of the kept
// rows. partials: [3 * blocks] f32 scratch (blocks = max(1, ceil(n / rows))). Outputs
// (fresh, contiguous): keys [n] i32 (the clamped packed key of each valid row, INVALID_KEY
// elsewhere), origin [3] f32 (the valid rows' minimum corner less leaf). Returns
// cudaGetLastError() (0 = success).
int lgs_cell_keys(const float* pts, const uint8_t* mask, long long n, int filter,
                  float min_distance, float max_distance, int use_max, int use_crop,
                  float lo_x, float lo_y, float lo_z, float hi_x, float hi_y, float hi_z,
                  const float* leaf, int shift_x, int shift_y, int max_x, int max_y,
                  int max_z, float* partials, uint8_t* mask_out, float* pts_out, int* keys,
                  float* origin, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned G = blocks_for(n);
  const Filter f{min_distance, max_distance, use_max, use_crop, {lo_x, lo_y, lo_z},
                 {hi_x, hi_y, hi_z}};
  const KeyBits kb{shift_x, shift_y, {max_x, max_y, max_z}};
  const int vec = aligned(pts, 16) && aligned(mask, 4) && aligned(keys, 16) &&
                  (!filter || (aligned(pts_out, 16) && aligned(mask_out, 4)));
  if (filter) {
    cell_corner_kernel<true><<<G, kThreads, 0, s>>>(pts, mask, n, f, vec, mask_out, pts_out,
                                                    partials);
  } else {
    cell_corner_kernel<false><<<G, kThreads, 0, s>>>(pts, mask, n, f, vec, mask_out, pts_out,
                                                     partials);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      filter ? launch_dependent(cell_keys_pair_kernel<true>, G, s, pts, mask, n, f, vec, leaf,
                                kb, static_cast<const float*>(partials), keys, origin)
             : launch_dependent(cell_keys_pair_kernel<false>, G, s, pts, mask, n, f, vec,
                                leaf, kb, static_cast<const float*>(partials), keys, origin));
}

// Over n >= 0 rows sorted by key (keys [n] i32 ascending, INVALID_KEY rows last). With
// pts (and order [n] i64, each sorted row's original index), pts_out [n, 3] f32 gets
// pts[order]. With C >= 0, the runs: starts, lengths [C + 1] i64 and num_voxels (one i64)
// as `_sorted_runs` gives them, in two launches, the second a programmatic dependent of
// the first; rec: [3 * blocks] i32 scratch (blocks as `lgs_cell_keys`). With C < 0 the
// gather alone, PAD_VALUE where the key is INVALID_KEY: one launch (none for n = 0).
// Returns cudaGetLastError() (0 = success).
int lgs_sorted_runs(const int* keys, const long long* order, const float* pts, long long n,
                    long long C, float* pts_out, int* rec, long long* starts,
                    long long* lengths, long long* num_voxels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned G = blocks_for(n);
  const int vec = aligned(keys, 16) &&
                  (pts == nullptr || (aligned(order, 16) && aligned(pts_out, 16)));
  if (C < 0) {
    if (n > 0) gather_pad_kernel<<<G, kThreads, 0, s>>>(keys, order, pts, n, vec, pts_out);
    return static_cast<int>(cudaGetLastError());
  }
  if (pts != nullptr) {
    runs_record_kernel<true><<<G, kThreads, 0, s>>>(keys, order, pts, n, vec, pts_out, rec);
  } else {
    runs_record_kernel<false><<<G, kThreads, 0, s>>>(keys, order, pts, n, vec, pts_out, rec);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(runs_write_kernel, G, s, keys, n, C, vec,
                                           static_cast<const int*>(rec), starts, lengths,
                                           num_voxels));
}

// Three launches on `stream` over n >= 1 rows: mean_d [n] f32 and n_found [n] i64 (the
// window statistics), mask [n] u8, pts [n, 3] f32, stddev: one f32 on the device.
// partials: [2 * blocks] f32 and counts [blocks] i32 scratch. Outputs (fresh,
// contiguous): mask_out [n] u8 (mask, two or more neighbours, mean_d <= mu + stddev *
// sigma), pts_out [n, 3] f32 (PAD_VALUE where not kept). Returns cudaGetLastError().
int lgs_sor_threshold(const float* mean_d, const long long* n_found, const uint8_t* mask,
                      const float* pts, long long n, const float* stddev, float* partials,
                      int* counts, uint8_t* mask_out, float* pts_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned G = blocks_for(n);
  sor_threshold_kernel<0><<<G, kThreads, 0, s>>>(mean_d, n_found, mask, pts, n, G, stddev,
                                                 partials, counts, mask_out, pts_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sor_threshold_kernel<1><<<G, kThreads, 0, s>>>(mean_d, n_found, mask, pts, n, G, stddev,
                                                 partials, counts, mask_out, pts_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sor_threshold_kernel<2><<<G, kThreads, 0, s>>>(mean_d, n_found, mask, pts, n, G, stddev,
                                                 partials, counts, mask_out, pts_out);
  return static_cast<int>(cudaGetLastError());
}

// Two launches on `stream` over n >= 1 rows: pts [n, 3] f32, mask [n] u8. rec: [blocks]
// i32 scratch. Outputs (fresh, contiguous): pts_out [out_rows, 3] f32 and mask_out
// [out_rows] u8, out_rows = min(n, capacity): the valid rows in their order, then
// PAD_VALUE rows and false. Returns cudaGetLastError() (0 = success).
int lgs_compact_rows(const float* pts, const uint8_t* mask, long long n, long long out_rows,
                     int* rec, float* pts_out, uint8_t* mask_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned G = blocks_for(n);
  compact_count_kernel<<<G, kThreads, 0, s>>>(mask, n, rec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_write_kernel<<<G, kThreads, 0, s>>>(pts, mask, n, out_rows, rec, G, pts_out,
                                                mask_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
