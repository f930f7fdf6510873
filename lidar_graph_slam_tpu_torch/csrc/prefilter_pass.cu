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
//    (a thread a row: r = sqrt((x x + y y) + z z) rounded once, r > min_distance, the
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
// 256 (a thread a row a tile, coalesced). Bit-equal to the plain versions: the keys, runs,
// counts and copies are integer or copied words, and each float operation is the plain
// version's, in its order, rounded once (`__f*_rn`, so nvcc contracts nothing into an
// FMA). Nothing is read back, nothing but the given buffers is written, and no scratch
// carries state from one launch to the next call, so a call captures into a CUDA graph
// and two graphs replaying at once share nothing.
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

// Inclusive prefix maximum of v over the block's threads; `total` gets the block's max.
__device__ int block_scan_max(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = max(v, u);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = -1;
  total = -1;
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    before = w < warp ? max(before, t) : before;
    total = max(total, t);
  }
  __syncthreads();
  return max(v, before);
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

// -- cell_keys -----------------------------------------------------------------------

template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
cell_corner_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                   long long n, Filter f, uint8_t* __restrict__ mask_out,
                   float* __restrict__ pts_out, float* __restrict__ partials) {
  __shared__ float red[3][kWarps];
  float m[3] = {kPadValue, kPadValue, kPadValue};  // where(mask, p, PAD_VALUE)
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    if (i >= n) break;
    bool keep = mask[i] != 0;
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    if (kFilter) {
      const float r = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
      keep = keep && r > f.min_distance && (!f.use_max || r < f.max_distance);
      if (f.use_crop)
        keep = keep && x >= f.lo[0] && y >= f.lo[1] && z >= f.lo[2] && x <= f.hi[0] &&
               y <= f.hi[1] && z <= f.hi[2];
      mask_out[i] = keep;
      pts_out[3 * i] = keep ? x : kPadValue;
      pts_out[3 * i + 1] = keep ? y : kPadValue;
      pts_out[3 * i + 2] = keep ? z : kPadValue;
    }
    if (keep) {
      m[0] = nan_min(m[0], x);
      m[1] = nan_min(m[1], y);
      m[2] = nan_min(m[2], z);
    }
  }
  block_min3(m, red, partials + 3 * static_cast<long long>(blockIdx.x));
}

__global__ void __launch_bounds__(kThreads)
cell_keys_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask, long long n,
                 const float* __restrict__ partials, long long G,
                 const float* __restrict__ leaf_p, KeyBits kb, int* __restrict__ keys,
                 float* __restrict__ origin_out) {
  __shared__ float red[3][kWarps];
  __shared__ float corner[3];
  float m[3] = {kPadValue, kPadValue, kPadValue};
  for (long long g = threadIdx.x; g < G; g += kThreads) {
    m[0] = nan_min(m[0], partials[3 * g]);
    m[1] = nan_min(m[1], partials[3 * g + 1]);
    m[2] = nan_min(m[2], partials[3 * g + 2]);
  }
  block_min3(m, red, corner);
  const float leaf = *leaf_p;
  const float inv = __fdiv_rn(1.0f, leaf);  // torch's 1.0 / leaf: a reciprocal, rounded once
  const float org[3] = {__fsub_rn(corner[0], leaf), __fsub_rn(corner[1], leaf),
                        __fsub_rn(corner[2], leaf)};
  if (blockIdx.x == 0 && threadIdx.x < 3) origin_out[threadIdx.x] = org[threadIdx.x];
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    if (i >= n) break;
    int key = kInvalidKey;
    if (mask[i]) {
      int c[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        // floor((p - origin) * inv).to(int32), clamped to [0, COORD_MAX]; the conversion
        // saturates, as torch's on the card.
        const float u = __fmul_rn(__fsub_rn(pts[3 * i + a], org[a]), inv);
        c[a] = min(max(__float2int_rz(floorf(u)), 0), kb.max_c[a]);
      }
      key = (c[0] << kb.shift_x) | (c[1] << kb.shift_y) | c[2];
    }
    keys[i] = key;
  }
}

// -- sorted_runs ---------------------------------------------------------------------

// kRuns: count the runs; kGather: gather the sorted points. The gather alone (the SOR's
// cell sort) parks the rows whose key is INVALID_KEY at PAD_VALUE; with the runs it copies.
template <bool kRuns, bool kGather>
__global__ void __launch_bounds__(kThreads)
runs_count_kernel(const int* __restrict__ keys, const long long* __restrict__ order,
                  const float* __restrict__ pts, long long n, float* __restrict__ pts_out,
                  int* __restrict__ rec) {
  __shared__ long long red[4 * kWarps];
  __shared__ long long tot[4];
  long long v[4] = {0, 0, 0, -1};  // first-of-run rows, valid rows, (unused), last first
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    if (i >= n) break;
    const int key = keys[i];
    if (kGather) {
      const long long o = order[i];
      const bool pad = !kRuns && key == kInvalidKey;
#pragma unroll
      for (int a = 0; a < 3; ++a) pts_out[3 * i + a] = pad ? kPadValue : pts[3 * o + a];
    }
    if (kRuns && key != kInvalidKey) {
      v[1] += 1;
      if (i == 0 || keys[i - 1] != key) {
        v[0] += 1;
        v[3] = i;
      }
    }
  }
  if (!kRuns) return;
  block_totals(v, red, tot);
  if (threadIdx.x == 0) {
    rec[3 * blockIdx.x] = static_cast<int>(tot[0]);
    rec[3 * blockIdx.x + 1] = static_cast<int>(tot[1]);
    rec[3 * blockIdx.x + 2] = static_cast<int>(tot[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
runs_write_kernel(const int* __restrict__ keys, long long n, long long C,
                    const int* __restrict__ rec, long long G, long long* __restrict__ starts,
                    long long* __restrict__ lengths, long long* __restrict__ num_voxels) {
  __shared__ long long red[4 * kWarps];
  __shared__ long long tot[4];
  __shared__ int warp_tot[kWarps];
  // Over the records: the firsts before this block, all firsts, all valid rows, and the
  // last first-of-run row before this block (the start of a run the block begins inside).
  long long v[4] = {0, 0, 0, -1};
  for (long long g = threadIdx.x; g < G; g += kThreads) {
    const long long f = rec[3 * g];
    v[1] += f;
    v[2] += rec[3 * g + 1];
    if (g < blockIdx.x) {
      v[0] += f;
      v[3] = max(v[3], static_cast<long long>(rec[3 * g + 2]));
    }
  }
  block_totals(v, red, tot);
  const long long nv = tot[1], nvalid = tot[2];
  long long run = tot[0];                   // firsts before the current tile
  int start = static_cast<int>(tot[3]);     // the latest first row before it (-1: none)
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int t = 0; t < kTiles; ++t) {
    const long long i = b0 + t * kThreads + threadIdx.x;
    const bool live = i < n;
    const int key = live ? keys[i] : kInvalidKey;
    const bool valid = key != kInvalidKey;
    const bool first = valid && (i == 0 || keys[i - 1] != key);
    const bool last = valid && (i == n - 1 || keys[i + 1] != key);
    int tile_firsts, tile_start;
    const int incl = block_scan(first ? 1 : 0, warp_tot, tile_firsts);
    const int s = block_scan_max(first ? static_cast<int>(i) : -1, warp_tot, tile_start);
    const long long seg = run + incl - 1;  // a valid row's run
    if (first) {
      if (seg < C) {
        starts[seg] = i;
      } else if (seg == C) {  // the first voxel past C opens the overflow run
        starts[C] = i;
        lengths[C] = n - i;
      }
    }
    if (last && seg < C) lengths[seg] = i + 1 - max(s, start);
    run += tile_firsts;
    start = max(start, tile_start);
  }
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

}  // namespace

extern "C" {

// Rows a block of every pass (the plain SOR threshold's tree width).
int lgs_prefilter_pass_rows() { return kRows; }

// Two launches on `stream` over n >= 0 rows. pts: [n, 3] f32; mask: [n] u8; leaf: one
// f32 on the device. With `filter` (the prefilter's distance filter, and the crop with
// use_crop), mask_out [n] u8 and pts_out [n, 3] f32 get the kept rows and the padded
// points, and the keys are those of the kept rows. partials: [3 * blocks] f32 scratch
// (blocks = max(1, ceil(n / rows))). Outputs (fresh, contiguous): keys [n] i32 (the
// clamped packed key of each valid row, INVALID_KEY elsewhere), origin [3] f32 (the
// valid rows' minimum corner less leaf). Returns cudaGetLastError() (0 = success).
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
  if (filter) {
    cell_corner_kernel<true><<<G, kThreads, 0, s>>>(pts, mask, n, f, mask_out, pts_out,
                                                    partials);
  } else {
    cell_corner_kernel<false><<<G, kThreads, 0, s>>>(pts, mask, n, f, mask_out, pts_out,
                                                     partials);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_keys_kernel<<<G, kThreads, 0, s>>>(filter ? pts_out : pts, filter ? mask_out : mask, n,
                                          partials, G, leaf, kb, keys, origin);
  return static_cast<int>(cudaGetLastError());
}

// Over n >= 0 rows sorted by key (keys [n] i32 ascending, INVALID_KEY rows last). With
// pts (and order [n] i64, each sorted row's original index), pts_out [n, 3] f32 gets
// pts[order]. With C >= 0, the runs: starts, lengths [C + 1] i64 and num_voxels (one i64)
// as `_sorted_runs` gives them; rec: [3 * blocks] i32 scratch. With C < 0 the gather
// alone, PAD_VALUE where the key is INVALID_KEY: one launch (none for n = 0). Two with
// the runs. Returns cudaGetLastError() (0 = success).
int lgs_sorted_runs(const int* keys, const long long* order, const float* pts, long long n,
                    long long C, float* pts_out, int* rec, long long* starts,
                    long long* lengths, long long* num_voxels, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned G = blocks_for(n);
  if (C < 0) {
    if (n > 0) {
      runs_count_kernel<false, true><<<G, kThreads, 0, s>>>(keys, order, pts, n, pts_out,
                                                            rec);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (pts != nullptr) {
    runs_count_kernel<true, true><<<G, kThreads, 0, s>>>(keys, order, pts, n, pts_out, rec);
  } else {
    runs_count_kernel<true, false><<<G, kThreads, 0, s>>>(keys, order, pts, n, pts_out, rec);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  runs_write_kernel<<<G, kThreads, 0, s>>>(keys, n, C, rec, G, starts, lengths, num_voxels);
  return static_cast<int>(cudaGetLastError());
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
