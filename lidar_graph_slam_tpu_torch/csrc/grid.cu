// The hash grid's build for Hopper (sm_90a): the dense cell table and the grid's rows
// after the sort by cell key.
//
// Replaces what the JAX package leaves to XLA inside its jitted `build_hash_grid`
// (lidar_graph_slam_tpu/ops/neighbors.py:68-100; it has no Pallas kernel for it) and its
// `build_dense_table` (lidar_graph_slam_tpu/ops/voxel.py:60-76):
//
//  * `dense_table_kernel` ports `build_dense_table`: a [dx * dy * dz] int32 table that
//    holds, for each cell, the smallest index among the rows that are valid and whose
//    unpacked key lies inside the table, and -1 for every other cell. The port's plain
//    version (`ops/voxel.py:build_dense_table_plain`) fills a table one slot longer with
//    INT_MAX, sends every row that fails to that overflow slot, takes `scatter_reduce_`
//    ("amin") over all N rows — on a grid nearly every row is such a row, an atomic min on
//    one address — and rewrites the 16 MiB table through a `torch.where` into a second
//    buffer. Here the caller's stream clears the table once (`cudaMemsetAsync` to 0xFF:
//    -1 in every slot), a thread takes a row, and only a row that passes touches the
//    table: an unsigned `atomicMin` of its index, which -1 (0xFFFFFFFF) never beats.
//    Rows that share a cell (the RANSAC occupancy table's keys are unsorted and repeat)
//    leave the smallest index whatever order they run in; no other row writes.
//  * `grid_rows_kernel` ports the rest of `build_hash_grid` after the sort: the
//    first-of-run flags, `starts` (the reference's `associative_scan(max)`, the plain
//    version's `torch.cummax` over one row of N: the first sorted row of each row's run
//    of equal keys), `packed` (x, y, z and the key's bits) and the table of the rows
//    that are first and valid, in one launch after the table's clear. A block takes
//    kGridThreads consecutive sorted rows, a thread a row: the flag from the row before,
//    an inclusive max-scan of (first ? row : -1) over the block (a warp scan by
//    shuffles, then the warps' totals), and for the rows before the block's first flag
//    the start of the run the block began inside, which warp 0 finds while the others
//    scan: the 32 rows before the block in one coalesced load (most runs are shorter),
//    else a 33-way lower_bound over the keys before them (the keys ascend), four rounds
//    at most on 655,360 rows (the INVALID_KEY tail of a loop submap is ~118,000 rows).
//    A first-and-valid row stores its index into the table with a plain store: the
//    first rows of distinct keys have distinct cells. The table slot comes from
//    `table_slot`, the same function as `dense_table_kernel`'s.
//
// Bit-equal to the plain versions: integers only, and the points and the key's bits are
// copied as 32-bit words (a key of INVALID_KEY is a NaN's bits). The result does not
// depend on the order in which threads run. Nothing waits on the host, and the clear is
// a memset on the caller's stream, so both capture into a CUDA graph.
//
// What bounds them on this card: bytes. `dense_table` writes the 16 MiB table once (the
// clear) and reads 5 B a row (key and flag), 4 B more for a row that passes: ~5 us on a
// map level or the occupancy table at 3.35 TB/s, nearly all of it the clear.
// `grid_rows` writes the table too, and 40 B a row (a key and the row before it, which
// the same cache line holds, and xyz read; packed and starts written): 26 MB on the
// dense ring's 655,360 rows, ~13 us with the clear. Neither does work worth counting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalidKey = 0x7fffffff;  // ops/voxel.py:INVALID_KEY
constexpr int kTableThreads = 256;       // rows (and threads) a block of dense_table
constexpr int kGridThreads = 256;        // sorted rows (and threads) a block of grid_rows
constexpr int kGridWarps = kGridThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

struct TableDims {  // the table's cells (dx, dy, dz) and unpack_key's shifts and masks
  int dx, dy, dz;
  int shift_x, shift_y, mask_y, mask_z;
};

// The table slot of a packed key, (cx * dy + cy) * dz + cz, or -1 where the unpacked key
// lies outside the table (ops/voxel.py:unpack_key, _flat_table_index): cx is an
// arithmetic shift, as torch's >> on int32, so a negative key has cx < 0; cy and cz are
// masked, so never negative.
__device__ __forceinline__ int table_slot(int key, const TableDims& d) {
  const int cx = key >> d.shift_x;
  const int cy = (key >> d.shift_y) & d.mask_y;
  const int cz = key & d.mask_z;
  if (cx < 0 || cx >= d.dx || cy >= d.dy || cz >= d.dz) return -1;
  return (cx * d.dy + cy) * d.dz + cz;
}

__global__ void __launch_bounds__(kTableThreads)
dense_table_kernel(const int* __restrict__ keys, const uint8_t* __restrict__ valid,
                   long long n, TableDims d, int* __restrict__ table) {
  const long long i = static_cast<long long>(blockIdx.x) * kTableThreads + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int slot = table_slot(keys[i], d);
  if (slot >= 0)
    atomicMin(reinterpret_cast<unsigned*>(table) + slot, static_cast<unsigned>(i));
}

// The first row of the run that holds rows b - 1 and b (keys[b - 1] == keys[b] == key;
// keys ascending): the least j with keys[j] == key, the lower bound of key. Called by a
// whole warp, the same b in every lane; every lane returns it.
__device__ __forceinline__ long long run_start(const int* __restrict__ keys, long long b,
                                               int key, int lane) {
  // The 32 rows before b (a row before 0 counts as a smaller key).
  const long long p = b - 32 + lane;
  unsigned less = __ballot_sync(kFullMask, p < 0 || keys[p < 0 ? 0 : p] < key);
  if (less) return b - 32 + (32 - __clz(less));  // after the last smaller lane
  // Rows b - 32 .. b - 1 all hold key: the answer lies in [lo, hi], keys[hi] == key.
  long long lo = 0, hi = b - 32;
  while (hi - lo >= 32) {
    // 32 probes cut [lo, hi] into 33 parts, each probe below hi; one part is left.
    const long long w = hi - lo;
    less = __ballot_sync(kFullMask, keys[lo + (lane + 1) * w / 33] < key);
    const int c = __popc(less);  // the keys ascend: the smaller probes are lanes 0 .. c-1
    const long long next_lo = c > 0 ? lo + c * w / 33 + 1 : lo;
    if (c < 32) hi = lo + (c + 1) * w / 33;
    lo = next_lo;
  }
  const long long q = lo + lane;
  less = __ballot_sync(kFullMask, q < hi && keys[q < hi ? q : hi] < key);
  return lo + __popc(less);
}

__global__ void __launch_bounds__(kGridThreads)
grid_rows_kernel(const int* __restrict__ keys, const float* __restrict__ pts, long long n,
                 TableDims d, long long* __restrict__ starts, int4* __restrict__ packed,
                 int* __restrict__ table) {
  __shared__ int warp_last[kGridWarps];
  __shared__ long long carry;
  const long long b0 = static_cast<long long>(blockIdx.x) * kGridThreads;
  const long long i = b0 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = i < n;
  const int key = live ? keys[i] : kInvalidKey;
  const bool first = live && (i == 0 || keys[i - 1] != key);
  // The latest first-of-run row at or before this one within the block (-1: none).
  int v = first ? static_cast<int>(threadIdx.x) : -1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v = max(v, u);
  }
  if (lane == 31) warp_last[warp] = v;
  if (warp == 0) {
    // The same in every thread of the block: does the block begin inside a run?
    const int k0 = keys[b0];
    if (b0 > 0 && keys[b0 - 1] == k0) {
      const long long s = run_start(keys, b0, k0, lane);
      if (lane == 0) carry = s;
    }
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) v = max(v, warp_last[w]);
  if (!live) return;
  starts[i] = v >= 0 ? b0 + v : carry;
  packed[i] = make_int4(__float_as_int(pts[3 * i]), __float_as_int(pts[3 * i + 1]),
                        __float_as_int(pts[3 * i + 2]), key);
  if (first && key != kInvalidKey) {
    const int slot = table_slot(key, d);
    if (slot >= 0) table[slot] = static_cast<int>(i);
  }
}

}  // namespace

extern "C" {

// The table's clear on `stream`, then one launch over n >= 0 rows (none for n = 0).
// keys: [n] i32 packed cell keys in any order; valid: [n] u8; table: [dx * dy * dz] i32
// (fresh, contiguous): the least index of the valid rows whose key lies in each cell, -1
// where none. Returns the clear's error, else cudaGetLastError() after the launch (0 =
// success).
int lgs_dense_table(const int* keys, const uint8_t* valid, long long n, int dx, int dy,
                    int dz, int shift_x, int shift_y, int mask_y, int mask_z, int* table,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TableDims d{dx, dy, dz, shift_x, shift_y, mask_y, mask_z};
  const cudaError_t err =
      cudaMemsetAsync(table, 0xff, sizeof(int) * static_cast<size_t>(dx) * dy * dz, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kTableThreads - 1) / kTableThreads);
    dense_table_kernel<<<blocks, kTableThreads, 0, s>>>(keys, valid, n, d, table);
  }
  return static_cast<int>(cudaGetLastError());
}

// The table's clear on `stream`, then one launch over n >= 0 rows sorted by cell key
// (none for n = 0). keys: [n] i32 ascending (INVALID_KEY rows last); pts: [n, 3] f32 in
// the keys' order. Outputs (fresh, contiguous): starts [n] i64, each row's first row of
// its run of equal keys; packed [n, 4] f32 (x, y, z, the key's bits; 16-byte aligned);
// table [dx * dy * dz] i32, each cell's first row among the valid rows, -1 where none.
// Returns the clear's error, else cudaGetLastError() after the launch (0 = success).
int lgs_grid_rows(const int* keys, const float* pts, long long n, int dx, int dy, int dz,
                  int shift_x, int shift_y, int mask_y, int mask_z, long long* starts,
                  float* packed, int* table, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TableDims d{dx, dy, dz, shift_x, shift_y, mask_y, mask_z};
  const cudaError_t err =
      cudaMemsetAsync(table, 0xff, sizeof(int) * static_cast<size_t>(dx) * dy * dz, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kGridThreads - 1) / kGridThreads);
    grid_rows_kernel<<<blocks, kGridThreads, 0, s>>>(
        keys, pts, n, d, starts, reinterpret_cast<int4*>(packed), table);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
