// The NDT target build's voxel finalize and the batched symmetric 3x3 eigensolve, for
// Hopper (sm_90a).
//
// Replaces what the JAX package leaves to XLA inside its jitted target build (it has no
// Pallas kernel for it): `_finalize_ndt` with `regularize_covariance` and `_eigh3x3`
// (lidar_graph_slam_tpu/ops/voxel.py:300-339, :246-254, :182-245), compiled into the
// programs `build_ndt_map` / `build_ndt_pyramid` (`:341`, `:360`) and, through them,
// `odometry/fused.py:insert_and_rebuild`. Eagerly, the port's plain version
// (`ops/voxel.py:_finalize_ndt_plain`) is ~1,050 ATen launches a map, ~950 of them the
// unrolled Jacobi; here it is one launch a map.
//
//  * `ndt_finalize_kernel`, one thread a voxel row: the local mean sums / max(n, 1), the
//    world mean from the voxel corner `unpack_key` names (origin + coord * resolution),
//    the sample covariance (outer - (cnt m_i) m_j) / max(n - 1, 1) on the upper
//    triangle, valid = occupied and n >= min_points, the identity for an invalid row,
//    the Jacobi eigensolve (`eigh3x3.cuh`), the floor w_reg = max(w, 0.01 max(w_2,
//    1e-9)), the inverse V diag(1 / w_reg) V^T summed k = 0, 1, 2, and the map's rows:
//    keys (INVALID_KEY where unoccupied), means (PAD_VALUE there), inv_covs, valid and the
//    packed [16] row (mean | inv_cov row-major | valid | 0, 0, 0), as four 16-byte stores.
//  * `eigh3x3_kernel`, one thread a matrix: w ascending and V (eigenvector columns) of
//    `_eigh3x3`, for GICP's covariances and the FPFH normals.
//
// Bit-equal to the plain versions: each float operation is theirs, in their order,
// rounded once (`eigh3x3.cuh`). `resolution` is read on the device, so nothing waits on
// the host. The moments may be rows of one wider tensor (the segment sums' [C, 13]
// stats): each input takes its row stride.
//
// What bounds it on this card: bytes. A row reads 57 B (key, count, 3 sums, 9 outer
// sums, the occupied flag) and writes 117 B (key, mean, inverse, valid, the 64 B packed
// row) for 851 float operations (738 of them the Jacobi's); at C = 65,536 that is 11.4
// MB, ~3.4 us at 3.35 TB/s, against 55.8 M operations, ~0.8 us at 67 TFLOP/s. In practice
// the IEEE divides and square roots (60 and 36 a row, each a multi-instruction sequence)
// and 256 blocks on 132 SMs make it latency-bound at these sizes; tensor cores and TMA
// have nothing to offer a per-row 3x3 eigensolve. `eigh3x3` reads 36 B and writes 48 B a
// matrix for 738 operations: bytes again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "eigh3x3.cuh"

namespace {

constexpr int kFinalizeThreads = 256;
constexpr int kInvalidKey = 0x7fffffff;  // ops/voxel.py:INVALID_KEY
constexpr float kPadValue = 1.0e6f;      // core/pointcloud.py:PAD_VALUE

struct KeyBits {  // unpack_key: (key >> shift_x, (key >> shift_y) & mask_y, key & mask_z)
  int shift_x, shift_y, mask_y, mask_z;
};

struct Moments {  // row r of counts / sums / outer at r * its stride (floats)
  const int* keys;
  const float* counts;
  long long counts_stride;
  const float* sums;
  long long sums_stride;
  const float* outer;
  long long outer_stride;
  const uint8_t* occupied;
};

struct MapRows {
  int* keys;
  float* means;
  float* inv_covs;
  uint8_t* valid;
  float4* packed;
};

__global__ void __launch_bounds__(kFinalizeThreads)
ndt_finalize_kernel(Moments m, const float* __restrict__ origin,
                    const float* __restrict__ resolution, float min_points, KeyBits bits,
                    long long C, MapRows out) {
  const long long r = static_cast<long long>(blockIdx.x) * kFinalizeThreads + threadIdx.x;
  if (r >= C) return;
  const int key = m.keys[r];
  const float n = m.counts[r * m.counts_stride];
  const bool occupied = m.occupied[r] != 0;
  const float cnt = nan_max(n, 1.0f);
  const float* s = m.sums + r * m.sums_stride;
  const float ml[3] = {__fdiv_rn(s[0], cnt), __fdiv_rn(s[1], cnt), __fdiv_rn(s[2], cnt)};
  const int coord[3] = {key >> bits.shift_x, (key >> bits.shift_y) & bits.mask_y,
                        key & bits.mask_z};
  const float res = *resolution;
  float mean[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    mean[d] = __fadd_rn(__fadd_rn(origin[d], __fmul_rn(__int2float_rn(coord[d]), res)),
                        ml[d]);
  const bool valid = occupied && n >= min_points;

  float a[6] = {1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};  // an invalid row: the identity
  if (valid) {
    const float* o = m.outer + r * m.outer_stride;
    const float den = nan_max(__fsub_rn(n, 1.0f), 1.0f);
    const auto cov = [&](int i, int j) {
      return __fdiv_rn(__fsub_rn(o[3 * i + j], __fmul_rn(__fmul_rn(cnt, ml[i]), ml[j])), den);
    };
    a[0] = cov(0, 0);
    a[1] = cov(1, 1);
    a[2] = cov(2, 2);
    a[3] = cov(0, 1);
    a[4] = cov(0, 2);
    a[5] = cov(1, 2);
  }
  float w[3], v[3][3];
  eigh3x3(a, w, v);
  const float floor_w = __fmul_rn(0.01f, nan_max(w[2], 1e-9f));
  float inv_w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv_w[k] = __fdiv_rn(1.0f, nan_max(w[k], floor_w));
  // inv[i][j] = sum_k (V[i][k] / w_k) V[j][k], with V[i][k] = v[k][i].
  float inv[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      inv[i][j] = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(v[0][i], inv_w[0]), v[0][j]),
                    __fmul_rn(__fmul_rn(v[1][i], inv_w[1]), v[1][j])),
          __fmul_rn(__fmul_rn(v[2][i], inv_w[2]), v[2][j]));

  const float mo[3] = {occupied ? mean[0] : kPadValue, occupied ? mean[1] : kPadValue,
                       occupied ? mean[2] : kPadValue};
  out.keys[r] = occupied ? key : kInvalidKey;
  out.valid[r] = valid;
#pragma unroll
  for (int d = 0; d < 3; ++d) out.means[3 * r + d] = mo[d];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out.inv_covs[9 * r + 3 * i + j] = inv[i][j];
  float4* row = out.packed + 4 * r;
  row[0] = make_float4(mo[0], mo[1], mo[2], inv[0][0]);
  row[1] = make_float4(inv[0][1], inv[0][2], inv[1][0], inv[1][1]);
  row[2] = make_float4(inv[1][2], inv[2][0], inv[2][1], inv[2][2]);
  row[3] = make_float4(valid ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kFinalizeThreads)
eigh3x3_kernel(const float* __restrict__ A, long long M, float* __restrict__ w_out,
               float* __restrict__ V_out) {
  const long long r = static_cast<long long>(blockIdx.x) * kFinalizeThreads + threadIdx.x;
  if (r >= M) return;
  const float* m = A + 9 * r;
  float a[6] = {m[0], m[4], m[8], m[1], m[2], m[5]};
  float w[3], v[3][3];
  eigh3x3(a, w, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) w_out[3 * r + k] = w[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) V_out[9 * r + 3 * i + j] = v[j][i];
}

unsigned int finalize_blocks(long long rows) {
  return static_cast<unsigned int>((rows + kFinalizeThreads - 1) / kFinalizeThreads);
}

}  // namespace

extern "C" {

// One launch on `stream` over C >= 1 voxel rows. keys: [C] i32; counts, sums, outer: row r
// at r * *_stride floats (sums 3, outer 9 contiguous floats a row); occupied: [C] u8;
// origin: [3] f32; resolution: one f32 on the device. Outputs (fresh, contiguous): keys_out
// [C] i32, means [C, 3], inv_covs [C, 3, 3], valid [C] u8, packed [C, 16] f32 (16-byte
// aligned). Returns cudaGetLastError() after the launch (0 = success).
int lgs_ndt_finalize(const int* keys, const float* counts, long long counts_stride,
                     const float* sums, long long sums_stride, const float* outer,
                     long long outer_stride, const uint8_t* occupied, const float* origin,
                     const float* resolution, float min_points, int shift_x, int shift_y,
                     int mask_y, int mask_z, long long C, int* keys_out, float* means,
                     float* inv_covs, uint8_t* valid, float* packed, void* stream) {
  const Moments m{keys, counts, counts_stride, sums, sums_stride, outer, outer_stride,
                  occupied};
  const MapRows out{keys_out, means, inv_covs, valid, reinterpret_cast<float4*>(packed)};
  ndt_finalize_kernel<<<finalize_blocks(C), kFinalizeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      m, origin, resolution, min_points, KeyBits{shift_x, shift_y, mask_y, mask_z}, C, out);
  return static_cast<int>(cudaGetLastError());
}

// One launch on `stream` over M >= 1 matrices: A [M, 3, 3] f32 (its upper triangle is
// read); w [M, 3] ascending, V [M, 3, 3] with eigenvector columns.
int lgs_eigh3x3(const float* A, long long M, float* w, float* V, void* stream) {
  eigh3x3_kernel<<<finalize_blocks(M), kFinalizeThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(A, M, w, V);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
