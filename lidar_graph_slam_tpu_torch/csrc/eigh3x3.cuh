// The symmetric 3x3 eigensolve of `ops/voxel.py:_eigh3x3` as one thread's device code,
// for the kernels of `voxel_finalize.cu`: fixed-sweep cyclic Jacobi (6 sweeps of the
// rotations (0,1), (0,2), (1,2)) on the 6 upper-triangle entries, then the ascending
// 3-sort network with paired column swaps. It ports the reference's unrolled elementwise
// version (`lidar_graph_slam_tpu/ops/voxel.py:182-245`), which XLA fuses into a few
// elementwise programs and the plain PyTorch version runs as ~950 eager operations.
//
// Bit-equal to the plain version. Every float operation is the plain version's, in its
// order, rounded once: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __frcp_rn /
// __fsqrt_rn, so nvcc contracts nothing into an FMA (its default -fmad=true would) and no
// reciprocal or square root is approximated. The constants are the float32 values torch
// converts the plain version's Python scalars to (2.0f, 1.0f). `x / y` of two tensors and
// `1.0 / x` (`reciprocal`, then `* 1.0`) both round the true quotient once, so a quotient
// of 1 or -1 is the correctly rounded reciprocal `__frcp_rn`, a shorter instruction
// sequence than the general divide's; torch's `sqrt` is the correctly rounded one on the
// card and on the CPU.

#pragma once

#include <cuda_runtime.h>

namespace {

// The index of entry (i, j) among the upper triangle a[0..5] = (00, 11, 22, 01, 02, 12).
__host__ __device__ constexpr int sym(int i, int j) {
  return i == j ? i : i + j + 2;
}

// torch.maximum / torch.clamp(min=) in float32: NaN wins, as in torch.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// One Jacobi rotation that zeroes a[sym(P, Q)]; v[j][i] = V[i, j] (columns). The plain
// version's `nz` guard divides by 1 where a_pq is 0 and then takes t = 0; its sign never
// is 0, so tau = 0 takes the exact 45-degree rotation (t = 1).
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(float (&a)[6], float (&v)[3][3]) {
  constexpr int R = 3 - P - Q;
  const float app = a[P], aqq = a[Q], apq = a[sym(P, Q)];
  const bool nz = fabsf(apq) > 0.0f;
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.0f, nz ? apq : 1.0f));
  // sgn / d as +-(1 / d): round to nearest is symmetric, so the same value.
  const float r = __frcp_rn(
      __fadd_rn(fabsf(tau), __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
  const float t = nz ? (tau >= 0.0f ? r : -r) : 0.0f;
  const float c = __frcp_rn(__fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  const float s = __fmul_rn(t, c);
  const float apr = a[sym(P, R)], aqr = a[sym(Q, R)];
  a[P] = __fsub_rn(app, __fmul_rn(t, apq));
  a[Q] = __fadd_rn(aqq, __fmul_rn(t, apq));
  a[sym(P, Q)] = 0.0f;
  a[sym(P, R)] = __fsub_rn(__fmul_rn(c, apr), __fmul_rn(s, aqr));
  a[sym(Q, R)] = __fadd_rn(__fmul_rn(s, apr), __fmul_rn(c, aqr));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = v[P][i], vq = v[Q][i];
    v[P][i] = __fsub_rn(__fmul_rn(c, vp), __fmul_rn(s, vq));
    v[Q][i] = __fadd_rn(__fmul_rn(s, vp), __fmul_rn(c, vq));
  }
}

// Swaps eigenpairs i and j when w[i] > w[j] (strict: equal or NaN values stay).
template <int I, int J>
__device__ __forceinline__ void sort_pair(float (&w)[3], float (&v)[3][3]) {
  if (w[I] > w[J]) {
    const float t = w[I];
    w[I] = w[J];
    w[J] = t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float u = v[I][k];
      v[I][k] = v[J][k];
      v[J][k] = u;
    }
  }
}

// a: the upper triangle (00, 11, 22, 01, 02, 12). Returns w ascending and v[j] the
// eigenvector of w[j] (v[j][i] = V[i, j]).
__device__ __forceinline__ void eigh3x3(float (&a)[6], float (&w)[3], float (&v)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
    jacobi_rotate<0, 1>(a, v);
    jacobi_rotate<0, 2>(a, v);
    jacobi_rotate<1, 2>(a, v);
  }
  w[0] = a[0];
  w[1] = a[1];
  w[2] = a[2];
  sort_pair<0, 1>(w, v);
  sort_pair<1, 2>(w, v);
  sort_pair<0, 1>(w, v);
}

}  // namespace
