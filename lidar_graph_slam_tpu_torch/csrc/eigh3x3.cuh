// The symmetric 3x3 eigensolve of `ops/voxel.py:_eigh3x3` as one thread's device code,
// for the kernels of `voxel_finalize.cu` and `covariances.cu`: fixed-sweep cyclic Jacobi
// (6 sweeps of the rotations (0,1), (0,2), (1,2)) on the 6 upper-triangle entries, then
// the ascending 3-sort network with paired column swaps. It ports the reference's unrolled
// elementwise version (`lidar_graph_slam_tpu/ops/voxel.py:182-245`), which XLA fuses into
// a few elementwise programs and the plain PyTorch version runs as ~950 eager operations.
//
// Bit-equal to the plain version. Every float operation the plain version's result depends
// on is the plain version's, in its order, rounded once: __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn / __frcp_rn / __fsqrt_rn, so nvcc contracts nothing into an FMA
// (its default -fmad=true would) and no reciprocal or square root is approximated. The
// constants are the float32 values torch converts the plain version's Python scalars to
// (2.0f, 1.0f). `x / y` of two tensors and `1.0 / x` (`reciprocal`, then `* 1.0`) both
// round the true quotient once, so a quotient of 1 or -1 is the correctly rounded
// reciprocal `__frcp_rn`, a shorter instruction sequence than the general divide's;
// torch's `sqrt` is the correctly rounded one on the card.
//
// Rotations whose result IEEE arithmetic fixes exactly are taken without the divide and
// roots that would compute it. A matrix converges in 2-4 sweeps, and the 18 rotations run
// as one thread's dependent chain of divides, roots and reciprocals; past convergence the
// off-diagonals are 0, subnormal or tiny, tau (or tau^2) overflows, and the correctly
// rounded routines take their slow paths (subroutine calls). With t the rotation's
// tangent, c its cosine and s = t c, the plain version computes
//   tau = (a_qq - a_pp) / (2 a_pq),  r = 1 / (|tau| + sqrt(1 + tau^2)),
//   t = +-r by tau >= 0 (t = +0 where |a_pq| > 0 is false),  c = 1 / sqrt(1 + t^2),
// and the shortcuts, each exact in IEEE binary32 with round to nearest:
//   * zero: |a_pq| > 0 false (0, -0 or NaN): t = +0, c = 1 (the plain version's select).
//   * no divide: |a_qq - a_pp| >= 2^64 |2 a_pq| with 2 a_pq finite. Then |tau| >= 2^64
//     (the quotient is at least 2^64 before rounding and 2^64 is a float), so tau^2 >=
//     2^128 overflows, sqrt(inf) = inf and r = 1 / inf = +0: t = +-0, the sign of tau,
//     which is the sign of a_qq - a_pp times that of a_pq (neither is 0 here). c = 1.
//     Every other tau^2 is finite: the quotient of two floats lies below 2^64 (1 - 2^-25)
//     once it lies below 2^64 (m_n / m_d in [1 - 2^-25, 1) needs m_d - m_n < 2^-23, the
//     spacing of their significands), so tau <= 2^64 - 2^40 and tau^2 <= 2^128 - 2^105.
//   * large tau: 2^25 <= tau^2. 1 + tau^2 rounds to tau^2 (1 is under half its
//     ulp, which is >= 4), and sqrt(fl(tau^2)) = |tau|: for x = m 2^e > 0, m in (1, 2),
//     fl(x^2) = x^2 (1 + d) with |d| <= 2^-24 / (1 + 2^-24), so sqrt(fl(x^2)) lies within
//     x |d| (1 + |d|) / 2 <= 2^-25 x of x, less than half its ulp, 2^-24 x / m (at m = 1
//     x^2 is exact). So the root is |tau| and r = 1 / (|tau| + |tau|): one reciprocal
//     and no root; then t^2 <= 2^-27 and 1 + t^2 rounds to 1: c = 1.
//   * unit c: 1 + t^2 rounds to 1 (t^2 <= 2^-24): c = 1 / sqrt(1) = 1, no root or
//     reciprocal for c.
// Each shortcut leaves the updates of a and v as they were, with c = 1 and s = t c: they
// still multiply by the constants, so signed zeros and NaNs come out as the plain
// version's. A NaN tau takes the general route.
// The choice, from a split of the launch (`scripts/torch_eigh3x3_split.py`, the FPFH
// normals' 8,192 matrices on an H100 at 700 W): the time is one solved warp's dependent
// chain of 18 rotations, and every sweep after the second is mostly shortcuts (the last
// rotation of sweep 3 on the normals: 6,785 of 8,192 take `zero`, 815 `no_divide`, 592
// `large_tau`), so the shortcuts take the launch from 10.24 to 5.65 us at the same 256
// threads a block; the launch shape is `voxel_finalize.cu`'s.
// (`tests/test_torch_eigh3x3_shortcuts.py` holds a float32 model of these routes bit-equal
// to `_eigh3x3` and checks the root claim over a whole binade;
// `scripts/torch_eigh3x3_split.py` counts each route on the FPFH normals' inputs.)

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
// is 0, so tau = 0 takes the exact 45-degree rotation (t = 1). The shortcuts are the
// header's; a warp runs a branch if any of its lanes takes it.
template <int P, int Q>
__device__ __forceinline__ void jacobi_rotate(float (&a)[6], float (&v)[3][3]) {
  constexpr int R = 3 - P - Q;
  const float app = a[P], aqq = a[Q], apq = a[sym(P, Q)];
  const float num = __fsub_rn(aqq, app), den = __fmul_rn(2.0f, apq);
  float t = 0.0f, c = 1.0f;
  if (fabsf(apq) > 0.0f) {
    if (__fmul_rn(fabsf(den), 0x1p64f) <= fabsf(num) && fabsf(den) < INFINITY) {
      // no divide: tau = +-inf or |tau| >= 2^64, t = +-0.
      t = __int_as_float((__float_as_int(num) ^ __float_as_int(den)) & 0x80000000);
    } else {
      const float tau = __fdiv_rn(num, den);  // |tau| <= 2^64 - 2^40, or NaN
      const float at = fabsf(tau), tt = __fmul_rn(tau, tau);
      float root = at;  // large tau: sqrt(1 + tau^2) = |tau|
      if (!(tt >= 0x1p25f)) root = __fsqrt_rn(__fadd_rn(1.0f, tt));
      // sgn / d as +-(1 / d): round to nearest is symmetric, so the same value.
      const float r = __frcp_rn(__fadd_rn(at, root));
      t = tau >= 0.0f ? r : -r;
      const float u = __fadd_rn(1.0f, __fmul_rn(t, t));
      if (u != 1.0f) c = __frcp_rn(__fsqrt_rn(u));  // else unit c
    }
  }
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
// eigenvector of w[j] (v[j][i] = V[i, j]). kSweeps < 6 only in the split's builds
// (`scripts/torch_eigh3x3_split.py`).
template <int kSweeps = 6>
__device__ __forceinline__ void eigh3x3(float (&a)[6], float (&w)[3], float (&v)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
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
