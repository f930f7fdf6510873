// One whole ICP iteration per launch, and the loop gate's fitness in one launch, for Hopper
// (sm_90a): the device side of the reference's `jax.lax.while_loop` in
// lidar_graph_slam_tpu/registration/icp.py (`icp_align`: body :73-101, cond :103-105) around
// its grid nearest-neighbour query (lidar_graph_slam_tpu/ops/neighbors.py:103-177,
// `_candidate_scan` + `nearest`) and its closed-form step (`_umeyama_step`, :31-45), and of
// `fitness_and_match_fraction` (:155-188). Neither has a Pallas counterpart: the reference
// compiles the jitted programs with XLA; the port ran them as torch ops that read the
// device once an iteration (the loop's `done`, and `torch.linalg.svd`'s status).
//
// `icp_iteration`. The carry (T [4,4] f32, done u8, iterations i32, fitness f32, inliers
// i32) lives in device memory and is updated in place. One launch:
//   1. Before the programmatic wait on the launch before it, the block's first tile of
//      kLoopThreads source points (`fetch_tile`, loop_common.cuh, one point a thread),
//      which no launch of the loop writes: its loads are in flight while the launch before
//      ends. Then the wait and the while_loop's cond: a launch that finds `done` returns
//      (as `gicp_iteration` does).
//   2. The carry's T, the anchor, the grid's origin and 1 / cell (the float32 reciprocal
//      of its cell size, as the torch path rounds it); p = R x + t.
//   3. The grid-NN query of the tile (`stage_nearest`, nn_stage.cuh): the plain version's
//      `nearest` at C = 7 or 27 cells and bucket_cap B = 16 or 32, d2 and the row exactly.
//   4. Each masked-in point adds its fitness term, min(d2, corr^2) when found and corr^2
//      when not (`fitness = sum / n_valid`), and counts as valid. A matched point (found,
//      masked in, d2 < corr^2) takes its row q from the query's stage (`matched_row`) and
//      adds 1, p - c, q - c and the nine products (q - c)_i (p - c)_j, the sums about c,
//      the align's anchor (the masked source centroid under T0, made by the wrapper once
//      an align).
//   5. `reduce_rows` (`reduce_and_step`'s fixed-order reduction and ticket); in warp 0 of
//      the last block the step of `_umeyama_step` (`icp_step_warp`): W = max(n, 1e-9), the
//      means m_p = S_p / W, m_q = S_q / W about c, the cross-covariance Sigma = S_qp / W -
//      m_q m_p^T (the plain version's sum_w (q - mu_d)(p - mu_s)^T / W, formed from
//      moments about c in one pass over the points where centring on the means takes two:
//      with c inside the cloud the moments are of the cloud's spread, so nothing cancels
//      as raw world-coordinate moments would), R from Sigma's two largest singular pairs
//      (one-sided Jacobi, ended at convergence; `rotation_of`), t = mu_d - R mu_s with mu
//      = c + m; the step taken when it has 3 or more inliers and is finite (else the
//      identity), T <- dT T, the fitness, and the stop test of the plain version:
//      |se3_log(dT)| < epsilon (`se3_log_norm`), or |fitness_prev - fitness| <
//      euclidean_fitness_epsilon when that is > 0. `ops/kernels.py:umeyama_from_moments`
//      and `rotation_of_plain` are this step in torch ops, operation for operation.
//
// `icp_fitness`: step 1 (its first tile before the wait, T after it: a programmatic
// dependent of the launch before it), steps 2-3 at T, then per masked-in
// point its valid count and capped d2 (min(d2, max_range^2) when found, else
// max_range^2) and per matched point (d2 < max_range^2) its count and d2, reduced four
// wide (`reduce_fitness`); the last block writes the "pcl" score (the matched mean, +inf
// with no match) or the "penalized" one (the capped mean over the valid points), and the
// matched fraction.
//
// No float atomics: two runs are bit-identical. The grid is persistent
// (`ops/kernels.py:loop_blocks` of N, the card and the kernel's occupancy).
//
// What bounds them on this card. A working launch at the verifier's shape (N = 16,384,
// 4,858 valid, against a loop submap's grid) reads the source (13 bytes a point), the
// table entries and the candidate rows its points' cells name (16 bytes a row): ~0.2 MB,
// 0.06 us at 3.35 TB/s; its operations are ~9 a candidate and ~30 a matched point. Like
// `gicp_iteration` it is bound by latency, a chain of dependent steps, not by bytes or
// operations. `scripts/torch_icp_loop_split.py` took both designs apart on an H100 in
// turns (us at the verifier / front end): PR 14's 16.4 / 19.7 held a 6.7 / 5.6 us step
// in one thread (six Jacobi sweeps, each rotation a chain of IEEE divides and square
// roots whose slow-path checks keep nvcc from overlapping them, then se3_log); the
// query (table starts and hash ~2.8 / 2.9, copy of the runs ~0.9 / 2.0, scan ~1.1-1.8 /
// ~3.5) and the tail (tile, transform, reduction, ticket: ~3.7-4.2) are GICP's; the
// matched row's second read cost 0.17 / 0.14. This design: the sweeps stop at
// convergence (2-4 sweeps), correctly rounded reciprocals and square roots in place of
// the divides, the means and the cross-covariance formed by lanes of warp 0, step 6.7 /
// 5.6 -> 2.6 / 2.7; the row from the stage, 0.17 / 0.14 -> 0.08 / 0.06; the first tile
// loaded before the wait, 0.14 / 0.27 won, the early exit unchanged (the anchor and the
// grid's constants before the wait won 0.12 / 0.17 more but made each early exit ~0.15
// dearer: they wait for the cond). 12.2 / 16.2 us a working launch. `icp_fitness` (14.2
// -> 8.1 us a call): the wrapper's torch op for 1 / cell (5.3 us of device time between
// two launches) is gone, and its 4-wide reduction takes 1.9 us where the 32-wide one
// took 3.3. The query and the tail stay GICP's (nn_stage.cuh, and `reduce_rows`, a copy of
// `reduce_and_step`'s reduction kept apart so that NDT's and GICP's SASS stays as it
// was).

#include "nn_stage.cuh"

namespace {

// The quantities a thread accumulates (of kRow): the matched count, the sums of p - c and
// q - c, the sums of (q - c)_i (p - c)_j (row i, column j), the fitness sum and the valid
// count.
constexpr int kN = 0, kSp = 1, kSq = 4, kSqp = 7, kFit = 16, kValid = 17, kIcpQ = 18;
// The fitness launch's: matched count, valid count, matched d2 sum, capped d2 sum.
constexpr int kFitQ = 4;
// Sweeps of the one-sided Jacobi SVD at most: they stop at the first sweep that finds
// every pair of columns orthogonal (a 3x3 converges in 3-4).
constexpr int kSvdSweeps = 6;
// Columns P and Q count as orthogonal when gamma^2 <= kOrtho2 alpha beta: the cosine of
// their angle within float32's epsilon, 2^-23, squared.
constexpr float kOrtho2 = 0x1p-46f;
constexpr float kPi = 3.14159265358979323846f;

struct IcpArgs {
  const float* src;     // [N, 3] untransformed source points
  const uint8_t* mask;  // [N]
  long long N;
  NnGrid tgt;           // the target's grid (its inv_cell unused: see `cell`)
  const float* cell;    // one f32: the grid's cell size, whose float32 reciprocal (what
                        // the torch path's 1 / cell rounds to) is the query's 1 / cell
  Grid dims;            // dense table dims and the coordinate clamp
  const float* anchor;  // [3] the sums' origin c
  float corr2;          // the squared correspondence distance
  float epsilon;        // the transform epsilon
  float fit_epsilon;    // euclidean_fitness_epsilon (0: off)
  Carry carry;
  float* partials;
  unsigned int* counter;
};

struct FitArgs {
  const float* src;
  const uint8_t* mask;
  long long N;
  NnGrid tgt;
  const float* cell;  // as IcpArgs::cell
  Grid dims;
  const float* T;  // [4, 4]
  float pen;       // max_range^2
  int pcl;         // 1: the "pcl" score, 0: "penalized"
  float* out;      // [2]: score, matched fraction
  float* partials;
  unsigned int* counter;
};

// The end of a launch, in every thread of the block: `reduce_and_step`'s reduction
// (loop_common.cuh), operation for operation — the block's partial row of its threads'
// sums, the ticket, the last block's fixed-order sum of the rows — without its 6x6 step.
// Returns true in warp 0 of the block that draws the last ticket only, lane q holding
// quantity q's total in `tot`, with sequence b's ticket counter reset for the next
// launch; false in every other thread. A copy rather than a piece that `reduce_and_step`
// calls: routed through it, NDT's and GICP's loop kernels compiled to other SASS
// (`scripts/torch_sass_diff.py`) and GICP's working launch took 0.43 us longer on an H100
// (in turns with the tree before; the carry stayed bit-identical).
__device__ __forceinline__ bool reduce_rows(float (&acc)[kRow], float (&red)[kLoopWarps][kRow],
                                            bool& last, float* __restrict__ partials,
                                            unsigned int* __restrict__ counter, long long b,
                                            float& tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  red[warp][lane] = warp_reduce_scatter(acc);
  __syncthreads();
  float* rows = partials + b * gridDim.x * kRow;
  if (warp == 0) {
    float s = red[0][lane];
#pragma unroll
    for (int v = 1; v < kLoopWarps; ++v) s += red[v][lane];
    rows[blockIdx.x * kRow + lane] = s;
  }
  __syncthreads();  // the row is written before thread 0 releases it with the ticket
  if (t == 0) last = ticket(counter + b) == gridDim.x - 1;
  __syncthreads();  // ... and the last block reads the rows after thread 0 acquired them
  if (!last) return false;
  float s = 0.f;
  for (unsigned base = warp; base < gridDim.x; base += kChunk * kLoopWarps) {
    float v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const unsigned row = base + c * kLoopWarps;
      v[c] = row < gridDim.x ? __ldcg(&rows[row * kRow + lane]) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) s += v[c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return false;
  tot = red[0][lane];
#pragma unroll
  for (int v = 1; v < kLoopWarps; ++v) tot += red[v][lane];
  if (lane == 0) counter[b] = 0u;  // ready for the next launch on this stream
  return true;
}

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float (&a)[3], const float (&b)[3],
                                       float (&c)[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// One rotation of the one-sided Jacobi SVD: columns P and Q of A V (a[k], column k) and
// of V (v[k]) turned so that a[P] . a[Q] becomes 0 (the Jacobi rotation of their Gram
// matrix, as `eigh3x3.cuh` takes it for a symmetric one), unless they are orthogonal to
// float32 already (kOrtho2), which returns false and turns nothing. One correctly rounded
// reciprocal takes each divide, and `__frsqrt_rn` the 1 / sqrt.
template <int P, int Q>
__device__ __forceinline__ bool orthogonalize(float (&a)[3][3], float (&v)[3][3]) {
  const float alpha = dot3(a[P], a[P]), beta = dot3(a[Q], a[Q]), gamma = dot3(a[P], a[Q]);
  if (!(gamma * gamma > kOrtho2 * (alpha * beta))) return false;
  const float zeta = (beta - alpha) * __frcp_rn(2.0f * gamma);
  const float r = __frcp_rn(fabsf(zeta) + __fsqrt_rn(1.0f + zeta * zeta));
  const float t = zeta >= 0.0f ? r : -r;
  const float c = __frsqrt_rn(1.0f + t * t);
  const float s = t * c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ap = a[P][i], aq = a[Q][i], vp = v[P][i], vq = v[Q][i];
    a[P][i] = c * ap - s * aq;
    a[Q][i] = s * ap + c * aq;
    v[P][i] = c * vp - s * vq;
    v[Q][i] = s * vp + c * vq;
  }
  return true;
}

// The rotation R maximizing trace(R^T S) over SO(3), which is `_umeyama_step`'s U diag(1,
// 1, det(U V^T)) V^T for S = U diag(s) V^T: from the two largest singular pairs alone, R =
// u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T, a proper rotation whatever the signs of U and
// V, and the same R for a rank-2 S (planar points). The pairs come from a one-sided Jacobi
// SVD of S (its columns orthogonalized in place, so the small singular directions keep
// their accuracy, where an eigensolve of S^T S would square their condition), in sweeps of
// the pairs (0, 1), (0, 2), (1, 2) until a sweep turns none (at most kSvdSweeps); the
// columns are ordered by their squared norms and normalized by `__frsqrt_rn` of them, u2
// made orthogonal to u1 first. A zero S gives non-finite entries, which the caller's test
// turns into the identity step; a rank-1 S (collinear matches) some rotation about its
// line, as the reference's SVD does.
__device__ __forceinline__ void rotation_of(const float (&S)[3][3], float (&R)[3][3]) {
  float a[3][3], v[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[k][i] = S[i][k];
      v[k][i] = i == k ? 1.0f : 0.0f;
    }
#pragma unroll 1
  for (int sweep = 0; sweep < kSvdSweeps; ++sweep) {
    bool turned = orthogonalize<0, 1>(a, v);
    turned |= orthogonalize<0, 2>(a, v);
    turned |= orthogonalize<1, 2>(a, v);
    if (!turned) break;
  }
  float n2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) n2[k] = dot3(a[k], a[k]);
  // The largest, then the larger of the other two (ties: the lower column).
  int k1 = 0;
  if (n2[1] > n2[k1]) k1 = 1;
  if (n2[2] > n2[k1]) k1 = 2;
  int k2 = k1 == 0 ? 1 : 0;
  const int other = k1 == 2 ? 1 : 2;
  if (n2[other] > n2[k2]) k2 = other;
  float u1[3], a2[3], v1[3], v2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u1[i] = k1 == 0 ? a[0][i] : (k1 == 1 ? a[1][i] : a[2][i]);
    a2[i] = k2 == 0 ? a[0][i] : (k2 == 1 ? a[1][i] : a[2][i]);
    v1[i] = k1 == 0 ? v[0][i] : (k1 == 1 ? v[1][i] : v[2][i]);
    v2[i] = k2 == 0 ? v[0][i] : (k2 == 1 ? v[1][i] : v[2][i]);
  }
  const float inv1 = __frsqrt_rn(k1 == 0 ? n2[0] : (k1 == 1 ? n2[1] : n2[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] *= inv1;
  const float proj = dot3(u1, a2);
  float u2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = a2[i] - proj * u1[i];
  const float inv2 = __frsqrt_rn(dot3(u2, u2));
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] *= inv2;
  float u3[3], v3[3];
  cross3(u1, u2, u3);
  cross3(v1, v2, v3);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = (u1[i] * v1[j] + u2[i] * v2[j]) + u3[i] * v3[j];
}

__device__ __forceinline__ float sign_of(float x) {  // torch.sign
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// |se3_log([R | t])| as core/se3.py computes it: so3_log (the arccos of the clamped trace,
// the Taylor scale below theta = 1e-4, the diagonal branch within 1e-3 of pi), then
// v = J_l^-1(omega) t (`_left_jacobian_inv`, its Taylor term below theta^2 = 1e-8), then
// sqrt(sum(x x)) over (omega, v). Its divides are correctly rounded reciprocals and a
// product, the half angle's sine and cosine one `sincosf`.
__device__ __forceinline__ float se3_log_norm(const float (&R)[3][3], const float (&t)[3]) {
  const float trace = (R[0][0] + R[1][1]) + R[2][2];
  const float cos_theta = clamp_max(clamp_min((trace - 1.0f) * 0.5f, -1.0f), 1.0f);
  const float theta = acosf(cos_theta);
  const float scale = theta < 1e-4f ? 0.5f + theta * theta / 12.0f
                                    : theta * __frcp_rn(2.0f * clamp_min(sinf(theta), 1e-8f));
  float w[3] = {scale * (R[2][1] - R[1][2]), scale * (R[0][2] - R[2][0]),
                scale * (R[1][0] - R[0][1])};
  if (kPi - theta < 1e-3f) {  // near pi: the axis from the diagonal of (R + I) / 2
    float sq[3], ax[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) sq[i] = clamp_min((R[i][i] + 1.0f) * 0.5f, 0.0f);
    int k = 0;  // argmax: the first largest
    if (sq[1] > sq[k]) k = 1;
    if (sq[2] > sq[k]) k = 2;
#pragma unroll
    for (int i = 0; i < 3; ++i) ax[i] = sqrtf(sq[i]);
    const float oyz = (R[2][1] + R[1][2]) * 0.25f, oxz = (R[0][2] + R[2][0]) * 0.25f;
    const float oxy = (R[1][0] + R[0][1]) * 0.25f;
    auto signed_by = [](float o, float x) { return o == 0.0f ? x : sign_of(o) * x; };
    float c[3];
    if (k == 0) {
      c[0] = ax[0];
      c[1] = signed_by(oxy, ax[1]);
      c[2] = signed_by(oxz, ax[2]);
    } else if (k == 1) {
      c[0] = signed_by(oxy, ax[0]);
      c[1] = ax[1];
      c[2] = signed_by(oyz, ax[2]);
    } else {
      c[0] = signed_by(oxz, ax[0]);
      c[1] = signed_by(oyz, ax[1]);
      c[2] = ax[2];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = theta * c[i];
  }
  const float theta_sq = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const float th = sqrtf(theta_sq + 1e-16f);
  const float half = 0.5f * th;
  float sin_half, cos_half;
  sincosf(half, &sin_half, &cos_half);
  const float cot = theta_sq < 1e-8f
                        ? 1.0f / 12.0f + theta_sq / 720.0f
                        : (1.0f - half * cos_half * __frcp_rn(clamp_min(sin_half, 1e-8f))) *
                              __frcp_rn(clamp_min(theta_sq, 1e-16f));
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float n2 = theta_sq;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float vi = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float J = ((i == j ? 1.0f : 0.0f) - 0.5f * W[i][j]) + cot * W2;
      vi += J * t[j];
    }
    n2 += vi * vi;
  }
  return sqrtf(n2);
}

// The step from one iteration's totals in warp 0 of the last block, lane q holding total
// q in `tot`: `_umeyama_step` from the moments about c, the guarded update, the fitness
// and the stop test; writes the carry. Ts: the carry's T as the launch read it; fit0,
// iters0: its fitness and iterations. The lanes of the sums S_p, S_q and S_qp each scale
// theirs by one correctly rounded 1 / W, and the lanes of S_qp form the cross-covariance's
// entries; the warp gathers them with shuffles and every lane runs the same rotation, t
// and stop test (no lane waits on another's result), then each of lanes 0-15 computes and
// stores one field of the carry (lane 4 i + j < 12: entry (i, j) of dT T).
__device__ __forceinline__ void icp_step_warp(float tot, const float* Ts, const float* c,
                                              float fit0, int iters0, const IcpArgs& a) {
  const int lane = threadIdx.x & 31;
  const float m = tot * __frcp_rn(clamp_min(__shfl_sync(kFull, tot, kN), 1e-9f));  // S / W
  const int e = min(max(lane - kSqp, 0), 8);  // entry (e / 3, e % 3) of Sigma in lane kSqp + e
  const float sig =
      m - __shfl_sync(kFull, m, kSq + e / 3) * __shfl_sync(kFull, m, kSp + e % 3);
  float mp[3], mq[3], S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mp[i] = __shfl_sync(kFull, m, kSp + i);
    mq[i] = __shfl_sync(kFull, m, kSq + i);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k / 3][k % 3] = __shfl_sync(kFull, sig, kSqp + k);
  const float n = __shfl_sync(kFull, tot, kN);
  const float fitness =
      __shfl_sync(kFull, tot, kFit) / clamp_min(__shfl_sync(kFull, tot, kValid), 1.0f);
  float R[3][3], t[3];
  rotation_of(S, R);
  const float mu_s[3] = {c[0] + mp[0], c[1] + mp[1], c[2] + mp[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = (c[i] + mq[i]) - dot3(R[i], mu_s);
  const int n_inliers = static_cast<int>(n);
  bool ok = n_inliers >= 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ok = ok && isfinite(t[i]);
#pragma unroll
    for (int j = 0; j < 3; ++j) ok = ok && isfinite(R[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = ok ? t[i] : 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = ok ? R[i][j] : (i == j ? 1.0f : 0.0f);
  }
  bool done = se3_log_norm(R, t) < a.epsilon;
  if (a.fit_epsilon > 0.0f) done = done || fabsf(fit0 - fitness) < a.fit_epsilon;
  // Row i < 3 of dT T (dT's last row is (0, 0, 0, 1), so T's row 3 stays).
  const int i = min(lane >> 2, 2), j = lane & 3;
  const float r0 = i == 0 ? R[0][0] : (i == 1 ? R[1][0] : R[2][0]);
  const float r1 = i == 0 ? R[0][1] : (i == 1 ? R[1][1] : R[2][1]);
  const float r2 = i == 0 ? R[0][2] : (i == 1 ? R[1][2] : R[2][2]);
  const float ti = i == 0 ? t[0] : (i == 1 ? t[1] : t[2]);
  const float Tij = ((r0 * Ts[j] + r1 * Ts[4 + j]) + r2 * Ts[8 + j]) + ti * Ts[12 + j];
  if (lane < 12) a.carry.T[lane] = Tij;
  if (lane == 12) *a.carry.done = done;
  if (lane == 13) *a.carry.iters = iters0 + 1;
  if (lane == 14) *a.carry.fitness = fitness;
  if (lane == 15) *a.carry.inliers = n_inliers;
}

// The float4 of the row `stage_nearest` matched to thread t's query: from the winning
// cell's staged run (its slot, counted from the cell's table start, is row - start), or
// from the packed rows when that run was past the stage. Reads the stage after the query
// returns and before the next tile's query clears its hash (past a barrier).
template <int C, int B>
__device__ __forceinline__ float4 matched_row(const Stage<C, B>& sm, const NnGrid& g, int t,
                                              int row) {
  const int c = static_cast<int>(static_cast<unsigned>(sm.best[t]) / B);
  const int id = sm.sid[c][t];
  return id < Stage<C, B>::kRuns ? sm.rows[id * Stage<C, B>::kStride + (row - sm.start[c][t])]
                                 : __ldg(g.packed + row);
}

template <int C, int B>
__global__ void __launch_bounds__(kLoopThreads) icp_iteration_kernel(const IcpArgs a) {
  __shared__ float Ts[16];
  __shared__ float cs[3];
  __shared__ float tile[3 * kLoopThreads];
  __shared__ float red[kLoopWarps][kRow];
  __shared__ float fit0;
  __shared__ int iters0;
  __shared__ bool last;
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  Stage<C, B>& sm = *reinterpret_cast<Stage<C, B>*>(stage_bytes);
  const int t = threadIdx.x, lane = t & 31;
  // Before the wait, the block's first tile (no launch of the loop writes the source):
  // its loads are in flight while the launch before this one ends. The grid's constants
  // and the anchor wait for the cond: read before it, they made each early exit ~0.15 us
  // dearer (`scripts/torch_icp_loop_split.py`).
  const long long tiles = (a.N + kLoopThreads - 1) / kLoopThreads;
  float w[3];
  bool m = false;
  if (blockIdx.x < tiles) fetch_tile(a.src, a.mask, a.N, blockIdx.x, t, w, m);
  // A programmatic dependent of the previous launch on the stream (as gicp_iteration).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (*a.carry.done) return;  // the loop's cond: the alignment is finished
  if (t < 16) Ts[t] = a.carry.T[t];
  if (t >= 16 && t < 19) cs[t - 16] = a.anchor[t - 16];
  if (t == 19) iters0 = *a.carry.iters;
  if (t == 20) fit0 = *a.carry.fitness;
  const float tinv = __frcp_rn(*a.cell);
  const float tox = a.tgt.origin[0], toy = a.tgt.origin[1], toz = a.tgt.origin[2];
  float acc[kRow];
#pragma unroll
  for (int k = 0; k < kRow; ++k) acc[k] = 0.f;

  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    __syncthreads();  // the previous tile's reads of `tile` are done (and Ts, cs written)
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[t + c * kLoopThreads] = w[c];
    const bool mine = m;
    __syncthreads();
    if (k + gridDim.x < tiles) fetch_tile(a.src, a.mask, a.N, k + gridDim.x, t, w, m);
    const float sx = tile[3 * t], sy = tile[3 * t + 1], sz = tile[3 * t + 2];
    const float x = Ts[0] * sx + Ts[1] * sy + Ts[2] * sz + Ts[3];
    const float y = Ts[4] * sx + Ts[5] * sy + Ts[6] * sz + Ts[7];
    const float z = Ts[8] * sx + Ts[9] * sy + Ts[10] * sz + Ts[11];
    int row = 0;
    const float d2 =
        stage_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, x, y, z, mine, sm, row);
    if (mine) {
      acc[kFit] += d2 < INFINITY ? fminf(d2, a.corr2) : a.corr2;
      acc[kValid] += 1.f;
    }
    if (mine && d2 < a.corr2) {  // matched: found, masked in, within the gate
      const float4 qr = matched_row<C, B>(sm, a.tgt, t, row);
      const float p[3] = {x - cs[0], y - cs[1], z - cs[2]};
      const float qv[3] = {qr.x - cs[0], qr.y - cs[1], qr.z - cs[2]};
      acc[kN] += 1.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        acc[kSp + i] += p[i];
        acc[kSq + i] += qv[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[kSqp + 3 * i + j] += qv[i] * p[j];
      }
    }
  }

  float tot;
  if (!reduce_rows(acc, red, last, a.partials, a.counter, 0, tot)) return;
  icp_step_warp(tot, Ts, cs, fit0, iters0, a);
  if (lane == 0) atomicAdd(&g_worked_launches, 1ull);
}

// Butterfly sum of v over the lanes whose index differs in bits 2-4 (xor 4, 8, 16).
__device__ __forceinline__ float sum_lanes_above_2(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  return v + __shfl_xor_sync(kFull, v, 16);
}

// The fitness launch's end, in every thread of the block: its kFitQ sums reduced in a
// fixed order, four wide where the loop kernels' reduction is kRow wide. Each warp
// reduce-scatters the four over its lanes (two halvings, then a butterfly over the lanes'
// upper bits: 6 shuffles, lane l holding quantity l & 3); the warps in order make the
// block's partial row of four; the ticket; in the block that draws the last ticket thread
// t adds quantity t & 3 of rows t / 4, t / 4 + 32, ... in order, then the lanes of a
// quantity by butterfly and the warps in order. Returns true in thread 0 of the last
// block only, with the totals in q and the ticket counter reset for the next launch.
__device__ __forceinline__ bool reduce_fitness(float (&v)[kFitQ],
                                               float (&red)[kLoopWarps][kFitQ], bool& last,
                                               float* __restrict__ partials,
                                               unsigned int* __restrict__ counter,
                                               float (&q)[kFitQ]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool up2 = lane & 2, up1 = lane & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up2 ? v[i] : v[i + 2], keep = up2 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  const float send = up1 ? v[0] : v[1], keep = up1 ? v[1] : v[0];
  const float s = sum_lanes_above_2(keep + __shfl_xor_sync(kFull, send, 1));
  if (lane < kFitQ) red[warp][lane] = s;
  __syncthreads();
  if (t < kFitQ)
    partials[blockIdx.x * kFitQ + t] = ((red[0][t] + red[1][t]) + red[2][t]) + red[3][t];
  __syncthreads();  // the row is written before thread 0 releases it with the ticket
  if (t == 0) last = ticket(counter) == gridDim.x - 1;
  __syncthreads();  // ... and the last block reads the rows after thread 0 acquired them
  if (!last) return false;
  constexpr int kRowsAtOnce = kLoopThreads / kFitQ;  // rows the block reads a round
  float r = 0.f;
  for (unsigned base = t / kFitQ; base < gridDim.x; base += 8 * kRowsAtOnce) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned row = base + u * kRowsAtOnce;
      x[u] = row < gridDim.x ? __ldcg(&partials[row * kFitQ + (t & 3)]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) r += x[u];
  }
  r = sum_lanes_above_2(r);
  if (lane < kFitQ) red[warp][lane] = r;  // the rows above were read before the ticket
  __syncthreads();
  if (t != 0) return false;
#pragma unroll
  for (int k = 0; k < kFitQ; ++k) q[k] = ((red[0][k] + red[1][k]) + red[2][k]) + red[3][k];
  counter[0] = 0u;  // ready for the next launch on this stream
  return true;
}

template <int C, int B>
__global__ void __launch_bounds__(kLoopThreads) icp_fitness_kernel(const FitArgs a) {
  __shared__ float Ts[16];
  __shared__ float tile[3 * kLoopThreads];
  __shared__ float red[kLoopWarps][kFitQ];
  __shared__ bool last;
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  Stage<C, B>& sm = *reinterpret_cast<Stage<C, B>*>(stage_bytes);
  const int t = threadIdx.x;
  // Before the wait, the block's first tile (the loop kernels that may run before this
  // launch do not write the source), as in `icp_iteration`.
  const long long tiles = (a.N + kLoopThreads - 1) / kLoopThreads;
  float w[3];
  bool m = false;
  if (blockIdx.x < tiles) fetch_tile(a.src, a.mask, a.N, blockIdx.x, t, w, m);
  // A programmatic dependent of the launch before it: T is its result.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t < 16) Ts[t] = a.T[t];
  const float tinv = __frcp_rn(*a.cell);
  const float tox = a.tgt.origin[0], toy = a.tgt.origin[1], toz = a.tgt.origin[2];
  float acc[kFitQ] = {0.f, 0.f, 0.f, 0.f};

  for (long long k = blockIdx.x; k < tiles; k += gridDim.x) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[t + c * kLoopThreads] = w[c];
    const bool mine = m;
    __syncthreads();
    if (k + gridDim.x < tiles) fetch_tile(a.src, a.mask, a.N, k + gridDim.x, t, w, m);
    const float sx = tile[3 * t], sy = tile[3 * t + 1], sz = tile[3 * t + 2];
    const float x = Ts[0] * sx + Ts[1] * sy + Ts[2] * sz + Ts[3];
    const float y = Ts[4] * sx + Ts[5] * sy + Ts[6] * sz + Ts[7];
    const float z = Ts[8] * sx + Ts[9] * sy + Ts[10] * sz + Ts[11];
    int row = 0;
    const float d2 =
        stage_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, x, y, z, mine, sm, row);
    if (mine) {
      acc[1] += 1.f;
      acc[3] += d2 < INFINITY ? fminf(d2, a.pen) : a.pen;
      if (d2 < a.pen) {
        acc[0] += 1.f;
        acc[2] += d2;
      }
    }
  }

  float q[kFitQ];
  if (!reduce_fitness(acc, red, last, a.partials, a.counter, q)) return;
  const float valid = clamp_min(q[1], 1.0f);
  a.out[0] = a.pcl ? (q[0] > 0.0f ? q[2] / clamp_min(q[0], 1.0f) : INFINITY) : q[3] / valid;
  a.out[1] = q[0] / valid;
}

template <int C, int B>
Variant variant_of(int fitness) {
  return {fitness ? reinterpret_cast<const void*>(&icp_fitness_kernel<C, B>)
                  : reinterpret_cast<const void*>(&icp_iteration_kernel<C, B>),
          static_cast<int>(sizeof(Stage<C, B>))};
}

// The instantiation of `icp_iteration` (fitness = 0) or `icp_fitness` (1) for
// (neighborhood, bucket_cap) with its stage's bytes allowed on the current device
// (`*err`), or {nullptr, 0} (cudaErrorInvalidValue).
Variant icp_kernel(int neighborhood, int bucket_cap, int fitness, cudaError_t* err) {
  Variant v = {nullptr, 0};
  if (neighborhood == 7 && bucket_cap == 16)
    v = variant_of<7, 16>(fitness);
  else if (neighborhood == 7 && bucket_cap == 32)
    v = variant_of<7, 32>(fitness);
  else if (neighborhood == 27 && bucket_cap == 16)
    v = variant_of<27, 16>(fitness);
  else if (neighborhood == 27 && bucket_cap == 32)
    v = variant_of<27, 32>(fitness);
  *err = v.fn == nullptr ? cudaErrorInvalidValue
                         : cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                v.smem);
  return v;
}

}  // namespace

extern "C" {

// The registers per thread, shared memory bytes a block (static and its stage) and local
// memory bytes per thread (out[0..2]) of `icp_iteration` (fitness = 0) or `icp_fitness`
// (1) for (neighborhood, bucket_cap), and the runs its stage holds (out[3]); returns the
// CUDA error (0 = success).
int lgs_icp_loop_attributes(int neighborhood, int bucket_cap, int fitness, int* out) {
  cudaError_t err;
  const Variant v = icp_kernel(neighborhood, bucket_cap, fitness, &err);
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

// Resident blocks per SM of `icp_iteration` (fitness = 0) or `icp_fitness` (1) for
// (neighborhood, bucket_cap) on the current device, or -(CUDA error).
int lgs_icp_loop_blocks_per_sm(int neighborhood, int bucket_cap, int fitness) {
  cudaError_t err;
  const Variant v = icp_kernel(neighborhood, bucket_cap, fitness, &err);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, v.fn, kLoopThreads, v.smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The whole ICP loop on `stream`: max_iterations launches of `icp_iteration`, `nblocks`
// blocks each, every launch a programmatic dependent of the one before it,
// cudaGetLastError() checked after each. src [N, 3] f32, mask [N] u8; the target grid
// (table [dx * dy * dz] i32, packed [t_n, 4] f32 16-byte aligned, origin [3] f32, cell
// size one f32); anchor [3] f32. The carry: T [4, 4] f32, done u8, iters i32, fitness f32,
// inliers i32, updated in place. partials: [32 * nblocks] f32; counter: one u32, 0
// between launches (the kernel leaves it 0). Returns the first nonzero CUDA error (0 =
// every launch was accepted; cudaErrorInvalidValue for a neighborhood or bucket_cap the
// kernel does not take, or another key layout).
int lgs_icp_align_loop(const float* src, const uint8_t* mask, long long N, const int* t_table,
                       const float* t_packed, const float* t_origin, const float* t_cell,
                       int t_n, int dx, int dy, int dz, int hx, int hy, int hz, int key_sx,
                       int key_sy, int neighborhood, int bucket_cap, const float* anchor,
                       float corr2, float epsilon, float fit_epsilon, float* T, uint8_t* done,
                       int* iters, float* fitness, int* inliers, int max_iterations,
                       float* partials, unsigned int* counter, int nblocks, void* stream) {
  if (key_sx != kKeyX || key_sy != kKeyY) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const Variant v = icp_kernel(neighborhood, bucket_cap, 0, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  IcpArgs a;
  a.src = src;
  a.mask = mask;
  a.N = N;
  a.tgt = NnGrid{t_table, reinterpret_cast<const float4*>(t_packed), t_origin, nullptr, t_n};
  a.cell = t_cell;
  a.dims = Grid{dx, dy, dz, hx, hy, hz};
  a.anchor = anchor;
  a.corr2 = corr2;
  a.epsilon = epsilon;
  a.fit_epsilon = fit_epsilon;
  a.carry = Carry{T, done, iters, fitness, inliers};
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
  void* args[] = {&a};
  for (int it = 0; it < max_iterations; ++it) {
    // The first launch waits for the stream as any launch does: the anchor and the carry
    // it reads are written just before it. Each later one starts while the launch before
    // it ends (that launch releases it at its start, `launch_dependents`), reads before
    // its wait only what no launch of the loop writes, and waits for the rest.
    cfg.numAttrs = it == 0 ? 0 : 1;
    cudaLaunchKernelExC(&cfg, v.fn, args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The loop gate's fitness at T [4, 4] f32 in one launch of `icp_fitness` on `stream`: the
// grid-NN query of the masked source (src [N, 3] f32, mask [N] u8) in the target grid (as
// lgs_icp_align_loop takes it), then out[0] the score ("pcl" when pcl != 0, else
// "penalized") and out[1] the matched fraction, with pen = max_range^2. Returns the CUDA
// error of the launch (0 = accepted).
int lgs_icp_fitness(const float* src, const uint8_t* mask, long long N, const int* t_table,
                    const float* t_packed, const float* t_origin, const float* t_cell,
                    int t_n, int dx, int dy, int dz, int hx, int hy, int hz, int key_sx,
                    int key_sy, int neighborhood, int bucket_cap, const float* T, float pen,
                    int pcl, float* out, float* partials, unsigned int* counter, int nblocks,
                    void* stream) {
  if (key_sx != kKeyX || key_sy != kKeyY) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const Variant v = icp_kernel(neighborhood, bucket_cap, 1, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  FitArgs a;
  a.src = src;
  a.mask = mask;
  a.N = N;
  a.tgt = NnGrid{t_table, reinterpret_cast<const float4*>(t_packed), t_origin, nullptr, t_n};
  a.cell = t_cell;
  a.dims = Grid{dx, dy, dz, hx, hy, hz};
  a.T = T;
  a.pen = pen;
  a.pcl = pcl;
  a.out = out;
  a.partials = partials;
  a.counter = counter;
  // A programmatic dependent of the launch before it: after a loop kernel (which releases
  // its dependents at its start and writes only its carry and scratch) it reads the source
  // and the grid while that launch ends, and T after the wait; after any other kernel it
  // starts when that kernel has finished, as a plain launch does.
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
  cudaLaunchKernelExC(&cfg, v.fn, args);
  return static_cast<int>(cudaGetLastError());
}

// The working launches of `icp_iteration` since the last reset (`read_worked_launches`,
// loop_common.cuh).
long long lgs_icp_worked_launches(int reset) { return read_worked_launches(reset); }

}  // extern "C"
