// One whole NDT Gauss-Newton iteration per launch, for Hopper (sm_90a): the device side
// of the reference's `jax.lax.while_loop` in lidar_graph_slam_tpu/registration/ndt.py
// (`ndt_align`: body :81-122, cond :124-126, polish :144-147).
//
// It extends the port of the TPU kernel `ndt_accumulate` (ops/pallas_kernels.py, deleted
// in 4350000; `ndt_accumulate.cu`) with everything else the loop body does, so the host
// enqueues the whole loop without reading anything back:
//
//   carry (T [4,4] f32, done u8, iterations i32, fitness f32, inliers i32), in device
//   memory, updated in place; `polish` is a launch argument.
//   1. A non-polish launch that finds `done` set returns at once in every block: it
//      writes nothing and draws no ticket (the while_loop's cond). `done` is written only
//      by the previous launch's last block, in stream order, so every block of a launch
//      reads the same value; a ticket is never half drawn.
//   2. Each thread transforms its source point in registers, p = R x + t from the carry's
//      T (`se3.transform_points`), then does the DIRECT7 gather and the accumulation of
//      `ndt_direct7_accumulate` (`ndt_common.cuh`: the same pair routine, per-block
//      partials and fixed-order ticket reduction; no float atomics, so a result is the
//      same bit for bit from run to run).
//   3. The block that draws the last ticket has the 31 totals; its thread 0 does the
//      step (`ops/kernels.py:ndt_step_plain`, the reference's body after the
//      accumulation): damping by clamp(trace(H) / 6, 1e-12), the 6x6 solve by LU with
//      partial pivoting in f32 (the algorithm of `torch.linalg.solve_ex`), the step cap,
//      fitness = centre |e|^2 / max(centre count, 1), a step that is not finite or has no
//      inliers zeroed, T <- se3_exp(delta) T (`core/se3.py`, with its theta^2 < 1e-8
//      Taylor branch and sqrt(theta^2 + EPS^2)), and, outside polish, done |= |delta| <
//      epsilon and iterations += 1. Every other block of the launch read T before it drew
//      its ticket, so the in-place write races with no reader.
//
// Entry points: `lgs_ndt_align_loop_batched` enqueues max_iterations non-polish launches
// then polish_iterations polish launches of one kernel on one stream (B sequences on
// gridDim.y, each with its own map, points, carry, partials and ticket; a finished
// sequence's blocks exit on its own `done`), checking cudaGetLastError() after each;
// `lgs_ndt_align_loop` is it with B = 1, so row b of a batch equals the single loop on
// sequence b bit for bit.
//
// What bounds it on this card. A working launch is the fused accumulate (latency-bound:
// dependent mask -> point -> table -> row loads; ~0.4 us of operations at N = 32,768
// against ~16 us measured for `ndt_direct7_accumulate`) plus a serial tail: the ticket,
// the last block's sum of the partials and ~1,000 dependent float operations of the step
// in one thread (~2-4 us at the SM clock). An early-exit launch is one load of `done` per
// block: the launch floor. The host's cost is one C call per align stage instead of
// ~135 eager launches and one synchronous read an iteration.

#include "ndt_common.cuh"

namespace {

// Launches of this kernel that did work (summed over the sequences of a batch), for the
// measurement of dead launches; read and reset by the host entry points below.
__device__ unsigned long long g_worked_launches = 0;

struct Carry {  // sequence b's fields start at b * 16 (T) or b (the others)
  float* T;
  uint8_t* done;
  int* iters;
  float* fitness;
  int* inliers;
};

struct StepArgs {
  float step_size, epsilon;
  const float* damping_ptr;  // or by value
  float damping_val;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {  // NaN stays NaN
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_max(float x, float hi) {  // NaN stays NaN
  return x > hi ? hi : x;
}

// The damped 6x6 solve: (H + damping * clamp(trace(H)/6, 1e-12) I) delta = -g, by LU
// with partial pivoting (first largest |pivot|), forward and back substitution. A zero
// pivot gives a non-finite delta, which the caller's step test zeroes.
__device__ void solve_damped6(const float (&H)[6][6], const float (&g)[6], float damping,
                              float (&delta)[6]) {
  float tr = 0.f;
  for (int i = 0; i < 6; ++i) tr += H[i][i];
  const float ds = damping * clamp_min(tr / 6.0f, 1e-12f);
  float A[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A[i][j] = H[i][j] + (i == j ? ds : 0.f);
    delta[i] = -g[i];
  }
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        piv = i;
      }
    }
    if (piv != k) {
      for (int j = 0; j < 6; ++j) {
        const float a = A[k][j];
        A[k][j] = A[piv][j];
        A[piv][j] = a;
      }
      const float b = delta[k];
      delta[k] = delta[piv];
      delta[piv] = b;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
      A[i][k] = l;
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
    }
  }
  for (int i = 1; i < 6; ++i)
    for (int j = 0; j < i; ++j) delta[i] -= A[i][j] * delta[j];
  for (int i = 5; i >= 0; --i) {
    for (int j = i + 1; j < 6; ++j) delta[i] -= A[i][j] * delta[j];
    delta[i] /= A[i][i];
  }
}

__device__ __forceinline__ float norm6(const float (&d)[6]) {
  float s = 0.f;
  for (int i = 0; i < 6; ++i) s += d[i] * d[i];
  return sqrtf(s);
}

// se(3) exp of the twist (omega, v) as core/se3.py computes it: rows 0..2 of [R | t].
__device__ void se3_exp(const float (&xi)[6], float (&E)[3][4]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta_sq = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta_sq + 1e-16f);  // _EPS * _EPS
  const bool small = theta_sq < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float A = small ? 1.0f - theta_sq / 6.0f : s / theta;
  const float B = small ? 0.5f - theta_sq / 24.0f : (1.0f - c) / theta_sq;
  const float C = small ? (1.0f / 6.0f) - theta_sq / 120.0f
                        : (theta - s) / (theta_sq * theta);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      E[i][j] = (I + A * W[i][j]) + B * W2[i][j];
      V[i][j] = (I + B * W[i][j]) + C * W2[i][j];
    }
  }
  for (int i = 0; i < 3; ++i) E[i][3] = V[i][0] * xi[3] + V[i][1] * xi[4] + V[i][2] * xi[5];
}

// The step from one iteration's totals `tot` (the quantities of ndt_common.cuh), on one
// thread: updates sequence b's carry in place.
__device__ void gn_step(const float* tot, float* T, uint8_t* done, int* iters,
                        float* fitness, int* inliers, const StepArgs& st, float damping,
                        int polish) {
  float H[6][6], g[6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) H[i][j] = tot[tri_index(i < j ? i : j, i < j ? j : i)];
  for (int i = 0; i < 6; ++i) g[i] = tot[21 + i];
  const int n_inliers = (int)tot[28];
  float delta[6];
  solve_damped6(H, g, damping, delta);
  const float scale = clamp_max(st.step_size / clamp_min(norm6(delta), 1e-12f), 1.0f);
  bool finite = true;
  for (int i = 0; i < 6; ++i) {
    delta[i] *= scale;
    finite = finite && isfinite(delta[i]);
  }
  const bool step_ok = finite && n_inliers > 0;
  for (int i = 0; i < 6; ++i) delta[i] = step_ok ? delta[i] : 0.f;
  float E[3][4];
  se3_exp(delta, E);
  float Tn[16];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                      E[i][3] * T[12 + j];
  for (int j = 0; j < 4; ++j) Tn[12 + j] = T[12 + j];  // E's last row is (0, 0, 0, 1)
  for (int k = 0; k < 16; ++k) T[k] = Tn[k];
  *fitness = tot[29] / clamp_min(tot[30], 1.0f);
  *inliers = n_inliers;
  if (!polish) {
    *done = (*done) || norm6(delta) < st.epsilon;
    *iters += 1;
  }
}

__global__ void __launch_bounds__(kThreads)
ndt_iteration_kernel(const float* __restrict__ src, const uint8_t* __restrict__ mask,
                     const int* __restrict__ table, const float4* __restrict__ packed,
                     const float* __restrict__ origin, const float* __restrict__ inv_leaf_ptr,
                     Grid grid, Batch bs, const float* __restrict__ d2_ptr, float d2_val,
                     const float* __restrict__ ws_ptr, float ws_val, long long N, Carry carry,
                     StepArgs st, int polish, float* __restrict__ partials,
                     unsigned int* __restrict__ counter) {
  const long long b = blockIdx.y;
  float* T = carry.T + 16 * b;
  uint8_t* done = carry.done + b;
  if (!polish && *done) return;  // the loop's cond: this sequence is finished
  __shared__ float Ts[12];
  if (threadIdx.x < 12) Ts[threadIdx.x] = T[threadIdx.x];
  __syncthreads();
  src += b * bs.p;
  mask += b * bs.mask;
  table += b * bs.table;
  packed += b * bs.packed4;
  origin += b * bs.origin;
  const float d2 = d2_ptr ? d2_ptr[b * bs.scalars] : d2_val;
  const float ws = ws_ptr ? ws_ptr[b * bs.scalars] : ws_val;
  const float inv_leaf = inv_leaf_ptr[b];
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;

  const long long K = 7 * N;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x; k < K; k += stride) {
    const long long i = k / 7;
    const int o = (int)(k - 7 * i);
    if (!mask[i]) continue;
    const float sx = src[3 * i], sy = src[3 * i + 1], sz = src[3 * i + 2];
    const float x = Ts[0] * sx + Ts[1] * sy + Ts[2] * sz + Ts[3];
    const float y = Ts[4] * sx + Ts[5] * sy + Ts[6] * sz + Ts[7];
    const float z = Ts[8] * sx + Ts[9] * sy + Ts[10] * sz + Ts[11];
    direct7_pair(acc, x, y, z, o, table, packed, ox, oy, oz, inv_leaf, grid, d2, ws);
  }
  __shared__ float tot[kQ];
  if (!reduce_partials(acc, partials + b * kQ * gridDim.x, counter + b, tot)) return;
  if (threadIdx.x == 0) {
    const float damping = st.damping_ptr ? *st.damping_ptr : st.damping_val;
    gn_step(tot, T, done, carry.iters + b, carry.fitness + b, carry.inliers + b, st, damping,
            polish);
    atomicAdd(&g_worked_launches, 1ull);
  }
}

}  // namespace

extern "C" {

// The whole loop of B sequences on `stream`: max_iterations launches, then
// polish_iterations polish launches, of `nblocks` x B blocks each. src [B, N, 3] f32, mask
// [B, N] u8, table [B, dx * dy * dz] i32, packed [B, rows, 16] f32 (16-byte aligned),
// origin [B, 3] f32, inv_leaf [B] f32; d2 / ws: by value, or pointers to one f32
// (scalars_per_sequence 0) or to B of them (1); damping by value or a pointer to one f32.
// The carry: T [B, 4, 4] f32, done [B] u8, iters [B] i32, fitness [B] f32, inliers [B]
// i32, updated in place. partials: [B * kQ * nblocks] f32; counter: B u32, 0 between
// launches (the kernel leaves it 0). Returns the first nonzero cudaGetLastError() (0 =
// every launch was accepted).
int lgs_ndt_align_loop_batched(const float* src, const uint8_t* mask, const int* table,
                               const float* packed, const float* origin,
                               const float* inv_leaf, int dx, int dy, int dz, int hx, int hy,
                               int hz, long long rows, int B, const float* d2_ptr,
                               float d2_val, const float* ws_ptr, float ws_val, long long N,
                               int scalars_per_sequence, float step_size, float epsilon,
                               const float* damping_ptr, float damping_val, float* T,
                               uint8_t* done, int* iters, float* fitness, int* inliers,
                               int max_iterations, int polish_iterations, float* partials,
                               unsigned int* counter, int nblocks, void* stream) {
  const Grid grid{dx, dy, dz, hx, hy, hz};
  const Batch bs{3 * N, N, (long long)dx * dy * dz, 4 * rows, 3, scalars_per_sequence};
  const Carry carry{T, done, iters, fitness, inliers};
  const StepArgs st{step_size, epsilon, damping_ptr, damping_val};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int it = 0; it < max_iterations + polish_iterations; ++it) {
    ndt_iteration_kernel<<<dim3(nblocks, B), kThreads, 0, s>>>(
        src, mask, table, reinterpret_cast<const float4*>(packed), origin, inv_leaf, grid, bs,
        d2_ptr, d2_val, ws_ptr, ws_val, N, carry, st, it >= max_iterations ? 1 : 0, partials,
        counter);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One sequence: packed [rows, 16] f32, table [dx * dy * dz] i32, origin [3] f32, inv_leaf
// one f32, the carry's fields one each; otherwise as `lgs_ndt_align_loop_batched`.
int lgs_ndt_align_loop(const float* src, const uint8_t* mask, const int* table,
                       const float* packed, const float* origin, const float* inv_leaf, int dx,
                       int dy, int dz, int hx, int hy, int hz, const float* d2_ptr,
                       float d2_val, const float* ws_ptr, float ws_val, long long N,
                       float step_size, float epsilon, const float* damping_ptr,
                       float damping_val, float* T, uint8_t* done, int* iters, float* fitness,
                       int* inliers, int max_iterations, int polish_iterations,
                       float* partials, unsigned int* counter, int nblocks, void* stream) {
  return lgs_ndt_align_loop_batched(src, mask, table, packed, origin, inv_leaf, dx, dy, dz, hx,
                                    hy, hz, 0, 1, d2_ptr, d2_val, ws_ptr, ws_val, N, 0,
                                    step_size, epsilon, damping_ptr, damping_val, T, done,
                                    iters, fitness, inliers, max_iterations,
                                    polish_iterations, partials, counter, nblocks, stream);
}

// The working launches since the last reset, after every queued launch of the device
// finished (a device-wide synchronize: for measurement only). Returns the count, or
// -(CUDA error) on failure.
long long lgs_ndt_worked_launches(int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  unsigned long long n = 0;
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&n, g_worked_launches, sizeof(n));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_worked_launches, &zero, sizeof(zero));
  }
  return err == cudaSuccess ? static_cast<long long>(n) : -static_cast<long long>(err);
}

}  // extern "C"
