"""SE(3) pose-graph optimizer — the f32 device tier and the solve escalation ladder.

Port of `lidar_graph_slam_tpu/graph/solver.py`. A pose graph from this pipeline is a
chain plus L loop factors: the Gauss-Newton normal matrix is block-tridiagonal plus L
rank-6 corrections. The chain part is solved by a block-tridiagonal elimination whose
algorithm depends on K as in the reference (sequential scan below 8 blocks, cyclic
reduction from 8 to 2047, blocked substructuring with padding from 2048); loop factors
enter through the Woodbury identity. `optimize` is the f32 Levenberg-Marquardt that the
escalation ladder (`escalate_f64`) runs only when the host float64 tier
(`graph/refine64.py`) stalls.

Differences of form, not of result:
  * `PoseGraph` is a dataclass of tensors on one device. As in the reference, every
    update returns a new graph and no tensor of a graph is written in place, so a
    snapshot (or a slice of one) stays valid while the live graph moves on. A write past
    capacity is refused by a masked write (no slot matches the index) and the count is
    clamped — the reference's scatter `mode="drop"`.
  * The jitted `while_loop` of `optimize` is a Python loop that reads `done` once per
    iteration.
  * Loop-factor scatters are one-hot contractions, so the result does not depend on the
    order of float atomics on the card.
  * Linear solves use `solve_ex`, which neither raises nor syncs on a singular block
    (the reference's solve returns non-finite values there too).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.graph import refine64


@dataclass
class PoseGraph:
    """Fixed-capacity factor-graph state (SoA over keyframes and loop factors).

    Field names are the reference's; `utils/state.py` builds one from its arrays."""

    poses: torch.Tensor       # [K, 4, 4] current estimates
    pose_mask: torch.Tensor   # [K] bool — active keyframes
    odom_meas: torch.Tensor   # [K, 4, 4] Z_k = between(T_{k-1}, T_k); row 0 unused
    prior_pose: torch.Tensor  # [4, 4] anchor for pose 0
    odom_info: torch.Tensor   # [6] diagonal information (1/sigma^2) for prior+odometry
    loop_i: torch.Tensor      # [L] int64 source keyframe ids
    loop_j: torch.Tensor      # [L] int64 target keyframe ids
    loop_meas: torch.Tensor   # [L, 4, 4] Z_l = between(T_i, T_j) measured by the verifier
    loop_info: torch.Tensor   # [L, 6] diagonal information per loop factor
    loop_mask: torch.Tensor   # [L] bool
    num_poses: torch.Tensor   # 0-d int64
    num_loops: torch.Tensor   # 0-d int64

    def replace(self, **changes) -> "PoseGraph":
        return dataclasses.replace(self, **changes)


def init_graph(max_keyframes: int, max_loops: int, odom_noise_var, device=None) -> PoseGraph:
    def eyes(n):
        return torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1)

    return PoseGraph(
        poses=eyes(max_keyframes),
        pose_mask=torch.zeros(max_keyframes, dtype=torch.bool, device=device),
        odom_meas=eyes(max_keyframes),
        prior_pose=torch.eye(4, dtype=torch.float32, device=device),
        odom_info=1.0 / torch.as_tensor(odom_noise_var, dtype=torch.float32, device=device),
        loop_i=torch.zeros(max_loops, dtype=torch.int64, device=device),
        loop_j=torch.zeros(max_loops, dtype=torch.int64, device=device),
        loop_meas=eyes(max_loops),
        loop_info=torch.ones((max_loops, 6), dtype=torch.float32, device=device),
        loop_mask=torch.zeros(max_loops, dtype=torch.bool, device=device),
        num_poses=torch.zeros((), dtype=torch.int64, device=device),
        num_loops=torch.zeros((), dtype=torch.int64, device=device),
    )


def graph_add_keyframes_batch(g: PoseGraph, poses: torch.Tensor, odoms: torch.Tensor,
                              count: int) -> PoseGraph:
    """Append the first `count` of a [B, 4, 4] keyframe batch: exactly `count` sequential
    `graph_add_keyframe` calls, each refused once the graph is full."""
    K = g.pose_mask.shape[0]
    B = poses.shape[0]
    k0 = g.num_poses
    j = torch.arange(K, device=k0.device) - k0            # batch row landing on each slot
    take = (j >= 0) & (j < min(count, B))                  # slots past K do not exist
    jc = j.clamp(0, B - 1)
    prior = torch.where(k0 == 0, poses[0], g.prior_pose) if count > 0 else g.prior_pose
    return g.replace(
        poses=torch.where(take[:, None, None], poses[jc], g.poses),
        odom_meas=torch.where(take[:, None, None], odoms[jc], g.odom_meas),
        pose_mask=g.pose_mask | take,
        prior_pose=prior,
        num_poses=torch.clamp(k0 + count, max=K),
    )


def graph_add_keyframe(g: PoseGraph, pose: torch.Tensor, odom_meas: torch.Tensor) -> PoseGraph:
    """Append a keyframe with its odometry between-measurement; refused at capacity."""
    return graph_add_keyframes_batch(g, pose[None], odom_meas[None], 1)


def graph_add_loop(g: PoseGraph, i, j, meas: torch.Tensor, info_diag: torch.Tensor) -> PoseGraph:
    """Append a loop between-factor (the reference's noise = fitness * I6, so callers pass
    info_diag = 1/fitness * ones). At capacity the insert is REFUSED and num_loops stays
    clamped, rather than silently overwriting the last factor."""
    L = g.loop_mask.shape[0]
    slot = torch.arange(L, device=g.num_loops.device) == g.num_loops   # no slot when full
    return g.replace(
        loop_i=torch.where(slot, torch.as_tensor(i, device=slot.device), g.loop_i),
        loop_j=torch.where(slot, torch.as_tensor(j, device=slot.device), g.loop_j),
        loop_meas=torch.where(slot[:, None, None], meas.to(g.loop_meas), g.loop_meas),
        loop_info=torch.where(slot[:, None], info_diag.to(g.loop_info), g.loop_info),
        loop_mask=g.loop_mask | slot,
        num_loops=torch.clamp(g.num_loops + 1, max=L),
    )


# --- residuals / linearization ----------------------------------------------------------


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) adjoint (ad) of a twist, (omega, v) ordering: [[W,0],[V,W]]."""
    W = se3.hat(xi[..., :3])
    V = se3.hat(xi[..., 3:])
    Z = torch.zeros_like(W)
    top = torch.cat([W, Z], dim=-1)
    bot = torch.cat([V, W], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of the SE(3) log, 2nd-order series: I + ad/2 + ad^2/12."""
    ad = _ad_se3(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device).expand(ad.shape)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


def between_residual(Ti: torch.Tensor, Tj: torch.Tensor, Z: torch.Tensor):
    """Residual r = log(Z^{-1} T_i^{-1} T_j) and Jacobians (J_i, J_j) for right
    perturbations T <- T exp(xi)."""
    E = se3.inverse(Z) @ se3.inverse(Ti) @ Tj
    r = se3.se3_log(E)
    Jr = _jr_inv(r)
    Jj = Jr
    Ji = -Jr @ se3.adjoint(se3.inverse(Tj) @ Ti)
    return r, Ji, Jj


def graph_cost(g: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """Total weighted squared residual under candidate poses."""
    r0 = se3.se3_log(se3.inverse(g.prior_pose) @ poses[0])
    cost = torch.sum(r0 * g.odom_info * r0)
    E = se3.inverse(g.odom_meas[1:]) @ se3.inverse(poses[:-1]) @ poses[1:]
    r = se3.se3_log(E)
    m = (g.pose_mask[1:] & g.pose_mask[:-1]).to(poses.dtype)
    cost = cost + torch.sum(m[:, None] * r * g.odom_info[None, :] * r)
    rl = se3.se3_log(se3.inverse(g.loop_meas) @ se3.inverse(poses[g.loop_i]) @ poses[g.loop_j])
    ml = g.loop_mask.to(poses.dtype)
    return cost + torch.sum(ml[:, None] * rl * g.loop_info * rl)


# --- block-tridiagonal solve ------------------------------------------------------------


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, B)[0]


def _tridiag_solve_cr(D: torch.Tensor, U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Block cyclic reduction solve of the symmetric block-tridiagonal system H x = B.

    D: [K, 6, 6]; U: [K, 6, 6] with U[k] = H[k, k+1] (U[K-1] ignored); B: [K, 6, M].
    K is padded internally to a power of two with decoupled identity blocks. Every odd
    block is eliminated in parallel and the half-size even system recurses:

      D'_j = D_2j − U_{2j−1}^T D_{2j−1}^{-1} U_{2j−1} − U_2j D_{2j+1}^{-1} U_2j^T
      U'_j = −U_2j D_{2j+1}^{-1} U_{2j+1}
      b'_j = b_2j − U_{2j−1}^T D_{2j−1}^{-1} b_{2j−1} − U_2j D_{2j+1}^{-1} b_{2j+1}
      back-substitution: x_{2j+1} = D_{2j+1}^{-1}(b_{2j+1} − U_2j^T x_2j − U_{2j+1} x_{2j+2})
    """
    K = D.shape[0]
    M = B.shape[-1]
    dtype, dev = D.dtype, D.device
    Kp = 1 << max(K - 1, 1).bit_length()
    if Kp != K:
        pad = Kp - K
        D = torch.cat([D, torch.eye(6, dtype=dtype, device=dev).expand(pad, 6, 6)])
        U = torch.cat([U[: K - 1], torch.zeros((pad + 1, 6, 6), dtype=dtype, device=dev)])
        B = torch.cat([B, torch.zeros((pad, 6, M), dtype=dtype, device=dev)])

    def solve_level(D, U, B):
        n = D.shape[0]
        if n == 1:
            return _solve(D[0], B[0])[None]
        D_e, D_o = D[0::2], D[1::2]
        B_e, B_o = B[0::2], B[1::2]
        U_eo = U[0::2]                                   # U_{2j}: even 2j -> odd 2j+1
        U_oe = U[1::2].clone()                           # U_{2j+1}: odd 2j+1 -> even 2j+2
        U_oe[-1] = 0.0                                   # no even block after the last odd

        rhs_o = torch.cat([U_eo.transpose(-1, -2), U_oe, B_o], dim=-1)
        sol_o = _solve(D_o, rhs_o)
        Dinv_Ueo_T = sol_o[..., :6]
        Dinv_Uoe = sol_o[..., 6:12]
        Dinv_bo = sol_o[..., 12:]

        D_right = U_eo @ Dinv_Ueo_T
        U_new = -(U_eo @ Dinv_Uoe)
        b_right = U_eo @ Dinv_bo
        UT_Dinv_U = U_oe.transpose(-1, -2) @ Dinv_Uoe
        b_left_src = U_oe.transpose(-1, -2) @ Dinv_bo
        D_left = torch.cat([torch.zeros((1, 6, 6), dtype=dtype, device=dev), UT_Dinv_U[:-1]])
        b_left = torch.cat([torch.zeros((1, 6, M), dtype=dtype, device=dev), b_left_src[:-1]])

        x_e = solve_level(D_e - D_right - D_left, U_new, B_e - b_right - b_left)
        x_e_next = torch.cat([x_e[1:], torch.zeros((1, 6, M), dtype=dtype, device=dev)])
        x_o = Dinv_bo - Dinv_Ueo_T @ x_e - Dinv_Uoe @ x_e_next
        return torch.stack([x_e, x_o], dim=1).reshape(n, 6, M)

    return solve_level(D, U, B)[:K]


def _tridiag_solve(D: torch.Tensor, U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve the block-tridiagonal system H x = B.

    D: [K, 6, 6] diagonal blocks; U: [K-1, 6, 6] super-diagonal blocks (H[k, k+1]);
    B: [K, 6, M]. Returns x [K, 6, M]. Same K thresholds as the reference, so the same K
    takes the same algorithm: scan below 8, cyclic reduction up to 2047, blocked above.
    """
    K = D.shape[0]
    if 8 <= K < 2048:
        U_full = torch.cat([U, torch.zeros((1, 6, 6), dtype=D.dtype, device=D.device)])
        return _tridiag_solve_cr(D, U_full, B)
    if K >= 2048:
        seg = 64
        if K % seg:
            # Pad to a seg multiple with decoupled identity blocks (zero coupling, zero rhs).
            pad = seg - K % seg
            z = torch.zeros((pad, 6, 6), dtype=D.dtype, device=D.device)
            D = torch.cat([D, torch.eye(6, dtype=D.dtype, device=D.device).expand(pad, 6, 6)])
            U = torch.cat([U, z])
            B = torch.cat([B, torch.zeros((pad,) + B.shape[1:], dtype=B.dtype, device=B.device)])
            return _tridiag_solve_blocked(D, U, B)[:K]
        return _tridiag_solve_blocked(D, U, B)
    return _tridiag_solve_scan(D, U, B)


def _tridiag_solve_blocked(D: torch.Tensor, U: torch.Tensor, B: torch.Tensor,
                           seg: int = 64) -> torch.Tensor:
    """Blocked substructuring solve: the K-block chain splits into S = K/seg segments
    whose last block is a separator; all S interior systems are eliminated by ONE batched
    scan, condensing onto the S-block separator system, solved recursively. Requires
    K % seg == 0 and seg >= 3 (`_tridiag_solve` pads)."""
    K = D.shape[0]
    M = B.shape[-1]
    dtype, dev = D.dtype, D.device
    if K % seg or seg < 3:
        raise ValueError(f"blocked solve needs K % seg == 0 and seg >= 3, got {K}, {seg}")
    S = K // seg

    D_s = D.reshape(S, seg, 6, 6)
    B_s = B.reshape(S, seg, 6, M)
    U_s = torch.cat([U, torch.zeros((1, 6, 6), dtype=dtype, device=dev)]).reshape(S, seg, 6, 6)
    zero = torch.zeros((1, 6, 6), dtype=dtype, device=dev)
    U_prev_last = torch.cat([zero, U_s[:-1, seg - 1]])                    # [S, 6, 6]
    U_last_int = U_s[:, seg - 2]                                           # [S, 6, 6]

    D_int = D_s[:, : seg - 1]
    U_int = U_s[:, : seg - 2]
    b_int = B_s[:, : seg - 1]
    C_cols = torch.zeros((S, seg - 1, 6, 6), dtype=dtype, device=dev)
    C_cols[:, 0] = U_prev_last.transpose(-1, -2)
    B_cols = torch.zeros((S, seg - 1, 6, 6), dtype=dtype, device=dev)
    B_cols[:, seg - 2] = U_last_int
    rhs = torch.cat([b_int, C_cols, B_cols], dim=-1)                      # [S, seg-1, 6, M+12]
    sol = _tridiag_solve_scan(D_int, U_int, rhs)
    y = sol[..., :M]
    W_C = sol[..., M:M + 6]
    W_B = sol[..., M + 6:]

    Ct = U_prev_last
    Bt = U_last_int.transpose(-1, -2)
    CtW_C = Ct @ W_C[:, 0]
    CtW_B = Ct @ W_B[:, 0]
    Cty = Ct @ y[:, 0]
    BtW_B = Bt @ W_B[:, seg - 2]
    Bty = Bt @ y[:, seg - 2]

    S_diag = D_s[:, seg - 1] - BtW_B
    S_diag = torch.cat([S_diag[:-1] - CtW_C[1:], S_diag[-1:]])
    S_off = -CtW_B[1:]
    S_rhs = B_s[:, seg - 1] - Bty
    S_rhs = torch.cat([S_rhs[:-1] - Cty[1:], S_rhs[-1:]])
    x_sep = _tridiag_solve(S_diag, S_off, S_rhs)                          # [S, 6, M]

    x_prev = torch.cat([torch.zeros((1, 6, M), dtype=dtype, device=dev), x_sep[:-1]])
    x_int = y - W_C @ x_prev[:, None] - W_B @ x_sep[:, None]
    return torch.cat([x_int, x_sep[:, None]], dim=1).reshape(K, 6, M)


def _tridiag_solve_scan(D: torch.Tensor, U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Sequential forward block elimination + back substitution over the block axis -3
    (leading axes are independent systems, the reference's vmap).

    D: [..., K, 6, 6]; U: [..., K-1, 6, 6]; B: [..., K, 6, M]."""
    K = D.shape[-3]
    batch = D.shape[:-3]
    dtype, dev = D.dtype, D.device
    S_prev = torch.eye(6, dtype=dtype, device=dev).expand(batch + (6, 6))
    y_prev = torch.zeros(batch + (6, B.shape[-1]), dtype=dtype, device=dev)
    S_all, y_all, G_all = [], [], []
    for k in range(K):
        Uk_prev = U[..., k - 1, :, :] if k else torch.zeros(batch + (6, 6), dtype=dtype,
                                                             device=dev)
        G = _solve(S_prev, Uk_prev)
        UT = Uk_prev.transpose(-1, -2)
        S = D[..., k, :, :] - UT @ G
        y = B[..., k, :, :] - UT @ _solve(S_prev, y_prev)
        S_all.append(S)
        y_all.append(y)
        G_all.append(G)
        S_prev, y_prev = S, y
    # Back substitution: x_{K-1} = S^{-1} y; x_k = S_k^{-1} y_k - G_{k+1} x_{k+1}.
    xs = [None] * K
    x_next = torch.zeros_like(y_prev)
    for k in range(K - 1, -1, -1):
        G_next = G_all[k + 1] if k + 1 < K else torch.zeros_like(S_prev)
        x_next = _solve(S_all[k], y_all[k]) - G_next @ x_next
        xs[k] = x_next
    return torch.stack(xs, dim=-3)


def _assemble_chain(g: PoseGraph, poses: torch.Tensor, damping: torch.Tensor):
    """Build block-tridiagonal (D, U) and gradient rhs b from prior + odometry factors."""
    K = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    info = g.odom_info.to(dtype)

    r, Ji, Jj = between_residual(poses[:-1], poses[1:], g.odom_meas[1:])
    m = (g.pose_mask[1:] & g.pose_mask[:-1]).to(dtype)[:, None, None]
    JiW = Ji.transpose(-1, -2) * info[None, None, :]
    JjW = Jj.transpose(-1, -2) * info[None, None, :]
    A = m * (JiW @ Ji)
    Coff = m * (JiW @ Jj)
    Cdiag = m * (JjW @ Jj)
    bi = -(m[..., 0] * (JiW @ r[..., None])[..., 0])
    bj = -(m[..., 0] * (JjW @ r[..., None])[..., 0])

    D = torch.zeros((K, 6, 6), dtype=dtype, device=dev)
    D[:-1] += A
    D[1:] += Cdiag
    b = torch.zeros((K, 6), dtype=dtype, device=dev)
    b[:-1] += bi
    b[1:] += bj

    r0 = se3.se3_log(se3.inverse(g.prior_pose) @ poses[0])
    J0 = _jr_inv(r0)
    J0W = J0.transpose(-1, -2) * info[None, :]
    D[0] += J0W @ J0
    b[0] += -(J0W @ r0[:, None])[:, 0]

    active = g.pose_mask.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    D = active[:, None, None] * D + (1.0 - active)[:, None, None] * eye6
    b = active[:, None] * b
    D = D + damping * active[:, None, None] * eye6
    return D, Coff, b


def _loop_terms(g: PoseGraph, poses: torch.Tensor):
    """Loop-factor residual and Jacobians (r [L,6], Ji, Jj [L,6,6])."""
    return between_residual(poses[g.loop_i], poses[g.loop_j], g.loop_meas)


def loop_gradient_and_whitened_columns(g: PoseGraph, poses: torch.Tensor):
    """Loop-factor linearization: (b_loop [K, 6] gradient contribution, Vw [K, 6, 6L]
    whitened Woodbury columns). Whitening by sqrt(info) makes the Woodbury small system
    I + Vw^T T^-1 Vw unit-diagonal; masked loops produce zero columns."""
    K = poses.shape[0]
    L = g.loop_i.shape[0]
    dtype = poses.dtype
    r, Ji, Jj = _loop_terms(g, poses)
    ml = g.loop_mask.to(dtype)[:, None]
    info_l = g.loop_info.to(dtype) * ml
    JiW = Ji.transpose(-1, -2) * info_l[:, None, :]
    JjW = Jj.transpose(-1, -2) * info_l[:, None, :]
    rows = torch.arange(K, device=poses.device)
    oh_i = (g.loop_i[:, None] == rows).to(dtype)                 # [L, K] one-hot scatter
    oh_j = (g.loop_j[:, None] == rows).to(dtype)
    b_loop = (oh_i.T @ -(JiW @ r[..., None])[..., 0]
              + oh_j.T @ -(JjW @ r[..., None])[..., 0])

    sqrt_info = torch.sqrt(info_l)
    JiS = Ji.transpose(-1, -2) * sqrt_info[:, None, :]
    JjS = Jj.transpose(-1, -2) * sqrt_info[:, None, :]
    Vw = (torch.einsum("lk,lab->kalb", oh_i, JiS)
          + torch.einsum("lk,lab->kalb", oh_j, JjS))
    return b_loop, Vw.reshape(K, 6, L * 6)


def woodbury_correct(Vw: torch.Tensor, Tinv_b: torch.Tensor, Tinv_V: torch.Tensor) -> torch.Tensor:
    """delta = T^-1 b - T^-1 Vw (I + Vw^T T^-1 Vw)^-1 Vw^T T^-1 b."""
    VtTinvV = torch.einsum("kim,kin->mn", Vw, Tinv_V)
    VtTinvb = torch.einsum("kim,ki->m", Vw, Tinv_b)
    small = torch.eye(Vw.shape[-1], dtype=Vw.dtype, device=Vw.device) + VtTinvV
    z = _solve(small, VtTinvb[:, None])[:, 0]
    return Tinv_b - torch.einsum("kim,m->ki", Tinv_V, z)


def _solve_step(g: PoseGraph, poses: torch.Tensor, damping: torch.Tensor) -> torch.Tensor:
    """One damped GN step: returns delta twists [K, 6] (right perturbation)."""
    D, U, b_chain = _assemble_chain(g, poses, damping)
    b_loop, Vw = loop_gradient_and_whitened_columns(g, poses)
    rhs = torch.cat([(b_chain + b_loop)[..., None], Vw], dim=-1)         # [K, 6, 1+6L]
    sol = _tridiag_solve(D, U, rhs)
    return woodbury_correct(Vw, sol[..., 0], sol[..., 1:])


# Rejected steps below this norm are the f32 floor's noise, not progress: at automotive
# scale f32 pose storage rounding, weighted by information up to 1e8, makes LM propose
# sub-millimeter steps that genuinely worsen the cost at the optimum.
_STUCK_STEP_TOL = 1e-3


def optimize(g: PoseGraph, max_iterations: int = 10, init_damping: float = 1e-4,
             step_tolerance: float = 1e-6) -> PoseGraph:
    """Levenberg-Marquardt over the full graph, warm-started from the current estimates;
    returns the graph with updated poses. Stops on an accepted plateau (< 1e-5 relative
    cost change), a step below `step_tolerance`, or a sub-`_STUCK_STEP_TOL` step that was
    REJECTED (the f32 floor) — one host read of that flag per iteration."""
    dtype, dev = g.poses.dtype, g.poses.device
    poses = g.poses
    cost0 = graph_cost(g, poses)
    damping = torch.full((), init_damping, dtype=dtype, device=dev)
    for _ in range(max_iterations):
        delta = _solve_step(g, poses, damping)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        cand = poses @ se3.se3_exp(delta)
        cand_cost = graph_cost(g, cand)
        accept = cand_cost < cost0
        step_norm = torch.max(torch.sqrt(torch.sum(delta * delta, dim=-1)))
        plateau = accept & (torch.abs(cand_cost - cost0)
                            < 1e-5 * torch.clamp(cost0, min=1e-3))
        stuck = (~accept) & (step_norm < _STUCK_STEP_TOL)
        poses = torch.where(accept, cand, poses)
        cost0 = torch.where(accept, cand_cost, cost0)
        damping = torch.clamp(torch.where(accept, damping * 0.3, damping * 8.0), 1e-9, 1e6)
        done = (step_norm < step_tolerance) | plateau | stuck
        if bool(done):  # the one host read per iteration
            break
    return g.replace(poses=poses)


def escalate_f64(view, device_lm, probe_iterations: int = 2,
                 refine_max_iterations: int = 12, tail_iterations: int = 6):
    """The solve escalation ladder, shared by `solve_incremental` and the back end:

      1. warm probe: `probe_iterations` of host f64 Gauss-Newton (a graph already at its
         optimum converges from its first step);
      2. cold continuation: more f64 Gauss-Newton;
      3. only if f64 itself stalls, `device_lm(poses64)` runs the f32 LM and returns f64
         poses, and an f64 tail finishes to the optimum.

    `view` is a `refine64.GraphView`; its `.poses` is mutated to thread progress.
    Returns (poses64, info) with info["device_lm"] and cumulative info["iterations"].
    """
    poses64, info = refine64.refine(view, max_iterations=probe_iterations)
    total_iters = info["iterations"]
    info["device_lm"] = False
    if not info["converged"]:
        view.poses = poses64
        poses64, info = refine64.refine(view, max_iterations=refine_max_iterations)
        total_iters += info["iterations"]
        info["device_lm"] = False
    if not info["converged"]:
        view.poses = device_lm(poses64)
        poses64, info = refine64.refine(view, max_iterations=tail_iterations)
        total_iters += info["iterations"]
        info["device_lm"] = True
    info["iterations"] = total_iters
    return poses64, info


def set_poses(g: PoseGraph, poses64: np.ndarray) -> PoseGraph:
    """The graph with its first len(poses64) poses replaced (f32 on the graph's device)."""
    k = poses64.shape[0]
    head = torch.as_tensor(np.asarray(poses64, np.float32), device=g.poses.device)
    return g.replace(poses=torch.cat([head, g.poses[k:]]))


def solve_incremental(g: PoseGraph, max_iterations: int = 30, probe_iterations: int = 2,
                      refine_max_iterations: int = 12):
    """Hybrid f64-host + f32-device pose-graph solve: the `escalate_f64` ladder with
    `optimize` as the device fallback. Returns (solved PoseGraph, info dict)."""
    view = refine64.GraphView.from_device_graph(g)
    if view.poses.shape[0] == 0:
        return g, {"iterations": 0, "converged": True, "device_lm": False,
                   "initial_step_norm": 0.0, "final_cost": 0.0}

    def device_lm(poses64):
        gd = optimize(set_poses(g, poses64), max_iterations=max_iterations)
        return gd.poses[: poses64.shape[0]].cpu().numpy().astype(np.float64)

    poses64, info = escalate_f64(
        view, device_lm, probe_iterations=probe_iterations,
        refine_max_iterations=refine_max_iterations, tail_iterations=refine_max_iterations)
    return set_poses(g, poses64), info
