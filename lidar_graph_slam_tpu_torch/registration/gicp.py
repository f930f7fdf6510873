"""Generalized ICP (distribution-to-distribution) — the fast_gicp equivalent.

Port of `lidar_graph_slam_tpu/registration/gicp.py`: per-point covariances from the
sorted-grid sliding window (computed once per cloud, not per iteration), regularized
fast_gicp-style by snapping the eigenvalues to (1e-3, 1, 1) so every surface patch is a
plane of fixed conditioning; correspondences from the grid NN, gated by the maximum
distance; the plane-to-plane metric M = (C_q + R C_p R^T)^-1 as a closed-form batched
3x3 inverse. The normal equations go through `ops.kernels.ndt_accumulate` with d2 = 0
and w_scale = 1, where the Magnusson weight degenerates to the match mask: one CUDA
kernel launch per iteration on the card, the plain version on the CPU.

Loop structure: the reference's `lax.while_loop` becomes a Python loop that reads the
device's `done` flag once per iteration, as `registration/ndt.py` and `icp.py` do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.neighbors import (
    HashGrid,
    build_hash_grid,
    nearest,
    window_covariances,
)
from lidar_graph_slam_tpu_torch.ops.voxel import INVALID_KEY, _eigh3x3, as_f32, const
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult, norm, solve_damped


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate. A determinant below 1e-12 in
    magnitude is replaced by +1e-12 (its sign dropped), as in the reference."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def estimate_covariances(points: torch.Tensor, mask: torch.Tensor, cell_size, k: int = 20,
                         window: int = 16):
    """fast_gicp 'PLANE'-regularized covariances, eigenvalues snapped to (1e-3, 1, 1).

    The scatter matrix comes from the sorted-grid sliding window rather than an exact
    k-NN set; the regularization keeps only the principal directions. `k` is kept for
    interface parity with fast_gicp's correspondence_randomness. Returns (covs [N, 3, 3]
    in the ORIGINAL row order, valid [N])."""
    del k
    grid = build_hash_grid(points, mask, cell_size)
    _mu, cov_s, cnt_s = window_covariances(grid, window=window)
    ok_s = cnt_s >= 5.0
    eye = torch.eye(3, dtype=points.dtype, device=points.device).expand(cov_s.shape)
    cov_safe = torch.where(ok_s[:, None, None], cov_s, eye)
    _w, V = _eigh3x3(cov_safe)
    target = const((1e-3, 1.0, 1.0), points.dtype, points.device)  # ascending eigenvalues
    cov_reg = (V * target[None, None, :]) @ V.transpose(-1, -2)
    cov_reg = torch.where(ok_s[:, None, None], cov_reg, eye)
    # Back to the original row order: `order` is a permutation, so this is exact.
    n = points.shape[0]
    covs = torch.empty((n, 3, 3), dtype=points.dtype, device=points.device)
    covs[grid.order] = cov_reg
    ok = torch.empty((n,), dtype=torch.bool, device=points.device)
    ok[grid.order] = ok_s
    return covs, ok & mask


@dataclass
class GicpTarget:
    """Pre-built GICP target: NN grid + plane-regularized covariances (sorted order)."""

    grid: HashGrid
    covs: torch.Tensor   # [N, 3, 3] aligned with grid.points
    valid: torch.Tensor  # [N]


def build_gicp_target(points, mask, cell_size, k: int = 20) -> GicpTarget:
    grid = build_hash_grid(points, mask, cell_size)
    sorted_mask = grid.keys != INVALID_KEY
    covs, ok = estimate_covariances(grid.points, sorted_mask, cell_size, k=k)
    return GicpTarget(grid=grid, covs=covs, valid=ok)


def match(target: GicpTarget, p: torch.Tensor, source_mask: torch.Tensor, corr2,
          bucket_cap: int = 32, neighborhood: int = 7):
    """Forward correspondences of the transformed source `p`: (idx [N] into the target's
    sorted rows, d2 [N], matched [N]) — NN found, source row valid, within the distance
    gate (`corr2` is its square) and a valid target covariance."""
    idx, d2, found = nearest(target.grid, p, bucket_cap=bucket_cap, neighborhood=neighborhood)
    return idx, d2, found & source_mask & (d2 < corr2) & target.valid[idx]


def residual_rows(target: GicpTarget, idx: torch.Tensor, p: torch.Tensor, R: torch.Tensor,
                  source_covs: torch.Tensor):
    """(e [N, 3], M [N, 3, 3]): the residual p - q and the plane-to-plane metric
    (C_q + R C_p R^T)^-1 of every row, matched or not — the rows the accumulation takes."""
    M = _inv3x3(target.covs[idx] + R @ source_covs @ R.T)
    return p - target.grid.points[idx], M


def gicp_align(
    target: GicpTarget,
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    init_transform: torch.Tensor,
    source_covs: torch.Tensor,
    max_correspondence_distance: float = 2.0,
    transform_epsilon: float = 0.01,
    max_iterations: int = 64,
    k: int = 20,
    bucket_cap: int = 32,
    reciprocal: bool = False,
    source_grid: HashGrid | None = None,
    neighborhood: int = 7,
) -> RegistrationResult:
    """Plane-to-plane GICP: minimize sum e^T (C_q + R C_p R^T)^-1 e over SE(3).

    `reciprocal=True` is PCL's `setUseReciprocalCorrespondences`: a pair (p_i -> q_j)
    survives only if q_j's nearest neighbor among the transformed source points is p_i.
    NN distance is rigid-invariant, so the backward query runs in the SOURCE frame
    against `source_grid`, a grid of the untransformed source (required when
    reciprocal). `neighborhood=7` searches the face-adjacent cells; 27 the full ring.
    `k` is kept for interface parity."""
    del k
    if reciprocal and source_grid is None:
        raise ValueError("reciprocal=True requires source_grid")
    corr2 = max_correspondence_distance * max_correspondence_distance
    dtype, dev = source_points.dtype, source_points.device
    n = source_points.shape[0]
    rows = torch.arange(n, device=dev)
    damping = as_f32(1e-6, source_points)

    def body(T, done, iters):
        p = se3.transform_points(T, source_points)
        idx, d2, matched = match(target, p, source_mask, corr2, bucket_cap, neighborhood)
        if reciprocal:
            # Backward NN in the source frame: T^-1 q against the static source grid.
            q_back = se3.transform_points(se3.inverse(T), target.grid.points[idx])
            bidx, _bd2, bfound = nearest(source_grid, q_back, bucket_cap=bucket_cap,
                                         neighborhood=neighborhood)
            back_orig = source_grid.order[bidx]  # sorted row -> original source row
            matched = matched & bfound & (back_orig == rows)

        e, M = residual_rows(target, idx, p, T[:3, :3], source_covs)
        # NDT's accumulation with d2 = 0: the weight is the match mask, which leaves the
        # plain GICP normal equations. Unmatched rows (e up to ~1e6 at padding) get
        # weight exactly 0.
        H, g, _sw, n_hit = kernels.ndt_accumulate(e, M, p, matched, 0.0, 1.0)
        n_inl = n_hit.to(torch.int32)

        delta = solve_damped(H, g, damping)
        ok = torch.isfinite(delta).all() & (n_inl >= 6)
        delta = torch.where(ok, delta, 0.0)
        T_new = se3.se3_exp(delta) @ T

        fitness = torch.sum(torch.where(matched, d2, 0.0)) / torch.clamp(n_inl, min=1)
        newly_done = norm(delta) < transform_epsilon
        return T_new, done | newly_done, iters + 1, fitness, n_inl

    T = init_transform.to(dtype)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    fitness = torch.full((), torch.inf, dtype=dtype, device=dev)
    n_inl = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iterations):
        T, done, iters, fitness, n_inl = body(T, done, iters)
        if bool(done):  # the one host read per iteration
            break
    # PCL parity: the max-iterations stop counts as converged; quality is gated by the
    # inlier count and the caller's health gate.
    converged = ((done | (iters >= max_iterations)) & (n_inl >= 6)
                 & torch.isfinite(T).all())
    return RegistrationResult(transform=T, converged=converged, iterations=iters,
                              fitness=fitness, num_inliers=n_inl)


def make_gicp_matcher(cfg, cell_size: float = 2.0):
    """Matcher closures (build_target, align) for the front end. Unlike NDT and ICP,
    `align` takes the source covariances, which the front end computes once per scan
    with `estimate_covariances`."""

    def build_target(points, mask):
        return build_gicp_target(points, mask, cell_size, k=cfg.correspondence_randomness)

    def align(target, points, mask, init_T, source_covs):
        source_grid = (build_hash_grid(points, mask, cfg.max_correspondence_distance)
                       if cfg.use_reciprocal else None)
        return gicp_align(
            target, points, mask, init_T, source_covs,
            max_correspondence_distance=cfg.max_correspondence_distance,
            transform_epsilon=cfg.transform_epsilon,
            max_iterations=cfg.max_iterations,
            k=cfg.correspondence_randomness,
            reciprocal=cfg.use_reciprocal,
            source_grid=source_grid,
        )

    return build_target, align
