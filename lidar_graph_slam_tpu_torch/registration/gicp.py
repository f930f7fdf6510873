"""Generalized ICP (distribution-to-distribution) — the fast_gicp equivalent.

Port of `lidar_graph_slam_tpu/registration/gicp.py`: per-point covariances from the
sorted-grid sliding window (computed once per cloud, not per iteration), regularized
fast_gicp-style by snapping the eigenvalues to (1e-3, 1, 1) so every surface patch is a
plane of fixed conditioning (on the card one launch after the cells' sort,
`ops.kernels.gicp_covariances`; on the CPU its plain version); correspondences from the grid NN, gated by the maximum distance; the
plane-to-plane metric M = (C_q + R C_p R^T)^-1 as a closed-form batched 3x3 inverse; the
normal equations of NDT's accumulation with d2 = 0 and w_scale = 1, where the Magnusson
weight degenerates to the match mask.

Loop structure: the reference's `lax.while_loop` is `ops.kernels.gicp_align_loop`, one
call an alignment. On the card it enqueues one launch of the `gicp_iteration` kernel an
iteration (match, rows, accumulation and the 6x6 step in one launch, the carry on the
device; a launch that finds the carry done exits at once) and reads nothing back; on the
CPU it runs the same body in torch ops (`gicp_align_loop_plain`). The body's pieces
(`match`, `residual_rows`, `_inv3x3`) live beside the kernel in `ops/kernels.py`, which
this module may import but not the other way round.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.kernels import (  # noqa: F401  (the body's pieces)
    gicp_match as match,
    gicp_residual_rows as residual_rows,
    inv3x3 as _inv3x3,
)
from lidar_graph_slam_tpu_torch.ops.neighbors import HashGrid, build_hash_grid, sort_by_cell
from lidar_graph_slam_tpu_torch.ops.voxel import INVALID_KEY, as_f32
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult


def _covariances(keys: torch.Tensor, points: torch.Tensor, order: torch.Tensor,
                 mask: torch.Tensor):
    """The covariances of rows sorted by cell (`keys`, `points`): their window sums (+-16
    sorted rows, the reference's default), then the plane regularization written at each
    row's index in `order`, valid where `mask` (`kernels.gicp_covariances`: one launch on
    the card)."""
    return kernels.gicp_covariances(keys, points, order, mask)


def estimate_covariances(points: torch.Tensor, mask: torch.Tensor, cell_size, k: int = 20):
    """fast_gicp 'PLANE'-regularized covariances, eigenvalues snapped to (1e-3, 1, 1).

    The scatter matrix comes from the sorted-grid sliding window (+-16 sorted rows, the
    reference's default window, which every caller uses) rather than an exact k-NN set;
    the regularization keeps only the principal directions. The rows sorted by cell (the
    grid's keys, points and order, without its lookup table), then `_covariances`. `k`
    is kept for interface parity with fast_gicp's correspondence_randomness. Returns
    (covs [N, 3, 3] in the ORIGINAL row order, valid [N])."""
    del k
    cells = sort_by_cell(points, mask, cell_size)
    return _covariances(cells.keys, cells.points, cells.order, mask)


@dataclass
class GicpTarget:
    """Pre-built GICP target: NN grid + plane-regularized covariances (sorted order)."""

    grid: HashGrid
    covs: torch.Tensor   # [N, 3, 3] aligned with grid.points
    valid: torch.Tensor  # [N]


def build_gicp_target(points, mask, cell_size, k: int = 20) -> GicpTarget:
    """The grid of `points`, and `estimate_covariances` of its sorted points, as the
    reference builds them. Sorting the grid's points by cell again (the reference's second
    `build_hash_grid`) gives the grid's own keys and the identity order (the same origin,
    keys already in order, a stable sort), so the window sums read the grid's rows
    directly and the covariances stay in its order. `k` is kept for interface parity."""
    del k
    grid = build_hash_grid(points, mask, cell_size)
    identity = torch.arange(grid.keys.shape[0], device=points.device)
    covs, ok = _covariances(grid.keys, grid.points, identity, grid.keys != INVALID_KEY)
    return GicpTarget(grid=grid, covs=covs, valid=ok)


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
    T, done, iters, fitness, n_inl = kernels.gicp_align_loop(
        target, source_points, source_mask, source_covs, init_transform,
        max_correspondence_distance * max_correspondence_distance, transform_epsilon,
        as_f32(1e-6, source_points), max_iterations, bucket_cap, neighborhood,
        source_grid if reciprocal else None)
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
