"""Point-to-point ICP — the back end's loop-closure verifier.

Port of `lidar_graph_slam_tpu/registration/icp.py` (PCL `IterativeClosestPoint` as the
reference's loop pipeline configures it). Correspondences come from the sorted-grid NN
(`ops.neighbors.nearest`), and each iteration applies the closed-form optimal rigid motion
(weighted Umeyama/Kabsch via a 3x3 SVD). The fitness is PCL's `getFitnessScore` (mean
squared correspondence distance), with unmatched source points contributing a capped
penalty in the "penalized" mode.

Loop structure: the reference's `lax.while_loop` is `ops.kernels.icp_align_loop`, one call
an alignment. On the card it enqueues one launch of the `icp_iteration` kernel an
iteration (the match, the sums and the closed-form step with its 3x3 SVD and stop test in
one launch, the carry on the device; a launch that finds the carry done exits at once)
and reads nothing back; on the CPU it runs the reference's body in torch ops
(`icp_align_loop_plain`). The loop gate's fitness is `ops.kernels.icp_fitness`, one launch
on the card. The body's pieces (`umeyama_step`, `icp_match`, `icp_body_plain`) live beside
the kernels in `ops/kernels.py`, which this module may import but not the other way round.
"""

from __future__ import annotations

import torch

from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.kernels import umeyama_step as _umeyama_step  # noqa: F401
from lidar_graph_slam_tpu_torch.ops.neighbors import HashGrid, build_hash_grid
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult


def icp_align(
    target_grid: HashGrid,
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    init_transform: torch.Tensor,
    max_correspondence_distance: float = 2.0,
    max_iterations: int = 50,
    transform_epsilon: float = 1e-6,
    euclidean_fitness_epsilon: float = 0.0,
    bucket_cap: int = 32,
    neighborhood: int = 27,
) -> RegistrationResult:
    """Align masked source points to a pre-built target grid. Returns source->target.

    The grid's cell size bounds the NN search radius (one cell ring).
    `euclidean_fitness_epsilon` is PCL's absolute-MSE stop: iteration stops when the
    fitness change between consecutive iterations falls below it; 0 disables.
    """
    T, done, iters, fitness, n_inl = kernels.icp_align_loop(
        target_grid, source_points, source_mask, init_transform,
        max_correspondence_distance * max_correspondence_distance, transform_epsilon,
        euclidean_fitness_epsilon, max_iterations, bucket_cap, neighborhood)
    # PCL parity: `hasConverged()` is true whenever the convergence criteria stopped the
    # loop — epsilon OR max-iterations — with a valid final solve (>= 3 inliers, finite).
    converged = ((done | (iters >= max_iterations)) & (n_inl >= 3)
                 & torch.isfinite(T).all())
    return RegistrationResult(transform=T, converged=converged, iterations=iters,
                              fitness=fitness, num_inliers=n_inl)


def fitness_score(target_grid: HashGrid, points, mask, transform, max_range: float,
                  bucket_cap: int = 16, neighborhood: int = 27,
                  mode: str = "penalized") -> torch.Tensor:
    """Loop-gate fitness (PCL `getFitnessScore`): "penalized" averages over ALL valid
    source points with unmatched ones at the max_range^2 cap; "pcl" averages over
    matched points only, uncapped, and is +inf when nothing matches."""
    score, _frac = fitness_and_match_fraction(
        target_grid, points, mask, transform, max_range,
        bucket_cap=bucket_cap, neighborhood=neighborhood, mode=mode)
    return score


def fitness_and_match_fraction(target_grid: HashGrid, points, mask, transform,
                               max_range: float, bucket_cap: int = 16,
                               neighborhood: int = 27, mode: str = "penalized"):
    """(fitness, matched-source fraction) from ONE NN query (`ops.kernels.icp_fitness`).
    The fraction is the loop gate's backstop for the matched-only "pcl" fitness."""
    return kernels.icp_fitness(target_grid, points, mask, transform, max_range,
                               bucket_cap=bucket_cap, neighborhood=neighborhood, mode=mode)


def make_icp_matcher(cfg, cell_size: float = 2.0):
    """Matcher closures (build_target, align) mirroring the PCL interface usage."""

    def build_target(points, mask):
        return build_hash_grid(points, mask, cell_size)

    def align(target_grid, points, mask, init_T):
        return icp_align(
            target_grid, points, mask, init_T,
            max_correspondence_distance=min(cfg.max_correspondence_distance, cell_size),
            max_iterations=cfg.max_iterations,
            transform_epsilon=max(cfg.transform_epsilon, 1e-7),
            neighborhood=7,
        )

    return build_target, align
