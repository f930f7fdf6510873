"""Point-to-point ICP — the back end's loop-closure verifier.

Port of `lidar_graph_slam_tpu/registration/icp.py` (PCL `IterativeClosestPoint` as the
reference's loop pipeline configures it). Correspondences come from the sorted-grid NN
(`ops.neighbors.nearest`), and each iteration applies the closed-form optimal rigid motion
(weighted Umeyama/Kabsch via a 3x3 SVD). The fitness is PCL's `getFitnessScore` (mean
squared correspondence distance), with unmatched source points contributing a capped
penalty in the "penalized" mode.

Loop structure: the reference's `lax.while_loop` becomes a Python loop that reads the
device's `done` flag once per iteration, as `registration/ndt.py` does.
"""

from __future__ import annotations

import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.ops.neighbors import HashGrid, build_hash_grid, nearest
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult, norm


def _umeyama_step(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Optimal R, t minimizing sum w ||R src + t - dst||^2 (closed form)."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    sc = src - mu_s
    dc = dst - mu_d
    Sigma = torch.einsum("ni,nj,n->ij", dc, sc, w) / wsum
    U, _, Vt = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    return R, t


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
    corr2 = max_correspondence_distance * max_correspondence_distance
    dtype, dev = source_points.dtype, source_points.device
    pen = torch.full((), corr2, dtype=dtype, device=dev)
    nvalid = torch.clamp(torch.sum(source_mask.to(torch.int64)), min=1)
    eye = torch.eye(4, dtype=dtype, device=dev)

    def body(T, done, iters, fitness_prev):
        p = se3.transform_points(T, source_points)
        idx, d2, found = nearest(target_grid, p, bucket_cap=bucket_cap,
                                 neighborhood=neighborhood)
        matched = found & source_mask & (d2 < corr2)
        w = matched.to(dtype)
        q = target_grid.points[idx]
        R, t = _umeyama_step(p, q, w)
        delta_T = se3.make_transform(R, t)
        n_inl = torch.sum(matched.to(torch.int32))
        ok = (n_inl >= 3) & torch.isfinite(delta_T).all()
        delta_T = torch.where(ok, delta_T, eye)
        T_new = delta_T @ T

        # PCL-style fitness: mean squared NN distance over valid source points; points
        # with no neighbor in the search ring contribute the capped radius squared.
        per_pt = torch.where(found, torch.minimum(d2, pen), pen)
        fitness = torch.sum(torch.where(source_mask, per_pt, 0.0)) / nvalid

        newly_done = norm(se3.se3_log(delta_T)) < transform_epsilon
        if euclidean_fitness_epsilon > 0.0:
            newly_done = newly_done | (
                torch.abs(fitness_prev - fitness) < euclidean_fitness_epsilon)
        return T_new, done | newly_done, iters + 1, fitness, n_inl

    T = init_transform.to(dtype)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    fitness = torch.full((), torch.inf, dtype=dtype, device=dev)
    n_inl = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iterations):
        T, done, iters, fitness, n_inl = body(T, done, iters, fitness)
        if bool(done):  # the one host read per iteration
            break
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
    """(fitness, matched-source fraction) from ONE NN query. The fraction is the loop
    gate's backstop for the matched-only "pcl" fitness."""
    if mode not in ("pcl", "penalized"):
        raise ValueError(f"unknown fitness mode {mode!r}")
    p = se3.transform_points(transform, points)
    _, d2, found = nearest(target_grid, p, bucket_cap=bucket_cap, neighborhood=neighborhood)
    pen = max_range * max_range
    matched = found & mask & (d2 < pen)
    frac = torch.sum(matched.to(torch.int64)) / torch.clamp(
        torch.sum(mask.to(torch.int64)), min=1)
    if mode == "pcl":
        n = torch.sum(matched.to(torch.int64))
        score = torch.where(
            n > 0,
            torch.sum(torch.where(matched, d2, 0.0)) / torch.clamp(n, min=1),
            torch.full((), torch.inf, dtype=p.dtype, device=p.device),
        )
        return score, frac
    per_pt = torch.where(found, torch.clamp(d2, max=pen), pen)
    nvalid = torch.clamp(torch.sum(mask.to(torch.int64)), min=1)
    return torch.sum(torch.where(mask, per_pt, 0.0)) / nvalid, frac


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
