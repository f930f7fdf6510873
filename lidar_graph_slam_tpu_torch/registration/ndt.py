"""Voxelized Normal Distributions Transform registration (ndt_omp equivalent).

Port of `lidar_graph_slam_tpu/registration/ndt.py`: iteratively-reweighted Gauss-Newton
on Magnusson's exponential score against a voxel-Gaussian map (`ops.voxel`). Each
iteration transforms the source, gathers the DIRECT7 neighbor Gaussians, accumulates the
6x6 normal equations and the fitness sums, solves the damped step and applies it.

Loop structure: the reference's `lax.while_loop` runs on the device. `ndt_align` makes one
call per align, `ops.kernels.ndt_align_loop`: on the card one C call enqueues
`max_iterations` launches of the `ndt_iteration` kernel (the whole body, the 6x6 step in
its last block, the carry in device memory; a launch that finds the carry done exits at
once, as the while_loop stops running its body), then the polish launches. The host reads
nothing back, so the align makes no synchronous read. The two polish iterations run
unconditionally, even after convergence, as in the reference.

With `line_search` (off by default) the gathered rows are kept for the step search, so that
path keeps a host loop: it gathers with `lookup_direct7`, accumulates with
`ops.kernels.ndt_accumulate` and reads the device's `done` flag once per iteration.

`ndt_align_batched` is the reference's `jax.vmap(ndt_align)` over B sequences, each
against its own map: one call of `ops.kernels.ndt_align_loop_batched` (one launch of the
batched kernel an iteration for the whole batch), in which a finished sequence's blocks
exit on its own `done` — its carry frozen from the iteration it is done on, as the vmapped
`while_loop` selects a finished lane's carry back. Sequence b's result equals `ndt_align`
on it alone, bit for bit on the card.
"""

from __future__ import annotations

import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import NdtConfig
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.voxel import (
    NdtVoxelMap,
    as_f32,
    build_ndt_map,
    build_ndt_pyramid,
)
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult


def magnusson_constants(resolution, outlier_ratio: float):
    """d1/d2 of the NDT mixture score (Magnusson 2009, as parameterized by ndt_omp),
    in float32 as the reference computes them."""
    res = torch.as_tensor(resolution, dtype=torch.float32)
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (res ** 3)
    d3 = -torch.log(c2)
    d1 = -torch.log(c1 + c2) - d3
    e = torch.exp(torch.full((), -0.5, dtype=torch.float32, device=res.device))
    d2 = -2.0 * torch.log((-torch.log(c1 * e + c2) - d3) / d1)
    return d1, d2


def ndt_align(
    vmap: NdtVoxelMap,
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    init_transform: torch.Tensor,
    step_size: float = 0.1,
    transform_epsilon: float = 0.01,
    outlier_ratio: float = 0.55,
    max_iterations: int = 64,
    polish_iterations: int = 2,
    line_search: bool = False,
) -> RegistrationResult:
    """Align a masked source cloud to an NDT voxel map. Returns source->map transform.

    Without `line_search` the loop is one call of `ops.kernels.ndt_align_loop` (on the
    card: no host read). `line_search=True` adds the reference's backtracking step-length
    search: each GN step is evaluated at alpha in {1, 1/2, 1/4} on the Magnusson score
    over the current correspondences and the best-scoring scale is taken; that path keeps
    a host loop with one read of `done` an iteration. Off by default."""
    d1, d2 = magnusson_constants(vmap.leaf, outlier_ratio)
    w_scale = -d1 * d2  # > 0: d1 < 0 by construction
    damping = as_f32(1e-6, source_points)
    source_mask = source_mask.contiguous()  # a strided subsample is copied once, here
    if line_search:
        T_p, done, iters, fitness_p, inliers_p = _line_search_loop(
            vmap, source_points, source_mask, init_transform, d2, w_scale, step_size,
            transform_epsilon, damping, max_iterations, polish_iterations)
    else:
        T_p, done, iters, fitness_p, inliers_p = kernels.ndt_align_loop(
            vmap, source_points.contiguous(), source_mask, init_transform, d2, w_scale,
            step_size, transform_epsilon, damping, max_iterations, polish_iterations)
    # PCL parity: hasConverged() is true whenever the convergence criteria stopped the
    # loop — epsilon OR max-iterations; the caller's inlier gate guards quality.
    converged = ((done | (iters >= max_iterations)) & (inliers_p > 0)
                 & torch.isfinite(T_p).all())
    return RegistrationResult(transform=T_p, converged=converged, iterations=iters,
                              fitness=fitness_p, num_inliers=inliers_p)


def _line_search_loop(vmap, source_points, source_mask, init_transform, d2, w_scale,
                      step_size, transform_epsilon, damping, max_iterations,
                      polish_iterations):
    """`ndt_align`'s loop with the line search: a host loop that reads `done` once per
    iteration, then the polish. Returns the carry (T, done, iterations, fitness,
    inliers)."""
    dtype, dev = source_points.dtype, source_points.device

    def body(T, done, iters):
        p = se3.transform_points(T, source_points)                   # [N, 3]
        # The line search evaluates the score against the gathered means and inverse
        # covariances, so this path gathers them and accumulates the rows.
        sums, (means, icovs, valid) = kernels.direct7_gathered(
            vmap, p, source_mask, d2, w_scale, kernels.ndt_accumulate)

        def backtrack(delta):
            # Backtracking on the fixed-correspondence Magnusson score, evaluated against
            # the means/icovs gathered this iteration (no re-gather).
            alphas = torch.tensor([1.0, 0.5, 0.25], dtype=dtype, device=dev)
            scores = []
            for a in alphas:
                pc = se3.transform_points(se3.se3_exp(a * delta) @ T, source_points)
                ec = pc[:, None, :] - means
                md2c = torch.einsum("kni,knij,knj->kn", ec, icovs, ec)
                scores.append(torch.sum(torch.where(valid, torch.exp(-0.5 * d2 * md2c), 0.0)))
            return alphas[torch.argmax(torch.stack(scores))] * delta

        return kernels.ndt_step_plain(sums, T, done, iters, step_size, transform_epsilon,
                                      damping, backtrack)

    T = init_transform.to(dtype)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    fitness = torch.full((), torch.inf, dtype=dtype, device=dev)
    inliers = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iterations):
        T, done, iters, fitness, inliers = body(T, done, iters)
        if bool(done):  # the one host read per iteration
            break
    # Polish: UNCONDITIONAL Gauss-Newton iterations after the early exit, so the result
    # is a function of (target, scan) rather than of where the epsilon stop landed.
    for _ in range(polish_iterations):
        T, _, _, fitness, inliers = body(T, done, iters)
    return T, done, iters, fitness, inliers


def ndt_align_batched(
    vmaps: NdtVoxelMap,
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    init_transforms: torch.Tensor,
    step_size: float = 0.1,
    transform_epsilon: float = 0.01,
    outlier_ratio: float = 0.55,
    max_iterations: int = 64,
    polish_iterations: int = 2,
) -> RegistrationResult:
    """`ndt_align` over B sequences at once (the reference's `jax.vmap(ndt_align)`).

    vmaps: B maps of one capacity stacked by `ops.kernels.stack_maps`; source_points
    [B, N, 3]; source_mask [B, N]; init_transforms [B, 4, 4]. Returns a
    `RegistrationResult` whose fields carry a leading batch axis. A sequence's carry stops
    changing once it is done (or at `max_iterations`); the polish iterations then run for
    every sequence. One call of `ops.kernels.ndt_align_loop_batched`: no host read."""
    d1, d2 = magnusson_constants(vmaps.leaf, outlier_ratio)          # [B] each
    w_scale = -d1 * d2
    damping = as_f32(1e-6, source_points)
    T_p, done, iters, fitness_p, inliers_p = kernels.ndt_align_loop_batched(
        vmaps, source_points.contiguous(), source_mask.contiguous(), init_transforms, d2,
        w_scale, step_size, transform_epsilon, damping, max_iterations, polish_iterations)
    converged = ((done | (iters >= max_iterations)) & (inliers_p > 0)
                 & torch.isfinite(T_p).flatten(1).all(dim=1))
    return RegistrationResult(transform=T_p, converged=converged, iterations=iters,
                              fitness=fitness_p, num_inliers=inliers_p)


def make_ndt_matcher(cfg: NdtConfig, map_capacity: int):
    """Bundle map-build + align closures for the front end's matcher slot.

    When `cfg.coarse_resolution` > 0 the target is a two-level pyramid and alignment
    runs coarse-then-fine. An integer coarse/fine ratio derives the coarse map by
    merging the fine map's raw voxel moments (`build_ndt_pyramid`); other ratios build
    the two maps independently."""
    use_pyramid = cfg.coarse_resolution > 0.0
    factor = round(cfg.coarse_resolution / cfg.resolution) if use_pyramid else 0
    fused_pyramid = use_pyramid and factor >= 2 and abs(
        factor * cfg.resolution - cfg.coarse_resolution) < 1e-6

    def build_target(points, mask):
        if fused_pyramid:
            return build_ndt_pyramid(points, mask, cfg.resolution, factor,
                                     capacity=map_capacity, coarse_capacity=map_capacity // 2)
        fine = build_ndt_map(points, mask, cfg.resolution, capacity=map_capacity)
        if not use_pyramid:
            return fine
        coarse = build_ndt_map(points, mask, cfg.coarse_resolution, capacity=map_capacity // 2)
        return (coarse, fine)

    def align(target_map, points, mask, init_T):
        if use_pyramid:
            coarse, fine = target_map
            # Coarse stage: larger step bound, strided source subsample, no polish — it
            # only has to land inside the fine stage's convergence basin.
            stride = max(int(cfg.coarse_subsample), 1)
            pre = ndt_align(
                coarse, points[::stride], mask[::stride], init_T,
                step_size=cfg.step_size * 4.0,
                transform_epsilon=cfg.transform_epsilon,
                outlier_ratio=cfg.outlier_ratio,
                max_iterations=cfg.coarse_iterations,
                polish_iterations=0,
            )
            init_T = pre.transform
        else:
            fine = target_map
        return ndt_align(
            fine, points, mask, init_T,
            step_size=cfg.step_size,
            transform_epsilon=cfg.transform_epsilon,
            outlier_ratio=cfg.outlier_ratio,
            max_iterations=cfg.max_iterations,
        )

    return build_target, align
