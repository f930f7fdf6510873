"""Shared Gauss-Newton machinery for SE(3) registration solvers.

Port of `lidar_graph_slam_tpu/registration/base.py`:

  * Pose parametrization: left-multiplicative se(3) perturbation, T <- exp(delta) T, with
    twist ordering (omega, v). The residual Jacobian for e = T p - q is de/domega =
    -hat(T p), de/dv = I; it and the normal-equation accumulation live beside the CUDA
    kernel that fuses them (`ops/kernels.py`).
  * Results carry PCL-compatible fields (`converged`, `fitness`).
  * Nothing here syncs the device: the 6x6 solve reports no error, and a failed solve
    surfaces as a non-finite step that the solvers' `step_ok` guard zeroes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RegistrationResult:
    transform: torch.Tensor    # [4, 4] final source->target transform
    converged: torch.Tensor    # bool — epsilon or max-iterations stop, with inliers
    iterations: torch.Tensor   # int32 — iterations used (until convergence)
    fitness: torch.Tensor      # float — mean squared distance to the matched voxel means
    num_inliers: torch.Tensor  # int32 — correspondences contributing to the final step


def solve_damped(H: torch.Tensor, g: torch.Tensor, damping) -> torch.Tensor:
    """Solve (H + damping * diag-scaled I) delta = -g for the 6-dof step.

    `solve_ex` neither raises nor syncs to check its `info`."""
    scale = torch.clamp(torch.trace(H) / 6.0, min=1e-12)
    A = H + damping * scale * torch.eye(6, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(A, -g)[0]


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of a vector, sqrt(sum(x*x)) as the reference's `jnp.linalg.norm`."""
    return torch.sqrt(torch.sum(x * x))


def cap_step(delta: torch.Tensor, max_norm) -> torch.Tensor:
    """Scale the twist so its norm never exceeds `max_norm` (ndt_omp's step bound)."""
    return delta * torch.clamp(max_norm / torch.clamp(norm(delta), min=1e-12), max=1.0)
