"""Scan-to-submap odometry: gyro integration and the submap ring.

Port of the parts of `lidar_graph_slam_tpu/odometry/scan_matcher.py` that the fused
front end uses: `integrate_gyro`, the last-K keyframe ring (`SubmapRing`, `init_ring`,
`ring_insert`) and `assemble_submap`. The classic stage-by-stage `ScanMatcher` driver is
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE


def integrate_gyro(queue, t0: Optional[float], t1: Optional[float]) -> Optional[np.ndarray]:
    """Integrate queued (stamp, angular_velocity) gyro samples over (t0, t1] into a 3x3
    rotation, or None when unstamped / no samples."""
    if t0 is None or t1 is None or not queue:
        return None
    samples = [(t, w) for t, w in queue if t0 < t <= t1]
    if not samples:
        return None
    omega = np.zeros(3)
    prev_t = t0
    for t, w in samples:
        omega += w * (t - prev_t)
        prev_t = t
    return se3.so3_exp(torch.as_tensor(omega, dtype=torch.float32)).numpy()


@dataclass
class SubmapRing:
    """Ring buffer of the last-K keyframe clouds (sensor frame) + their poses."""

    clouds: torch.Tensor  # [K, N, 3]
    masks: torch.Tensor   # [K, N]
    poses: torch.Tensor   # [K, 4, 4]
    used: torch.Tensor    # [K] bool — slot holds a real keyframe


def init_ring(window: int, n_points: int, device=None) -> SubmapRing:
    return SubmapRing(
        clouds=torch.full((window, n_points, 3), PAD_VALUE, dtype=torch.float32, device=device),
        masks=torch.zeros((window, n_points), dtype=torch.bool, device=device),
        poses=torch.eye(4, dtype=torch.float32, device=device).repeat(window, 1, 1),
        used=torch.zeros((window,), dtype=torch.bool, device=device),
    )


def ring_insert(ring: SubmapRing, slot: int, points, mask, pose) -> SubmapRing:
    """Write a keyframe into `slot` IN PLACE (the reference donates the ring to an
    out-of-place update; here the ring's buffers are updated and the same ring returned)."""
    ring.clouds[slot] = points
    ring.masks[slot] = mask
    ring.poses[slot] = pose
    ring.used[slot] = True
    return ring


def assemble_submap(ring: SubmapRing, stride: int = 1):
    """Transform every ring cloud into the map frame and flatten: [K*N, 3], [K*N].

    `stride` > 1 subsamples each slot's points for the NDT MAP BUILD only (the
    registration source always sees every point)."""
    if stride < 1:
        raise ValueError(f"map_build_stride must be >= 1, got {stride}")
    world = se3.transform_points(ring.poses, ring.clouds)  # [K, N, 3]
    mask = ring.masks & ring.used[:, None]
    world = torch.where(mask[..., None], world, PAD_VALUE)
    if stride > 1:
        world = world[:, ::stride]
        mask = mask[:, ::stride]
    return world.reshape(-1, 3), mask.reshape(-1)
