"""Synthetic LiDAR world + trajectory simulator.

Copied from `lidar_graph_slam_tpu/io/synthetic.py` (the port cannot import the JAX package,
whose `__init__` imports jax); `tests/test_torch_*.py` hold the copy equal to it.

The reference was validated only against live rosbag replays and rviz inspection
(SURVEY.md §4 — it ships no fixtures). This module is the test-fixture generator the
reference never had: a structured 3-D world (ground plane, walls, boxes — surfaces that
constrain all six pose dof), a smooth closed trajectory that revisits its start (so loop
closure fires), and a range-limited scan simulator with Gaussian sensor noise.

All host-side numpy: fixtures are built once per test/benchmark, then shipped to device.
"""

from __future__ import annotations

import numpy as np


def make_world(
    rng: np.random.Generator, extent: float = 60.0, density: float = 4.0,
    wall_height: float = 3.0, box_height: tuple = (2.0, 6.0), n_boxes: int = 30,
) -> np.ndarray:
    """Structured world point set [M, 3]: ground + perimeter walls + random boxes/pillars.

    `wall_height` / `box_height` / `n_boxes` shape the vertical scene: the 3 m defaults
    give an open suburban course; tall values (urban canyon) fill the upward half of a
    spinning lidar's elevation fan, which is what pushes per-scan return counts toward
    the HDL-64's ~100k+ (open scenes cap near ~60k occupied beams regardless of point
    density because up-beams see sky)."""
    pts = []
    n_ground = int(extent * extent * density * 0.25)
    g = rng.uniform(-extent, extent, size=(n_ground, 2))
    pts.append(np.concatenate([g, np.zeros((n_ground, 1))], axis=1))

    # Perimeter walls (4 planes).
    n_wall = int(extent * density * 2 * wall_height)
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        w = np.zeros((n_wall, 3))
        w[:, axis] = sign * extent
        w[:, 1 - axis] = rng.uniform(-extent, extent, n_wall)
        w[:, 2] = rng.uniform(0, wall_height, n_wall)
        pts.append(w)

    # Random boxes (buildings): 4 side faces each.
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-extent * 0.8, extent * 0.8, 2)
        sx, sy = rng.uniform(2.0, 8.0, 2)
        h = rng.uniform(*box_height)
        n_face = int(density * (sx + sy) * h)  # ~constant per-area density on the 4 faces
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            f = np.zeros((n_face, 3))
            size = (sx, sy)
            f[:, axis] = (cx, cy)[axis] + sign * size[axis]
            f[:, 1 - axis] = (cx, cy)[1 - axis] + rng.uniform(-size[1 - axis], size[1 - axis], n_face)
            f[:, 2] = rng.uniform(0, h, n_face)
            pts.append(f)

    # Pillars (vertical features).
    for _ in range(40):
        cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        n_p = int(density * 10)
        p = np.stack(
            [
                np.full(n_p, cx) + rng.normal(scale=0.05, size=n_p),
                np.full(n_p, cy) + rng.normal(scale=0.05, size=n_p),
                rng.uniform(0, 4.0, n_p),
            ],
            axis=1,
        )
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def make_loop_trajectory(
    n_frames: int, radius: float = 35.0, speed: float = 0.6, z: float = 1.8, laps: float = 1.08
) -> np.ndarray:
    """Closed circular trajectory [n, 4, 4] (world <- sensor), slightly over one lap so the
    end revisits the start — exercising the back end's loop gates
    (`graph_based_slam/src/graph_based_slam.cpp:264-280`). Yaw follows the path tangent."""
    del speed  # arc-length is set by laps/n_frames
    poses = np.zeros((n_frames, 4, 4), dtype=np.float32)
    angles = np.linspace(0, 2 * np.pi * laps, n_frames)
    for i, a in enumerate(angles):
        cx, cy = radius * np.cos(a), radius * np.sin(a)
        yaw = a + np.pi / 2  # tangent direction
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.array(
            [[c, -s, 0, cx], [s, c, 0, cy], [0, 0, 1, z], [0, 0, 0, 1]], dtype=np.float32
        )
    return poses


def simulate_scan(
    world: np.ndarray,
    pose: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 50.0,
    min_range: float = 1.5,
    max_points: int = 16384,
    noise: float = 0.02,
    occlusion: bool = True,
    n_azimuth: int = 720,
    n_elevation: int = 32,
    elevation_range: tuple = (-0.4363, 0.2618),  # [-25 deg, +15 deg], VLP-32-like
) -> np.ndarray:
    """Sensor-frame scan [k, 3] (k <= max_points) with a ray-cast sensor model.

    `occlusion=True` (default): Velodyne-like scanline sampling — each world point in
    range maps to an (azimuth, elevation) beam bin and only the NEAREST return per bin
    survives, so surfaces hide what is behind them and the vertical field of view is
    bounded like a real spinning lidar. This is the parity instrument standing in for
    the reference's real-sensor validation (`/root/reference/README.md:31`): the round-2
    occlusion-free sampler saw through walls and materially overstated registration ease
    (VERDICT r02 item 4). `occlusion=False` keeps the old isotropic range-ball sampler
    for A/B diagnostics.
    """
    R, t = pose[:3, :3], pose[:3, 3]
    local = (world - t) @ R  # world -> sensor (R^T applied from the right)
    r2 = np.einsum("ij,ij->i", local, local)
    keep = (r2 < max_range * max_range) & (r2 > min_range * min_range)
    local = local[keep]
    if occlusion and local.shape[0] > 0:
        r = np.sqrt(r2[keep])
        az = np.arctan2(local[:, 1], local[:, 0])                  # [-pi, pi)
        el = np.arcsin(np.clip(local[:, 2] / r, -1.0, 1.0))
        el_lo, el_hi = elevation_range
        in_fov = (el >= el_lo) & (el < el_hi)
        local, r, az, el = local[in_fov], r[in_fov], az[in_fov], el[in_fov]
        az_bin = (((az + np.pi) / (2 * np.pi)) * n_azimuth).astype(np.int64) % n_azimuth
        el_bin = np.clip(
            ((el - el_lo) / (el_hi - el_lo) * n_elevation).astype(np.int64),
            0, n_elevation - 1,
        )
        beam = az_bin * n_elevation + el_bin
        # Nearest return per beam: sort by range, keep each beam's first occurrence.
        order = np.argsort(r, kind="stable")
        beam_sorted = beam[order]
        _, first = np.unique(beam_sorted, return_index=True)
        local = local[order[first]]
    if local.shape[0] > max_points:
        idx = rng.choice(local.shape[0], size=max_points, replace=False)
        local = local[idx]
    return (local + rng.normal(scale=noise, size=local.shape)).astype(np.float32)


class SyntheticSequence:
    """Iterable dataset of (scan_sensor_frame, gt_pose) with a loop-closing trajectory."""

    def __init__(
        self,
        n_frames: int = 100,
        seed: int = 0,
        extent: float = 60.0,
        radius: float = 35.0,
        max_points: int = 16384,
        noise: float = 0.02,
        laps: float = 1.08,
        occlusion: bool = True,
        n_azimuth: int = 720,
        n_elevation: int = 32,
    ):
        self.rng = np.random.default_rng(seed)
        self.world = make_world(self.rng, extent=extent)
        self.poses = make_loop_trajectory(n_frames, radius=radius, laps=laps)
        self.max_points = max_points
        self.noise = noise
        self.n_frames = n_frames
        self.occlusion = occlusion
        self.n_azimuth = n_azimuth
        self.n_elevation = n_elevation

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        for i in range(self.n_frames):
            scan = simulate_scan(
                self.world, self.poses[i], self.rng, max_points=self.max_points,
                noise=self.noise, occlusion=self.occlusion,
                n_azimuth=self.n_azimuth, n_elevation=self.n_elevation,
            )
            yield scan, self.poses[i]
