"""Scan-to-submap LiDAR odometry: the classic stage-by-stage driver and the submap ring.

Port of `lidar_graph_slam_tpu/odometry/scan_matcher.py`: `integrate_gyro`, the last-K
keyframe ring (`SubmapRing`, `init_ring`, `ring_insert`), `assemble_submap`, the matcher
factory shared with the fused front end (`make_matcher`, `make_register`), and the
`ScanMatcher` driver. `ScanMatcher.process` runs one prefiltered scan:

    initial guess (constant pose or velocity, gyro rotation) -> register(target)
      -> ONE batched device->host read -> health gate -> keyframe decision
      -> on a keyframe: ring insert and an immediate target rebuild

Unlike the fused driver, the target is rebuilt before the next scan is registered (no
one-frame lag), so its trajectory is held against the reference's `ScanMatcher`, not
against the fused front end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import ScanMatcherConfig
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.msgs import KeyFrame
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, PointCloud, pad_points
from lidar_graph_slam_tpu_torch.registration import gicp, icp, ndt


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


def ring_insert(ring: SubmapRing, slot, points, mask, pose) -> SubmapRing:
    """Write a keyframe into `slot` IN PLACE (the reference donates the ring to an
    out-of-place update; here the ring's buffers are updated and the same ring returned).
    The used flag is a fill on the device, as the reference's `.at[slot].set(True)`: an
    assignment of a Python bool copies it in from the host and synchronizes. `slot` is an
    int, or a [1] int64 tensor on the ring's device (the captured insert takes it there,
    so the host reads nothing)."""
    if isinstance(slot, torch.Tensor):
        ring.clouds.index_copy_(0, slot, points[None])
        ring.masks.index_copy_(0, slot, mask[None])
        ring.poses.index_copy_(0, slot, pose[None])
        ring.used.index_fill_(0, slot, True)
        return ring
    ring.clouds[slot] = points
    ring.masks[slot] = mask
    ring.poses[slot] = pose
    ring.used[slot].fill_(True)
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


def make_matcher(cfg: ScanMatcherConfig, map_voxel_capacity: int):
    """(build_target, align) of the configured registration method. The front-end ICP
    reads `cfg.gicp`, as the reference does."""
    method = cfg.registration_method.upper()
    if method == "NDT":
        return ndt.make_ndt_matcher(cfg.ndt, map_voxel_capacity)
    if method == "GICP":
        return gicp.make_gicp_matcher(cfg.gicp)
    if method == "ICP":
        return icp.make_icp_matcher(cfg.gicp, cell_size=cfg.gicp.max_correspondence_distance)
    raise ValueError(f"unknown registration_method {cfg.registration_method!r}")


def make_register(cfg: ScanMatcherConfig, align):
    """register(target, points, mask, guess) -> RegistrationResult. GICP computes the
    scan's own covariances once per scan and hands them to `align`."""
    if cfg.registration_method.upper() != "GICP":
        return align

    def register(target, points, mask, guess):
        covs, _ = gicp.estimate_covariances(points, mask, cfg.gicp.max_correspondence_distance,
                                            k=cfg.gicp.correspondence_randomness)
        return align(target, points, mask, guess, covs)

    return register


class ScanMatcher:
    """Host-side front-end driver over device tensors on `device` (None: the CUDA card,
    `core/device.py`).

    process(cloud, stamp) -> dict with pose [4,4] np, is_keyframe, converged, fitness,
    iterations — what the reference publishes per frame.
    """

    def __init__(self, cfg: ScanMatcherConfig, scan_capacity: int,
                 map_voxel_capacity: int = 65536, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scan_capacity = scan_capacity
        self.map_voxel_capacity = map_voxel_capacity
        self.method = cfg.registration_method.upper()
        if self.method not in ("NDT", "GICP", "ICP"):
            raise ValueError(f"unknown registration_method {cfg.registration_method!r}")

        self.ring = init_ring(cfg.max_scan_accumulate_num, scan_capacity, device=self.device)
        self.pose = np.eye(4, dtype=np.float32)
        self.last_motion = np.eye(4, dtype=np.float32)  # T_{t-1}^{-1} T_t
        self.last_kf_pose = np.eye(4, dtype=np.float32)
        # Gyro samples (stamp, angular_velocity): the integrated rotation between two
        # scan stamps replaces the guess's rotation.
        self.imu_queue: list[tuple[float, np.ndarray]] = []
        # Time-varying sensor->base extrinsic hook (`resolve_extrinsic`): a callable
        # stamp -> [4,4] | None, standing in for the reference's per-frame TF lookup.
        self.extrinsic_provider = None
        self.last_scan_stamp: Optional[float] = None
        self.accum_distance = 0.0
        self.n_keyframes = 0
        self.n_frames = 0
        self.target = None
        self.keyframe_log: list[KeyFrame] = []  # host-side keyframe records for the back end
        self._build_target, align = make_matcher(cfg, map_voxel_capacity)
        self._register_fn = make_register(cfg, align)

    # -- device-side helpers ------------------------------------------------------------

    def _rebuild_target(self):
        """Ring -> map-frame submap -> registration target, at once (no lag)."""
        self.target = self._build_target(
            *assemble_submap(self.ring, stride=self.cfg.map_build_stride))

    def _register(self, cloud: PointCloud, init_T):
        return self._register_fn(self.target, cloud.points, cloud.mask, init_T)

    def _add_keyframe(self, cloud: PointCloud, pose: np.ndarray, delta: float):
        slot = self.n_keyframes % self.cfg.max_scan_accumulate_num
        ring_insert(self.ring, slot, cloud.points, cloud.mask,
                    torch.as_tensor(pose, device=self.device))
        self.accum_distance += float(delta)
        # The keyframe payload in one copy: x, y, z and the mask as a fourth column.
        payload = torch.cat([cloud.points, cloud.mask[:, None].to(cloud.points.dtype)],
                            dim=1).cpu().numpy()
        self.keyframe_log.append(
            KeyFrame(
                id=self.n_keyframes,
                pose=pose.copy(),
                accum_distance=self.accum_distance,
                cloud=np.ascontiguousarray(payload[:, :3]),
                cloud_mask=payload[:, 3] > 0.5,
                frame_index=self.n_frames - 1,  # n_frames is incremented before keyframing
                stamp=self.last_scan_stamp,
            )
        )
        self.n_keyframes += 1
        self.last_kf_pose = pose.copy()
        self._rebuild_target()

    # -- public API ---------------------------------------------------------------------

    def add_imu(self, stamp: float, angular_velocity, linear_acceleration=None) -> None:
        """Queue an IMU sample. Only the gyro is used (rotation prediction); the
        acceleration is accepted for interface parity."""
        del linear_acceleration
        self.imu_queue.append((float(stamp), np.asarray(angular_velocity, dtype=np.float64)))
        if len(self.imu_queue) > 2000:
            self.imu_queue = self.imu_queue[-1000:]

    def _imu_rotation_delta(self, stamp: Optional[float]) -> Optional[np.ndarray]:
        """Integrate queued gyro samples between the previous scan and `stamp`."""
        R = integrate_gyro(self.imu_queue, self.last_scan_stamp, stamp)
        if R is None:
            return None
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = R
        return out

    def resolve_extrinsic(self, stamp: Optional[float]) -> Optional[np.ndarray]:
        """Sensor->base transform for this frame: the provider's, when it gives one; else
        the static config extrinsic; both absent -> None (identity)."""
        if self.extrinsic_provider is not None:
            T = self.extrinsic_provider(stamp)
            if T is not None:
                return np.asarray(T, np.float32)
        if any(abs(v) > 1e-12 for v in self.cfg.extrinsic_xyzrpy):
            x, y, z, roll, pitch, yaw = self.cfg.extrinsic_xyzrpy
            return se3.make_transform(
                se3.so3_exp(torch.tensor([roll, pitch, yaw], dtype=torch.float32)),
                torch.tensor([x, y, z], dtype=torch.float32)).numpy()
        return None

    def process(self, cloud: PointCloud, stamp: Optional[float] = None) -> dict:
        """Feed one prefiltered scan (sensor frame); returns per-frame odometry outputs."""
        self.n_frames += 1
        T_ext = self.resolve_extrinsic(stamp)
        if T_ext is not None:
            pts = se3.transform_points(torch.as_tensor(T_ext, device=self.device), cloud.points)
            cloud = PointCloud(points=pad_points(pts, cloud.mask), mask=cloud.mask)
        if self.n_keyframes == 0:
            # First-scan bootstrap: identity pose, keyframe 0, target := the scan itself.
            self.last_scan_stamp = stamp
            self._add_keyframe(cloud, self.pose, 0.0)
            return {"pose": self.pose.copy(), "is_keyframe": True, "converged": True,
                    "fitness": 0.0, "iterations": 0}

        if self.cfg.initial_guess == "constant_velocity":
            guess = self.pose @ self.last_motion
        else:  # "constant_pose": the reference's model
            guess = self.pose
        imu_delta = self._imu_rotation_delta(stamp)
        if imu_delta is not None:
            # The gyro-integrated rotation replaces the guess's; its translation stays.
            guess = guess.copy()
            guess[:3, :3] = self.pose[:3, :3] @ imu_delta[:3, :3]
        self.last_scan_stamp = stamp
        res = self._register(cloud, torch.as_tensor(guess, device=self.device))
        # ONE batched device->host read per frame: the pose and the five scalars in one
        # float32 row (the counts stay exact below 2^24).
        f32 = torch.float32
        row = torch.cat([res.transform.reshape(16).to(f32), torch.stack([
            res.converged.to(f32), res.fitness.to(f32), res.iterations.to(f32),
            res.num_inliers.to(f32), torch.sum(cloud.mask.to(f32))])]).cpu().numpy()
        transform = row[:16].reshape(4, 4).copy()
        converged = bool(row[16] > 0.5)
        fitness, iters, inliers, n_valid = float(row[17]), int(row[18]), int(row[19]), int(row[20])
        # Health gate: "converged" with almost no matched points is a silent failure.
        n_valid = max(n_valid, 1)
        denom = n_valid * 7 if self.method == "NDT" else n_valid
        if converged and inliers < self.cfg.min_inlier_fraction * denom:
            converged = False
        if not converged:
            # The reference drops the frame and keeps the previous pose.
            return {"pose": self.pose.copy(), "is_keyframe": False, "converged": False,
                    "fitness": fitness, "iterations": iters}

        new_pose = transform
        self.last_motion = (np.linalg.inv(self.pose) @ new_pose).astype(np.float32)
        self.pose = new_pose
        delta = float(np.linalg.norm(self.pose[:3, 3] - self.last_kf_pose[:3, 3]))
        is_keyframe = delta >= self.cfg.displacement
        if is_keyframe:
            self._add_keyframe(cloud, self.pose, delta)
        return {"pose": self.pose.copy(), "is_keyframe": is_keyframe, "converged": True,
                "fitness": fitness, "iterations": iters}
