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

Dispatch. The reference jits the align (`ndt_align`, `icp_align`, GICP's
`estimate_covariances` then `gicp_align`) and a keyframe's `ring_insert` (donated) and
assemble-and-build, so a frame costs it a few dispatches and one batched read. The port's
`ScanMatcher` runs the same stages as two `utils/capture.py:Program`s over fixed buffers
(on the card a CUDA graph each, captured at first use and replayed after):

  * the register program: the input cloud `cloud_in` moved by the frame's extrinsic
    under its device flag into the frame's cloud `cloud`, the registration from the guess
    in `frame_in`, and its outputs in the one row `row` (`ROW`), which the host reads once;
  * the insert program: `cloud` into the ring slot `kf_slot` with the pose `kf_pose`, and
    the target rebuilt from the ring in place (`copy_into`).

The ring and the target are updated in place, and the target is first built from the
empty ring. The host logic (the guess, the gyro rotation, the health gate, the keyframe
decision) is the reference's. A keyframe's payload is copied to the host from `cloud`
before the insert is enqueued and waited for alone, so the rebuild runs on the card while
the host goes on, as the reference reads the cloud before it rebuilds.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import ScanMatcherConfig
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.msgs import KeyFrame
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, PointCloud, pad_points
from lidar_graph_slam_tpu_torch.registration import gicp, icp, ndt
from lidar_graph_slam_tpu_torch.utils.capture import Program, copy_into


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


# The register program's inputs in one float32 row: the guess (16) | T_ext (16) | use_ext.
FRAME_INPUTS = 33
# Its outputs in one float32 row (the counts stay exact below 2^24): the pose (16) |
# converged | fitness | iterations | num_inliers | n_valid.
ROW = 21


def rebuild_target(build_target, stride: int, ring: SubmapRing):
    """Ring -> map-frame submap -> registration target."""
    return build_target(*assemble_submap(ring, stride=stride))


def place(cloud_in: PointCloud, cloud: PointCloud, frame_in: torch.Tensor) -> None:
    """`cloud`'s points := `cloud_in`'s, moved by `frame_in`'s T_ext where its flag is on
    (padded rows at PAD_VALUE); with the flag off, `cloud_in`'s own bits."""
    moved = pad_points(se3.transform_points(frame_in[16:32].view(4, 4), cloud_in.points),
                       cloud_in.mask)
    cloud.points.copy_(torch.where(frame_in[32] > 0.5, moved, cloud_in.points))


def _register_body(register, target, cloud_in: PointCloud, cloud: PointCloud,
                   frame_in: torch.Tensor, row: torch.Tensor) -> None:
    """The register program: the frame's cloud placed, registered against `target` from
    `frame_in`'s guess, and the result packed into `row` (`ROW`). (The bodies take their
    buffers as arguments: a body bound to the matcher would make a cycle that only the
    garbage collector frees.)"""
    place(cloud_in, cloud, frame_in)
    res = register(target, cloud.points, cloud.mask, frame_in[0:16].view(4, 4))
    f32 = torch.float32
    row.copy_(torch.cat([res.transform.reshape(16).to(f32), torch.stack([
        res.converged.to(f32), res.fitness.to(f32), res.iterations.to(f32),
        res.num_inliers.to(f32), torch.sum(cloud.mask.to(f32))])]))


def _insert_body(rebuild_fn, ring: SubmapRing, target, cloud: PointCloud,
                 kf_slot: torch.Tensor, kf_pose: torch.Tensor) -> None:
    """The insert program: the frame's cloud into ring slot `kf_slot` ([1] int64) with pose
    `kf_pose`, then the target rebuilt from the ring, in place (the reference's donated
    `ring_insert` and its jitted assemble-and-build)."""
    ring_insert(ring, kf_slot, cloud.points, cloud.mask, kf_pose)
    copy_into(target, rebuild_fn(ring))


class ScanMatcher:
    """Host-side front-end driver over device tensors on `device` (None: the CUDA card,
    `core/device.py`), its stages two programs over fixed buffers (module docstring).

    process(cloud, stamp) -> dict with pose [4,4] np, is_keyframe, converged, fitness,
    iterations — what the reference publishes per frame. `cloud` may be any
    `PointCloud` of `scan_capacity` rows; `cloud_in` itself (where the runner's prefilter
    program writes) is taken without a copy.
    """

    def __init__(self, cfg: ScanMatcherConfig, scan_capacity: int,
                 map_voxel_capacity: int = 65536, device=None):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.scan_capacity = scan_capacity
        self.map_voxel_capacity = map_voxel_capacity
        self.method = cfg.registration_method.upper()
        if self.method not in ("NDT", "GICP", "ICP"):
            raise ValueError(f"unknown registration_method {cfg.registration_method!r}")

        self.ring = init_ring(cfg.max_scan_accumulate_num, scan_capacity, device=dev)
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
        self.keyframe_log: list[KeyFrame] = []  # host-side keyframe records for the back end
        self._build_target, align = make_matcher(cfg, map_voxel_capacity)
        self._register_fn = make_register(cfg, align)
        self._rebuild = partial(rebuild_target, self._build_target, cfg.map_build_stride)

        # The fixed buffers (module docstring); the frame's cloud shares the input's mask.
        n = scan_capacity
        self.cloud_in = PointCloud(
            points=torch.full((n, 3), PAD_VALUE, dtype=torch.float32, device=dev),
            mask=torch.zeros((n,), dtype=torch.bool, device=dev))
        self.cloud = PointCloud(points=torch.full((n, 3), PAD_VALUE, dtype=torch.float32,
                                                  device=dev), mask=self.cloud_in.mask)
        self.frame_in = torch.zeros(FRAME_INPUTS, dtype=torch.float32, device=dev)
        self.row = torch.zeros(ROW, dtype=torch.float32, device=dev)
        self.kf_slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.kf_pose = torch.eye(4, dtype=torch.float32, device=dev)
        self.target = self._rebuild(self.ring)  # the empty map; frame 0 bootstraps
        # Their host sides: pinned on the card, so that the uploads and reads are
        # asynchronous copies; each is rewritten only after the stream passed its copy.
        pin = dev.type == "cuda"
        self._host = {name: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                      for name, t in (("frame_in", self.frame_in), ("row", self.row),
                                      ("kf_slot", self.kf_slot), ("kf_pose", self.kf_pose),
                                      ("kf_points", self.cloud.points),
                                      ("kf_mask", self.cloud.mask))}
        self.stream = torch.cuda.Stream(dev) if pin else None
        self.register_program = Program(
            partial(_register_body, self._register_fn, self.target, self.cloud_in,
                    self.cloud, self.frame_in, self.row), dev, self.stream)
        self.insert_program = Program(
            partial(_insert_body, self._rebuild, self.ring, self.target, self.cloud,
                    self.kf_slot, self.kf_pose), dev, self.stream)

    @property
    def programs(self) -> dict:
        return {"register": self.register_program, "insert": self.insert_program}

    # -- device-side helpers ------------------------------------------------------------

    def _upload(self, name: str, dst: torch.Tensor, values) -> None:
        host = self._host[name]
        host.numpy()[...] = values
        dst.copy_(host, non_blocking=True)

    def load(self, ring: SubmapRing) -> None:
        """Copy a resumed ring into the fixed ring and rebuild the target there; the
        programs go on reading the same buffers."""
        copy_into(self.ring, ring)
        copy_into(self.target, self._rebuild(self.ring))

    def _add_keyframe(self, pose: np.ndarray, delta: float):
        """`cloud` into the ring as keyframe `n_keyframes`, the target rebuilt at once."""
        slot = self.n_keyframes % self.cfg.max_scan_accumulate_num
        self.accum_distance += float(delta)
        # The payload leaves the fixed cloud buffer before the insert is enqueued, and
        # only its copies are waited for: the rebuild runs on while the host goes on.
        points, mask = self._host["kf_points"], self._host["kf_mask"]
        points.copy_(self.cloud.points, non_blocking=True)
        mask.copy_(self.cloud.mask, non_blocking=True)
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        self._upload("kf_slot", self.kf_slot, slot)
        self._upload("kf_pose", self.kf_pose, pose)
        self.insert_program()
        if copied is not None:
            copied.synchronize()
        self.keyframe_log.append(
            KeyFrame(
                id=self.n_keyframes,
                pose=pose.copy(),
                accum_distance=self.accum_distance,
                cloud=points.numpy().copy(),
                cloud_mask=mask.numpy().copy(),
                frame_index=self.n_frames - 1,  # n_frames is incremented before keyframing
                stamp=self.last_scan_stamp,
            )
        )
        self.n_keyframes += 1
        self.last_kf_pose = pose.copy()

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
        if cloud.points is not self.cloud_in.points:
            self.cloud_in.points.copy_(cloud.points)
            self.cloud_in.mask.copy_(cloud.mask)
        frame_in = self._host["frame_in"].numpy()
        frame_in[16:32] = (np.eye(4) if T_ext is None else T_ext).reshape(16)
        frame_in[32] = T_ext is not None
        if self.n_keyframes == 0:
            # First-scan bootstrap: identity pose, keyframe 0, target := the scan itself.
            # Nothing registers: the cloud is placed once, outside the programs.
            self.last_scan_stamp = stamp
            self._upload("frame_in", self.frame_in, frame_in)
            place(self.cloud_in, self.cloud, self.frame_in)
            self._add_keyframe(self.pose, 0.0)
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
        frame_in[0:16] = np.asarray(guess, np.float32).reshape(16)
        self._upload("frame_in", self.frame_in, frame_in)
        self.register_program()
        # ONE device->host read per frame: the pose and the five scalars in one float32
        # row (the counts stay exact below 2^24).
        row = self._host["row"]
        row.copy_(self.row)
        row = row.numpy()
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
            self._add_keyframe(self.pose, delta)
        return {"pose": self.pose.copy(), "is_keyframe": is_keyframe, "converged": True,
                "fitness": fitness, "iterations": iters}
