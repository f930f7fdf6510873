"""Graph-based SLAM back end — the keyframe store.

Port of the part of `lidar_graph_slam_tpu/graph/slam.py` that the pipeline runs with
loop closure off: keyframe insertion with host pose chaining (`add_keyframe`), lazy
keyframe clouds (`_LazyCloud`, `_cloud`, `drain_lazy_clouds`) and the outputs
(`optimized_poses`, `assemble_map`, `save_map`). With no loop factors the optimized
poses are the chained odometry, so no device pose graph is kept. Loop detection,
verification and the pose-graph solve are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, GraphSlamConfig
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud
from lidar_graph_slam_tpu_torch.io.pcd import write_pcd
from lidar_graph_slam_tpu_torch.ops.voxel import voxel_downsample


class _LazyCloud:
    """Deferred keyframe-cloud materialization: holds the driver's tensors (host copies
    of the device payload, or CPU tensors) until someone needs the numpy points."""

    __slots__ = ("_dev", "_mask", "_np")

    def __init__(self, cloud, mask):
        self._dev = cloud
        self._mask = mask
        self._np = None

    def get(self) -> np.ndarray:
        if self._np is None:
            c, m = self._dev.cpu().numpy(), self._mask.cpu().numpy()
            self._np = c[m].astype(np.float32)
            self._dev = self._mask = None  # release the buffers
        return self._np


class GraphBasedSLAM:
    """Host-side back end: keyframe clouds, accumulated distances and poses."""

    def __init__(self, cfg: GraphSlamConfig, capacity: CapacityConfig, device=None):
        self.cfg = cfg
        self.capacity = capacity
        self.device = device
        self.kf_clouds: list = []  # [n_i, 3] numpy sensor-frame clouds or _LazyCloud
        self.kf_accum_dist: list[float] = []
        self.kf_stamps: list[Optional[float]] = []
        self.kf_front_poses: list[np.ndarray] = []  # front-end (odometry) poses
        self._poses_host: list[np.ndarray] = []      # chained keyframe estimates
        self.n_keyframes = 0
        self._lazy_pending: list = []
        self.keyframe_overflow = False
        self._map_cache = None

    def add_keyframe(self, kf) -> None:
        """Insert a front-end keyframe record (`core.msgs.KeyFrame` or a mapping with
        pose, cloud, cloud_mask, accum_distance). At `max_keyframes` capacity the insert
        is refused and `keyframe_overflow` is flagged."""
        if self.n_keyframes >= self.capacity.max_keyframes:
            self.keyframe_overflow = True
            return
        pose = np.asarray(kf["pose"], dtype=np.float32)
        if self.n_keyframes == 0:
            odom = np.eye(4, dtype=np.float32)
        else:
            prev = self.kf_front_poses[-1]
            odom = (np.linalg.inv(prev) @ pose).astype(np.float32)
            # Chain the measurement onto the previous estimate (iSAM2's initialization
            # of new keys from composed odometry).
            prev_opt = self._poses_host[self.n_keyframes - 1]
            pose = (prev_opt @ odom).astype(np.float32)
        if isinstance(kf["cloud"], np.ndarray):
            cloud = np.asarray(kf["cloud"])[np.asarray(kf["cloud_mask"])]
            self.kf_clouds.append(cloud.astype(np.float32))
        else:
            # Tensors handed over by the fused driver: the numpy conversion waits for
            # `drain_lazy_clouds` (a couple of keyframes later) or a map read.
            self.kf_clouds.append(_LazyCloud(kf["cloud"], kf["cloud_mask"]))
            self._lazy_pending.append(self.n_keyframes)
        self.kf_accum_dist.append(float(kf["accum_distance"]))
        stamp = kf.get("stamp") if hasattr(kf, "get") else None
        self.kf_stamps.append(None if stamp is None else float(stamp))
        self.kf_front_poses.append(np.asarray(kf["pose"], dtype=np.float32))
        self._poses_host.append(pose)
        self.n_keyframes += 1

    def _cloud(self, k: int) -> np.ndarray:
        """Keyframe k's sensor/base-frame cloud (materialized on first access)."""
        c = self.kf_clouds[k]
        if isinstance(c, _LazyCloud):
            c = c.get()
            self.kf_clouds[k] = c
        return c

    def drain_lazy_clouds(self, max_items: int = 1, min_age: int = 2) -> None:
        """Materialize up to `max_items` pending keyframe clouds that are at least
        `min_age` keyframes old. Called once per frame by the pipeline."""
        drained = 0
        while (self._lazy_pending and drained < max_items
               and self._lazy_pending[0] <= self.n_keyframes - min_age):
            self._cloud(self._lazy_pending.pop(0))
            drained += 1

    def optimized_poses(self) -> np.ndarray:
        if self.n_keyframes == 0:
            return np.zeros((0, 4, 4), dtype=np.float32)
        return np.stack(self._poses_host).astype(np.float32)

    def assemble_map(self, resolution: float = 0.0, max_points: Optional[int] = None) -> np.ndarray:
        """All keyframe clouds under optimized poses; optional voxel filter at `resolution`
        (run on the back end's device). Cached per (keyframes, resolution): with no loop
        factors, poses change only by keyframe appends."""
        if self.n_keyframes == 0:
            return np.zeros((0, 3), dtype=np.float32)
        key = (self.n_keyframes, float(resolution), max_points)
        if self._map_cache is not None and self._map_cache[0] == key:
            return self._map_cache[1]
        poses = self.optimized_poses()
        chunks = [
            self._cloud(k) @ poses[k][:3, :3].T + poses[k][:3, 3]
            for k in range(self.n_keyframes)
        ]
        pts = np.concatenate(chunks).astype(np.float32)
        if resolution > 0.0:
            cap = max_points or pts.shape[0]
            cloud = PointCloud.from_array(pts, capacity=pts.shape[0], device=self.device)
            grid = voxel_downsample(cloud.points, cloud.mask, resolution, capacity=cap)
            pts = grid.points[grid.mask].cpu().numpy()
        self._map_cache = (key, pts)
        return pts

    def save_map(self, path: str, resolution: float = 0.0) -> bool:
        """The `/save_map` service: resolution <= 0 exports the raw map."""
        try:
            pts = self.assemble_map(resolution)
            write_pcd(path, pts)
            return True
        except OSError:
            return False
