"""KITTI odometry dataset loading (velodyne .bin scans + ground-truth poses).

The port's own copy of `lidar_graph_slam_tpu/io/kitti.py` (host code over numpy), reading
through the port's `native` library. Layout expected:

  <root>/sequences/<seq>/velodyne/000000.bin ...   (float32 x,y,z,intensity)
  <root>/poses/<seq>.txt                           (3x4 row-major cam0 poses, optional)
  <root>/sequences/<seq>/calib.txt                 (Tr: velodyne->cam0, optional)
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def read_velodyne_bin(path: str, max_points: Optional[int] = None) -> np.ndarray:
    """Load one KITTI velodyne scan -> [n, 3] float32 (intensity dropped).

    Uses the native decoder (`native.read_bin`) when built; capacity-truncation keeps the
    first `max_points` records (deterministic, like the native path)."""
    if max_points is not None:
        from lidar_graph_slam_tpu_torch import native

        pts, n = native.read_bin(path, max_points)
        return pts[:n]
    data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return data[:, :3]


def read_poses(path: str) -> np.ndarray:
    """KITTI ground-truth poses file -> [N, 4, 4]."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float64), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows
    return out.astype(np.float32)


def read_calib_velo_to_cam(path: str) -> Optional[np.ndarray]:
    """Parse `Tr:` (velodyne -> cam0) from a KITTI calib.txt, or None if absent."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.fromstring(line.split(":", 1)[1], sep=" ")
                T = np.eye(4, dtype=np.float32)
                T[:3, :4] = vals.reshape(3, 4)
                return T
    return None


class KittiSequence:
    """Iterable of (scan [n,3] velodyne frame, gt_pose [4,4] velodyne frame or None)."""

    def __init__(self, root: str, sequence: str = "00", max_frames: Optional[int] = None,
                 max_points: Optional[int] = None):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.files = sorted(
            os.path.join(velo_dir, f) for f in os.listdir(velo_dir) if f.endswith(".bin")
        )
        if max_frames:
            self.files = self.files[:max_frames]
        self.max_points = max_points

        self.gt_poses = None
        pose_file = os.path.join(root, "poses", f"{sequence}.txt")
        if os.path.exists(pose_file):
            cam_poses = read_poses(pose_file)[: len(self.files)]
            calib = os.path.join(self.seq_dir, "calib.txt")
            Tr = read_calib_velo_to_cam(calib) if os.path.exists(calib) else None
            if Tr is not None:
                # Express poses in the velodyne frame: T_velo = Tr^-1 T_cam Tr.
                Tr_inv = np.linalg.inv(Tr)
                self.gt_poses = np.einsum("ij,njk,kl->nil", Tr_inv, cam_poses, Tr).astype(np.float32)
            else:
                self.gt_poses = cam_poses

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator:
        if self.max_points is not None:
            # Native read-ahead: host decode of scan t+1 overlaps device compute of
            # scan t (`native/lgs_io.cpp` prefetcher; numpy fallback inside). This is
            # the CLI's path: `pipeline/cli.py` passes max_points=capacity.raw_points.
            from lidar_graph_slam_tpu_torch import native

            pf = native.ScanPrefetcher(self.files, self.max_points)
            try:
                for i, (pts, n) in enumerate(pf):
                    gt = self.gt_poses[i] if self.gt_poses is not None else None
                    yield pts[:n], gt
            finally:
                pf.close()
            return
        for i, f in enumerate(self.files):
            scan = read_velodyne_bin(f, self.max_points)
            gt = self.gt_poses[i] if self.gt_poses is not None else None
            yield scan, gt
