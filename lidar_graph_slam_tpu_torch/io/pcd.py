"""Point-cloud and trajectory file I/O.

Copied from `lidar_graph_slam_tpu/io/pcd.py` (the port cannot import the JAX package,
whose `__init__` imports jax); `tests/test_torch_*.py` hold the copy equal to it.

Replaces `pcl::io::savePCDFile` (map export in the save-map service,
`graph_based_slam/src/graph_based_slam.cpp:496-498`) and adds the trajectory exports
(TUM / KITTI formats) the reference lacks but every SLAM evaluation needs.
"""

from __future__ import annotations

import numpy as np


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an [N, 3] float32 cloud as PCD v0.7 (binary by default, like PCL's default)."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """Read x/y/z from an ASCII or binary PCD written by `write_pcd` or PCL."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        n = int(header["POINTS"])
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        if header["DATA"] == "ascii":
            data = np.loadtxt(f, max_rows=n).reshape(n, -1)
        else:
            dtype = np.dtype({"names": fields, "formats": [f"f{s}" for s in sizes]})
            data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            data = np.stack([data["x"], data["y"], data["z"]], axis=1)
            return data.astype(np.float32)
    ix, iy, iz = fields.index("x"), fields.index("y"), fields.index("z")
    return data[:, [ix, iy, iz]].astype(np.float32)


def write_ply(path: str, points: np.ndarray) -> None:
    """Minimal binary-little-endian PLY export."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {points.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(points.astype("<f4").tobytes())


def write_tum_trajectory(path: str, poses: np.ndarray, timestamps=None) -> None:
    """TUM format: `t tx ty tz qx qy qz qw` per line."""
    import torch

    from lidar_graph_slam_tpu_torch.core import se3

    poses = np.asarray(poses)
    q = se3.matrix_to_quat(torch.as_tensor(poses[:, :3, :3], dtype=torch.float32)).numpy()
    t = poses[:, :3, 3]
    ts = timestamps if timestamps is not None else np.arange(len(poses), dtype=np.float64)
    with open(path, "w") as f:
        for i in range(len(poses)):
            f.write(
                f"{ts[i]:.6f} {t[i,0]:.6f} {t[i,1]:.6f} {t[i,2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )


def write_kitti_trajectory(path: str, poses: np.ndarray) -> None:
    """KITTI format: 12 row-major values of the 3x4 pose per line."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)) + "\n")
