"""The port's two front-end drivers held to each other, after
`tests/test_fused_frontend.py::test_fused_matches_classic_trajectory` and
`tests/test_imu.py::test_fused_driver_imu_matches_classic`: the fused driver (one step a
frame, a one-frame submap lag) and the classic stage-by-stage driver give the same
trajectory within the reference tests' bounds, with and without a gyro stream. Both are
`slow`, as their references are.

Bounds (the reference tests'): without IMU, each driver within 1.0 m of the truth at
every frame, the two within 0.5 m of each other, the same keyframe schedule; with IMU,
within 0.6 m of the truth and 0.3 m of each other.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from tests.test_pipeline import small_config


def _config(fused: bool) -> tcfg.PipelineConfig:
    cfg = tcfg._update_dataclass(tcfg.PipelineConfig(), dataclasses.asdict(small_config()))
    return dataclasses.replace(cfg, fused_frontend=fused, enable_loop_closure=False)


@pytest.mark.slow
def test_fused_matches_classic_trajectory():
    n = 40
    seq = SyntheticSequence(n_frames=n, seed=3, max_points=8192, radius=30.0, laps=1.1 * n / 90)
    scans = [np.asarray(s) for s, _ in seq]
    T0_inv = np.linalg.inv(seq.poses[0])
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])
    results = {fused: SlamPipeline(_config(fused), device="cpu").run(scans)
               for fused in (False, True)}
    a, b = results[False].odometry_poses, results[True].odometry_poses
    assert a.shape == b.shape == (n, 4, 4)
    for fused, r in results.items():
        err = np.linalg.norm(r.odometry_poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        assert err.max() < 1.0, f"fused={fused} lost tracking: max err {err.max():.3f}"
    d = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    assert d.max() < 0.5, f"fused diverged from classic: {d.max():.3f}"
    np.testing.assert_array_equal(results[False].keyframe_frame_indices,
                                  results[True].keyframe_frame_indices)


@pytest.mark.slow
def test_fused_driver_imu_matches_classic():
    """The same gyro stream fed to both drivers gives matching trajectories."""
    n, cap = 12, 4096
    seq = SyntheticSequence(n_frames=n, seed=2, max_points=cap, laps=0.1)
    scans = [np.asarray(s) for s, _ in seq]
    T0_inv = np.linalg.inv(seq.poses[0])
    dt = 0.1
    results = {}
    for fused in (False, True):
        pipe = SlamPipeline(_config(fused), device="cpu")
        prev_gt = None
        for i, scan in enumerate(scans):
            rel = (T0_inv @ seq.poses[i]).astype(np.float32)
            if prev_gt is not None:
                dR = se3.so3_log(torch.as_tensor(
                    (np.linalg.inv(prev_gt) @ rel)[:3, :3])).numpy() / dt
                pipe.add_imu(i * dt - 0.05, dR)
                pipe.add_imu(i * dt, dR)
            pipe.process_scan(scan, stamp=i * dt)
            prev_gt = rel
        results[fused] = pipe.result()
    a, b = results[False].odometry_poses, results[True].odometry_poses
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])
    for fused, r in results.items():
        err = np.linalg.norm(r.odometry_poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        assert err.max() < 0.6, f"fused={fused} IMU run lost tracking: {err.max():.3f}"
    d = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    assert d.max() < 0.3, f"fused+IMU diverged from classic+IMU: {d.max():.3f}"
