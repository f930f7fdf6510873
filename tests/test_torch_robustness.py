"""Degenerate inputs through the port, after `tests/test_robustness.py`: an empty scan, a
one-point scan and an out-of-range garbage scan through `SlamPipeline` on the CPU keep the
trajectory finite and the pose in place, and the loop-factor and keyframe capacities
refuse and flag an insert instead of overwriting. The port's trajectories are held to the
JAX package's on the same streams (poses to 1e-3, the same keyframe schedule)."""

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.core import config as jcfg
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JaxPipeline
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.graph import solver
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests (the back end's workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(mod):
    return mod.PipelineConfig(
        prefilter=mod.PrefilterConfig(leaf_size=0.3, mean_k=10),
        graph_slam=mod.GraphSlamConfig(loop_search_period_frames=5),
        capacity=mod.CapacityConfig(raw_points=8192, filtered_points=2048,
                                    keyframe_points=2048, loop_submap_points=16384,
                                    max_keyframes=64, voxel_capacity=8192,
                                    max_loop_factors=4))


def _both(stream):
    out = []
    for pipe in (JaxPipeline(_tiny(jcfg)), SlamPipeline(_tiny(tcfg), device="cpu")):
        for s in stream:
            pipe.process_scan(s)
        out.append(pipe.result())
    return out


def test_empty_and_tiny_scans_do_not_crash():
    scans = [s for s, _ in SyntheticSequence(n_frames=4, seed=0, max_points=4096, laps=0.05)]
    stream = [scans[0], np.zeros((0, 3), np.float32), scans[1],
              np.zeros((1, 3), np.float32), scans[2]]
    jres, res = _both(stream)
    assert np.isfinite(res.odometry_poses).all() and res.odometry_poses.shape[0] == 5
    np.testing.assert_allclose(res.odometry_poses, jres.odometry_poses, atol=1e-3)
    np.testing.assert_array_equal(res.keyframe_frame_indices, jres.keyframe_frame_indices)


def test_garbage_scan_is_survived():
    """Far-out-of-range garbage: the health gate freezes the pose for that frame and
    tracking resumes."""
    scans = [s for s, _ in SyntheticSequence(n_frames=5, seed=1, max_points=4096, laps=0.05)]
    stream = scans[:3] + [np.full((512, 3), 4.0e5, np.float32)] + scans[3:]
    jres, res = _both(stream)
    assert np.isfinite(res.odometry_poses).all()
    d = np.linalg.norm(np.diff(res.odometry_poses[:, :3, 3], axis=0), axis=1)
    assert d.max() < 10.0, d
    np.testing.assert_allclose(res.odometry_poses, jres.odometry_poses, atol=1e-3)


def _backend_with_keyframes(n, points=64):
    cfg = _tiny(tcfg)
    back = GraphBasedSLAM(cfg.graph_slam, cfg.capacity, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (float(k), 0, 0)
        back.add_keyframe({"pose": T, "cloud": rng.normal(size=(points, 3)).astype(np.float32),
                           "cloud_mask": np.ones(points, bool), "accum_distance": float(k)})
    return back, cfg


def test_loop_factor_overflow_surfaced():
    """At max_loop_factors the insert is refused and surfaced, never overwritten."""
    back, cfg = _backend_with_keyframes(8)
    for _ in range(cfg.capacity.max_loop_factors):
        back.graph = solver.graph_add_loop(back.graph, 0, 7, torch.eye(4),
                                           torch.ones(6))
        back.n_loops += 1
    loops_before = back.graph.loop_meas.clone()
    assert not back.loop_overflow
    assert back.try_close_loop() is False
    assert back.loop_overflow
    assert back.loop_log and back.loop_log[-1].get("overflow")
    assert int(back.graph.num_loops) == cfg.capacity.max_loop_factors
    assert torch.equal(back.graph.loop_meas, loops_before)


def test_keyframe_overflow_refused():
    cap = _tiny(tcfg).capacity.max_keyframes
    back, _ = _backend_with_keyframes(cap + 3, points=16)
    assert back.n_keyframes == cap and back.keyframe_overflow
    assert int(back.graph.num_poses) == cap
