"""Inputs shared by the port's two-process workers (`tests/torch_multihost_worker.py`) and
the parent test (`tests/test_torch_multihost.py`), which runs the one-process side. Made
from seeds with numpy; imports torch and the port only."""

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.graph import solver
from lidar_graph_slam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    make_loop_trajectory,
    make_world,
    simulate_scan,
)

GRAPH_K = 16


def store_fixture():
    """`tests/multihost_worker.py:46-57`: six 32-point clouds from `default_rng(0)`, pose k
    at x = k. Returns (clouds, poses, the rng, which the graph's draws continue)."""
    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(32, 3)).astype(np.float32) for _ in range(6)]
    poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    for k in range(6):
        poses[k, 0, 3] = float(k)
    return clouds, poses, rng


def graph_twists(rng) -> list:
    """The K = 16 chain's odometry twists of `tests/multihost_worker.py:69-78`: 1 m steps
    along x with 0.01 rad of rotation noise."""
    return [np.concatenate([rng.normal(size=3) * 0.01, [1.0, 0, 0]]).astype(np.float32)
            for _ in range(GRAPH_K - 1)]


def torch_graph(rng) -> solver.PoseGraph:
    """That chain as the port's `PoseGraph` on the CPU, closed by the loop (0, K - 1) at
    information 1e4."""
    g = solver.init_graph(GRAPH_K, 2, (1e-4,) * 6, device="cpu")
    T = np.eye(4, dtype=np.float32)
    g = solver.graph_add_keyframe(g, torch.as_tensor(T), torch.eye(4))
    for xi in graph_twists(rng):
        meas = se3.se3_exp(torch.as_tensor(xi)).numpy()
        T = T @ meas
        g = solver.graph_add_keyframe(g, torch.as_tensor(T), torch.as_tensor(meas))
    return solver.graph_add_loop(g, 0, GRAPH_K - 1, torch.eye(4),
                                 torch.full((6,), 1e4, dtype=torch.float32))


def small_config(async_backend: bool = True, **parallel) -> tcfg.PipelineConfig:
    """The reference worker's small capacities (`tests/multihost_worker.py:112-120`). A
    multi-process run forces the synchronous back end whatever `async_backend` says; its
    one-process counterpart passes False."""
    return tcfg.PipelineConfig(
        prefilter=tcfg.PrefilterConfig(leaf_size=0.3, mean_k=10),
        graph_slam=tcfg.GraphSlamConfig(loop_search_period_frames=5,
                                        async_backend=async_backend),
        capacity=tcfg.CapacityConfig(raw_points=8192, filtered_points=4096,
                                     keyframe_points=4096, loop_submap_points=65536,
                                     max_keyframes=256, voxel_capacity=32768,
                                     max_loop_factors=16),
        parallel=tcfg.ParallelConfig(**parallel))


def short_scans(n: int = 15) -> list:
    """n frames of the 90-frame loop course's world (seed 3, radius 30) at its ~2.3 m a
    frame."""
    seq = SyntheticSequence(n_frames=n, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * n / 90)
    return [s for s, _ in seq]


def course_scans() -> list:
    """The reference worker's loop course (`tests/multihost_worker.py:121-124`): 75 frames,
    seed 3, radius 25, 1.12 laps, 4,096 points."""
    seq = SyntheticSequence(n_frames=75, seed=3, max_points=4096, radius=25.0, laps=1.12)
    return [s for s, _ in seq]


def batch_course(B: int = 2, F: int = 4, N: int = 1024):
    """`tests/test_torch_multi_sequence.py`'s small batch: B sequences of F frames
    (`SyntheticSequence(seed 10 + b, radius 30 + 2b, 0.1 laps)`), [B, F, N, 3] scans padded
    with 1e6 and [B, F, N] masks; and its matcher (a 3-scan ring, the 2 m map only)."""
    scans = np.full((B, F, N, 3), 1.0e6, dtype=np.float32)
    masks = np.zeros((B, F, N), dtype=bool)
    for b in range(B):
        seq = SyntheticSequence(n_frames=F, seed=10 + b, max_points=N, laps=0.1,
                                radius=30.0 + 2 * b)
        for f, (scan, _) in enumerate(seq):
            scans[b, f, :len(scan)] = scan
            masks[b, f, :len(scan)] = True
    cfg = tcfg.ScanMatcherConfig(max_scan_accumulate_num=3, ndt=tcfg.NdtConfig(
        resolution=2.0, max_iterations=32, coarse_resolution=0.0))
    return scans, masks, cfg


def multi_lap_backend(mesh=None, cloud_store=None):
    """`tests/test_pipeline_mesh.py`'s back end with `loop_topk=2`: ground-truth keyframes
    along a 2.15-lap circle, so the latest keyframe has two gated candidates a lap apart."""
    from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM

    cfg = tcfg.GraphSlamConfig(accumulate_distance_threshold=80.0,
                               search_for_candidate_threshold=15.0, search_key_frame_num=10,
                               loop_topk=2)
    cap = tcfg.CapacityConfig(max_keyframes=128, max_loop_factors=8, keyframe_points=4096,
                              loop_submap_points=65536, voxel_capacity=32768)
    back = GraphBasedSLAM(cfg, cap, device="cpu", mesh=mesh, cloud_store=cloud_store)
    rng = np.random.default_rng(11)
    world = make_world(rng, extent=40.0, density=2.0)
    traj = make_loop_trajectory(80, radius=16.0, laps=2.15)
    accum, prev = 0.0, traj[0]
    for k in range(80):
        pose = traj[k]
        if k:
            accum += float(np.linalg.norm(pose[:3, 3] - prev[:3, 3]))
        prev = pose
        scan = simulate_scan(world, pose, rng, max_points=4096, noise=0.01)
        back.add_keyframe({"pose": pose.astype(np.float32), "cloud": scan,
                           "cloud_mask": np.ones(scan.shape[0], bool), "accum_distance": accum})
    return back
