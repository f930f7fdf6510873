"""Robust loop factors through the port's back end, after
`tests/test_robust_loops.py::test_poisoned_loop_neutralized_through_backend`: a loop
factor that passes the fitness gate but is wrong, inserted through the back end's own
insertion path, must not corrupt `optimized_poses()` — the default redescending kernel
rides `_run_optimize`'s float64 solve (`graph/refine64.py`, copied from the reference).

Tolerances: the reference test's 0.05 m from the truth, and the port's solved poses within
1e-5 m of the JAX back end's on the same keyframes (both solve in float64 with the same
`refine64`, then round to float32).
"""

import numpy as np
import torch

from lidar_graph_slam_tpu.graph import refine64
from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, GraphSlamConfig
from lidar_graph_slam_tpu_torch.graph import solver
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM

K = 64


def _poisoned(back_cls, cfg, cap, add_loop):
    """`K` keyframes around a circle (64 random points each), then a loop factor that
    claims keyframes 10 and 42 — about a diameter apart — coincide, at fitness 0.01
    (information 100 a dof), inserted as `_consume_verify` inserts one, then solved."""
    step = 2 * np.pi / K
    meas = refine64.se3_exp(np.tile(np.array([0, 0, step, 1.0, 0, 0]), (K, 1)))
    rng = np.random.default_rng(1)
    back = back_cls(cfg, cap)
    T = np.eye(4)
    gt = []
    for k in range(K):
        if k:
            T = T @ meas[k]
        gt.append(T.copy())
        back.add_keyframe({
            "pose": T.astype(np.float32),
            "cloud": rng.normal(size=(64, 3)).astype(np.float32),
            "cloud_mask": np.ones(64, bool),
            "accum_distance": float(k) * step,
        })
    back.graph = add_loop(back.graph)
    back._host_loops.append((10, 42, np.eye(4), np.full(6, 100.0)))
    back.n_loops += 1
    back._run_optimize()
    return back.optimized_poses(), np.stack(gt)


def test_poisoned_loop_neutralized_through_backend():
    import jax.numpy as jnp

    from lidar_graph_slam_tpu.core import config as jcfg
    from lidar_graph_slam_tpu.graph import solver as jsolver
    from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM as JBack

    cap = dict(max_keyframes=K, max_loop_factors=8, keyframe_points=256)
    est, gt = _poisoned(
        lambda c, k: GraphBasedSLAM(c, k, device="cpu"), GraphSlamConfig(async_backend=False),
        CapacityConfig(**cap),
        lambda g: solver.graph_add_loop(g, 10, 42, torch.eye(4),
                                        torch.full((6,), 100.0, dtype=torch.float32)))
    jest, _ = _poisoned(
        JBack, jcfg.GraphSlamConfig(async_backend=False), jcfg.CapacityConfig(**cap),
        lambda g: jsolver.graph_add_loop(g, jnp.asarray(10), jnp.asarray(42), jnp.eye(4),
                                         jnp.full((6,), 100.0, jnp.float32)))
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.max() < 0.05, f"poisoned factor corrupted the backend: {err.max():.3f} m"
    np.testing.assert_allclose(est, jest, atol=1e-5)
