"""Trajectory evaluation: ATE / RPE against ground truth.

Copied from `lidar_graph_slam_tpu/utils/evaluation.py` (the port cannot import the JAX package,
whose `__init__` imports jax); `tests/test_torch_*.py` hold the copy equal to it.

The reference ships no evaluation at all (SURVEY.md §6 — its implicit baseline is "the
trajectory the C++ stack produces"); these metrics are how this engine's parity with that
baseline is quantified (BASELINE.json "metric": KITTI ATE bound).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment src->dst over [N, 3] position arrays.

    Returns (R, t, s) minimizing ||s R src + t - dst||^2.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (sc ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE [m] over [N, 4, 4] pose arrays."""
    p_est = est_poses[:, :3, 3]
    p_gt = gt_poses[:, :3, 3]
    if align:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`: returns (trans_rmse [m], rot_rmse [rad])."""
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.arccos(cos))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(np.sqrt(np.mean(np.square(r_errs))))
