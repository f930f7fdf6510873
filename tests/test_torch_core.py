"""PyTorch port vs the JAX reference: se3, point-cloud compaction and the host-only
modules the port carries as copies (synthetic data, evaluation, trajectory I/O).

The se3 inputs are `tests/test_se3.py`'s cases, made with numpy from a seed and fed to
both packages. Tolerance: atol 1e-6 on every output, plus rtol 1e-6 (about 8 ulps) because
float32's own spacing exceeds 1e-6 above 8 (translations reach ~15 m here). The log maps get
rtol 2e-5: arccos's slope near +-1 turns a one-ulp difference between XLA's and PyTorch's
arccos/trace into ~20 ulps of the angle, and the inverse left Jacobian carries it on."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core import pointcloud as jpc
from lidar_graph_slam_tpu.core import se3 as jse3
from lidar_graph_slam_tpu_torch.core import pointcloud as tpc
from lidar_graph_slam_tpu_torch.core import se3 as tse3

ATOL = 1e-6
RTOL = 1e-6
RTOL_LOG = 2e-5


def _axis_angle(rng, n, lo=0.0, hi=3.0):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * rng.uniform(lo, hi, size=(n, 1))).astype(np.float32)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jse3.quat_to_matrix(jnp.asarray(q, dtype=jnp.float32)))


def _transforms(rng, n, trans_scale=10.0):
    R = _rotations(rng, n)
    t = (rng.normal(size=(n, 3)) * trans_scale).astype(np.float32)
    return np.asarray(jse3.make_transform(jnp.asarray(R), jnp.asarray(t)))


def _near_pi(rng):
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = (axis * (np.pi - np.abs(rng.normal(size=(32, 1))) * 1e-5)).astype(np.float32)
    return (np.asarray(jse3.so3_exp(jnp.asarray(w))),)


def _canonical_quats(rng):
    q = rng.normal(size=(128, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return ((q * np.where(q[:, :1] < 0, -1.0, 1.0)).astype(np.float32),)


# (case, function name, inputs from rng) — the cases of tests/test_se3.py.
CASES = [
    ("so3_exp", "so3_exp", lambda r: (_axis_angle(r, 64),)),
    ("so3_exp_small", "so3_exp", lambda r: ((r.normal(size=(16, 3)) * 1e-8).astype(np.float32),)),
    ("so3_log", "so3_log", lambda r: (np.asarray(jse3.so3_exp(jnp.asarray(_axis_angle(r, 64)))),)),
    ("so3_log_large", "so3_log", lambda r: (np.asarray(jse3.so3_exp(
        jnp.asarray((r.normal(size=(64, 3)) * 2.5).astype(np.float32)))),)),
    ("so3_log_small", "so3_log", lambda r: (np.asarray(jse3.so3_exp(
        jnp.asarray((r.normal(size=(16, 3)) * 1e-8).astype(np.float32)))),)),
    ("se3_exp", "se3_exp", lambda r: (np.concatenate(
        [_axis_angle(r, 64), (r.normal(size=(64, 3)) * 5.0).astype(np.float32)], -1),)),
    ("se3_log", "se3_log", lambda r: (np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate(
        [_axis_angle(r, 64), (r.normal(size=(64, 3)) * 5.0).astype(np.float32)], -1)))),)),
    ("inverse", "inverse", lambda r: (_transforms(r, 8),)),
    ("between", "between", lambda r: (_transforms(r, 8), _transforms(r, 8))),
    ("transform_points", "transform_points", lambda r: (
        _transforms(r, 1)[0], (r.normal(size=(100, 3)) * 5.0).astype(np.float32))),
    ("quat_to_matrix", "quat_to_matrix", _canonical_quats),
    ("matrix_to_quat", "matrix_to_quat", lambda r: (_rotations(r, 128),)),
    ("matrix_to_pose7", "matrix_to_pose7", lambda r: (_transforms(r, 16),)),
    ("pose7_to_matrix", "pose7_to_matrix", lambda r: (np.asarray(
        jse3.matrix_to_pose7(jnp.asarray(_transforms(r, 16)))),)),
    ("euler_to_quat", "euler_to_quat", lambda r: (r.uniform(-1.4, 1.4, size=(32, 3)).astype(np.float32),)),
    ("quat_to_euler", "quat_to_euler", lambda r: (np.asarray(jse3.euler_to_quat(
        jnp.asarray(r.uniform(-1.4, 1.4, size=(32, 3)).astype(np.float32)))),)),
    ("adjoint", "adjoint", lambda r: (_transforms(r, 4),)),
    ("hat", "hat", lambda r: (r.normal(size=(10, 3)).astype(np.float32),)),
    ("vee", "vee", lambda r: (r.normal(size=(10, 3, 3)).astype(np.float32),)),
]


@pytest.mark.parametrize("case,fn,make", CASES, ids=[c[0] for c in CASES])
def test_se3_matches_reference(rng, case, fn, make):
    args = make(rng)
    want = np.asarray(getattr(jse3, fn)(*[jnp.asarray(a) for a in args]))
    got = getattr(tse3, fn)(*[torch.as_tensor(np.array(a)) for a in args]).numpy()
    assert got.dtype == want.dtype
    rtol = RTOL_LOG if fn.endswith("_log") else RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL, err_msg=case)


def test_so3_log_near_pi_matches_reference(rng):
    """Near pi the log's axis comes from the diagonal, and arccos's slope there turns
    an ulp of the trace into ~1e-3 rad; as in tests/test_se3.py the rotations the two
    logs map back to are compared (atol 1e-3 to each other, 2e-3 to the input, the
    bound tests/test_se3.py states for float32 sqrt near zero), not the twists."""
    (R,) = _near_pi(rng)
    w_j = jse3.so3_log(jnp.asarray(R))
    w_t = tse3.so3_log(torch.as_tensor(np.array(R)))
    np.testing.assert_allclose(tse3.so3_exp(w_t).numpy(), np.asarray(jse3.so3_exp(w_j)),
                               atol=1e-3)
    np.testing.assert_allclose(tse3.so3_exp(w_t).numpy(), R, atol=2e-3)


def test_orthonormalize_matches_reference(rng):
    R = _rotations(rng, 8)
    noisy = (R + rng.normal(size=R.shape) * 1e-3).astype(np.float32)
    want = np.asarray(jse3.orthonormalize(jnp.asarray(noisy)))
    got = tse3.orthonormalize(torch.as_tensor(noisy)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("capacity", [300, 512, 800])
def test_compact_matches_reference_exactly(rng, capacity):
    pts = rng.normal(size=(512, 3)).astype(np.float32)
    mask = rng.random(512) > 0.4
    jp, jm = jpc.compact(jnp.asarray(pts), jnp.asarray(mask), capacity)
    tp, tm = tpc.compact(torch.as_tensor(pts), torch.as_tensor(mask), capacity)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_concat_and_pad_match_reference(rng):
    a, b = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    ma, mb = rng.random(64) > 0.5, rng.random(64) > 0.5
    jp, jm = jpc.concat_clouds([jnp.asarray(a), jnp.asarray(b)],
                               [jnp.asarray(ma), jnp.asarray(mb)], 100)
    tp, tm = tpc.concat_clouds([torch.as_tensor(a), torch.as_tensor(b)],
                               [torch.as_tensor(ma), torch.as_tensor(mb)], 100)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    cloud = tpc.PointCloud.from_array(a[:10], capacity=16)
    np.testing.assert_array_equal(cloud.to_array(), a[:10])
    assert int(cloud.count()) == 10


def test_copied_host_modules_match_reference(tmp_path):
    """The port's copies of the numpy-only modules give the reference's outputs."""
    from lidar_graph_slam_tpu.io import pcd as jpcd
    from lidar_graph_slam_tpu.io import synthetic as jsyn
    from lidar_graph_slam_tpu.utils import evaluation as jev
    from lidar_graph_slam_tpu_torch.io import pcd as tpcd
    from lidar_graph_slam_tpu_torch.io import synthetic as tsyn
    from lidar_graph_slam_tpu_torch.utils import evaluation as tev

    js = jsyn.SyntheticSequence(n_frames=3, seed=5, max_points=2048, laps=0.05)
    ts = tsyn.SyntheticSequence(n_frames=3, seed=5, max_points=2048, laps=0.05)
    for (sj, pj), (st, pt) in zip(js, ts):
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(pt, pj)

    poses = js.poses.copy()
    noisy = poses.copy()
    noisy[:, :3, 3] += np.random.default_rng(1).normal(scale=0.1, size=(3, 3))
    assert tev.ate_rmse(noisy, poses) == jev.ate_rmse(noisy, poses)
    assert tev.rpe(noisy, poses) == jev.rpe(noisy, poses)

    jpcd.write_tum_trajectory(str(tmp_path / "j.txt"), noisy)
    tpcd.write_tum_trajectory(str(tmp_path / "t.txt"), noisy)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    pts = np.random.default_rng(2).normal(size=(50, 3)).astype(np.float32)
    tpcd.write_pcd(str(tmp_path / "m.pcd"), pts)
    np.testing.assert_array_equal(jpcd.read_pcd(str(tmp_path / "m.pcd")), pts)
