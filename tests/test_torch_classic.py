"""PyTorch port vs the JAX reference: the classic stage-by-stage driver (`ScanMatcher`
and `SlamPipeline(fused_frontend=False)`) with NDT, GICP and ICP, its extrinsic and IMU
paths, and one fused front-end step with the GICP and ICP matchers.

The classic driver rebuilds its target at once on a keyframe, where the fused one lags a
frame, so it is held against the reference's `ScanMatcher`, not against the port's fused
driver.

Tolerances: `ScanMatcher` per frame — the pose to atol 1e-4 (metres and rotation
entries), keyframe flags, convergence and iterations equal. GICP's fifth and sixth
frames to atol 5e-3: its targets amplify the closed loop's rounding. A 1e-7 pose
difference at keyframe 1 moves the next target's points by ~4e-6 m, which turns the
plane-regularized covariances of near-isotropic patches by up to O(1) (0.93 measured at
frame 3, where the poses still agree to 2e-5), and the alignment by 1.2e-4 to 5.5e-4 m
at frame 4 and 2.3e-4 to 2.2e-3 m at frame 5 at 1, 2, 4 and 8 intra-op threads (the
reduction order); this module runs at one.
The 5-frame classic pipeline — per-frame translation within 1 cm and rotation within
1 mrad, keyframe flags, iterations and keyframe indices equal (as
`tests/test_torch_pipeline.py` holds the fused one). One fused step from the reference's
state and target — the pose to atol 1e-4, flags exact, num_inliers within 1%.
"""

import dataclasses
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core import config as jcfg
from lidar_graph_slam_tpu.core import se3 as jse3
from lidar_graph_slam_tpu.core.pointcloud import PointCloud as JCloud
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.odometry.fused import make_fused_frontend as jax_fused
from lidar_graph_slam_tpu.odometry.scan_matcher import ScanMatcher as JMatcher
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JaxPipeline
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud as TCloud
from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import ScanMatcher as TMatcher
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline as TorchPipeline
from lidar_graph_slam_tpu_torch.utils.state import (
    front_end_state_from_numpy,
    gicp_target_from_numpy,
    hash_grid_from_numpy,
)
from tests.test_pipeline import small_config

CAP = 4096


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it: the suite
    runs its files in parallel processes, and an OpenMP pool of one thread per core in
    each of them oversubscribes the cores so far that GICP's many small ops (its
    covariances are ~800 of them) slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg, cls):
    """The same config in the port's (copied) dataclasses."""
    return tcfg._update_dataclass(cls(), dataclasses.asdict(cfg))


def _rot_err(A, B):
    chord = np.linalg.norm(A[:3, :3].astype(np.float64) - B[:3, :3].astype(np.float64))
    return float(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))


@pytest.fixture(scope="module")
def course():
    """`tests/test_odometry.py:run_odometry`'s sequence (seed 0, 4,096 points) cut to 6
    frames at the per-frame motion of its GICP/ICP cases (~1.9 m)."""
    seq = SyntheticSequence(n_frames=6, seed=0, max_points=CAP, laps=0.12 * 5 / 14)
    return [s for s, _ in seq], seq.poses


def _gyro(poses):
    """Per-frame gyro samples of `tests/test_imu.py`: the ground-truth yaw rate, two
    samples per 0.1 s frame."""
    T0_inv = np.linalg.inv(poses[0])
    rel = [(T0_inv @ p).astype(np.float32) for p in poses]
    out = [[]]
    for i in range(1, len(rel)):
        dR = np.asarray(jse3.so3_log(jnp.asarray((np.linalg.inv(rel[i - 1]) @ rel[i])[:3, :3])))
        out.append([(i * 0.1 - 0.05, dR / 0.1), (i * 0.1, dR / 0.1)])
    return out


def _yaw(yaw):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


# case -> (ScanMatcherConfig overrides, stamps + gyro, extrinsic provider, raw rotation)
MATCHER_CASES = {
    "NDT": (dict(ndt=jcfg.NdtConfig(max_iterations=32)), False, False, 0.0),
    "GICP": (dict(registration_method="GICP"), False, False, 0.0),
    "ICP": (dict(registration_method="ICP"), False, False, 0.0),
    # test_extrinsic_applied: raw scans rotated by -yaw, the static extrinsic undoes it.
    "extrinsic": (dict(extrinsic_xyzrpy=(0.1, 0.0, 0.2, 0.0, 0.0, 0.4)), False, False, 0.4),
    # test_dynamic_extrinsic_provider: a time-varying mount rotation, one stamp a miss.
    "provider": (dict(), True, True, 0.0),
    # test_odometry_with_imu_stamps: stamps and the gyro rotation guess.
    "imu": (dict(), True, False, 0.0),
}


def _provider(stamp):
    if stamp is None or int(round(stamp * 10)) == 3:
        return None  # a lookup miss falls back to the (identity) config extrinsic
    return _yaw(0.1 * round(stamp * 10))


def _drive(matcher, cloud_cls, scans, poses, stamped, provider, raw_yaw):
    if provider:
        matcher.extrinsic_provider = _provider
    gyro = _gyro(poses) if stamped and not provider else [[]] * len(scans)
    outs = []
    for i, scan in enumerate(scans):
        for t, w in gyro[i]:
            matcher.add_imu(t, w)
        stamp = 0.1 * i if stamped else None
        if raw_yaw:
            scan = scan @ _yaw(-raw_yaw)[:3, :3].T
        if provider and _provider(stamp) is not None:
            scan = scan @ _provider(stamp)[:3, :3]  # undone by the provider's rotation
        outs.append(matcher.process(cloud_cls.from_array(scan, capacity=CAP), stamp=stamp))
    return outs


@pytest.fixture(scope="module")
def matcher_runs(course):
    """Each case through both packages' `ScanMatcher`: {case: (reference outputs, port
    outputs, port matcher, reference matcher)}."""
    scans, poses = course
    out = {}
    for case, (overrides, stamped, provider, raw_yaw) in MATCHER_CASES.items():
        jc = jcfg.ScanMatcherConfig(**overrides)
        jm = JMatcher(jc, scan_capacity=CAP, map_voxel_capacity=32768)
        tm = TMatcher(_port(jc, tcfg.ScanMatcherConfig), scan_capacity=CAP,
                      map_voxel_capacity=32768, device="cpu")
        out[case] = (_drive(jm, JCloud, scans, poses, stamped, provider, raw_yaw),
                     _drive(tm, TCloud, scans, poses, stamped, provider, raw_yaw), tm, jm)
    return out


@pytest.mark.parametrize("case", list(MATCHER_CASES))
def test_scan_matcher_matches_reference(matcher_runs, course, case):
    jouts, touts, tm, jm = matcher_runs[case]
    for f, (t, j) in enumerate(zip(touts, jouts)):
        atol = 5e-3 if case == "GICP" and f >= 4 else 1e-4
        np.testing.assert_allclose(t["pose"], j["pose"], atol=atol, err_msg=f"frame {f}")
        for key in ("is_keyframe", "converged", "iterations"):
            assert t[key] == j[key], (f, key)
    assert all(t["converged"] for t in touts)
    assert tm.n_keyframes == jm.n_keyframes >= 3
    for tk, jk in zip(tm.keyframe_log, jm.keyframe_log):
        assert (tk["frame_index"], tk["id"]) == (jk["frame_index"], jk["id"])
        np.testing.assert_allclose(tk["accum_distance"], jk["accum_distance"], atol=1e-4)
        np.testing.assert_array_equal(tk["cloud_mask"], np.asarray(jk["cloud_mask"]))
    # Tracking holds: within 0.3 m of ground truth over the course.
    _, poses = course
    T0_inv = np.linalg.inv(poses[0])
    gt = np.stack([(T0_inv @ p)[:3, 3] for p in poses])
    est = np.stack([t["pose"][:3, 3] for t in touts])
    assert np.linalg.norm(est - gt, axis=1).max() < 0.3


def test_scan_matcher_imu_hooks():
    """`tests/test_imu.py`'s unit cases: 0.5 s of 0.2 rad/s yaw integrates to 0.1 rad;
    no samples, no rotation."""
    sm = TMatcher(tcfg.ScanMatcherConfig(), scan_capacity=512, device="cpu")
    sm.last_scan_stamp = 0.0
    assert sm._imu_rotation_delta(0.5) is None
    for i in range(1, 6):
        sm.add_imu(i * 0.1, [0.0, 0.0, 0.2])
    delta = sm._imu_rotation_delta(0.5)
    np.testing.assert_allclose(np.arctan2(delta[1, 0], delta[0, 0]), 0.1, atol=1e-5)


def test_scan_matcher_validates_and_needs_a_card(monkeypatch):
    with pytest.raises(ValueError):
        TMatcher(tcfg.ScanMatcherConfig(registration_method="VGICP"), 512, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TMatcher(tcfg.ScanMatcherConfig(), 512)
    assert TMatcher(tcfg.ScanMatcherConfig(), 512, device="cpu").ring.clouds.device.type == "cpu"


# -- the classic pipeline -------------------------------------------------------------

N_FRAMES = 5


@pytest.fixture(scope="module")
def pipeline_course():
    """The 5-frame course of `tests/test_torch_pipeline.py`."""
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * N_FRAMES / 90)
    return [s for s, _ in seq]


def test_classic_pipeline_matches_reference(pipeline_course):
    cfg = replace(small_config(), fused_frontend=False, enable_loop_closure=False)
    jpipe = JaxPipeline(cfg)
    tpipe = TorchPipeline(_port(cfg, tcfg.PipelineConfig), device="cpu")
    assert tpipe.front is not None and not tpipe.fused
    for i, s in enumerate(pipeline_course):
        jo = jpipe.process_scan(s, stamp=0.1 * i)
        to = tpipe.process_scan(s, stamp=0.1 * i)
        assert to["is_keyframe"] == jo["is_keyframe"]  # no readback lag in this driver
    jres, tres = jpipe.result(), tpipe.result()
    assert tres.odometry_poses.shape == jres.odometry_poses.shape == (N_FRAMES, 4, 4)
    for a, b in zip(tres.odometry_poses, jres.odometry_poses):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.01
        assert _rot_err(a, b) < 1e-3
    np.testing.assert_array_equal(tres.keyframe_frame_indices, jres.keyframe_frame_indices)
    np.testing.assert_allclose(tres.keyframe_poses, jres.keyframe_poses, atol=0.01)
    j_frames = [r for r in jpipe.metrics_writer.records if "frame" in r and "event" not in r]
    t_frames = [r for r in tpipe.metrics_writer.records if "frame" in r and "event" not in r]
    for key in ("iterations", "is_keyframe", "converged", "n_keyframes"):
        assert [r[key] for r in t_frames] == [r[key] for r in j_frames], key
    assert all("prefilter_ms" in r for r in t_frames)
    assert set(tres.metrics) == {"prefilter", "register", "backend"}
    assert all(len(v) == N_FRAMES for v in tpipe.timings.values())
    for k in range(jpipe.back.n_keyframes):
        assert tpipe.back._cloud(k).shape == jpipe.back._cloud(k).shape
    assert tpipe.back.kf_stamps == jpipe.back.kf_stamps


def test_classic_pipeline_routes_imu_and_loops(pipeline_course):
    """`add_imu` reaches `ScanMatcher`'s queue; loop closure on (the default) runs the
    back end's cadence hook in this driver too."""
    cfg = replace(small_config(), fused_frontend=False)
    pipe = TorchPipeline(_port(cfg, tcfg.PipelineConfig), device="cpu")
    pipe.add_imu(0.05, [0.0, 0.0, 0.1])
    assert pipe.front.imu_queue == [(0.05, pytest.approx(np.array([0.0, 0.0, 0.1])))]
    res = pipe.run(pipeline_course[:3])
    assert res.odometry_poses.shape == (3, 4, 4) and res.num_loop_closures == 0
    assert pipe.back._frames_since_loop_check == 3


# -- one fused step with the GICP and ICP matchers ------------------------------------

@pytest.mark.parametrize("method", ["GICP", "ICP"])
def test_fused_step_matches_reference(pipeline_course, method):
    """The reference's fused front end bootstraps on frame 0 and rebuilds its target;
    the port's step for frame 1, started from the reference's state and target (carried
    across by utils/state.py), gives the reference's outputs."""
    cfg = small_config()
    cfg = replace(cfg, scan_matcher=replace(cfg.scan_matcher, registration_method=method))
    cap = cfg.capacity
    init_state, step, aux = jax_fused(cfg.scan_matcher, cfg.prefilter, cap)
    raw = []
    for s in pipeline_course[:2]:
        r = np.full((cap.raw_points, 3), 1.0e6, np.float32)
        r[: len(s)] = s[: cap.raw_points]
        raw.append(r)
    eye3, eye4, no = jnp.eye(3), jnp.eye(4), jnp.asarray(False)
    state, out0 = step(init_state(), jnp.asarray(raw[0]), aux["rebuild"](aux["init_ring"]()),
                       eye3, no, eye4, no)
    ring, target = aux["insert_and_rebuild"](aux["init_ring"](), jnp.asarray(0, jnp.int32),
                                             out0.kf_cloud, out0.kf_mask, out0.pose)
    carried_state = front_end_state_from_numpy(dict(
        front_pose=np.array(state.pose), front_last_motion=np.array(state.last_motion),
        front_last_kf_pose=np.array(state.last_kf_pose),
        front_accum=np.array(state.accum_distance),
        front_n_keyframes=np.array(state.n_keyframes)))
    grid = target.grid if method == "GICP" else target
    grid_arrays = {f.name: np.array(getattr(grid, f.name)) for f in dataclasses.fields(grid)}
    carried_target = (gicp_target_from_numpy({**grid_arrays, "covs": np.array(target.covs),
                                              "valid": np.array(target.valid)})
                      if method == "GICP" else hash_grid_from_numpy(grid_arrays))
    _, want = step(state, jnp.asarray(raw[1]), target, eye3, no, eye4, no)

    tc = _port(cfg, tcfg.PipelineConfig)
    _, tstep, _ = make_fused_frontend(tc.scan_matcher, tc.prefilter, tc.capacity, device="cpu")
    _, out = tstep(carried_state, torch.as_tensor(raw[1]), carried_target, torch.eye(3), False,
                   torch.eye(4), False)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    for k in ("converged", "is_keyframe", "iterations"):
        assert getattr(out, k).item() == np.asarray(getattr(want, k)).item(), k
    j_inl = int(np.asarray(want.num_inliers))
    assert abs(int(out.num_inliers) - j_inl) <= 0.01 * j_inl
    assert bool(out.converged) and j_inl > 1000
