"""PyTorch port vs the JAX reference: the fused front-end step, the loops-off pipeline,
its lagged readback, the copied config, the CLI (loops on and off), and the port's
independence from JAX. The pipeline with loop closure on is held against the reference
in `tests/test_torch_loop_pipeline.py`.

Tolerances: a single fused step started from the reference's state — pose to atol 1e-4,
flags, iterations and inlier counts exact. The 5-frame pipeline — per-frame translation
within 1 cm and rotation within 1 mrad, keyframe flags and iteration counts identical.
"""

import dataclasses
import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core import config as jcfg
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JaxPipeline
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend
from lidar_graph_slam_tpu_torch.pipeline import cli
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline as TorchPipeline
from lidar_graph_slam_tpu_torch.utils.state import (
    front_end_state_from_numpy,
    ndt_map_from_numpy,
    ring_from_numpy,
)
from tests.test_pipeline import small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 5


def _torch_config(cfg) -> tcfg.PipelineConfig:
    """The same config tree in the port's (copied) dataclasses."""
    return tcfg._update_dataclass(tcfg.PipelineConfig(), dataclasses.asdict(cfg))


def _rot_err(A, B):
    """Rotation angle between two poses from the chordal distance (the arccos-of-trace
    form reads ~5e-4 rad of float32 rounding noise for equal matrices)."""
    chord = np.linalg.norm(A[:3, :3].astype(np.float64) - B[:3, :3].astype(np.float64))
    return float(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))


def _map_arrays(m) -> dict:
    return {f.name: np.array(getattr(m, f.name)) for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def course():
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * N_FRAMES / 90)
    return [s for s, _ in seq]


@pytest.fixture(scope="module")
def cfg():
    return replace(small_config(), enable_loop_closure=False)


@pytest.fixture(scope="module")
def jax_run(course, cfg):
    """One reference run; every call of its fused step is recorded (inputs as numpy, in
    the checkpoint's key names, and the outputs)."""
    pipe = JaxPipeline(cfg)
    real_step, steps = pipe._step, []

    def spy(state, raw, target, imu_R, use_imu, T_ext, use_ext):
        rec = {
            "state": dict(front_pose=np.array(state.pose),
                          front_last_motion=np.array(state.last_motion),
                          front_last_kf_pose=np.array(state.last_kf_pose),
                          front_accum=np.array(state.accum_distance),
                          front_n_keyframes=np.array(state.n_keyframes)),
            "raw": np.array(raw),
            "target": [_map_arrays(m) for m in target],
        }
        new_state, out = real_step(state, raw, target, imu_R, use_imu, T_ext, use_ext)
        rec["out"] = {k: np.array(getattr(out, k)) for k in
                      ("pose", "converged", "is_keyframe", "iterations", "num_inliers")}
        steps.append(rec)
        return new_state, out

    pipe._step = spy
    for s in course:
        pipe.process_scan(s)
    return pipe, pipe.result(), steps, real_step


@pytest.fixture(scope="module")
def torch_run(course, cfg):
    pipe = TorchPipeline(_torch_config(cfg), device="cpu")
    outs = [pipe.process_scan(s) for s in course]
    return pipe, pipe.result(), outs


def test_config_dataclasses_equal_reference():
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(jcfg.PipelineConfig())
    for name in ("CapacityConfig", "PrefilterConfig", "NdtConfig", "GicpConfig", "IcpConfig",
                 "ScanMatcherConfig", "GlobalRegConfig", "GraphSlamConfig", "ParallelConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())
    pairs = ["scan_matcher.ndt.resolution=1.5", "capacity.raw_points=4096", "pipeline_depth=2"]
    assert (dataclasses.asdict(tcfg.apply_cli_overrides(tcfg.PipelineConfig(), pairs))
            == dataclasses.asdict(jcfg.apply_cli_overrides(jcfg.PipelineConfig(), pairs)))


@pytest.mark.parametrize("raw,want", [("false", False), ("False", False), ("FALSE", False),
                                      ("true", True), ("True", True), ("0", 0)])
def test_cli_overrides_parse_booleans(raw, want):
    """`--set fused_frontend=false` must select the classic driver: the reference's
    parser keeps a bare `false` as the (truthy) string "false"."""
    cfg = tcfg.apply_cli_overrides(tcfg.PipelineConfig(), [f"fused_frontend={raw}"])
    assert cfg.fused_frontend == want and type(cfg.fused_frontend) is type(want)
    cfg = tcfg.apply_cli_overrides(tcfg.PipelineConfig(), [
        "scan_matcher.registration_method=GICP", "graph_slam.registration_method=GICP"])
    assert cfg.scan_matcher.registration_method == cfg.graph_slam.registration_method == "GICP"


@pytest.mark.parametrize("frame", [1, 3, 4])
def test_fused_step_from_reference_state(jax_run, cfg, frame):
    """One fused step started from exactly the reference's state and target (carried
    across by utils/state.py) gives the reference's outputs."""
    _, _, steps, _ = jax_run
    rec = steps[frame]
    tc = _torch_config(cfg)
    _, step, _ = make_fused_frontend(tc.scan_matcher, tc.prefilter, tc.capacity, device="cpu")
    state = front_end_state_from_numpy(rec["state"])
    target = tuple(ndt_map_from_numpy(m) for m in rec["target"])
    _, out = step(state, torch.as_tensor(rec["raw"]), target, torch.eye(3), False,
                  torch.eye(4), False)
    want = rec["out"]
    np.testing.assert_allclose(out.pose.numpy(), want["pose"], atol=1e-4)
    for k in ("converged", "is_keyframe", "iterations", "num_inliers"):
        assert getattr(out, k).item() == want[k].item(), k


def test_fused_step_with_imu_and_extrinsic(jax_run, cfg):
    """The gyro-rotation guess and the per-frame extrinsic, both switched on, from the
    reference's state of frame 3 (pose atol 1e-4, flags and counts exact)."""
    from lidar_graph_slam_tpu.odometry.fused import FrontEndState as JaxState
    from lidar_graph_slam_tpu.ops.voxel import NdtVoxelMap as JaxMap

    _, _, steps, real_step = jax_run
    rec = steps[3]
    c, s = np.cos(0.01), np.sin(0.01)
    imu_R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    T_ext = np.eye(4, dtype=np.float32)
    T_ext[:3, :3] = imu_R.T
    T_ext[:3, 3] = [0.05, -0.02, 0.1]
    st = rec["state"]
    jstate = JaxState(pose=jnp.asarray(st["front_pose"]),
                      last_motion=jnp.asarray(st["front_last_motion"]),
                      last_kf_pose=jnp.asarray(st["front_last_kf_pose"]),
                      accum_distance=jnp.asarray(st["front_accum"]),
                      n_keyframes=jnp.asarray(st["front_n_keyframes"]))
    jtarget = tuple(JaxMap(**{k: jnp.asarray(v) for k, v in m.items()}) for m in rec["target"])
    _, jout = real_step(jstate, jnp.asarray(rec["raw"]), jtarget, jnp.asarray(imu_R),
                        jnp.asarray(True), jnp.asarray(T_ext), jnp.asarray(True))
    tc = _torch_config(cfg)
    _, step, _ = make_fused_frontend(tc.scan_matcher, tc.prefilter, tc.capacity, device="cpu")
    _, out = step(front_end_state_from_numpy(st), torch.as_tensor(rec["raw"]),
                  tuple(ndt_map_from_numpy(m) for m in rec["target"]), torch.as_tensor(imu_R),
                  True, torch.as_tensor(T_ext), True)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(jout.pose), atol=1e-4)
    for k in ("converged", "is_keyframe", "iterations", "num_inliers"):
        assert getattr(out, k).item() == np.asarray(getattr(jout, k)).item(), k
    np.testing.assert_array_equal(out.kf_mask.numpy(), np.asarray(jout.kf_mask))


@pytest.mark.parametrize("stride", [1, 2])
def test_assemble_submap_matches_reference(jax_run, stride):
    from lidar_graph_slam_tpu.odometry.scan_matcher import assemble_submap as jax_assemble
    from lidar_graph_slam_tpu_torch.odometry.scan_matcher import assemble_submap

    pipe, _, _, _ = jax_run
    ring = ring_from_numpy({f"ring_{k}": np.array(getattr(pipe._ring, k))
                            for k in ("clouds", "masks", "poses", "used")})
    jp, jm = jax_assemble(pipe._ring, stride=stride)
    tp, tm = assemble_submap(ring, stride=stride)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        assemble_submap(ring, stride=0)


def test_ring_rebuild_from_reference_state(jax_run, cfg):
    """The reference's submap ring, carried across, rebuilds the reference's target."""
    pipe, _, _, _ = jax_run
    ring = ring_from_numpy({f"ring_{k}": np.array(getattr(pipe._ring, k))
                            for k in ("clouds", "masks", "poses", "used")})
    tc = _torch_config(cfg)
    _, _, aux = make_fused_frontend(tc.scan_matcher, tc.prefilter, tc.capacity, device="cpu")
    for jm, tm in zip(pipe._target, aux["rebuild"](ring)):
        for field in ("keys", "valid", "num_voxels", "table"):
            np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                          np.asarray(getattr(jm, field)), err_msg=field)
        np.testing.assert_allclose(tm.means.numpy(), np.asarray(jm.means), atol=1e-5)


def test_pipeline_matches_reference(jax_run, torch_run):
    jpipe, jres, _, _ = jax_run
    tpipe, tres, _ = torch_run
    assert tres.odometry_poses.shape == jres.odometry_poses.shape == (N_FRAMES, 4, 4)
    for a, b in zip(tres.odometry_poses, jres.odometry_poses):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.01
        assert _rot_err(a, b) < 1e-3
    np.testing.assert_array_equal(tres.keyframe_frame_indices, jres.keyframe_frame_indices)
    np.testing.assert_allclose(tres.keyframe_poses, jres.keyframe_poses, atol=0.01)
    j_frames = [r for r in jpipe.metrics_writer.records if "frame" in r and "event" not in r]
    t_frames = [r for r in tpipe.metrics_writer.records if "frame" in r and "event" not in r]
    for key in ("iterations", "is_keyframe", "converged"):
        assert [r[key] for r in t_frames] == [r[key] for r in j_frames], key
    assert all(r["converged"] for r in t_frames)
    assert set(tres.metrics) == {"prefilter", "register", "backend"}
    # Both back ends hold the same keyframe clouds.
    for k in range(jpipe.back.n_keyframes):
        np.testing.assert_array_equal(tpipe.back._cloud(k).shape, jpipe.back._cloud(k).shape)


def test_lagged_output_semantics(torch_run):
    """process_scan returns the PREVIOUS frame's record (frame 0, the bootstrap, is
    consumed at once); result() drains the frame still in flight."""
    _, res, outs = torch_run
    assert res.odometry_poses.shape[0] == N_FRAMES
    assert res.keyframe_frame_indices[0] == 0
    assert outs[0]["is_keyframe"] and outs[1]["is_keyframe"]  # both describe frame 0
    np.testing.assert_array_equal(outs[0]["pose"], np.eye(4, dtype=np.float32))
    for t in range(1, N_FRAMES):
        np.testing.assert_array_equal(outs[t]["pose"], res.odometry_poses[t - 1])


def test_map_export(torch_run, tmp_path):
    pipe, _, _ = torch_run
    path = str(tmp_path / "map.pcd")
    assert pipe.save_map(path, resolution=0.5)
    from lidar_graph_slam_tpu_torch.io.pcd import read_pcd

    pts = read_pcd(path)
    assert pts.shape[0] > 100 and np.isfinite(pts).all() and np.abs(pts).max() < 200.0


def test_unported_modes_raise(course, cfg):
    """The modes that raised before their slice was ported now construct and run on the
    CPU: the classic driver (`fused_frontend=False`), and the fused front end with the
    GICP and ICP matchers. One intra-op thread: GICP's many small ops thrash an OpenMP
    pool per core when the suite runs its files in parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for overrides in (["fused_frontend=False"],
                          ["scan_matcher.registration_method=GICP"],
                          ["scan_matcher.registration_method=ICP"]):
            tc = tcfg.apply_cli_overrides(_torch_config(cfg), overrides)
            pipe = TorchPipeline(tc, device="cpu")
            assert pipe.fused == tc.fused_frontend
            res = pipe.run(course[:3])
            assert res.odometry_poses.shape == (3, 4, 4), overrides
            assert np.isfinite(res.odometry_poses).all()
            frames = [r for r in pipe.metrics_writer.records
                      if "frame" in r and "event" not in r]
            assert [r["converged"] for r in frames] == [True] * 3, overrides
    finally:
        torch.set_num_threads(threads)


def test_loop_closure_constructs_and_runs(course, cfg):
    """Loop closure on (the default) with the asynchronous back end: the pipeline runs,
    and the result carries the back end's loop log (this 5-frame course is too short
    for the 100 m gate, so no attempt is made)."""
    pipe = TorchPipeline(_torch_config(replace(cfg, enable_loop_closure=True)), device="cpu")
    assert pipe.back.async_enabled
    res = pipe.run(course)
    assert res.odometry_poses.shape == (N_FRAMES, 4, 4)
    assert res.loop_log is pipe.back.loop_log and res.num_loop_closures == 0
    assert pipe.back._pending_verify is None and pipe.back._solve_thread is None


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "lidar_graph_slam_tpu_torch.pipeline.cli", "--frames", "3",
           "--device", "cpu", "--no-loop-closure", "--output", str(out), "--progress-every", "0",
           "--set", "prefilter.leaf_size=0.3", "--set", "prefilter.mean_k=10",
           "--set", "capacity.raw_points=16384", "--set", "capacity.filtered_points=4096",
           "--set", "capacity.voxel_capacity=32768"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads((out / "metrics.json").read_text())
    assert summary["frames"] == 3 and summary["keyframes"] >= 1 and summary["device"] == "cpu"
    assert summary["ate_odometry_m"] < 0.5
    for name in ("odometry_tum.txt", "odometry_kitti.txt", "keyframes_tum.txt", "map.pcd"):
        assert (out / name).exists(), name
    assert summary["fused_frontend"] is True and summary["registration_method"] == "NDT"
    # The classic driver with the GICP front end and verifier, chosen by --set.
    classic = tmp_path / "classic"
    args = [a if a != str(out) else str(classic) for a in cmd]
    proc = subprocess.run(args + ["--set", "fused_frontend=false",
                                  "--set", "scan_matcher.registration_method=GICP",
                                  "--set", "graph_slam.registration_method=GICP"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads((classic / "metrics.json").read_text())
    assert summary["frames"] == 3 and summary["fused_frontend"] is False
    assert summary["registration_method"] == summary["loop_verifier"] == "GICP"
    assert summary["ate_odometry_m"] < 0.5
    # The default run has loop closure on and reports it.
    loops_on = tmp_path / "loops_on"
    default = [a for a in cmd if a != "--no-loop-closure"]
    default[default.index(str(out))] = str(loops_on)
    proc = subprocess.run(default, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads((loops_on / "metrics.json").read_text())
    assert summary["frames"] == 3 and summary["loop_closures"] == 0


ENTRY_POINTS = {
    "SlamPipeline": lambda c: TorchPipeline(c),
    "GraphBasedSLAM": lambda c: GraphBasedSLAM(c.graph_slam, c.capacity),
    "make_fused_frontend": lambda c: make_fused_frontend(c.scan_matcher, c.prefilter,
                                                         c.capacity),
    "cli": lambda c: cli.main(["--frames", "1", "--no-loop-closure"]),
    "SlamPipeline-cuda": lambda c: TorchPipeline(c, device="cuda"),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path, cfg, entry):
    """Without CUDA, an entry point given no device (the CLI: no --device) raises a clear
    error instead of falling back to the CPU; named "cpu", it builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    tc = _torch_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ENTRY_POINTS[entry](tc)
    if entry == "SlamPipeline":
        assert TorchPipeline(tc, device="cpu").device.type == "cpu"
    elif entry == "GraphBasedSLAM":
        assert GraphBasedSLAM(tc.graph_slam, tc.capacity, device="cpu").device.type == "cpu"
    elif entry == "make_fused_frontend":
        init_state, _, aux = make_fused_frontend(tc.scan_matcher, tc.prefilter, tc.capacity,
                                                 device="cpu")
        assert init_state().pose.device.type == aux["init_ring"]().clouds.device.type == "cpu"


def test_port_imports_no_jax():
    """Every module of the port (the CLI included) imports without jax or flax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lidar_graph_slam_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'lidar_graph_slam_tpu_torch.pipeline.cli' in names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'lidar_graph_slam_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 20
