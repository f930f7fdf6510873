"""PyTorch port: checkpoint / resume (`utils/checkpoint.py`), alone and across the two
packages.

Tolerances (the JAX package's own, `tests/test_checkpoint.py`): with the classic driver a
resumed run equals the continuous one to atol 1e-4 with the same keyframe schedule; with
the fused driver to atol 5e-2 with the same schedule (the one-frame submap lag collapses at
the checkpoint: `flush()` drains the frame in flight and the target is rebuilt from the
ring). Across packages, a checkpoint saved by one package and continued by the other
follows the saving package's own continuation to atol 1e-4 in the poses (the NDT
pipelines' parity) with the same keyframe schedule; the file has the same keys, shapes and
dtypes whichever package wrote it.
"""

import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JaxPipeline
from lidar_graph_slam_tpu.utils import checkpoint as jckpt
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline as TorchPipeline
from lidar_graph_slam_tpu_torch.utils import checkpoint as tckpt
from tests.test_pipeline import small_config


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it: an OpenMP
    pool per core in each of the suite's parallel test processes oversubscribes the cores
    so far that these tests slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_config(cfg) -> tcfg.PipelineConfig:
    return tcfg._update_dataclass(tcfg.PipelineConfig(), dataclasses.asdict(cfg))


def _scans(n):
    """`tests/test_checkpoint.py`'s course (24 frames over 0.25 laps) at its motion per
    frame, for any number of frames."""
    seq = SyntheticSequence(n_frames=n, seed=6, max_points=4096, laps=0.25 * n / 24)
    return [s for s, _ in seq]


def _resume_run(cfg, n, tmp_path):
    scans = _scans(n)
    pipe_a = TorchPipeline(cfg, device="cpu")
    for s in scans:
        pipe_a.process_scan(s)
    res_a = pipe_a.result()

    pipe_b = TorchPipeline(cfg, device="cpu")
    for s in scans[: n // 2]:
        pipe_b.process_scan(s)
    ckpt = str(tmp_path / "state.npz")
    tckpt.save_pipeline(pipe_b, ckpt)
    pipe_c = tckpt.load_pipeline(ckpt, device="cpu")
    assert pipe_c.device.type == "cpu" and pipe_c.fused == cfg.fused_frontend
    assert len(pipe_c.odometry_poses) == n // 2
    for s in scans[n // 2:]:
        pipe_c.process_scan(s)
    return res_a, pipe_c.result()


FRAMES = [12, pytest.param(24, marks=pytest.mark.slow)]


@pytest.mark.parametrize("n", FRAMES)
def test_checkpoint_exact_resume(tmp_path, n):
    cfg = replace(_torch_config(small_config()), fused_frontend=False)
    res_a, res_c = _resume_run(cfg, n, tmp_path)
    assert res_c.odometry_poses.shape == res_a.odometry_poses.shape == (n, 4, 4)
    np.testing.assert_allclose(res_c.odometry_poses, res_a.odometry_poses, atol=1e-4,
                               err_msg="resumed odometry diverged from the continuous run")
    assert res_c.keyframe_poses.shape == res_a.keyframe_poses.shape
    np.testing.assert_allclose(res_c.keyframe_poses, res_a.keyframe_poses, atol=1e-4)
    np.testing.assert_array_equal(res_c.keyframe_frame_indices, res_a.keyframe_frame_indices)
    assert len(res_a.keyframe_frame_indices) >= 3


@pytest.mark.parametrize("n", FRAMES)
def test_checkpoint_resume_fused(tmp_path, n):
    cfg = replace(_torch_config(small_config()), fused_frontend=True)
    res_a, res_c = _resume_run(cfg, n, tmp_path)
    assert res_c.odometry_poses.shape == res_a.odometry_poses.shape == (n, 4, 4)
    np.testing.assert_allclose(res_c.odometry_poses, res_a.odometry_poses, atol=5e-2)
    np.testing.assert_array_equal(res_c.keyframe_frame_indices, res_a.keyframe_frame_indices)
    np.testing.assert_allclose(res_c.keyframe_poses, res_a.keyframe_poses, atol=5e-2)


def test_checkpoint_preserves_config(tmp_path):
    """The config goes through JSON: tuples come back as tuples, overrides survive, and
    the classic front end's counters are restored."""
    cfg = tcfg.apply_cli_overrides(
        replace(_torch_config(small_config()), fused_frontend=False),
        ["scan_matcher.displacement=2.5", "prefilter.min_xyz=(-40.0, -41.0, -5.0)",
         "graph_slam.global_reg.hypotheses=256"])
    pipe = TorchPipeline(cfg, device="cpu")
    for s in _scans(6):
        pipe.process_scan(s)
    ckpt = str(tmp_path / "state.npz")
    tckpt.save_pipeline(pipe, ckpt)
    pipe2 = tckpt.load_pipeline(ckpt, device="cpu")
    assert pipe2.cfg == cfg
    assert pipe2.cfg.scan_matcher.displacement == 2.5
    assert pipe2.cfg.prefilter.min_xyz == (-40.0, -41.0, -5.0)
    assert isinstance(pipe2.cfg.graph_slam.odom_noise_var, tuple)
    assert pipe2.front.n_frames == 6 and pipe2.front.n_keyframes == pipe.front.n_keyframes
    assert pipe2.front.keyframe_log == [] and pipe2._kf_consumed == 0
    assert pipe2.back.n_keyframes == pipe.back.n_keyframes == len(pipe2.back.kf_clouds)
    for a, b in zip(pipe2.back.kf_clouds, pipe.back.kf_clouds):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pipe2.back.optimized_poses(), pipe.back.optimized_poses())
    g, g2 = pipe.back.graph, pipe2.back.graph
    for f in dataclasses.fields(g):
        a, b = getattr(g, f.name), getattr(g2, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_load_needs_a_card_unless_asked(tmp_path, monkeypatch):
    pipe = TorchPipeline(_torch_config(small_config()), device="cpu")
    pipe.process_scan(_scans(2)[0])
    ckpt = str(tmp_path / "state.npz")
    tckpt.save_pipeline(pipe, ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tckpt.load_pipeline(ckpt)
    assert tckpt.load_pipeline(ckpt, device="cpu").back.n_keyframes == 1


def test_save_drains_the_back_end_and_keeps_the_loop_log(tmp_path):
    """A verification still pending (its thread running) and lazy keyframe clouds are
    settled by `save_pipeline`; loop-log records with numpy values survive the file."""
    from tests.test_loop_verifiers import build_loop_backend
    from tests.test_torch_loop import _port_backend

    cfg = _torch_config(small_config())
    pipe = TorchPipeline(cfg, device="cpu")
    jb, _ = build_loop_backend("ICP")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe.back = _port_backend(jb, async_backend=True)
        pipe.back._pending_verify = pipe.back.begin_loop_attempt()
        assert "thread" in pipe.back._pending_verify
        ckpt = str(tmp_path / "state.npz")
        tckpt.save_pipeline(pipe, ckpt)
    finally:
        torch.set_num_threads(threads)
    back = pipe.back
    assert back._pending_verify is None and back._solve_thread is None and back.n_loops == 1
    z = np.load(ckpt)
    assert int(z["graph_num_loops"]) == 1 and bool(z["graph_loop_mask"][0])
    assert z["graph_loop_i"].dtype == np.int32 and z["graph_poses"].dtype == np.float32
    # The capacities travel with the config; the loaded back end solves from the mirrors.
    pipe2 = tckpt.load_pipeline(ckpt, device="cpu")
    b2 = pipe2.back
    assert b2.n_loops == 1 and b2.is_loop_closed and len(b2._host_loops) == 1
    rec, rec2 = back.loop_log[0], b2.loop_log[0]
    assert rec2["accepted"] and rec2["candidate"] == rec["candidate"]
    assert rec2["transform"].dtype == np.float32
    np.testing.assert_array_equal(rec2["transform"], rec["transform"])
    np.testing.assert_array_equal(b2.optimized_poses(), back.optimized_poses())
    b2._run_optimize()
    np.testing.assert_allclose(b2.optimized_poses(), back.optimized_poses(), atol=1e-5)
    # The reference reads the same file, loop log included.
    assert jckpt.load_pipeline(ckpt).back.n_loops == 1


N_CROSS, CUT = 10, 6
DRIVERS = [True, pytest.param(False, marks=pytest.mark.slow)]


def _file_layout(path):
    z = np.load(path)
    return {k: (z[k].shape, z[k].dtype) for k in z.files if k not in ("config_json", "loop_log")}


@pytest.mark.parametrize("fused", DRIVERS)
def test_checkpoint_crosses_between_the_packages(tmp_path, fused):
    """JAX saves at frame 6, the port loads and continues; the port saves at frame 6, the
    JAX package loads and continues. Each follows the saver's own continuation."""
    jcfg_ = replace(small_config(), fused_frontend=fused, enable_loop_closure=False)
    cfg = _torch_config(jcfg_)
    scans = _scans(N_CROSS)
    jp, tp = JaxPipeline(jcfg_), TorchPipeline(cfg, device="cpu")
    for s in scans[:CUT]:
        jp.process_scan(s)
        tp.process_scan(s)
    j_file, t_file = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jckpt.save_pipeline(jp, j_file)
    tckpt.save_pipeline(tp, t_file)
    # One format: the same keys, shapes and dtypes from either package.
    assert _file_layout(t_file) == _file_layout(j_file)

    from_jax = tckpt.load_pipeline(j_file, device="cpu")   # JAX -> port
    from_torch = jckpt.load_pipeline(t_file)                # port -> JAX
    assert from_jax.cfg == cfg and from_torch.cfg == jcfg_
    for s in scans[CUT:]:
        for p in (jp, tp, from_jax, from_torch):
            p.process_scan(s)
    res_j, res_t = jp.result(), tp.result()
    for res, saver in ((from_jax.result(), res_j), (from_torch.result(), res_t)):
        assert res.odometry_poses.shape == (N_CROSS, 4, 4)
        np.testing.assert_allclose(res.odometry_poses, saver.odometry_poses, atol=1e-4)
        np.testing.assert_array_equal(res.keyframe_frame_indices, saver.keyframe_frame_indices)
        np.testing.assert_allclose(res.keyframe_poses, saver.keyframe_poses, atol=1e-4)
