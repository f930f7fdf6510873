"""The classic driver's three programs on fixed buffers (`odometry/scan_matcher.py:
ScanMatcher`'s register and insert programs, `pipeline/runner.py`'s prefilter program, run
by `utils/capture.py:Program`), on the CPU, where each program runs its body on the same
fixed buffers the card's CUDA graphs read and write.

  (a) `ScanMatcher` with NDT, ICP and GICP over a course whose keyframes wrap its
      3-slot ring: its ring, target, input and frame clouds, inputs row and output row
      keep their storage (one `data_ptr` each) from construction to the last frame, and
      every frame equals the JAX package's `ScanMatcher`.
  (b) The classic pipeline with a static extrinsic and gyro samples against the JAX
      package's classic pipeline, and its programs' buffers kept as in (a).
  (c) A classic checkpoint cut mid-course, loaded into the fixed ring and target, against
      the uninterrupted run: the same keyframe schedule, every pose to 1e-4 (the largest
      difference printed), and the resumed matcher's programs reading its own buffers.
  (d) The programs on a stand-in card (`tests/test_torch_capture.py:fake_card`): three
      captures (prefilter, register, insert), then replays only; a failed capture raises
      and the body runs no more after it.
  (e) `prefilter.use_random_sampling`: the draws made once are a fresh seed-0
      generator's, so a scan's sample does not depend on the scans before it.

Tolerances: `tests/test_torch_classic.py`'s — `ScanMatcher` per frame, the pose to atol
1e-4 (GICP's fifth and sixth frames 5e-3: that module's docstring), keyframe flags,
convergence and iterations equal; the pipeline, translation within 1 cm and rotation within
1 mrad a frame, keyframe flags and indices equal. The checkpoint, `tests/
test_torch_checkpoint.py`'s classic 1e-4 with the same schedule.
"""

import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.core import config as jcfg
from lidar_graph_slam_tpu.core.pointcloud import PointCloud as JCloud
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.odometry.scan_matcher import ScanMatcher as JMatcher
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JaxPipeline
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud as TCloud
from lidar_graph_slam_tpu_torch.filters import prefilter as tpf
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import ScanMatcher as TMatcher
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline as TorchPipeline
from lidar_graph_slam_tpu_torch.utils import capture
from lidar_graph_slam_tpu_torch.utils import checkpoint as tckpt
from tests.test_pipeline import small_config
from tests.test_torch_capture import _FakeStream, fake_card  # noqa: F401 (a fixture)

CAP = 4096
WINDOW = 3
METHODS = ("NDT", "ICP", "GICP")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module (GICP's covariances are ~800 small ops,
    and the suite runs its files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg, cls):
    """The same config in the port's (copied) dataclasses."""
    return tcfg._update_dataclass(cls(), dataclasses.asdict(cfg))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for item in x for t in _leaves(item)]
    return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]


def _buffers(m: TMatcher) -> list:
    """Every fixed buffer of a matcher's programs."""
    return (_leaves(m.ring) + _leaves(m.target) + _leaves(m.cloud_in) + _leaves(m.cloud)
            + [m.frame_in, m.row, m.kf_slot, m.kf_pose])


def _ptrs(m: TMatcher) -> list:
    return [t.data_ptr() for t in _buffers(m)]


def _held_by_programs(m: TMatcher) -> bool:
    """The programs' bodies hold the matcher's own buffers (nothing was rebound)."""
    held = [id(a) for p in m.programs.values() for a in p.body.args]
    return all(id(b) in held for b in (m.ring, m.target, m.cloud_in, m.cloud, m.row))


# -- (a) ScanMatcher across the ring's wrap ------------------------------------------------

@pytest.fixture(scope="module")
def course():
    """`tests/test_torch_classic.py`'s course (seed 0, 4,096 points, ~1.9 m a frame), 7
    frames: every frame a keyframe, so the 3-slot ring wraps twice."""
    seq = SyntheticSequence(n_frames=7, seed=0, max_points=CAP, laps=0.12 * 6 / 14)
    return [s for s, _ in seq]


@pytest.mark.parametrize("method", METHODS)
def test_scan_matcher_keeps_its_buffers_and_matches_reference(course, method):
    jc = jcfg.ScanMatcherConfig(registration_method=method, max_scan_accumulate_num=WINDOW)
    jm = JMatcher(jc, scan_capacity=CAP, map_voxel_capacity=32768)
    tm = TMatcher(_port(jc, tcfg.ScanMatcherConfig), scan_capacity=CAP,
                  map_voxel_capacity=32768, device="cpu")
    ptrs = _ptrs(tm)
    for f, scan in enumerate(course):
        j = jm.process(JCloud.from_array(scan, capacity=CAP))
        t = tm.process(TCloud.from_array(scan, capacity=CAP))
        atol = 5e-3 if method == "GICP" and f >= 4 else 1e-4
        np.testing.assert_allclose(t["pose"], j["pose"], atol=atol, err_msg=f"frame {f}")
        for key in ("is_keyframe", "converged", "iterations"):
            assert t[key] == j[key], (f, key)
        assert _ptrs(tm) == ptrs, f
    assert tm.n_keyframes == jm.n_keyframes > 2 * WINDOW
    assert bool(tm.ring.used.all()) and _held_by_programs(tm)
    np.testing.assert_array_equal(tm.ring.masks.numpy(), np.asarray(jm.ring.masks))
    np.testing.assert_allclose(tm.ring.poses.numpy(), np.asarray(jm.ring.poses), atol=1e-2)
    for tk, jk in zip(tm.keyframe_log, jm.keyframe_log):
        assert (tk["frame_index"], tk["id"]) == (jk["frame_index"], jk["id"])
        np.testing.assert_array_equal(tk["cloud_mask"], np.asarray(jk["cloud_mask"]))


# -- (b) the classic pipeline with an extrinsic and gyro samples -----------------------------

N_FRAMES = 5


@pytest.fixture(scope="module")
def pipeline_course():
    """`tests/test_torch_classic.py`'s 5-frame pipeline course."""
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * N_FRAMES / 90)
    return [s for s, _ in seq]


def _rot_err(A, B):
    chord = np.linalg.norm(A[:3, :3].astype(np.float64) - B[:3, :3].astype(np.float64))
    return float(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))


def test_classic_pipeline_with_extrinsic_and_imu_matches_reference(pipeline_course):
    cfg = replace(small_config(), fused_frontend=False, enable_loop_closure=False)
    cfg = replace(cfg, scan_matcher=replace(
        cfg.scan_matcher, max_scan_accumulate_num=WINDOW,
        extrinsic_xyzrpy=(0.1, -0.05, 0.2, 0.0, 0.0, 0.05)))
    jpipe = JaxPipeline(cfg)
    tpipe = TorchPipeline(_port(cfg, tcfg.PipelineConfig), device="cpu")
    ptrs = _ptrs(tpipe.front) + [tpipe._raw.points.data_ptr(), tpipe._raw.mask.data_ptr()]
    for i, s in enumerate(pipeline_course):
        for t in (0.1 * i - 0.05, 0.1 * i):  # a slow yaw rate, two samples a frame
            jpipe.add_imu(t, [0.0, 0.0, 0.02])
            tpipe.add_imu(t, [0.0, 0.0, 0.02])
        jo = jpipe.process_scan(s, stamp=0.1 * i)
        to = tpipe.process_scan(s, stamp=0.1 * i)
        assert (to["is_keyframe"], to["converged"], to["iterations"]) == (
            jo["is_keyframe"], jo["converged"], jo["iterations"]), i
    jres, tres = jpipe.result(), tpipe.result()
    for a, b in zip(tres.odometry_poses, jres.odometry_poses):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.01
        assert _rot_err(a, b) < 1e-3
    np.testing.assert_array_equal(tres.keyframe_frame_indices, jres.keyframe_frame_indices)
    assert len(tres.keyframe_frame_indices) >= 3
    assert ptrs == _ptrs(tpipe.front) + [tpipe._raw.points.data_ptr(),
                                         tpipe._raw.mask.data_ptr()]
    prefilter_args = tpipe.prefilter_program.body.args
    assert prefilter_args[1] is tpipe._raw and prefilter_args[2] is tpipe.front.cloud_in
    assert set(tpipe.programs) == {"prefilter", "register", "insert"}


# -- (c) a classic checkpoint into the fixed buffers -----------------------------------------

def _checkpoint_scans(n):
    """`tests/test_torch_checkpoint.py`'s course (seed 6, 4,096 points, 24 frames over
    0.25 laps) at its motion per frame."""
    seq = SyntheticSequence(n_frames=n, seed=6, max_points=4096, laps=0.25 * n / 24)
    return [s for s, _ in seq]


def test_classic_checkpoint_loads_into_the_fixed_buffers(tmp_path):
    cfg = replace(small_config(), fused_frontend=False, enable_loop_closure=False)
    cfg = _port(replace(cfg, scan_matcher=replace(cfg.scan_matcher,
                                                  max_scan_accumulate_num=WINDOW)),
                tcfg.PipelineConfig)
    scans, cut = _checkpoint_scans(10), 6
    whole = TorchPipeline(cfg, device="cpu")
    for s in scans:
        whole.process_scan(s)
    res_a = whole.result()

    first = TorchPipeline(cfg, device="cpu")
    for s in scans[:cut]:
        first.process_scan(s)
    assert first.front.n_keyframes > WINDOW  # the saved ring has wrapped
    path = str(tmp_path / "classic.npz")
    tckpt.save_pipeline(first, path)
    resumed = tckpt.load_pipeline(path, device="cpu")
    front = resumed.front
    assert _held_by_programs(front) and resumed.prefilter_program.body.args[2] is front.cloud_in
    ptrs = _ptrs(front)
    for s in scans[cut:]:
        resumed.process_scan(s)
    res_c = resumed.result()
    assert _ptrs(front) == ptrs
    np.testing.assert_array_equal(res_c.keyframe_frame_indices, res_a.keyframe_frame_indices)
    diff = float(np.abs(res_c.odometry_poses - res_a.odometry_poses).max())
    kf_diff = float(np.abs(res_c.keyframe_poses - res_a.keyframe_poses).max())
    print(f"classic resume: largest odometry difference {diff}, keyframes {kf_diff}")
    assert diff <= 1e-4 and kf_diff <= 1e-4


# -- (d) the programs on a stand-in card -------------------------------------------------------

def _on_fake_card(pipe):
    """`pipe`'s three programs rebuilt as CUDA programs on the stand-in card (their bodies
    still on the CPU's fixed buffers), each body counting its runs; returns the counts."""
    runs = {}

    def counted(name, body):
        def run():
            runs[name] = runs.get(name, 0) + 1
            body()
        return run

    def rebuilt(name, program):
        return capture.Program(counted(name, program.body), "cuda", stream=_FakeStream())

    pipe.prefilter_program = rebuilt("prefilter", pipe.prefilter_program)
    pipe.front.register_program = rebuilt("register", pipe.front.register_program)
    pipe.front.insert_program = rebuilt("insert", pipe.front.insert_program)
    return runs


def test_classic_programs_capture_once_then_replay(fake_card, pipeline_course):
    cfg = replace(small_config(), fused_frontend=False, enable_loop_closure=False)
    pipe = TorchPipeline(_port(cfg, tcfg.PipelineConfig), device="cpu")
    runs = _on_fake_card(pipe)
    for s in pipeline_course[:4]:
        pipe.process_scan(s)
    pipe.front.insert_program()  # a keyframe's insert after its capture
    # The warm-up and the stand-in capture ran each body; a replay runs none.
    assert runs == {"prefilter": 2, "register": 2, "insert": 2}
    log = pipe.program_log()
    assert [log[k]["captures"] for k in ("prefilter", "register", "insert")] == [1, 1, 1]
    assert log["prefilter"]["replays"] == 3 and log["register"]["replays"] == 2
    assert log["insert"]["replays"] >= 1
    assert fake_card["modes"] == ["thread_local"] * 3
    assert set(log["register"]["first_call_ms"]) == {"warm_up", "drain", "collect", "capture"}


def test_failed_classic_capture_raises(fake_card, pipeline_course):
    fake_card["fail"] = True
    cfg = replace(small_config(), fused_frontend=False, enable_loop_closure=False)
    pipe = TorchPipeline(_port(cfg, tcfg.PipelineConfig), device="cpu")
    runs = _on_fake_card(pipe)
    with pytest.raises(RuntimeError, match="capturing"):
        pipe.process_scan(pipeline_course[0])
    assert runs == {"prefilter": 2} and not pipe.prefilter_program.captured
    assert pipe.front.n_frames == 0 and not pipe.odometry_poses


# -- (e) the random sample's draws -------------------------------------------------------------

def test_random_sample_draws_once_as_a_fresh_generator(pipeline_course):
    cfg = tcfg.PrefilterConfig(leaf_size=0.3, mean_k=10, use_random_sampling=True,
                               random_sample_num=1500)
    clouds = [TCloud.from_array(s, capacity=8192) for s in pipeline_course[:2]]
    warm = tpf.make_prefilter(cfg, capacity_out=4096, voxel_capacity=8192)
    warm(clouds[0].points, clouds[0].mask)
    again = warm(clouds[1].points, clouds[1].mask)
    fresh = tpf.make_prefilter(cfg, capacity_out=4096, voxel_capacity=8192)
    first = fresh(clouds[1].points, clouds[1].mask)
    assert torch.equal(again.points, first.points) and torch.equal(again.mask, first.mask)
    assert int(first.mask.sum()) == 1500
    # The draws' sample is the per-scan generator's (`random_sample_mask`) on any mask.
    scores = torch.rand(8192, generator=torch.Generator().manual_seed(0))
    mask = torch.rand(8192, generator=torch.Generator().manual_seed(1)) < 0.5
    want = tpf.random_sample_mask(torch.zeros(8192, 3), mask, 1500,
                                  torch.Generator().manual_seed(0))
    assert torch.equal(tpf.sample_by_scores(mask, 1500, scores), want)
