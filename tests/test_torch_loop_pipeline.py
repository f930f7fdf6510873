"""PyTorch port vs the JAX reference: the whole pipeline with loop closure on (the default
configuration, at the small capacities of `tests/test_pipeline.py`), with the
deterministic synchronous back end (`async_backend=False`) in both packages.

Tolerances: keyframe indices, loop-attempt (latest, candidate) pairs and accept
decisions exact; fitness to rtol 2e-2 (the fourth and fifth verifications of the
30-frame course read up to 0.6% apart between the port's own runs with 1, 2, 4 or 8 CPU
threads: the reduction order changes the last bits, and 25 frames of odometry and three
loop solves carry them into the verification's source cloud); keyframe poses to atol
2e-3 on the 30-frame course and 5e-3 on `course90` (a pose matrix's entries, so metres
for the translation: the fitness sets the loop factor's information, 1/fitness, so its
rounding moves the solved poses, and more so after five loops on a lap than after a
short course). A loop factor moves the poses that later keyframes chain onto, so a tiny
fitness difference next to the 0.3 gate could flip a decision and part the trajectories:
where a decision differs, the test requires the fitness to lie within the fitness
tolerance of the gate and compares only the attempts and keyframes before it; otherwise
it fails.
"""

import dataclasses
from dataclasses import replace

import numpy as np
import pytest

from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JaxPipeline
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline as TorchPipeline
from tests.test_pipeline import small_config
from tests import test_torch_loop

FITNESS_RTOL = 2e-2

one_intra_op_thread = test_torch_loop.one_intra_op_thread


def _torch_config(cfg) -> tcfg.PipelineConfig:
    return tcfg._update_dataclass(tcfg.PipelineConfig(), dataclasses.asdict(cfg))


def _loop_config(**graph_overrides):
    cfg = small_config()
    assert cfg.enable_loop_closure
    return replace(cfg, graph_slam=replace(cfg.graph_slam, async_backend=False,
                                           **graph_overrides))


def _run_both(scans, cfg):
    jpipe, tpipe = JaxPipeline(cfg), TorchPipeline(_torch_config(cfg), device="cpu")
    for s in scans:
        jpipe.process_scan(s)
        tpipe.process_scan(s)
    return jpipe, jpipe.result(), tpipe, tpipe.result()


def _assert_same_loop_decisions(jres, tres, gate):
    """Same keyframes and loop decisions; returns how many keyframes to compare."""
    np.testing.assert_array_equal(tres.keyframe_frame_indices, jres.keyframe_frame_indices)
    n_keyframes = len(jres.keyframe_frame_indices)
    for j, t in zip(jres.loop_log, tres.loop_log):
        assert (t["latest"], t["candidate"]) == (j["latest"], j["candidate"])
        if t["accepted"] != j["accepted"]:
            assert abs(j["fitness"] - gate) <= FITNESS_RTOL * gate, (j, t)
            return j["latest"]  # trajectories part here
        assert t["converged"] == j["converged"]
        np.testing.assert_allclose(t["fitness"], j["fitness"], rtol=FITNESS_RTOL)
    assert len(tres.loop_log) == len(jres.loop_log)
    assert tres.num_loop_closures == jres.num_loop_closures
    return n_keyframes


def test_closed_loop_course_matches_reference():
    """A 30-frame course at the per-frame motion of `course90` (2.3 m, 0.077 rad), with
    the accumulated-distance gate lowered to 12 m so candidates pass it within the
    course; the loop search runs every 5 frames."""
    seq = SyntheticSequence(n_frames=30, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 30 / 90)
    scans = [s for s, _ in seq]
    jpipe, jres, tpipe, tres = _run_both(scans, _loop_config(accumulate_distance_threshold=12.0))
    n = _assert_same_loop_decisions(jres, tres, tpipe.cfg.graph_slam.score_threshold)
    np.testing.assert_allclose(tres.keyframe_poses[:n], jres.keyframe_poses[:n], atol=2e-3)
    assert tres.num_loop_closures >= 1
    assert tres.num_loop_closures == sum(r["accepted"] for r in tres.loop_log)
    frames = [r for r in tpipe.metrics_writer.records if "frame" in r and "event" not in r]
    attempts = [r for r in tpipe.metrics_writer.records if r.get("event") == "loop_attempt"]
    assert len(attempts) == len(tres.loop_log)
    assert frames[-1]["loops_accepted"] == tres.num_loop_closures
    assert all(r["converged"] for r in frames)


@pytest.mark.slow
def test_course90_matches_reference(course90):
    """The 90-frame loop course of `tests/conftest.py` (1.1 laps) with the default gates:
    the lap closes in both packages with the same decisions."""
    scans, _ = course90
    jpipe, jres, tpipe, tres = _run_both(scans, _loop_config())
    n = _assert_same_loop_decisions(jres, tres, tpipe.cfg.graph_slam.score_threshold)
    np.testing.assert_allclose(tres.keyframe_poses[:n], jres.keyframe_poses[:n], atol=5e-3)
    assert tres.num_loop_closures >= 1
