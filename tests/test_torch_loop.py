"""PyTorch port vs the JAX reference: the graph back end — loop gates, verification,
loop factors, the solve, the concurrent back end, and map assembly.

Tolerances: loop detection and capacity refusals exact. `try_close_loop` on the
verifier fixture of `tests/test_loop_verifiers.py`, with the ICP, NDT and GICP
verifiers: the same candidate and accept decision, fitness to rtol 1e-4, the verifier's transform to atol 1e-4 and the optimized
poses to atol 1e-4. The port's asynchronous back end against its synchronous one, alone
and in the pipeline on a 30-frame closed-loop course: the same decisions and poses to
atol 1e-4 (the reference's own bound for that comparison). The FPFH+RANSAC initial guess
(`use_global_init`) draws its hypotheses from another generator than the reference, so it
is held to the reference test's own limits (`tests/test_loop_verifiers.py:90-108`): the
large-drift loop closes, the corrected pose lies within 0.3 m of truth, and the identity
guess misses the loop or reads a worse fitness.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.core.config import CapacityConfig as JCap
from lidar_graph_slam_tpu.core.config import GraphSlamConfig as JCfg
from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM as JBack
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.graph import slam as tslam
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM as TBack
from tests.test_loop_verifiers import build_loop_backend


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it. The back
    end runs torch ops in worker threads; an OpenMP pool of one thread per core for
    each of them, in each of the suite's parallel test processes, oversubscribes the
    cores so far that these tests slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(cfg):
    return tcfg._update_dataclass(tcfg.GraphSlamConfig(), dataclasses.asdict(cfg))


def _port_capacity(cap):
    return tcfg._update_dataclass(tcfg.CapacityConfig(), dataclasses.asdict(cap))


def _port_backend(jback, **overrides) -> TBack:
    """A port back end fed the keyframes the reference back end was fed."""
    cfg = dataclasses.replace(_port_config(jback.cfg), **overrides)
    back = TBack(cfg, _port_capacity(jback.capacity), device="cpu")
    for k in range(jback.n_keyframes):
        cloud = jback._cloud(k)
        back.add_keyframe({"pose": jback.kf_front_poses[k], "cloud": cloud,
                           "cloud_mask": np.ones(cloud.shape[0], bool),
                           "accum_distance": jback.kf_accum_dist[k],
                           "stamp": jback.kf_stamps[k]})
    return back


def _keyframe(x, y, accum, stamp=None):
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3], pose[1, 3] = x, y
    return {"pose": pose, "cloud": np.zeros((4, 3), np.float32),
            "cloud_mask": np.ones(4, bool), "accum_distance": accum, "stamp": stamp}


def _line(n, spacing=1.0, dt=None):
    return [_keyframe(k * spacing, 0.0, (k + 1) * spacing, None if dt is None else k * dt)
            for k in range(n)]


# The scenarios of `tests/test_loop_gates.py`: (config overrides, keyframes).
GATE_CASES = {
    "no_accum_gap": (dict(accumulate_distance_threshold=100.0), _line(30)),
    "far_away": (dict(accumulate_distance_threshold=100.0,
                      search_for_candidate_threshold=15.0), _line(120)),
    "revisit": (dict(accumulate_distance_threshold=100.0, search_for_candidate_threshold=15.0),
                _line(110) + [_keyframe(2.0, 0.0, 300.0)]),
    "radius": (dict(accumulate_distance_threshold=100.0, search_for_candidate_threshold=5.0,
                    search_radius=50.0), _line(110) + [_keyframe(0.0, 30.0, 300.0)]),
    "accum": (dict(accumulate_distance_threshold=100.0, search_for_candidate_threshold=5.0,
                   search_radius=10.0), _line(110) + [_keyframe(0.0, 80.0, 300.0)]),
    "temporal_old": (dict(accumulate_distance_threshold=100.0, search_radius=50.0),
                     _line(110, dt=10.0) + [_keyframe(2.0, 0.0, 300.0, 1100.0)]),
    "temporal_recent": (dict(accumulate_distance_threshold=100.0, search_radius=50.0),
                        _line(110, dt=0.1) + [_keyframe(2.0, 0.0, 300.0, 11.1)]),
    "temporal_off": (dict(accumulate_distance_threshold=100.0, search_radius=50.0,
                          temporal_gate_sec=0.0),
                     _line(110, dt=0.1) + [_keyframe(2.0, 0.0, 300.0, 11.1)]),
    "topk": (dict(accumulate_distance_threshold=20.0, search_for_candidate_threshold=60.0,
                  search_key_frame_num=5), _line(60) + [_keyframe(30.0, 1.0, 300.0)]),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_loop_gates_match_reference(case):
    overrides, keyframes = GATE_CASES[case]
    cap = dict(max_keyframes=128, max_loop_factors=8, keyframe_points=256,
               loop_submap_points=1024, voxel_capacity=1024)
    jb = JBack(JCfg(**overrides), JCap(**cap))
    tb = TBack(tcfg.GraphSlamConfig(**overrides), tcfg.CapacityConfig(**cap), device="cpu")
    for kf in keyframes:
        jb.add_keyframe(kf)
        tb.add_keyframe(kf)
    for mode in ("inline", "radius", "accum"):
        assert tb.detect_loop(mode=mode) == jb.detect_loop(mode=mode), mode
        assert tb.detect_loop_topk(3, mode=mode) == jb.detect_loop_topk(3, mode=mode), mode
    np.testing.assert_array_equal(tb.optimized_poses(), jb.optimized_poses())
    with pytest.raises(ValueError):
        tb.detect_loop(mode="kdtree")


def test_capacity_refusals_match_reference():
    """Keyframe inserts past `max_keyframes` and loop attempts at `max_loop_factors`
    are refused and flagged; the device graph agrees."""
    cap = dict(max_keyframes=4, max_loop_factors=2, keyframe_points=256,
               loop_submap_points=1024, voxel_capacity=1024)
    jb, tb = JBack(JCfg(), JCap(**cap)), TBack(tcfg.GraphSlamConfig(), tcfg.CapacityConfig(**cap), device="cpu")
    for kf in _line(6):
        jb.add_keyframe(kf)
        tb.add_keyframe(kf)
    assert tb.n_keyframes == jb.n_keyframes == 4 and tb.keyframe_overflow and jb.keyframe_overflow
    assert int(tb.graph.num_poses) == int(np.asarray(jb.graph.num_poses)) == 4
    np.testing.assert_array_equal(tb.graph.poses.numpy(), np.asarray(jb.graph.poses))

    cap["max_keyframes"], cap["max_loop_factors"] = 16, 0
    jb, tb = JBack(JCfg(), JCap(**cap)), TBack(tcfg.GraphSlamConfig(), tcfg.CapacityConfig(**cap), device="cpu")
    for kf in _line(3):
        jb.add_keyframe(kf)
        tb.add_keyframe(kf)
    assert not tb.try_close_loop() and not jb.try_close_loop()
    assert tb.loop_overflow and jb.loop_overflow
    assert tb.loop_log == jb.loop_log


def test_backend_validates_its_configuration():
    """An unknown verifier is a ValueError, as in the reference; the global initial
    guess constructs."""
    with pytest.raises(ValueError):
        TBack(tcfg.GraphSlamConfig(registration_method="VGICP"), tcfg.CapacityConfig(),
              device="cpu")
    assert TBack(tcfg.GraphSlamConfig(registration_method="gicp"), tcfg.CapacityConfig(),
                 device="cpu").method == "GICP"
    back = TBack(tcfg.GraphSlamConfig(use_global_init=True), tcfg.CapacityConfig(),
                 device="cpu")
    assert back.cfg.use_global_init and back.cfg.global_reg.hypotheses == 2048
    assert TBack(tcfg.GraphSlamConfig(registration_method="ndt"),
                 tcfg.CapacityConfig(), device="cpu").method == "NDT"


@pytest.fixture(scope="module")
def verifier_backends():
    """The reference's `build_loop_backend(method)` before and after `try_close_loop`,
    for ICP, NDT and GICP: {method: (reference back end after the closure, its optimized
    poses before it, a port back end fed the same keyframes)}."""
    out = {}
    for method in ("ICP", "NDT", "GICP"):
        jb, _ = build_loop_backend(method)
        before = jb.optimized_poses()
        fresh = _port_backend(jb, async_backend=False)  # fed before the closure
        assert jb.try_close_loop(), jb.loop_log
        out[method] = (jb, before, fresh)
    return out


@pytest.mark.parametrize("method", ["ICP", "NDT", "GICP"])
def test_try_close_loop_matches_reference(verifier_backends, method):
    jb, before, tb = verifier_backends[method]
    np.testing.assert_array_equal(tb.optimized_poses(), before)
    assert tb.try_close_loop()
    assert len(tb.loop_log) == len(jb.loop_log) == 1
    rt, rj = tb.loop_log[0], jb.loop_log[0]
    for key in ("latest", "candidate", "converged", "accepted"):
        assert rt[key] == rj[key], key
    assert rt["accepted"] and rt["fitness"] < tb.cfg.score_threshold
    np.testing.assert_allclose(rt["fitness"], rj["fitness"], rtol=1e-4)
    np.testing.assert_allclose(rt["transform"], rj["transform"], atol=1e-4)
    np.testing.assert_allclose(tb.optimized_poses(), jb.optimized_poses(), atol=1e-4)
    assert tb.n_loops == jb.n_loops == 1 and tb.is_loop_closed
    # The device graph holds the factor and the solved poses.
    g = tb.graph
    assert int(g.num_loops) == 1 and bool(g.loop_mask[0])
    np.testing.assert_allclose(g.poses[: tb.n_keyframes].numpy(), tb.optimized_poses())
    np.testing.assert_allclose(g.loop_meas[0].numpy(), np.asarray(jb.graph.loop_meas[0]),
                               atol=1e-4)


def test_async_backend_matches_sync(verifier_backends):
    """The port's concurrent back end (verification in a worker thread, consumed after
    the lag, then the threaded solve) accepts the same loop and lands on the same poses
    as its synchronous `try_close_loop`; the package's matmul pins hold in the thread."""
    jb, _, _ = verifier_backends["ICP"]
    sync = _port_backend(build_loop_backend("ICP")[0], async_backend=False)
    back = _port_backend(build_loop_backend("ICP")[0], async_backend=True)
    assert sync.try_close_loop()

    seen = {}
    verify_one = back._verify_one

    def spy(*args):
        seen["thread"] = threading.current_thread().name
        seen["precision"] = torch.get_float32_matmul_precision()
        seen["tf32"] = torch.backends.cuda.matmul.allow_tf32
        return verify_one(*args)

    back._verify_one = spy
    back._pending_verify = back.begin_loop_attempt()
    assert back._pending_verify is not None and "thread" in back._pending_verify
    for _ in range(back.cfg.loop_verify_lag_frames + 1):
        assert back._pending_verify is not None  # consumed only after the lag
        back.poll_async()
    assert back._pending_verify is None and back._solve_thread is not None
    back.finish_async()
    assert seen == {"thread": "loop-verify", "precision": "highest", "tf32": False}
    assert [(r["candidate"], r["accepted"]) for r in back.loop_log] == \
           [(r["candidate"], r["accepted"]) for r in sync.loop_log] == \
           [(r["candidate"], r["accepted"]) for r in jb.loop_log]
    np.testing.assert_allclose(back.optimized_poses(), sync.optimized_poses(), atol=1e-4)
    assert back.is_loop_closed and back._solve_thread is None


def test_verify_thread_error_surfaces():
    """An exception inside the verification thread is raised where the attempt is
    consumed, with its own message, and the back end can go on."""
    back = _port_backend(build_loop_backend("NDT")[0], async_backend=True)

    def boom(*args):
        raise RuntimeError("verifier exploded")

    good, back._verify_one = back._verify_one, boom
    pending = back.begin_loop_attempt()
    with pytest.raises(RuntimeError, match="verifier exploded"):
        back._consume_verify(pending)
    assert back.loop_log == [] and back.n_loops == 0
    back._verify_one = good
    assert back.try_close_loop()


def test_solve_thread_error_surfaces(monkeypatch):
    back = _port_backend(build_loop_backend("NDT")[0], async_backend=True)

    def boom(view, device_lm, tail_iterations=6):
        raise RuntimeError("solver exploded")

    monkeypatch.setattr(tslam.solver, "escalate_f64", boom)
    back._start_solve_async()
    with pytest.raises(RuntimeError, match="solver exploded"):
        back._finish_solve()
    assert back._solve_thread is None and back._solve_error is None


def test_assemble_map_follows_the_solve(verifier_backends):
    """The map cache is keyed by loops and solve epoch too: a loop closure moves the
    keyframes, and the next export must show it (a key of keyframe count and resolution
    alone returned the map from before the closure)."""
    jb, _, _ = verifier_backends["NDT"]
    back = _port_backend(jb, async_backend=False)
    before = back.assemble_map(0.0)
    assert back.try_close_loop()
    after = back.assemble_map(0.0)
    poses = back.optimized_poses()
    expect = np.concatenate([back._cloud(k) @ poses[k][:3, :3].T + poses[k][:3, 3]
                             for k in range(back.n_keyframes)])
    np.testing.assert_array_equal(after, expect)
    assert np.abs(after - before).max() > 0.05
    np.testing.assert_allclose(after, jb.assemble_map(0.0), atol=1e-2)


def test_submap_subsamples_to_budget_matches_reference():
    """Uniform-stride subsampling of an over-budget loop submap, as in the reference."""
    cap = dict(max_keyframes=64, max_loop_factors=8, keyframe_points=4096)
    jb = JBack(JCfg(), JCap(**cap))
    tb = TBack(tcfg.GraphSlamConfig(), tcfg.CapacityConfig(**cap), device="cpu")
    rng = np.random.default_rng(0)
    for k in range(21):
        kf = _keyframe(2.0 * k, 0.0, 2.0 * k)
        kf["cloud"] = rng.normal(scale=0.5, size=(4000, 3)).astype(np.float32)
        kf["cloud_mask"] = np.ones(4000, bool)
        jb.add_keyframe(kf)
        tb.add_keyframe(kf)
    for budget in (20000, 10**9):
        np.testing.assert_array_equal(tb._assemble_submap(10, 10, max_points=budget),
                                      jb._assemble_submap(10, 10, max_points=budget))


def test_async_pipeline_matches_sync():
    """The port's pipeline on the 30-frame closed-loop course of
    `tests/test_torch_loop_pipeline.py`, with the asynchronous back end (verification
    joined `loop_verify_lag_frames` later, threaded solve) and with the synchronous one:
    the same attempts and decisions, fitness to rtol 1e-4, keyframe poses to atol 1e-4."""
    from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline

    seq = SyntheticSequence(n_frames=30, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 30 / 90)
    scans = [s for s, _ in seq]
    base = tcfg.apply_cli_overrides(tcfg.PipelineConfig(), [
        "prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=8192",
        "capacity.filtered_points=4096", "capacity.keyframe_points=4096",
        "capacity.loop_submap_points=65536", "capacity.max_keyframes=256",
        "capacity.voxel_capacity=32768", "capacity.max_loop_factors=16",
        "graph_slam.loop_search_period_frames=5",
        "graph_slam.accumulate_distance_threshold=12.0"])
    res = {}
    for async_backend in (False, True):
        cfg = dataclasses.replace(base, graph_slam=dataclasses.replace(
            base.graph_slam, async_backend=async_backend))
        pipe = SlamPipeline(cfg, device="cpu")
        assert pipe.back.async_enabled == async_backend
        res[async_backend] = pipe.run(scans)
    sync, asyn = res[False], res[True]
    assert [(r["latest"], r["candidate"], r["accepted"]) for r in asyn.loop_log] == \
           [(r["latest"], r["candidate"], r["accepted"]) for r in sync.loop_log]
    assert asyn.num_loop_closures == sync.num_loop_closures >= 1
    np.testing.assert_allclose([r["fitness"] for r in asyn.loop_log],
                               [r["fitness"] for r in sync.loop_log], rtol=1e-4)
    np.testing.assert_allclose(asyn.keyframe_poses, sync.keyframe_poses, atol=1e-4)


# -- the FPFH+RANSAC initial guess (`use_global_init`) --------------------------------------

BIG_DRIFT = dict(err_yaw=0.4, err_xy=(4.0, -4.2))
# The fast lane's global registration: half the default keypoint capacity and a quarter
# of the default hypotheses (the [H, Q, 3] scoring tensor is 24 MiB instead of 192 MiB).
REDUCED_REG = tcfg.GlobalRegConfig(max_keypoints=4096, hypotheses=512)


@pytest.fixture(scope="module")
def big_drift_reference():
    """`build_loop_backend` with ~5.8 m / 23 deg of drift on the latest keyframe (never
    closed: it only holds the keyframes that the port back ends are fed)."""
    return build_loop_backend("ICP", **BIG_DRIFT)


def _global_init_recovers(jb, true_last, global_reg):
    plain = _port_backend(jb, async_backend=False)
    glob = _port_backend(jb, async_backend=False, use_global_init=True, global_reg=global_reg)
    drifted = plain.optimized_poses()[-1]
    assert np.linalg.norm(drifted[:3, 3] - true_last[:3, 3]) > 5.0
    closed_plain = plain.try_close_loop()
    assert glob.try_close_loop(), f"global-init verification failed ({glob.loop_log})"
    rec = glob.loop_log[-1]
    corrected = rec["transform"] @ drifted
    assert np.linalg.norm(corrected[:3, 3] - true_last[:3, 3]) < 0.3
    assert not closed_plain or rec["fitness"] <= plain.loop_log[-1]["fitness"]
    fam = rec["ransac_families"]
    assert set(fam) == {"n_3pt_valid", "n_yaw_valid", "best_is_yaw"}
    assert isinstance(fam["n_3pt_valid"], int) and isinstance(fam["best_is_yaw"], bool)
    assert fam["n_3pt_valid"] + fam["n_yaw_valid"] > 0
    assert "ransac_families" not in plain.loop_log[-1]
    return closed_plain


def test_global_init_recovers_large_drift_reduced(big_drift_reference):
    """`try_close_loop` from the global guess closes the large-drift loop on the CPU, at
    the reduced registration size."""
    _global_init_recovers(*big_drift_reference, REDUCED_REG)


@pytest.mark.slow
def test_global_init_recovers_large_drift(big_drift_reference):
    """`tests/test_loop_verifiers.py:test_global_init_recovers_large_drift` on the port,
    at the default `GlobalRegConfig` (8,192 keypoints, 2,048 hypotheses)."""
    _global_init_recovers(*big_drift_reference, tcfg.GlobalRegConfig())


def test_each_candidate_gets_its_own_guess(big_drift_reference):
    """With `loop_topk=2` the two candidates' verifications start from two different
    guesses, each from its own submap, and each record carries its own RANSAC counts;
    with the option off both start from the identity."""
    jb, _ = big_drift_reference
    seen = []
    for use in (True, False):
        back = _port_backend(jb, async_backend=False, use_global_init=use, loop_topk=2,
                             search_key_frame_num=3, global_reg=REDUCED_REG)
        verify_one, guesses = back._verify_one, []

        def spy(grid, pre_map, extra, guess, *rest, _inner=verify_one, _out=guesses):
            _out.append(guess.clone())
            return _inner(grid, pre_map, extra, guess, *rest)

        back._verify_one = spy
        back.try_close_loop()
        assert len(guesses) == 2 and len(back.loop_log) == 2
        assert back.loop_log[0]["candidate"] != back.loop_log[1]["candidate"]
        seen.append(guesses)
        assert all(("ransac_families" in rec) == use for rec in back.loop_log)
    eye = torch.eye(4)
    assert all(torch.equal(g, eye) for g in seen[1])
    a, b = seen[0]
    assert not torch.equal(a, b)
    assert not torch.equal(a, eye) or not torch.equal(b, eye)


def test_global_init_in_the_async_backend(big_drift_reference):
    """The guess is built in the worker thread, ahead of the verification, which reads
    the RANSAC counts with the results."""
    jb, true_last = big_drift_reference
    back = _port_backend(jb, async_backend=True, use_global_init=True, global_reg=REDUCED_REG)
    drifted = back.optimized_poses()[-1]
    pending = back.begin_loop_attempt()
    assert pending is not None and "thread" in pending
    assert back._consume_verify(pending)
    rec = back.loop_log[-1]
    assert rec["accepted"] and "ransac_families" in rec
    corrected = rec["transform"] @ drifted
    assert np.linalg.norm(corrected[:3, 3] - true_last[:3, 3]) < 0.3


def test_global_guess_is_built_in_the_verify_worker(big_drift_reference, monkeypatch):
    """With the asynchronous back end the FPFH+RANSAC guess is built in the verify worker
    (on the CPU its thread; on a card also its stream), not on the frame's thread; with
    the synchronous one it runs inline. Both give the same decisions, RANSAC counts and
    transforms (the module's async-vs-sync bound, atol 1e-4)."""
    jb, _ = big_drift_reference
    threads = []
    real = tslam.global_register

    def spy(*args, **kwargs):
        threads.append(threading.current_thread().name)
        return real(*args, **kwargs)

    monkeypatch.setattr(tslam, "global_register", spy)
    logs = {}
    for async_backend in (False, True):
        back = _port_backend(jb, async_backend=async_backend, use_global_init=True,
                             global_reg=REDUCED_REG, loop_topk=2, search_key_frame_num=3)
        threads.clear()
        pending = back.begin_loop_attempt()
        assert ("thread" in pending) == async_backend
        if async_backend:  # the worker may already have started: none on this thread
            assert threading.current_thread().name not in threads
        else:
            assert threads == [threading.current_thread().name] * 2
        back._consume_verify(pending)
        assert threads == ["loop-verify" if async_backend else threading.current_thread().name] * 2
        logs[async_backend] = back.loop_log
    assert len(logs[True]) == len(logs[False]) == 2
    for a, s in zip(logs[True], logs[False]):
        assert (a["candidate"], a["converged"], a["accepted"], a["ransac_families"]) == \
               (s["candidate"], s["converged"], s["accepted"], s["ransac_families"])
        np.testing.assert_allclose(a["transform"], s["transform"], atol=1e-4)
        np.testing.assert_allclose(a["fitness"], s["fitness"], rtol=1e-4)
    assert any(r["accepted"] for r in logs[True])
