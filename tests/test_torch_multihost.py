"""The port's multi-process path (`lidar_graph_slam_tpu_torch/parallel/multihost.py` and its
hooks) against its one-process runs and the JAX package, after `tests/test_multihost.py`.

Two fresh interpreters (`tests/torch_multihost_worker.py`) join a gloo process group on
localhost, each with 2 CPU slots, and write what they computed to `tmp_path`; this process
computes the one-process side and the JAX package's outputs on the same seeded inputs
(`tests/torch_multihost_fixtures.py`). Every subprocess has its own timeout and both are
killed when one expires; the process group's own timeout is finite
(`PROCESS_GROUP_TIMEOUT_S`), so no test can hang.

Tolerances: the store's submap 1e-6 against the JAX store (the reference test's); the
cross-process chain and Schur steps bit-equal on both processes and to the one-process
4-slot mesh, and within 1e-4 (chain) and 1e-2 (Schur) of the JAX package's local step
(`tests/multihost_worker.py:93-100`); the sharded pipelines' keyframe poses within 1e-4
of the local-store runs (`tests/multihost_worker.py:134`; bit-equal is expected, and the
fast cases hold that), their loop decisions equal; the loop course of the `slow` case
against the JAX package within `tests/test_torch_loop_pipeline.py`'s course90 bound,
5e-3.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu_torch.parallel import multihost
from lidar_graph_slam_tpu_torch.parallel.distributed import (
    distributed_graph_step,
    make_mesh,
)
from lidar_graph_slam_tpu_torch.parallel.multi_sequence import batch_odometry
from lidar_graph_slam_tpu_torch.parallel.schur import schur_graph_step
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from tests import torch_multihost_fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
SMALL_SETS = ("prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=16384",
              "capacity.filtered_points=4096", "capacity.voxel_capacity=32768")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread, as in the workers: the one-process runs here must take
    the workers' reduction orders to be compared bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS") and not k.startswith("LGS_")}
    return {**env, "OMP_NUM_THREADS": "1", **extra}


def _start(cmds, envs) -> list:
    return [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env) for cmd, env in zip(cmds, envs)]


def _finish(procs, timeout: float) -> list:
    """Each process's (return code, output); all of them killed when one overruns."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"a process of the two-process run timed out after {timeout} s")
        outs.append((p.returncode, out))
    return outs


def _run_workers(out_dir, phases, timeout: float, local=None) -> tuple:
    """The two workers on `phases`; `local()` runs here meanwhile. Returns (p0, p1, what
    `local` returned) with each worker's arrays."""
    port = _free_port()
    procs = _start([[sys.executable, WORKER, str(port), str(i), str(out_dir), *phases]
                    for i in range(2)], [_env()] * 2)
    try:
        mine = local() if local is not None else None
    finally:
        outs = _finish(procs, timeout)
    for i, (rc, out) in enumerate(outs):
        assert rc == 0 and "TORCH_MULTIHOST_OK" in out, f"worker {i} failed:\n{out[-4000:]}"
    p0, p1 = (dict(np.load(os.path.join(out_dir, f"p{i}.npz"))) for i in range(2))
    return p0, p1, mine


# --- one process ---------------------------------------------------------------------------


def test_initialize_from_env_single_process_noop(monkeypatch):
    """`tests/test_multihost.py:52-58`: no coordinator is single-process (False); a count
    above one without an id is refused."""
    for name in ("LGS_COORDINATOR", "LGS_NUM_PROCESSES", "LGS_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_from_env() is False
    monkeypatch.setenv("LGS_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("LGS_NUM_PROCESSES", "1")
    assert multihost.initialize_from_env() is False
    monkeypatch.setenv("LGS_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="LGS_PROCESS_ID"):
        multihost.initialize_from_env()
    assert not torch.distributed.is_initialized()


def test_host_sharded_store_single_process_matches_reference():
    """The fixture of `tests/test_multihost.py:61-85` through both packages' stores: the
    one-process submap equal to the JAX store's (and the plain transform) to 1e-6, and the
    two-process ownership bookkeeping and its refusal the same."""
    from lidar_graph_slam_tpu.parallel.multihost import HostShardedKeyframeStore as JStore

    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(16, 3)).astype(np.float32) for _ in range(4)]
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    stores = (multihost.HostShardedKeyframeStore(pad_points=32, process_id=0, num_processes=1),
              JStore(pad_points=32, process_id=0, num_processes=1))
    for k in range(4):
        poses[k, 1, 3] = 2.0 * k
        for store in stores:
            store.add(k, clouds[k])
    sub, jsub = (s.assemble_submap(1, 3, poses) for s in stores)
    expected = np.concatenate([clouds[1] + np.array([0, 2.0, 0], np.float32),
                               clouds[2] + np.array([0, 4.0, 0], np.float32)])
    np.testing.assert_allclose(sub, jsub, atol=1e-6)
    np.testing.assert_allclose(sub, expected, atol=1e-6)
    np.testing.assert_array_equal(stores[0].get_cloud(2), clouds[2])

    views = (multihost.HostShardedKeyframeStore(pad_points=32, process_id=1, num_processes=2),
             JStore(pad_points=32, process_id=1, num_processes=2))
    for s in views:
        s.add(0, None)  # not owned: metadata only
        s.add(1, clouds[1])
        assert s.local_ids() == [1] and s.n_keyframes == 2
        assert [s.owner(k) for k in range(5)] == [0, 1, 0, 1, 0]
        with pytest.raises(ValueError, match="owns keyframe 3"):
            s.add(3, None)  # owned but no cloud supplied


# --- two processes x 2 CPU slots -----------------------------------------------------------


def _one_process_side():
    """What the workers compute, in one process: the 4-slot mesh steps, the local-store
    pipelines (the synchronous back end, which a multi-process run forces), the 4-slot
    mesh pipeline and the 2-slot top-k attempt."""
    out = {}
    _, _, rng = fx.store_fixture()
    g = fx.torch_graph(rng)
    mesh4 = make_mesh(4, device="cpu")
    out["chain"] = distributed_graph_step(mesh4, g, 1e-4).numpy()
    out["schur"] = schur_graph_step(mesh4, g, 1e-4).numpy()
    pipe = SlamPipeline(fx.small_config(async_backend=False), device="cpu")
    res = pipe.run(fx.short_scans())
    out.update(pipe_keyframe_poses=res.keyframe_poses, pipe_odometry_poses=res.odometry_poses,
               pipe_map=pipe.back.assemble_map(0.5))
    cfg = fx.small_config(async_backend=False, use_mesh=True, mesh_devices=4)
    out["mesh_pipe_keyframe_poses"] = SlamPipeline(cfg, device="cpu").run(
        fx.short_scans(5)).keyframe_poses
    scans, masks, cfg = fx.batch_course()
    final, outs = batch_odometry(scans, masks, cfg, map_capacity=4096,
                                 mesh=make_mesh(2, device="cpu"))
    out["batch_pose"], out["batch_ring"] = outs["pose"].numpy(), final.ring_clouds.numpy()
    back = fx.multi_lap_backend(mesh=make_mesh(2, device="cpu"))
    assert back.try_close_loop()
    out["topk_log"] = np.asarray([(r["candidate"], r["accepted"], r["fitness"])
                                  for r in back.loop_log], np.float64)
    out["topk_poses"] = back.optimized_poses()
    out["topk_device_lm"] = back._make_device_lm(back._bucket_graph())(back._host_view().poses)
    return out


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    return _run_workers(tmp_path_factory.mktemp("multihost"), ["core", "pipeline", "mesh"],
                        timeout=240, local=_one_process_side)


def test_global_mesh_and_sharded_store(two_process):
    """A 4-slot mesh over both processes; the clouds split round-robin; the submap of
    `tests/multihost_worker.py:46-57` the same on both processes and equal to the JAX
    store's one-process output."""
    from lidar_graph_slam_tpu.parallel.multihost import HostShardedKeyframeStore as JStore

    p0, p1, _ = two_process
    assert p0["store_local_ids"].tolist() == [0, 2, 4]
    assert p1["store_local_ids"].tolist() == [1, 3, 5]
    clouds, poses, _ = fx.store_fixture()
    jstore = JStore(pad_points=64, process_id=0, num_processes=1)
    for k, c in enumerate(clouds):
        jstore.add(k, c)
    np.testing.assert_array_equal(p0["submap"], p1["submap"])
    np.testing.assert_allclose(p0["submap"], jstore.assemble_submap(0, 6, poses), atol=1e-6)
    np.testing.assert_array_equal(p0["cloud3"], clouds[3])
    np.testing.assert_array_equal(p1["cloud3"], clouds[3])


@pytest.mark.parametrize("step,tol", [("chain", 1e-4), ("schur", 1e-2)])
def test_cross_process_steps_are_bit_equal(two_process, step, tol):
    """The chain and Schur steps on the K = 16 graph over 2 processes x 2 slots: bit-equal
    on both processes and to the one-process 4-slot mesh; within the reference worker's
    bound of the JAX package's local `solver._solve_step`."""
    import jax
    import jax.numpy as jnp

    from lidar_graph_slam_tpu.core import se3 as jse3
    from lidar_graph_slam_tpu.graph import solver as jsolver

    p0, p1, local = two_process
    np.testing.assert_array_equal(p0[step], p1[step])
    np.testing.assert_array_equal(p0[step], local[step])
    _, _, rng = fx.store_fixture()
    g = jsolver.init_graph(fx.GRAPH_K, 2, (1e-4,) * 6)
    T = np.eye(4, dtype=np.float32)
    g = jsolver.graph_add_keyframe(g, jnp.asarray(T), jnp.eye(4))
    for xi in fx.graph_twists(rng):
        meas = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
        T = T @ meas
        g = jsolver.graph_add_keyframe(g, jnp.asarray(T), jnp.asarray(meas))
    g = jsolver.graph_add_loop(g, jnp.asarray(0), jnp.asarray(fx.GRAPH_K - 1), jnp.eye(4),
                               jnp.full((6,), 1e4, jnp.float32))
    local_step = np.asarray(jax.jit(lambda g: g.poses @ jse3.se3_exp(
        jsolver._solve_step(g, g.poses, jnp.asarray(1e-4, jnp.float32))))(g))
    assert np.abs(p0[step] - local_step).max() < tol


def test_sharded_pipeline_matches_local_store(two_process):
    """A 15-frame `SlamPipeline` on the CPU in each process (its clouds sharded, its back
    end forced synchronous) against the one-process local-store run: keyframe poses within
    1e-4 (bit-equal here), odometry equal, the same map; each process owns some clouds;
    `save_pipeline` refuses a sharded pipeline."""
    p0, p1, local = two_process
    for p in (p0, p1):
        diff = np.abs(p["pipe_keyframe_poses"] - local["pipe_keyframe_poses"]).max()
        assert diff <= 1e-4, diff
        np.testing.assert_array_equal(p["pipe_keyframe_poses"], local["pipe_keyframe_poses"])
        np.testing.assert_array_equal(p["pipe_odometry_poses"], local["pipe_odometry_poses"])
        assert p["pipe_map"].shape == local["pipe_map"].shape
        np.testing.assert_array_equal(p["pipe_map"], local["pipe_map"])
        assert bool(p["save_refused"])
    n_kf = local["pipe_keyframe_poses"].shape[0]
    owned = sorted(p0["pipe_owned"].tolist() + p1["pipe_owned"].tolist())
    assert owned == list(range(n_kf)) and 0 < len(p0["pipe_owned"]) < n_kf


def test_mesh_over_processes_matches_one_process_mesh(two_process):
    """`parallel.use_mesh` (4 slots over the two processes) against the one-process 4-slot
    mesh; on a 2-slot mesh over the processes against a one-process 2-slot mesh:
    `batch_odometry` of two sequences (one a process, gathered), and a top-2 loop attempt
    (one candidate each, through the sharded store) with the same candidates, decisions
    and fitness, the same solved poses and the same mesh LM."""
    p0, p1, local = two_process
    for p in (p0, p1):
        np.testing.assert_array_equal(p["batch_pose"], local["batch_pose"])
        np.testing.assert_array_equal(p["batch_ring"], local["batch_ring"])
        np.testing.assert_array_equal(p["mesh_pipe_keyframe_poses"],
                                      local["mesh_pipe_keyframe_poses"])
        np.testing.assert_array_equal(p["topk_log"], local["topk_log"])
        np.testing.assert_array_equal(p["topk_poses"], local["topk_poses"])
        np.testing.assert_array_equal(p["topk_device_lm"], local["topk_device_lm"])
    assert local["topk_log"].shape[0] == 2 and local["topk_log"][:, 1].all()


# --- the CLI -------------------------------------------------------------------------------


def _cli(out, *extra):
    return [sys.executable, "-m", "lidar_graph_slam_tpu_torch.pipeline.cli", "--frames", "5",
            "--device", "cpu", "--output", str(out), "--progress-every", "0",
            *(a for v in SMALL_SETS for a in ("--set", v)), *extra]


def test_two_cli_processes_equal_one(tmp_path):
    """Two `--multihost --device cpu` processes: both exit 0, process 1 writes
    `<output>-p1`, and both trajectories equal a one-process CLI run's."""
    port = _free_port()
    multi = tmp_path / "multi"
    envs = [_env(LGS_COORDINATOR=f"127.0.0.1:{port}", LGS_NUM_PROCESSES="2",
                 LGS_PROCESS_ID=str(i)) for i in range(2)]
    procs = _start([_cli(multi, "--multihost")] * 2 + [_cli(tmp_path / "single")],
                   envs + [_env()])
    outs = _finish(procs, timeout=240)
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"CLI process {i} failed:\n{out[-3000:]}"
    assert "multihost: process 0/2" in outs[0][1] and "multihost: process 1/2" in outs[1][1]
    runs = [multi, tmp_path / "multi-p1", tmp_path / "single"]
    for name in ("odometry_tum.txt", "keyframes_tum.txt", "odometry_kitti.txt"):
        texts = [(d / name).read_text() for d in runs]
        assert texts[0] == texts[1] == texts[2], name
    summaries = [json.loads((d / "metrics.json").read_text()) for d in runs]
    assert summaries[0]["keyframes"] == summaries[2]["keyframes"] >= 1
    assert summaries[0]["frames"] == summaries[1]["frames"] == 5


def test_multihost_cli_without_env_runs_single_process_and_fails_when_misconfigured(tmp_path):
    """`--multihost` with no `LGS_*` coordinator runs single-process with the reference's
    notice; a configured group that cannot form (no process id) exits non-zero and never
    carries on alone."""
    bad = _env(LGS_COORDINATOR=f"127.0.0.1:{_free_port()}", LGS_NUM_PROCESSES="2")
    (rc, out), (rc_bad, out_bad) = _finish(_start(
        [_cli(tmp_path / "alone", "--multihost", "--no-loop-closure"),
         _cli(tmp_path / "bad", "--multihost")], [_env(), bad]), timeout=180)
    assert rc == 0 and "no LGS_* coordinator env, running single-process" in out
    assert rc_bad != 0 and "LGS_PROCESS_ID" in out_bad
    assert "running single-process" not in out_bad
    assert not (tmp_path / "bad" / "metrics.json").exists()


# --- slow: the reference worker's loop course ---------------------------------------------


@pytest.mark.slow
def test_sharded_loop_course_matches_local_and_reference(tmp_path):
    """`tests/multihost_worker.py:105-141` on the port: the 75-frame course (seed 3,
    radius 25, 1.12 laps) sharded over two processes equals the local-store run to 1e-4,
    with >= 1 loop and the same decisions; the port's one-process keyframe poses within
    5e-3 of the JAX package's one-process run, the same decisions."""
    from lidar_graph_slam_tpu.core import config as jcfg
    from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence as JSeq
    from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline as JPipeline

    def local():
        pipe = SlamPipeline(fx.small_config(async_backend=False), device="cpu")
        return pipe.run(fx.course_scans()), pipe.back.assemble_map(0.5).shape

    p0, p1, (res, map_shape) = _run_workers(tmp_path, ["course"], timeout=1200, local=local)
    decisions = np.asarray([(r["candidate"], r["accepted"]) for r in res.loop_log],
                           np.int64).reshape(-1, 2)
    assert res.num_loop_closures >= 1
    for p in (p0, p1):
        diff = np.abs(p["course_keyframe_poses"] - res.keyframe_poses).max()
        assert diff < 1e-4, diff
        assert int(p["course_loops"]) == res.num_loop_closures
        np.testing.assert_array_equal(p["course_decisions"], decisions)
        assert tuple(p["course_map_shape"]) == map_shape
    assert 0 < len(p0["course_owned"]) < res.keyframe_poses.shape[0]

    jc = jcfg.PipelineConfig(
        prefilter=jcfg.PrefilterConfig(leaf_size=0.3, mean_k=10),
        graph_slam=jcfg.GraphSlamConfig(loop_search_period_frames=5, async_backend=False),
        capacity=jcfg.CapacityConfig(raw_points=8192, filtered_points=4096,
                                     keyframe_points=4096, loop_submap_points=65536,
                                     max_keyframes=256, voxel_capacity=32768,
                                     max_loop_factors=16))
    jres = JPipeline(jc).run([s for s, _ in JSeq(n_frames=75, seed=3, max_points=4096,
                                                  radius=25.0, laps=1.12)])
    np.testing.assert_array_equal(
        np.asarray([(r["candidate"], r["accepted"]) for r in jres.loop_log],
                   np.int64).reshape(-1, 2), decisions)
    np.testing.assert_allclose(res.keyframe_poses, jres.keyframe_poses, atol=5e-3)
