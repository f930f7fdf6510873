"""The mesh in the port's live pipeline (`ParallelConfig.use_mesh`): `shard_batch`, the
back end's divisibility refusal, the mesh's solve bucket, top-k loop verification over
the slots against the unmeshed back end, and `SlamPipeline` with the mesh against the
JAX package's (`tests/test_pipeline_mesh.py`).

The port's CPU mesh has the reference tests' 8 slots. Tolerances are the reference
test's: the same candidates and decisions, fitness to 1e-4 (top-k) or 1e-3 (the
pipeline), optimized keyframe positions to 0.02 m. The slots of a CPU mesh share one
device, so the meshed and unmeshed top-k verifications are equal bit for bit here.
"""

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM as JBack
from lidar_graph_slam_tpu.parallel import distributed as jdist
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    make_loop_trajectory,
    make_world,
    simulate_scan,
)
from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu_torch.parallel.distributed import make_mesh, shard_batch
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline

pytestmark = pytest.mark.xdist_group("course90")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it: the back end
    runs verification and the solve in worker threads (`tests/test_torch_loop.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shard_batch_lays_out_batch_over_mesh():
    """A mesh-divisible batch lands item i on slot i // (batch / n) with the shared tree
    beside it; a batch that does not divide the mesh is left alone."""
    mesh = make_mesh(8, device="cpu")
    vm = build_ndt_map(torch.randn(256, 3) * 3, torch.ones(256, dtype=torch.bool), 2.0,
                       capacity=128)
    batched = [(vm, torch.full((3,), float(i))) for i in range(16)]
    shared = (torch.zeros(16, 3), None)
    items, shares, slots = shard_batch(mesh, batched, shared)
    assert slots == [i // 2 for i in range(16)]
    assert all(torch.equal(it[1], b[1]) for it, b in zip(items, batched))
    assert all(s[0].shape == (16, 3) and s[1] is None for s in shares)
    assert all(it[0].table.device == mesh.devices[s] for it, s in zip(items, slots))
    items, shares, slots = shard_batch(mesh, batched[:3], shared)
    assert slots == [None] * 3 and items[0] is batched[0] and shares[0] is shared


def _cap(**kw):
    return tcfg.CapacityConfig(**{**dict(max_keyframes=128, max_loop_factors=8,
                                         keyframe_points=4096, loop_submap_points=65536,
                                         voxel_capacity=32768), **kw})


@pytest.mark.parametrize("max_keyframes,slots,ok", [(128, 8, True), (16, 8, True),
                                                     (8, 8, False), (64, 3, False),
                                                     (96, 3, True)])
def test_backend_refuses_a_mesh_the_capacity_does_not_divide(max_keyframes, slots, ok):
    """`graph/slam.py:156-166` of the reference: the capacity must divide the mesh with at
    least 2 poses a slot, or the back end refuses to build."""
    mesh = make_mesh(slots, device="cpu")
    cap = _cap(max_keyframes=max_keyframes)
    if ok:
        assert GraphBasedSLAM(tcfg.GraphSlamConfig(), cap, device="cpu", mesh=mesh).mesh is mesh
    else:
        with pytest.raises(ValueError, match="multiple of the mesh size"):
            GraphBasedSLAM(tcfg.GraphSlamConfig(), cap, device="cpu", mesh=mesh)


@pytest.mark.parametrize("slots,max_keyframes,n_keyframes", [
    (8, 4096, 0), (8, 4096, 300), (512, 4096, 10), (1, 128, 5), (3, 96, 10)])
def test_bucket_size_on_a_mesh(slots, max_keyframes, n_keyframes):
    """The solve bucket grows to a mesh multiple with >= 2 poses a slot, capped at the
    capacity, as the reference's; a 3-slot mesh (which no doubled 256 divides, where the
    reference's loop never ends) gets the capacity."""
    cap = _cap(max_keyframes=max_keyframes)
    back = GraphBasedSLAM(tcfg.GraphSlamConfig(), cap, device="cpu",
                          mesh=make_mesh(slots, device="cpu"))
    back.n_keyframes = n_keyframes
    b = back._bucket_size()
    assert b % slots == 0 and b // slots >= 2 and b <= max_keyframes
    if slots != 3:
        from lidar_graph_slam_tpu.core.config import CapacityConfig, GraphSlamConfig

        jback = JBack(GraphSlamConfig(), CapacityConfig(max_keyframes=max_keyframes),
                      mesh=jdist.make_mesh(1))
        jback.mesh = type("M", (), {"devices": np.empty(slots)})()  # only its size is read
        jback.n_keyframes = n_keyframes
        assert b == jback._bucket_size()
    else:
        assert b == max_keyframes


def _multi_lap_backend(loop_topk: int, mesh=None, async_backend=True):
    """`tests/test_pipeline_mesh.py`'s back end: ground-truth keyframes along a 2.15-lap
    circle, so the latest keyframe has two gated candidates a lap apart."""
    cfg = tcfg.GraphSlamConfig(accumulate_distance_threshold=80.0,
                               search_for_candidate_threshold=15.0, search_key_frame_num=10,
                               loop_topk=loop_topk, async_backend=async_backend)
    back = GraphBasedSLAM(cfg, _cap(), device="cpu", mesh=mesh)
    rng = np.random.default_rng(11)
    world = make_world(rng, extent=40.0, density=2.0)
    traj = make_loop_trajectory(80, radius=16.0, laps=2.15)
    accum, prev = 0.0, traj[0]
    for k in range(80):
        pose = traj[k]
        if k:
            accum += float(np.linalg.norm(pose[:3, 3] - prev[:3, 3]))
        prev = pose
        scan = simulate_scan(world, pose, rng, max_points=4096, noise=0.01)
        back.add_keyframe({"pose": pose.astype(np.float32), "cloud": scan,
                           "cloud_mask": np.ones(scan.shape[0], bool), "accum_distance": accum})
    return back


@pytest.mark.parametrize("slots", [2, 8])
def test_topk_on_mesh_matches_unmeshed(slots):
    """`loop_topk=2` routed over the mesh (2 candidates: one a slot on 2 slots; on 8 the
    batch does not divide and stays put) reproduces the unmeshed decisions and poses —
    through the asynchronous worker — and the mesh LM is the device LM."""
    plain = _multi_lap_backend(2)
    meshed = _multi_lap_backend(2, mesh=make_mesh(slots, device="cpu"))
    assert plain.try_close_loop() and meshed.try_close_loop()
    assert meshed.n_loops == plain.n_loops == 2
    for a, b in zip(plain.loop_log, meshed.loop_log):
        assert a["candidate"] == b["candidate"] and a["accepted"] == b["accepted"]
        assert abs(a["fitness"] - b["fitness"]) < 1e-4
    dt = np.linalg.norm(plain.optimized_poses()[:, :3, 3] - meshed.optimized_poses()[:, :3, 3],
                        axis=1)
    assert dt.max() < 0.02
    gb = meshed._bucket_graph()
    poses64 = meshed._host_view().poses
    out = meshed._make_device_lm(gb)(poses64)
    assert out.shape == poses64.shape and np.isfinite(out).all()


def _small_config(**parallel):
    return tcfg.PipelineConfig(
        prefilter=tcfg.PrefilterConfig(leaf_size=0.3, mean_k=10),
        graph_slam=tcfg.GraphSlamConfig(loop_search_period_frames=5),
        capacity=tcfg.CapacityConfig(raw_points=8192, filtered_points=4096,
                                     keyframe_points=4096, loop_submap_points=65536,
                                     max_keyframes=256, voxel_capacity=32768,
                                     max_loop_factors=16),
        parallel=tcfg.ParallelConfig(**parallel))


def test_mesh_pipeline_runs_and_matches_unmeshed():
    """`SlamPipeline` with `use_mesh=True` on 8 slots is no longer refused; its odometry
    equals the unmeshed pipeline's (the front end stays on one device)."""
    scans = [s for s, _ in SyntheticSequence(n_frames=5, seed=3, max_points=8192,
                                             radius=30.0, laps=1.1)]
    res = {}
    for use_mesh in (False, True):
        pipe = SlamPipeline(_small_config(use_mesh=use_mesh, mesh_devices=8), device="cpu")
        assert (pipe.back.mesh is not None) == use_mesh
        res[use_mesh] = pipe.run(scans)
    assert pipe.back.mesh.size == 8
    np.testing.assert_array_equal(res[True].odometry_poses, res[False].odometry_poses)


@pytest.mark.slow
def test_mesh_pipeline_matches_single_chip(course90, course90_single_result):
    """`tests/test_pipeline_mesh.py::test_mesh_pipeline_matches_single_chip` on the port:
    the 8-slot mesh pipeline (Schur LM, top-k over the slots) against the JAX package's
    single-device run of the same course."""
    scans, _ = course90
    r_single = course90_single_result
    r_mesh = SlamPipeline(_small_config(use_mesh=True, mesh_devices=8,
                                        backend_solver="schur"), device="cpu").run(scans)
    assert r_single.num_loop_closures >= 1
    assert r_mesh.num_loop_closures == r_single.num_loop_closures
    for a, b in zip(r_single.loop_log, r_mesh.loop_log):
        assert a["candidate"] == b["candidate"] and a["accepted"] == b["accepted"]
        assert abs(a["fitness"] - b["fitness"]) < 1e-3
    dt = np.linalg.norm(r_single.keyframe_poses[:, :3, 3] - r_mesh.keyframe_poses[:, :3, 3],
                        axis=1)
    assert dt.max() < 0.02, f"mesh-vs-single translation divergence {dt.max():.4f} m"


@pytest.mark.slow
def test_topk_on_mesh_matches_reference():
    """The port's 8-slot top-k attempt against the JAX package's on its 8 virtual devices
    (`tests/test_pipeline_mesh.py::_multi_lap_backend`, the same keyframes): the same
    candidates and decisions, fitness to 1e-4, optimized positions to 0.02 m."""
    from tests.test_pipeline_mesh import _multi_lap_backend as jax_backend

    jback = jax_backend(loop_topk=2, mesh=jdist.make_mesh(8))
    tback = _multi_lap_backend(2, mesh=make_mesh(8, device="cpu"))
    assert jback.try_close_loop() and tback.try_close_loop()
    assert tback.n_loops == jback.n_loops == 2
    for a, b in zip(jback.loop_log, tback.loop_log):
        assert a["candidate"] == b["candidate"] and a["accepted"] == b["accepted"]
        assert abs(a["fitness"] - b["fitness"]) < 1e-4
    dt = np.linalg.norm(jback.optimized_poses()[:, :3, 3] - tback.optimized_poses()[:, :3, 3],
                        axis=1)
    assert dt.max() < 0.02
