"""The port's batched multi-sequence odometry and SLAM
(`lidar_graph_slam_tpu_torch/parallel/multi_sequence.py`), its batched `ndt_align` and the
batched fused NDT kernel's plain version, against the JAX package on the same numpy
inputs.

Tolerances: batched `ndt_align` against the reference's `jax.vmap(ndt_align)` — transforms
1e-4, iterations, converged and inliers exact, fitness rtol 1e-4 (`tests/test_torch_ndt.py`);
against the port's single `ndt_align`, and the batched plain kernel against the single
plain version, bit for bit. `batch_odometry` against the reference's on a 2-slot mesh
(B = 2 sharded over 2 of the 8 virtual devices: a batch must divide the mesh there) —
poses 1e-4, `accum_dist` 1e-4, `is_keyframe`, `converged` and `kf_count` exact, and every
final state field after the 3-slot ring wrapped: the ring's clouds, masks and used flags
exact (the input scans), its poses, the pose, last motion, last keyframe position and
distance 1e-4; a batch
of 2 equals two batches of 1, and the meshed run the unmeshed one, bit for bit. The
JAX-sized cases (B = 4 x 12 frames; B = 4 x 90 frames with loops) are `slow`, as the
reference's are; `test_batch_slam_closes_loops_fast` is the fast closed-loop case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.core.config import NdtConfig as JNdtConfig
from lidar_graph_slam_tpu.core.config import ScanMatcherConfig as JScanMatcherConfig
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.ops.voxel import build_ndt_map as jbuild_ndt_map
from lidar_graph_slam_tpu.parallel import distributed as jdist
from lidar_graph_slam_tpu.parallel import multi_sequence as jms
from lidar_graph_slam_tpu.registration.ndt import ndt_align as jndt_align
from lidar_graph_slam_tpu_torch.core.config import (
    CapacityConfig,
    GraphSlamConfig,
    NdtConfig,
    ScanMatcherConfig,
)
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu_torch.parallel import distributed as tdist
from lidar_graph_slam_tpu_torch.parallel import multi_sequence as tms
from lidar_graph_slam_tpu_torch.registration.ndt import ndt_align, ndt_align_batched
from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse


def sequences(B, F, N, seed0, **kw):
    """[B, F, N, 3] scans (padding 1e6), [B, F, N] masks and per-sequence ground truth
    relative to frame 0: `SyntheticSequence(seed0 + b, ...)`, as the reference's tests."""
    scans = np.full((B, F, N, 3), 1.0e6, dtype=np.float32)
    masks = np.zeros((B, F, N), dtype=bool)
    gts = []
    for b in range(B):
        args = {k: (v(b) if callable(v) else v) for k, v in kw.items()}
        seq = SyntheticSequence(n_frames=F, seed=seed0 + b, max_points=N, **args)
        gt_b = []
        for f, (scan, gt_pose) in enumerate(seq):
            scans[b, f, :len(scan)] = scan
            masks[b, f, :len(scan)] = True
            gt_b.append(gt_pose)
        T0_inv = np.linalg.inv(gt_b[0])
        gts.append(np.stack([(T0_inv @ p).astype(np.float32) for p in gt_b]))
    return scans, masks, gts


# --- batched ndt_align and the batched kernel's plain version ---------------------------


@pytest.fixture(scope="module")
def ndt_batch():
    """3 sequences' (map, source) pairs: frame 1 of each against a map of its frame 0."""
    scans, masks, _ = sequences(3, 2, 2048, 30, laps=0.1, radius=lambda b: 25.0 + 3 * b)
    maps_np = [(scans[b, 0], masks[b, 0]) for b in range(3)]
    return maps_np, scans[:, 1], masks[:, 1]


@pytest.mark.parametrize("max_iterations", [20, 3])
def test_batched_ndt_align_matches_vmapped_reference_and_single(ndt_batch, max_iterations):
    """Lanes that finish at different iterations keep their carry (3 iterations: every
    lane stops at the cap, where `converged` still holds, PCL's rule)."""
    maps_np, srcs, msks = ndt_batch
    inits = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    jmaps = jdist.stack_pytrees([jbuild_ndt_map(jnp.asarray(p), jnp.asarray(m),
                                                jnp.float32(2.0), capacity=4096)
                                 for p, m in maps_np])
    j = jax.vmap(lambda vm, s, m, i: jndt_align(vm, s, m, i, max_iterations=max_iterations))(
        jmaps, jnp.asarray(srcs), jnp.asarray(msks), jnp.asarray(inits))
    tmaps = [build_ndt_map(torch.as_tensor(p), torch.as_tensor(m), 2.0, capacity=4096)
             for p, m in maps_np]
    t = ndt_align_batched(kernels.stack_maps(tmaps), torch.as_tensor(srcs),
                          torch.as_tensor(msks), torch.as_tensor(inits),
                          max_iterations=max_iterations)
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    for name in ("iterations", "converged", "num_inliers"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    np.testing.assert_allclose(t.fitness.numpy(), np.asarray(j.fitness), rtol=1e-4, atol=1e-6)
    if max_iterations == 20:
        assert len(set(t.iterations.tolist())) > 1, "the lanes should stop apart"
    for b in range(3):
        s = ndt_align(tmaps[b], torch.as_tensor(srcs[b]), torch.as_tensor(msks[b]),
                      torch.as_tensor(inits[b]), max_iterations=max_iterations)
        for name in ("transform", "iterations", "converged", "fitness", "num_inliers"):
            assert torch.equal(getattr(t, name)[b], getattr(s, name)), name


def test_batched_plain_kernel_equals_single_plain(ndt_batch):
    maps_np, srcs, msks = ndt_batch
    tmaps = [build_ndt_map(torch.as_tensor(p), torch.as_tensor(m), 2.0, capacity=4096)
             for p, m in maps_np]
    p, m = torch.as_tensor(srcs), torch.as_tensor(msks)
    m[1] = False  # an all-masked sequence gives a zero row
    d2 = torch.tensor([0.25, 0.5, 0.75])
    out = kernels.ndt_direct7_accumulate_batched(kernels.stack_maps(tmaps), p, m, d2, 1.05)
    assert out[0].shape == (3, 6, 6) and out[5].shape == (3,)
    for b in range(3):
        single = kernels.ndt_direct7_accumulate_plain(tmaps[b], p[b], m[b], d2[b], 1.05)
        for x, y in zip(out, single):
            assert torch.equal(x[b], y)
    assert float(out[3][1]) == 0.0 and not out[0][1].any()
    back = kernels.map_at(kernels.stack_maps(tmaps), 2)
    assert torch.equal(back.table, tmaps[2].table) and torch.equal(back.inv_leaf,
                                                                   tmaps[2].inv_leaf)


# --- batch_odometry ------------------------------------------------------------------------

B_SMALL, F_SMALL, N_SMALL = 2, 4, 1024


@pytest.fixture(scope="module")
def small_course():
    return sequences(B_SMALL, F_SMALL, N_SMALL, 10, laps=0.1, radius=lambda b: 30.0 + 2 * b)


def _cfgs(window=3, **ndt):
    return (JScanMatcherConfig(max_scan_accumulate_num=window, ndt=JNdtConfig(**ndt)),
            ScanMatcherConfig(max_scan_accumulate_num=window, ndt=NdtConfig(**ndt)))


def test_batch_odometry_matches_reference(small_course):
    scans, masks, _ = small_course
    jcfg, tcfg = _cfgs(resolution=2.0, max_iterations=32)
    jfin, jout = jms.batch_odometry(scans, masks, jcfg, map_capacity=4096,
                                    mesh=jdist.make_mesh(2, axis="seq"))
    tfin, tout = tms.batch_odometry(scans, masks, tcfg, map_capacity=4096,
                                    mesh=tdist.make_mesh(2, axis="seq", device="cpu"))
    jout = jax.device_get(jout)
    assert tout["pose"].shape == (B_SMALL, F_SMALL, 4, 4)
    np.testing.assert_allclose(tout["pose"].numpy(), jout["pose"], atol=1e-4)
    np.testing.assert_allclose(tout["accum_dist"].numpy(), jout["accum_dist"], atol=1e-4)
    for name in ("is_keyframe", "converged"):
        np.testing.assert_array_equal(tout[name].numpy(), jout[name])
    np.testing.assert_array_equal(tfin.kf_count.numpy(), np.asarray(jfin.kf_count))
    np.testing.assert_allclose(tfin.ring_poses.numpy(), np.asarray(jfin.ring_poses), atol=1e-4)
    # Every frame is a keyframe, so frame 3 wrapped the 3-slot ring onto slot 0.
    assert (tfin.kf_count == F_SMALL).all()
    for name in ("ring_clouds", "ring_masks", "ring_used"):  # the input scans themselves
        np.testing.assert_array_equal(getattr(tfin, name).numpy(), np.asarray(getattr(jfin, name)))
    for name in ("pose", "last_motion", "last_kf_pos", "accum_dist"):
        np.testing.assert_allclose(getattr(tfin, name).numpy(), np.asarray(getattr(jfin, name)),
                                   atol=1e-4)


def test_batch_equals_single_sequence_runs(small_course):
    """A batch of 2 equals two batches of 1, and a 2-slot mesh the unmeshed run, bit for
    bit (each sequence's carry is its own)."""
    scans, masks, _ = small_course
    _, cfg = _cfgs(resolution=2.0, max_iterations=32, coarse_resolution=0.0)
    fin, out = tms.batch_odometry(scans, masks, cfg, map_capacity=4096, device="cpu")
    _, meshed = tms.batch_odometry(scans, masks, cfg, map_capacity=4096,
                                   mesh=tdist.make_mesh(2, device="cpu"))
    for b in range(B_SMALL):
        fin_b, out_b = tms.batch_odometry(scans[b:b + 1], masks[b:b + 1], cfg,
                                          map_capacity=4096, device="cpu")
        for k, v in out.items():
            assert torch.equal(v[b], out_b[k][0]), k
            assert torch.equal(v, meshed[k]), k
        assert torch.equal(fin.ring_clouds[b], fin_b.ring_clouds[0])
    with pytest.raises(ValueError, match="does not divide"):
        tms.batch_odometry(scans, masks, cfg, map_capacity=4096,
                           mesh=tdist.make_mesh(3, device="cpu"))


@pytest.mark.slow
def test_batch_odometry_tracks_all_sequences():
    """`tests/test_multi_sequence.py::test_batch_odometry_tracks_all_sequences` on the
    port, on a 4-slot mesh."""
    B, F, N = 4, 12, 2048
    scans, masks, gts = sequences(B, F, N, 10, laps=0.1, radius=lambda b: 30.0 + 2 * b)
    cfg = ScanMatcherConfig(max_scan_accumulate_num=10,
                            ndt=NdtConfig(resolution=2.0, max_iterations=32))
    final, outs = tms.batch_odometry(scans, masks, cfg, map_capacity=16384,
                                     mesh=tdist.make_mesh(4, axis="seq", device="cpu"))
    poses = outs["pose"].numpy()
    for b in range(B):
        ate = ate_rmse(poses[b], gts[b], align=False)
        travelled = np.sum(np.linalg.norm(np.diff(gts[b][:, :3, 3], axis=0), axis=1))
        assert ate < max(0.05 * travelled, 0.35), f"seq {b}: ATE {ate:.3f} over {travelled:.1f} m"
    assert (final.kf_count.numpy() >= 2).all()
    assert outs["is_keyframe"].numpy()[:, 0].all()


# --- batch_slam ------------------------------------------------------------------------------


def _check_slam(results, gts, B):
    total = 0
    for b, res in enumerate(results):
        kf = res["keyframe_frame_indices"]
        assert res["keyframe_poses"].shape[0] == kf.shape[0] >= 5
        ate_opt = ate_rmse(res["keyframe_poses"], gts[b][kf], align=False)
        ate_odom = ate_rmse(res["odometry_poses"][kf], gts[b][kf], align=False)
        assert ate_opt <= ate_odom * 1.2 + 0.05, f"seq {b}: {ate_opt} vs {ate_odom}"
        total += res["num_loop_closures"]
    assert len(results) == B and total >= 1, "no loop closures"
    return total


def test_batch_slam_closes_loops_fast():
    """The fast closed-loop case: one 40-frame, 1.1-lap sequence (radius 14 m, ~2.4 m a
    frame, 2,048 points) through `batch_slam` on a 1-slot mesh with the loop gates cut to
    its size (50 m of travel, a 5-keyframe submap half-window): loops are accepted and
    the optimized keyframe ATE is no worse than the odometry's (the reference test's
    bound)."""
    scans, masks, gts = sequences(1, 40, 2048, 20, laps=1.1, radius=14.0)
    results = tms.batch_slam(
        scans, masks, ScanMatcherConfig(max_scan_accumulate_num=10,
                                        ndt=NdtConfig(resolution=2.0)),
        graph_cfg=GraphSlamConfig(accumulate_distance_threshold=50.0,
                                  search_key_frame_num=5),
        capacity=CapacityConfig(raw_points=2048, filtered_points=2048, keyframe_points=2048,
                                loop_submap_points=16384, max_keyframes=64,
                                voxel_capacity=16384, max_loop_factors=8),
        map_capacity=8192, mesh=tdist.make_mesh(1, axis="seq", device="cpu"),
        loop_every_keyframes=4)
    assert _check_slam(results, gts, 1) >= 1
    assert results[0]["odometry_poses"].shape == (40, 4, 4)


@pytest.mark.slow
def test_batch_slam_four_sequences_with_loops():
    """`tests/test_multi_sequence.py::test_batch_slam_four_sequences_with_loops` on the
    port, on a 4-slot mesh, and against the reference's run: the same loop decisions."""
    B, F, N = 4, 90, 4096
    scans, masks, gts = sequences(B, F, N, 20, laps=1.1, radius=lambda b: 30.0 + b)
    cap = dict(raw_points=N, filtered_points=N, keyframe_points=N, loop_submap_points=32768,
               max_keyframes=128, voxel_capacity=16384, max_loop_factors=8)
    results = tms.batch_slam(
        scans, masks, ScanMatcherConfig(max_scan_accumulate_num=10,
                                        ndt=NdtConfig(resolution=2.0)),
        graph_cfg=GraphSlamConfig(), capacity=CapacityConfig(**cap), map_capacity=16384,
        mesh=tdist.make_mesh(4, axis="seq", device="cpu"), loop_every_keyframes=4)
    _check_slam(results, gts, B)
    from lidar_graph_slam_tpu.core.config import CapacityConfig as JCap
    from lidar_graph_slam_tpu.core.config import GraphSlamConfig as JGraph

    ref = jms.batch_slam(
        scans, masks, JScanMatcherConfig(max_scan_accumulate_num=10,
                                         ndt=JNdtConfig(resolution=2.0)),
        graph_cfg=JGraph(), capacity=JCap(**cap), map_capacity=16384,
        mesh=jdist.make_mesh(4, axis="seq"), loop_every_keyframes=4)
    for t, j in zip(results, ref):
        assert t["num_loop_closures"] == j["num_loop_closures"]
        assert [(r["candidate"], r["accepted"]) for r in t["loop_log"]] == [
            (r["candidate"], r["accepted"]) for r in j["loop_log"]]
