"""The port's mesh paths (`lidar_graph_slam_tpu_torch/parallel/distributed.py`) against the
JAX package's on the same numpy inputs, on 8 slots each: the port's CPU mesh
(`make_mesh(8, device="cpu")`) and the reference's 8 virtual CPU devices.

Tolerances: batched ICP and NDT transforms 1e-4 with converged exact per item
(`tests/test_torch_icp.py`, `tests/test_torch_ndt.py`), NDT iterations exact, ICP's within
one (its 1e-6 epsilon stop sits at float32 noise: 2 of the 8 items stop one iteration
apart; the reference's own test bounds only the error to the truth, 0.1 m), and each item
equal to the single-item call bit for bit; the distributed chain step 5e-4 against the reference's
(`tests/test_distributed.py:77`) and against the port's single-device step; the
collectives exact.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core import se3 as jse3
from lidar_graph_slam_tpu.core.pointcloud import PointCloud as JPointCloud
from lidar_graph_slam_tpu.graph import solver as jsolver
from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops.neighbors import build_hash_grid as jbuild_hash_grid
from lidar_graph_slam_tpu.ops.voxel import build_ndt_map as jbuild_ndt_map
from lidar_graph_slam_tpu.parallel import distributed as jdist
from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.graph import solver as tsolver
from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid
from lidar_graph_slam_tpu_torch.ops.voxel import NdtVoxelMap, build_ndt_map
from lidar_graph_slam_tpu_torch.parallel import distributed as tdist
from lidar_graph_slam_tpu_torch.registration.icp import icp_align
from lidar_graph_slam_tpu_torch.registration.ndt import ndt_align
from tests.test_torch_solver import _to_torch

B = 8


@pytest.fixture(scope="module")
def meshes():
    return jdist.make_mesh(8), tdist.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def batch():
    """`tests/test_distributed.py`'s batch: one 4,096-point target and 8 sources, each
    the target's world rescanned and moved by a random small twist."""
    rng = np.random.default_rng(2)
    world = make_world(rng, extent=30.0, density=2.0)
    pose = np.eye(4, dtype=np.float32)
    target = simulate_scan(world, pose, rng, max_points=4096, noise=0.01)
    tc = JPointCloud.from_array(target, capacity=4096)
    srcs, msks = [], []
    for _ in range(B):
        sc = JPointCloud.from_array(simulate_scan(world, pose, rng, max_points=4096,
                                                  noise=0.01), capacity=4096)
        xi = np.concatenate([rng.normal(size=3) * 0.02,
                             rng.normal(size=3) * 0.2]).astype(np.float32)
        T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
        pts, m = np.asarray(sc.points), np.asarray(sc.mask)
        srcs.append(np.where(m[:, None], pts @ T[:3, :3].T + T[:3, 3], pts))
        msks.append(m)
    inits = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    return (np.array(tc.points), np.array(tc.mask), np.stack(srcs).astype(np.float32),
            np.stack(msks), inits)


def _assert_results(t, j, singles, iteration_slack=0):
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert np.abs(t.iterations.numpy() - np.asarray(j.iterations)).max() <= iteration_slack
    np.testing.assert_array_equal(t.converged.numpy(), np.asarray(j.converged))
    for b, s in enumerate(singles):
        assert torch.equal(t.transform[b], s.transform)
        assert int(t.iterations[b]) == int(s.iterations)


def test_batched_icp_matches_reference_and_single(meshes, batch):
    jmesh, tmesh = meshes
    tp, tm, srcs, msks, inits = batch
    kw = dict(max_correspondence_distance=2.0, max_iterations=30)
    j = jdist.batched_icp(jmesh, jbuild_hash_grid(jnp.asarray(tp), jnp.asarray(tm), 2.0),
                          jnp.asarray(srcs), jnp.asarray(msks), jnp.asarray(inits), **kw)
    grid = build_hash_grid(torch.as_tensor(tp), torch.as_tensor(tm), 2.0)
    t = tdist.batched_icp(tmesh, grid, torch.as_tensor(srcs), torch.as_tensor(msks),
                          torch.as_tensor(inits), **kw)
    singles = [icp_align(grid, torch.as_tensor(srcs[b]), torch.as_tensor(msks[b]),
                         torch.as_tensor(inits[b]), **kw) for b in range(B)]
    assert t.transform.shape == (B, 4, 4)
    _assert_results(t, j, singles, iteration_slack=1)


def test_batched_ndt_matches_reference_and_single(meshes, batch):
    jmesh, tmesh = meshes
    tp, tm, srcs, msks, inits = batch
    kw = dict(max_iterations=20)
    j = jdist.batched_ndt(jmesh, jbuild_ndt_map(jnp.asarray(tp), jnp.asarray(tm),
                                                jnp.float32(2.0), capacity=4096),
                          jnp.asarray(srcs), jnp.asarray(msks), jnp.asarray(inits), **kw)
    vm = build_ndt_map(torch.as_tensor(tp), torch.as_tensor(tm), 2.0, capacity=4096)
    t = tdist.batched_ndt(tmesh, vm, torch.as_tensor(srcs), torch.as_tensor(msks),
                          torch.as_tensor(inits), **kw)
    singles = [ndt_align(vm, torch.as_tensor(srcs[b]), torch.as_tensor(msks[b]),
                         torch.as_tensor(inits[b]), **kw) for b in range(B)]
    _assert_results(t, j, singles)
    np.testing.assert_array_equal(t.num_inliers.numpy(), np.asarray(j.num_inliers))


def test_batched_registration_refuses_a_batch_that_does_not_divide(meshes, batch):
    tp, tm, srcs, msks, inits = batch
    grid = build_hash_grid(torch.as_tensor(tp), torch.as_tensor(tm), 2.0)
    with pytest.raises(ValueError, match="does not divide"):
        tdist.batched_icp(meshes[1], grid, torch.as_tensor(srcs[:3]),
                          torch.as_tensor(msks[:3]), torch.as_tensor(inits[:3]))


def _chain_graph():
    """`tests/test_distributed.py`'s graph: a 20-pose drifted chain in a 32-capacity
    graph and one loop factor (0, 19) at information 1e4."""
    rng = np.random.default_rng(5)
    g = jsolver.init_graph(32, 4, (1e-4,) * 6)
    T = np.eye(4, dtype=np.float32)
    g = jsolver.graph_add_keyframe(g, jnp.asarray(T), jnp.eye(4))
    for _ in range(1, 20):
        xi = np.concatenate([rng.normal(size=3) * 0.01, [1.0, 0, 0]]).astype(np.float32)
        meas = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
        T = T @ meas
        g = jsolver.graph_add_keyframe(g, jnp.asarray(T), jnp.asarray(meas))
    return jsolver.graph_add_loop(
        g, jnp.asarray(0), jnp.asarray(19), jnp.asarray(np.eye(4, dtype=np.float32)),
        jnp.full((6,), 1e4, jnp.float32))


@pytest.mark.parametrize("slots", [8, 3, 1])
def test_distributed_graph_step_matches_reference_and_single(meshes, slots):
    """At 8 slots against the JAX package's step (4 poses a slot); at 3 (a ragged last
    shard: 11, 11, 10 factors) and 1 against the single-device step."""
    jg = _chain_graph()
    g = _to_torch(jg)
    poses = tdist.distributed_graph_step(tdist.make_mesh(slots, device="cpu"), g,
                                         damping=1e-4).numpy()
    if slots == 8:
        ref = np.asarray(jdist.distributed_graph_step(meshes[0], jg, damping=1e-4))
        np.testing.assert_allclose(poses[:20], ref[:20], atol=5e-4)
    delta = tsolver._solve_step(g, g.poses, torch.tensor(1e-4))
    single = (g.poses @ se3.se3_exp(delta)).numpy()
    np.testing.assert_allclose(poses[:20], single[:20], atol=5e-4)
    assert float(tsolver.graph_cost(g, torch.as_tensor(poses))) < float(
        tsolver.graph_cost(g, g.poses))


def test_local_chain_blocks_sum_to_the_assembled_chain():
    """The slots' chain blocks, summed, are the single-device assembly's chain part (no
    prior, no damping): each factor lands in exactly one shard."""
    g = _to_torch(_chain_graph())
    K = g.poses.shape[0]
    parts = [tdist._local_chain_blocks(g.poses, g.odom_meas, g.pose_mask, g.odom_info,
                                       lo, 5, K) for lo in range(0, K, 5)]
    D, U, b = (sum(p[i] for p in parts) for i in range(3))
    whole = tdist._local_chain_blocks(g.poses, g.odom_meas, g.pose_mask, g.odom_info, 0, K, K)
    for x, y in zip((D, U, b), whole):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-3)


def test_collectives_and_mesh():
    mesh = tdist.make_mesh(4, axis="seq", device="cpu")
    assert mesh.size == 4 and mesh.axis == "seq"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert tdist.make_mesh(device="cpu").size == 1
    parts = [torch.tensor([1e8, float(i)]) for i in range(4)]
    out = tdist.psum(mesh, parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]  # slot 0 first, in slot order
    assert len(out) == 4 and all(torch.equal(o, want) for o in out)
    pairs = tdist.psum(mesh, [(p, 2 * p) for p in parts])
    assert torch.equal(pairs[2][1], 2 * want)
    rot = tdist.ppermute(mesh, [torch.tensor(i) for i in range(4)])
    assert [int(x) for x in rot] == [3, 0, 1, 2]


def test_tree_helpers():
    vm = build_ndt_map(torch.randn(512, 3) * 4, torch.ones(512, dtype=torch.bool), 2.0,
                       capacity=256)
    moved = tdist.tree_to((vm, [torch.zeros(2)], {"k": None}, 3), "cpu")
    assert isinstance(moved[0], NdtVoxelMap) and torch.equal(moved[0].inv_leaf, vm.inv_leaf)
    assert moved[2] == {"k": None} and moved[3] == 3
    stacked = tdist.stack_pytrees([(vm, torch.ones(3)), (vm, torch.zeros(3))])
    assert stacked[0].table.shape == (2,) + vm.table.shape
    assert stacked[1].shape == (2, 3)
    assert dataclasses.is_dataclass(stacked[0])
