"""The port's Schur-complement distributed solve (`lidar_graph_slam_tpu_torch/parallel/
schur.py`) against the JAX package's on the same inputs, at the same slot count (8: the
port's CPU mesh, the reference's 8 virtual CPU devices — the decomposition depends on the
partition), against a dense solve and against the single-device solver.

Tolerances are `tests/test_schur.py`'s: rtol 2e-3 / atol 2e-4 for the solves, 5e-3 on the
poses of one damped-GN step on its deliberately ill-conditioned graph (information up to
1e8), for the port against the JAX package too: there the JAX package's own Schur and
single-device steps differ by 1.7e-3 and the port's from the JAX package's by 1.5e-3
(float32 eliminations of a 1e8-information system in different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.graph import solver as jsolver
from lidar_graph_slam_tpu.parallel import distributed as jdist
from lidar_graph_slam_tpu.parallel import schur as jschur
from lidar_graph_slam_tpu_torch.graph import solver as tsolver
from lidar_graph_slam_tpu_torch.parallel import distributed as tdist
from lidar_graph_slam_tpu_torch.parallel import schur as tschur
from tests.test_schur import dense_solve, random_spd_tridiag
from tests.test_torch_solver import _optimize_fixture, _to_torch


@pytest.fixture(scope="module")
def meshes():
    return jdist.make_mesh(8, axis="pose"), tdist.make_mesh(8, axis="pose", device="cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("K,M", [(32, 3), (64, 5), (16, 1)])
def test_schur_tridiag_matches_reference_dense_and_single(meshes, rng, K, M):
    jmesh, tmesh = meshes
    D, U = random_spd_tridiag(rng, K)
    B = jnp.asarray(rng.normal(size=(K, 6, M)).astype(np.float32))
    x = tschur.schur_tridiag_solve(tmesh, _t(D), _t(U), _t(B)).numpy()
    x_ref = np.asarray(jschur.schur_tridiag_solve(jmesh, D, U, B))
    np.testing.assert_allclose(x, x_ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(x, dense_solve(D, U, B), rtol=2e-3, atol=2e-4)
    x_seq = tsolver._tridiag_solve(_t(D), _t(U)[: K - 1], _t(B)).numpy()
    np.testing.assert_allclose(x, x_seq, rtol=2e-3, atol=2e-4)


def test_schur_keeps_the_divisibility_assert(meshes, rng):
    D, U = random_spd_tridiag(rng, 12)
    with pytest.raises(AssertionError, match="not divisible"):
        tschur.schur_tridiag_solve(meshes[1], _t(D), _t(U), torch.zeros((12, 6, 1)))


def _schur_graph():
    """`tests/test_schur.py`'s graph: a 24-pose chain in a 32-capacity graph with one
    loop at information 1e4 (odometry at 1e4 as well)."""
    from lidar_graph_slam_tpu.core import se3

    rng = np.random.default_rng(9)
    g = jsolver.init_graph(32, 4, (1e-4,) * 6)
    T = np.eye(4, dtype=np.float32)
    g = jsolver.graph_add_keyframe(g, jnp.asarray(T), jnp.eye(4))
    for _ in range(1, 24):
        xi = np.concatenate([rng.normal(size=3) * 0.01, [1.0, 0, 0.1]]).astype(np.float32)
        meas = np.asarray(se3.se3_exp(jnp.asarray(xi)))
        T = T @ meas
        g = jsolver.graph_add_keyframe(g, jnp.asarray(T), jnp.asarray(meas))
    return jsolver.graph_add_loop(
        g, jnp.asarray(2), jnp.asarray(23), jnp.asarray(np.eye(4, dtype=np.float32)),
        jnp.full((6,), 1e4, jnp.float32))


def test_schur_graph_step_matches_reference_and_single(meshes):
    jmesh, tmesh = meshes
    jg = _schur_graph()
    g = _to_torch(jg)
    poses = tschur.schur_graph_step(tmesh, g, damping=1e-4).numpy()
    ref = np.asarray(jschur.schur_graph_step(jmesh, jg, damping=1e-4))
    np.testing.assert_allclose(poses[:24], ref[:24], atol=5e-3)
    from lidar_graph_slam_tpu_torch.core import se3

    delta = tsolver._solve_step(g, g.poses, torch.tensor(1e-4))
    single = (g.poses @ se3.se3_exp(delta)).numpy()
    np.testing.assert_allclose(poses[:24], single[:24], atol=5e-3)
    assert float(tsolver.graph_cost(g, torch.as_tensor(poses))) < float(
        tsolver.graph_cost(g, g.poses))


@pytest.mark.parametrize("solver", ["schur", "chain"])
@pytest.mark.parametrize("name", ["loop_closure", "reference_weighting"])
def test_mesh_optimize_matches_reference_and_single(meshes, solver, name):
    """The mesh LM (both step kinds) on `tests/test_torch_solver.py`'s drifting square
    (13 poses in a 16-capacity graph: 2 per slot; loop information 1e8 and 1e4): the
    single-device optimum of the port and of the JAX package to that file's 2e-3, and the
    loop closes the drift at the last pose. Against the JAX package's own mesh LM: the
    chain steps to 2e-3; the Schur steps to `tests/test_pipeline_mesh.py`'s 0.02 at
    information 1e4. At 1e8 the JAX package's Schur LM stops 0.22-0.35 from its own
    single-device optimum (a rejected float32 step below the stuck tolerance ends it),
    where the port's lands on it to 1e-6, so that pair is not compared."""
    jmesh = jdist.make_mesh(8)  # the reference's chain step names the "scan" axis
    tmesh = tdist.make_mesh(8, device="cpu")
    jg, iters, last, truth, bound = _optimize_fixture(name, np.random.default_rng(0))
    g = _to_torch(jg)
    out = tdist.mesh_optimize(tmesh, g, max_iterations=iters, solver=solver).poses.numpy()
    np.testing.assert_allclose(out, tsolver.optimize(g, max_iterations=iters).poses.numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(out, np.asarray(jsolver.optimize(jg, max_iterations=iters).poses),
                               atol=2e-3)
    if truth is not None:
        assert np.linalg.norm(out[last, :3, 3] - truth[:3, 3]) < bound
    if solver == "chain" or name == "reference_weighting":
        ref = np.asarray(jdist.mesh_optimize(jmesh, jg, max_iterations=iters,
                                             solver=solver).poses)
        np.testing.assert_allclose(out, ref, atol=2e-3 if solver == "chain" else 0.02)


def test_mesh_optimize_rejects_an_unknown_solver(meshes):
    with pytest.raises(ValueError, match="unknown mesh solver"):
        tdist.mesh_optimize(meshes[1], _to_torch(_schur_graph()), solver="dense")
