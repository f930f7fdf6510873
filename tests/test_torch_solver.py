"""PyTorch port vs the JAX reference: the pose-graph solver and the f64 refinement tier.

Tolerances: the `refine64` copy — bit-equal outputs on the `tests/test_refine64.py` cases
(the same numpy code on the same inputs). `graph_add_*` — every field exact, including
the refused insert at capacity. `graph_cost` — rtol 1e-5; one LM step's twists to 1e-4
of the step's size. The tridiagonal solves (scan K=4, cyclic reduction K=64, blocked
K=2100) — rtol/atol 2e-4, the bound
`tests/test_graph_solver.py` holds the blocked solve to against the scan. `optimize`
(f32 LM) — poses within 2e-3 of the reference's (both stop at the f32 floor, where a
step's size is rounding) and the fixtures' own bounds. The escalation ladder from the
same graph: without the device fallback the poses are bit-equal; with it, within 1e-4
after the f64 tail.
"""

import dataclasses

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core import se3 as jse3
from lidar_graph_slam_tpu.graph import refine64 as jref
from lidar_graph_slam_tpu.graph import solver as jsolver
from lidar_graph_slam_tpu_torch.graph import refine64 as tref
from lidar_graph_slam_tpu_torch.graph import solver as tsolver
from lidar_graph_slam_tpu_torch.utils.state import pose_graph_from_numpy
from tests.test_graph_solver import VAR, chain_graph, random_walk
from tests.test_refine64 import _circle_view, _rand_spd_tridiag

GRAPH_FIELDS = [f.name for f in dataclasses.fields(tsolver.PoseGraph)]


def _arrays(g) -> dict:
    return {name: np.array(getattr(g, name)) for name in GRAPH_FIELDS}


def _to_torch(g) -> tsolver.PoseGraph:
    return pose_graph_from_numpy(_arrays(g))


def _assert_graphs_equal(t, j):
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


# --- the refine64 copy --------------------------------------------------------------------


def _refine_cases():
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.7, size=(64, 6))
    yield "se3", lambda m: (m.se3_exp(xi), m.se3_log(m.se3_exp(xi)), m.adjoint(m.se3_exp(xi)),
                            m.inverse(m.se3_exp(xi)), m.so3_log(m.so3_exp(xi[:, :3])))
    for K, M in ((40, 3), (777, 7), (512, 49)):
        D, U, B = _rand_spd_tridiag(np.random.default_rng(2), K, M)
        yield f"tridiag{K}", lambda m, D=D, U=U, B=B: (m._tridiag_solve64(D, U, B),
                                                       m._thomas64(D, U, B))
    for name, K, L, seed in (("cold", 256, 4, 3), ("no_loops", 64, 0, 5)):
        yield f"refine_{name}", lambda m, K=K, L=L, seed=seed: _refine(m, K, L, seed)


def _refine(m, K, L, seed):
    view, _ = _circle_view(K, L, np.random.default_rng(seed))
    view = m.GraphView(view.poses, view.odom_meas, view.prior_pose, view.odom_info,
                       view.loop_i, view.loop_j, view.loop_meas, view.loop_info,
                       robust_delta=5.0)
    poses, info = m.refine(view, max_iterations=10)
    warm = m.GraphView(poses.astype(np.float32), view.odom_meas, view.prior_pose,
                       view.odom_info, view.loop_i, view.loop_j, view.loop_meas,
                       view.loop_info, robust_delta=5.0)
    poses2, info2 = m.refine(warm, max_iterations=10)
    return poses, poses2, [info[k] for k in ("iterations", "converged", "final_cost")], \
        [info2[k] for k in ("iterations", "converged", "initial_step_norm")]


REFINE_CASES = dict(_refine_cases())


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refine64_copy_equals_reference(case):
    fn = REFINE_CASES[case]
    for a, b in zip(fn(tref), fn(jref)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


# --- graph inserts --------------------------------------------------------------------


def test_graph_add_matches_reference_including_capacity_refusal():
    """The keyframe and loop inserts of `tests/test_loop_gates.py`, one past capacity
    each: refused, count clamped, the last factor untouched — every field equal."""
    jg = jsolver.init_graph(4, 2, VAR)
    tg = tsolver.init_graph(4, 2, VAR)
    _assert_graphs_equal(tg, jg)
    rng = np.random.default_rng(1)
    for k in range(5):  # the fifth is refused
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(size=3)
        Z = np.eye(4, dtype=np.float32)
        Z[0, 3] = float(k)
        jg = jsolver.graph_add_keyframe(jg, jnp.asarray(T), jnp.asarray(Z))
        tg = tsolver.graph_add_keyframe(tg, torch.as_tensor(T), torch.as_tensor(Z))
        _assert_graphs_equal(tg, jg)
    assert int(tg.num_poses) == 4
    for l, (i, j, y) in enumerate(((0, 2, 0.5), (1, 3, -0.5), (0, 3, 9.0))):
        Z = np.eye(4, dtype=np.float32)
        Z[1, 3] = y
        info = np.full(6, 1.0 + 99.0 * (l == 2), np.float32)
        jg = jsolver.graph_add_loop(jg, jnp.asarray(i), jnp.asarray(j), jnp.asarray(Z),
                                    jnp.asarray(info))
        tg = tsolver.graph_add_loop(tg, i, j, torch.as_tensor(Z), torch.as_tensor(info))
        _assert_graphs_equal(tg, jg)
    assert int(tg.num_loops) == 2 and float(tg.loop_info.max()) == 1.0


def test_graph_add_batch_matches_reference():
    """The deferred flush: batches of 3 and 32 rows, partly past a capacity of 40."""
    rng = np.random.default_rng(2)
    jg = jsolver.init_graph(40, 4, VAR)
    tg = tsolver.init_graph(40, 4, VAR)
    for count in (3, 32, 32):
        poses = rng.normal(size=(32, 4, 4)).astype(np.float32)
        odoms = rng.normal(size=(32, 4, 4)).astype(np.float32)
        jg = jsolver.graph_add_keyframes_batch(jg, jnp.asarray(poses), jnp.asarray(odoms),
                                               jnp.asarray(count, jnp.int32))
        tg = tsolver.graph_add_keyframes_batch(tg, torch.as_tensor(poses),
                                               torch.as_tensor(odoms), count)
        _assert_graphs_equal(tg, jg)
    assert int(tg.num_poses) == 40


def test_graph_updates_leave_earlier_graphs_unchanged():
    """Every update returns a new graph, as in the reference: a snapshot taken before
    (the threaded solve's, `GraphBasedSLAM._bucket_graph`) keeps every field."""
    rng = np.random.default_rng(3)
    g0 = tsolver.init_graph(8, 2, VAR)
    g1 = tsolver.graph_add_keyframes_batch(g0, torch.as_tensor(np.stack(random_walk(rng, 4))),
                                           torch.eye(4).repeat(4, 1, 1), 4)
    before = {name: getattr(g1, name).clone() for name in GRAPH_FIELDS}
    g2 = tsolver.graph_add_loop(g1, 0, 3, torch.eye(4), torch.ones(6))
    g2 = tsolver.graph_add_keyframe(g2, torch.eye(4), torch.eye(4))
    g2 = tsolver.set_poses(g2, np.zeros((5, 4, 4)))
    for name in GRAPH_FIELDS:
        assert torch.equal(getattr(g1, name), before[name]), name
    assert int(g0.num_poses) == 0 and int(g2.num_poses) == 5 and int(g2.num_loops) == 1


# --- cost, linear algebra, f32 LM -----------------------------------------------------------


def test_graph_cost_and_linearization_match_reference(rng):
    poses = random_walk(rng, 12)
    jg = chain_graph(poses, K=16, L=4)
    Z = np.asarray(jse3.between(jnp.asarray(poses[0]), jnp.asarray(poses[-1])))
    Z = Z @ np.asarray(jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.02, 0.3, -0.2, 0.1])))
    jg = jsolver.graph_add_loop(jg, jnp.asarray(0), jnp.asarray(11), jnp.asarray(Z),
                                jnp.full((6,), 1e3, jnp.float32))
    # Odometry information 1e4 rather than the reference's 1e8: at 1e8 the f32 normal
    # equations are conditioned so that either library's rounding moves the step by
    # ~0.5% of its size, which says nothing about the port.
    jg = jg.replace(odom_info=jnp.full((6,), 1e4, jnp.float32))
    tg = _to_torch(jg)
    noisy = np.array(jg.poses)
    noisy[1:12, :3, 3] += rng.normal(scale=0.1, size=(11, 3)).astype(np.float32)
    jc = float(jax.jit(jsolver.graph_cost)(jg, jnp.asarray(noisy)))
    tc = float(tsolver.graph_cost(tg, torch.as_tensor(noisy)))
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    jdelta = jax.jit(jsolver._solve_step)(jg, jnp.asarray(noisy), jnp.asarray(1e-4, jnp.float32))
    tdelta = tsolver._solve_step(tg, torch.as_tensor(noisy), torch.tensor(1e-4))
    scale = float(np.abs(np.asarray(jdelta)).max())
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("K", [4, 64, 2100])
def test_tridiag_solve_branches_match_reference(K):
    """K = 4 takes the scan, 64 cyclic reduction, 2100 the padded blocked solve."""
    rng = np.random.default_rng(K)
    D, U, B = (x.astype(np.float32) for x in _rand_spd_tridiag(rng, K, 7))
    j = jax.jit(jsolver._tridiag_solve)(jnp.asarray(D), jnp.asarray(U), jnp.asarray(B))
    t = tsolver._tridiag_solve(torch.as_tensor(D), torch.as_tensor(U), torch.as_tensor(B))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)
    x64 = jref._thomas64(D.astype(np.float64), U.astype(np.float64), B.astype(np.float64))
    np.testing.assert_allclose(t.numpy(), x64, rtol=2e-4, atol=2e-4)


def _loop_square_graph(var, info):
    """The drifting square of `test_loop_closure_redistributes_drift` /
    `test_reference_weighting_partial_correction`."""
    n = 13
    true_poses, T = [], np.eye(4, dtype=np.float32)
    for k in range(n):
        true_poses.append(T.copy())
        yaw = np.pi / 2 if (k + 1) % 3 == 0 else 0.0
        T = T @ np.asarray(jse3.se3_exp(jnp.asarray([0, 0, yaw, 2.0, 0, 0], dtype=jnp.float32)))
    drift = np.asarray(jse3.se3_exp(jnp.asarray([0, 0, 0.015, 0, 0, 0], dtype=jnp.float32)))
    g = jsolver.init_graph(16, 4, var)
    est = np.eye(4, dtype=np.float32)
    g = jsolver.graph_add_keyframe(g, jnp.asarray(est), jnp.eye(4))
    for k in range(1, n):
        meas = np.asarray(jse3.between(jnp.asarray(true_poses[k - 1]),
                                       jnp.asarray(true_poses[k]))) @ drift
        est = est @ meas
        g = jsolver.graph_add_keyframe(g, jnp.asarray(est), jnp.asarray(meas))
    Z = jse3.between(jnp.asarray(true_poses[0]), jnp.asarray(true_poses[-1]))
    g = jsolver.graph_add_loop(g, jnp.asarray(0), jnp.asarray(n - 1), Z,
                               jnp.full((6,), info, jnp.float32))
    return g, true_poses


def _optimize_fixture(name, rng):
    if name == "loop_closure":
        g, truth = _loop_square_graph((1e-4,) * 6, 1e8)
        return g, 20, 12, truth[-1], 0.05
    if name == "reference_weighting":
        g, truth = _loop_square_graph(VAR, 1e4)
        return g, 20, 12, None, None
    poses = random_walk(rng, 8)
    g = chain_graph(poses, K=12)
    if name == "consistent_chain":
        return g, 5, 7, poses[-1], 1e-4
    noisy = np.stack(poses).copy()
    for k in range(1, 8):
        xi = np.concatenate([rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.2])
        noisy[k] = noisy[k] @ np.asarray(jse3.se3_exp(jnp.asarray(xi.astype(np.float32))))
    g = g.replace(poses=g.poses.at[:8].set(jnp.asarray(noisy)))
    return g, 15, 7, poses[-1], 1e-3  # perturbed_chain


@pytest.mark.parametrize("name", ["consistent_chain", "perturbed_chain", "loop_closure",
                                  "reference_weighting"])
def test_optimize_matches_reference(rng, name):
    jg, iters, last, truth, bound = _optimize_fixture(name, rng)
    tg = _to_torch(jg)
    j = jsolver.optimize(jg, max_iterations=iters)
    t = tsolver.optimize(tg, max_iterations=iters)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), atol=2e-3)
    if truth is not None:
        assert np.linalg.norm(t.poses[last, :3, 3].numpy() - truth[:3, 3]) < bound
    # The prior anchors pose 0; slots past the active poses stay identity.
    np.testing.assert_allclose(t.poses[0].numpy(), np.asarray(jg.poses[0]), atol=1e-4)
    n = int(tg.num_poses)
    np.testing.assert_array_equal(t.poses[n:].numpy(), np.asarray(jg.poses[n:]))


def test_optimize_at_blocked_capacity():
    """optimize() on a 2080-capacity graph (>= 2048, % 64 != 0) solves, as in the
    reference's `test_optimize_non_power_of_two_capacity`."""
    poses = random_walk(np.random.default_rng(0), 6)
    tg = _to_torch(chain_graph(poses, K=2080))
    out = tsolver.optimize(tg, max_iterations=3)
    assert torch.isfinite(out.poses).all()
    np.testing.assert_allclose(out.poses[:6].numpy(), np.stack(poses), atol=1e-3)


# --- the escalation ladder -------------------------------------------------------------


def _circle_graph(K=128, L=2, seed=6, capacity=256):
    view, _ = _circle_view(K, L, np.random.default_rng(seed))
    g = jsolver.init_graph(capacity, 8, (1e-6,) * 3 + (1e-8, 1e-8, 1e-6))
    for k in range(K):
        g = jsolver.graph_add_keyframe(g, jnp.asarray(view.poses[k], jnp.float32),
                                       jnp.asarray(view.odom_meas[k], jnp.float32))
    for l in range(view.loop_i.size):
        g = jsolver.graph_add_loop(
            g, jnp.asarray(int(view.loop_i[l])), jnp.asarray(int(view.loop_j[l])),
            jnp.asarray(view.loop_meas[l], jnp.float32),
            jnp.asarray(view.loop_info[l], jnp.float32))
    return g


def test_solve_incremental_cold_and_warm_match_reference():
    jg = _circle_graph()
    tg = _to_torch(jg)
    jg1, jinfo1 = jsolver.solve_incremental(jg)
    tg1, tinfo1 = tsolver.solve_incremental(tg)
    assert tinfo1 == jinfo1 and tinfo1["converged"] and not tinfo1["device_lm"]
    np.testing.assert_array_equal(tg1.poses.numpy(), np.asarray(jg1.poses))
    jg2, jinfo2 = jsolver.solve_incremental(jg1)
    tg2, tinfo2 = tsolver.solve_incremental(tg1)
    assert tinfo2 == jinfo2 and tinfo2["iterations"] == 1 and not tinfo2["device_lm"]
    np.testing.assert_array_equal(tg2.poses.numpy(), np.asarray(jg2.poses))
    # The empty graph returns at once.
    empty = tsolver.init_graph(64, 4, (1e-6,) * 6)
    same, info = tsolver.solve_incremental(empty)
    assert same is empty and info["converged"] and info["iterations"] == 0


def test_escalate_f64_device_fallback_matches_reference():
    """A perturbed start (0.05 rad / 1 m per pose) that two f64 iterations cannot finish
    forces the device f32 LM; the f64 tail then finishes both packages at the same
    optimum."""
    jg = _circle_graph()
    rng = np.random.default_rng(0)
    xi = np.concatenate([rng.normal(scale=0.05, size=(128, 3)),
                         rng.normal(scale=1.0, size=(128, 3))], axis=1).astype(np.float32)
    jg = jg.replace(poses=jg.poses.at[:128].set(jg.poses[:128] @ jse3.se3_exp(jnp.asarray(xi))))
    tg = _to_torch(jg)
    kw = dict(probe_iterations=1, refine_max_iterations=1, tail_iterations=8)
    jcalls, tcalls = [], []

    def jlm(p):
        jcalls.append(1)
        gd = jg.replace(poses=jg.poses.at[: p.shape[0]].set(jnp.asarray(p, jnp.float32)))
        return np.asarray(jsolver.optimize(gd, max_iterations=30).poses,
                          np.float64)[: p.shape[0]]

    def tlm(p):
        tcalls.append(1)
        gd = tsolver.optimize(tsolver.set_poses(tg, p), max_iterations=30)
        return gd.poses[: p.shape[0]].numpy().astype(np.float64)

    jp, jinfo = jsolver.escalate_f64(jref.GraphView.from_device_graph(jg), jlm, **kw)
    tp, tinfo = tsolver.escalate_f64(tref.GraphView.from_device_graph(tg), tlm, **kw)
    assert jcalls == tcalls == [1] and jinfo["device_lm"] and tinfo["device_lm"]
    assert tinfo["converged"] == jinfo["converged"]
    np.testing.assert_allclose(tp, jp, atol=1e-4)
