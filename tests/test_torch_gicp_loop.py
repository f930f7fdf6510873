"""The GICP loop on the device (`ops.kernels.gicp_align_loop`, the port of the reference's
`lax.while_loop` in `registration/gicp.py:gicp_align`) through its plain PyTorch version
on the CPU; the kernel itself (`gicp_iteration`, `csrc/gicp_loop.cu`) is tested on a card
by `tests/test_torch_cuda.py`.

- The plain loop run to `max_iterations` with its carry frozen after `done` (what the
  kernel loop does on the card) equals the early-stop run bit for bit in all five carry
  fields.
- `gicp_align` and `make_gicp_matcher`'s align make one loop call an alignment.
- The frozen plain loop against the JAX `gicp_align` on the fixtures of
  `tests/test_torch_gicp.py` (the reference's and the port's own target and
  covariances; reciprocal off and on; the max-iterations stop; a source with no match):
  the transform to atol 1e-4, iterations and converged equal, inliers within 1%, fitness
  to rtol 1e-3 — the bounds `tests/test_torch_gicp.py` holds `gicp_align` to.
- One launch's carry update (`gicp_carry_update`: the step in the kernel's last block)
  against a float64 numpy oracle of the JAX body's step: T to rtol 1e-5 / atol 1e-6,
  fitness to rtol 1e-6, done, iterations and inliers exact; the inlier floor of 6, a
  singular system and a step far past NDT's cap (GICP takes it whole).
- The wrapper takes the plain version for CPU tensors, and refuses other devices and a
  `neighborhood` or `bucket_cap` the kernel does not take.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.ops import neighbors as jnb
from lidar_graph_slam_tpu.registration import gicp as jgicp
from lidar_graph_slam_tpu_torch.core.config import GicpConfig as TGicpConfig
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
from lidar_graph_slam_tpu_torch.registration import gicp as tgicp
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult
from lidar_graph_slam_tpu_torch.utils.state import gicp_target_from_numpy
from tests.test_registration import perturbation
from tests.test_torch_gicp import (  # noqa: F401  (fixtures)
    GICP_CASES,
    _assert_results_close,
    _moved,
    _t,
    _target_arrays,
    gicp_problem,
    one_intra_op_thread,
    scans,
)
from tests.test_torch_ndt_loop import _oracle_se3_exp, _singular_h, _spd

FIELDS = ("T", "done", "iterations", "fitness", "inliers")


def _source(g, case: str):
    """(source points, source covariances as the reference takes them, T_true, whether
    the covariances are rotated with the cloud) of a `GICP_CASES` case, or of "no_match":
    the reciprocal_off source 500 m away."""
    c = GICP_CASES["reciprocal_off" if case == "no_match" else case]
    T_true = perturbation(seed=c["seed"], rot=c["rot"], trans=c["trans"])
    src = _moved(g["spts"], g["smask"], T_true)
    R = T_true[:3, :3]
    jcovs = np.einsum("ij,njk,lk->nil", R, g["jc"], R) if c["rotate_covs"] else g["jc"]
    if case == "no_match":
        src = (src + np.float32(500.0)).astype(np.float32)
    return src, jcovs.astype(np.float32), T_true, c["rotate_covs"]


def _loop_args(g, src, covs, target, max_iterations, reciprocal=False,
               transform_epsilon=0.01):
    src_t, mask_t = _t(src, g["smask"])
    grid = tnb.build_hash_grid(src_t, mask_t, 2.0) if reciprocal else None
    return (target, src_t, mask_t, torch.as_tensor(covs), torch.eye(4), 4.0,
            transform_epsilon, torch.tensor(1e-6), max_iterations, 32, 7, grid)


def _result(carry, max_iterations) -> RegistrationResult:
    """The loop's carry as `gicp_align` returns it."""
    T, done, iters, fitness, n_inl = carry
    converged = (done | (iters >= max_iterations)) & (n_inl >= 6) & torch.isfinite(T).all()
    return RegistrationResult(transform=T, converged=converged, iterations=iters,
                              fitness=fitness, num_inliers=n_inl)


# (case, reciprocal, max_iterations, transform_epsilon): the last two never converge by
# epsilon (the max-iterations stop) or find nothing to match.
FROZEN_CASES = [("recover", False, 16, 0.01), ("reciprocal_on", True, 16, 0.01),
                ("reciprocal_off", False, 2, 1e-12), ("no_match", False, 16, 0.01)]


@pytest.mark.parametrize("case,reciprocal,max_iterations,eps", FROZEN_CASES,
                         ids=[c[0] + ("-2" if c[2] == 2 else "") for c in FROZEN_CASES])
def test_frozen_loop_equals_early_stop(gicp_problem, case, reciprocal, max_iterations, eps):
    g = gicp_problem
    src, covs, *_ = _source(g, case)
    args = _loop_args(g, src, torch.as_tensor(covs), g["tt"], max_iterations, reciprocal, eps)
    early = tk.gicp_align_loop_plain(*args, stop_early=True)
    frozen = tk.gicp_align_loop_plain(*args, stop_early=False)
    for name, a, b in zip(FIELDS, early, frozen):
        assert torch.equal(a, b), name
    iters, done = int(early[2]), bool(early[1])
    if max_iterations == 2:
        assert iters == 2 and not done
    else:
        assert done and 0 < iters < max_iterations
    if case == "no_match":
        assert iters == 1 and int(early[4]) == 0
        assert torch.equal(early[0], torch.eye(4))


@pytest.mark.parametrize("use_reciprocal", [False, True])
def test_gicp_align_makes_one_loop_call(gicp_problem, monkeypatch, use_reciprocal):
    """`gicp_align` through `make_gicp_matcher`'s align (which builds the source grid when
    reciprocal) is one `gicp_align_loop` call with the configured gate, epsilon,
    iterations and query, and returns that call's carry."""
    g = gicp_problem
    src, *_ = _source(g, "reciprocal_off")
    calls = []
    loop = tk.gicp_align_loop
    monkeypatch.setattr(tk, "gicp_align_loop",
                        lambda *a: calls.append(a) or loop(*a))
    cfg = TGicpConfig(use_reciprocal=use_reciprocal)
    _, align = tgicp.make_gicp_matcher(cfg)
    res = align(g["tt"], *_t(src, g["smask"]), torch.eye(4), g["tc"])
    assert len(calls) == 1
    a = calls[0]
    assert a[5] == cfg.max_correspondence_distance ** 2
    assert (a[6], a[8], a[9], a[10]) == (cfg.transform_epsilon, cfg.max_iterations, 32, 7)
    assert (a[11] is not None) == use_reciprocal
    assert bool(res.converged) and int(res.num_inliers) > 1000
    want = tk.gicp_align_loop_plain(*a)
    for name, x, y in zip(FIELDS, (res.transform, None, res.iterations, res.fitness,
                                   res.num_inliers), want):
        if x is not None:
            assert torch.equal(x, y), name


# case -> (GICP_CASES source, reciprocal, max_iterations, transform_epsilon)
REFERENCE_CASES = {
    "recover": ("recover", False, 16, 0.01),
    "reciprocal_off": ("reciprocal_off", False, 16, 0.01),
    "reciprocal_on": ("reciprocal_on", True, 16, 0.01),
    "max_iterations_1": ("reciprocal_off", False, 1, 1e-12),
    "no_match": ("no_match", False, 16, 0.01),
}


@pytest.mark.parametrize("inputs", ["reference", "own"])
@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_frozen_plain_loop_matches_reference(gicp_problem, case, inputs):
    g = gicp_problem
    source, reciprocal, max_iterations, eps = REFERENCE_CASES[case]
    src, jcovs, T_true, rotate_covs = _source(g, source)
    kw = dict(max_correspondence_distance=2.0, max_iterations=max_iterations,
              transform_epsilon=eps)
    if reciprocal:
        kw.update(reciprocal=True, source_grid=jnb.build_hash_grid(
            jnp.asarray(src), jnp.asarray(g["smask"]), 2.0))
    j = jgicp.gicp_align(g["jt"], jnp.asarray(src), jnp.asarray(g["smask"]), jnp.eye(4),
                         jnp.asarray(jcovs), **kw)
    if inputs == "reference":
        target, covs = gicp_target_from_numpy(_target_arrays(g["jt"])), torch.as_tensor(jcovs)
    else:
        target = g["tt"]
        Rt = torch.as_tensor(np.array(T_true[:3, :3]))
        covs = Rt @ g["tc"] @ Rt.T if rotate_covs else g["tc"]
    carry = tk.gicp_align_loop_plain(
        *_loop_args(g, src, covs, target, max_iterations, reciprocal, eps), stop_early=False)
    t = _result(carry, max_iterations)
    _assert_results_close(t, j)
    if case == "no_match":
        assert int(t.num_inliers) == int(j.num_inliers) == 0
        assert not bool(t.converged) and int(t.iterations) == 1
        np.testing.assert_array_equal(t.transform.numpy(), np.eye(4, dtype=np.float32))
        return
    assert bool(t.converged) and int(t.num_inliers) > 1000
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-3)
    if case == "max_iterations_1":
        assert int(t.iterations) == 1 and not bool(carry[1])
    else:
        err = t.transform.numpy() @ T_true  # the perturbation is undone
        assert np.linalg.norm(err[:3, 3]) < 0.1


# -- one launch's carry update against a float64 oracle of the reference's step ------------


def _oracle_step(H, g, n_hit, d2_sum, carry, eps):
    """The reference body's step (`registration/gicp.py:169-178`) in float64 after the
    damped system is formed in float32, as both packages form it. Returns the next carry,
    as the kernel's launch updates it."""
    T, done, iters, fitness, inliers = carry
    if done:
        return carry
    H32 = H.astype(np.float32)
    scale = np.maximum(np.trace(H32) / np.float32(6), np.float32(1e-12))
    A = (H32 + np.float32(1e-6) * scale * np.eye(6, dtype=np.float32)).astype(np.float64)
    try:
        delta = np.linalg.solve(A, -g.astype(np.float64))
    except np.linalg.LinAlgError:
        delta = np.full(6, np.nan)
    n_inliers = int(n_hit)
    if not (np.isfinite(delta).all() and n_inliers >= 6):
        delta = np.zeros(6)
    T_new = _oracle_se3_exp(delta) @ T
    fit = d2_sum / max(n_inliers, 1)
    return T_new, bool(np.sqrt(delta @ delta) < eps), iters + 1, fit, n_inliers


# name -> (H, g, n_hit): a plain step, one of |delta| = 1.4 (fourteen times NDT's default
# cap of 0.1: GICP takes it whole), a singular system, 5 and 6 inliers (either side of the floor),
# and a twist with theta^2 < 1e-8 (the Taylor branch).
def _step_cases(rng):
    return {
        "plain": (_spd(rng, 50.0), rng.normal(size=6), 900.0),
        "uncapped": (_spd(rng, 5.0), 5.0 * rng.normal(size=6), 900.0),
        "singular": (_singular_h(), rng.normal(size=6), 900.0),
        "five_inliers": (_spd(rng, 50.0), rng.normal(size=6), 5.0),
        "six_inliers": (_spd(rng, 50.0), rng.normal(size=6), 6.0),
        "small_twist": (100.0 * np.eye(6), 1e-4 * rng.normal(size=6), 12.0),
    }


@pytest.mark.parametrize("done", [False, True], ids=["live", "frozen"])
@pytest.mark.parametrize("case", ["plain", "uncapped", "singular", "five_inliers",
                                  "six_inliers", "small_twist"])
def test_carry_update_matches_float64_oracle(case, done):
    rng = np.random.default_rng(11)
    H, g, n_hit = _step_cases(rng)[case]
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.array([[c, -s, 0, 4.0], [s, c, 0, -2.0], [0, 0, 1, 0.5], [0, 0, 0, 1]])
    d2_sum = 37.5
    want = _oracle_step(H, g, n_hit, d2_sum, (T, done, 5, 0.25, 700), 0.01)
    sums = (torch.tensor(H, dtype=torch.float32), torch.tensor(g, dtype=torch.float32),
            torch.tensor(n_hit, dtype=torch.float32), torch.tensor(n_hit, dtype=torch.float32),
            torch.tensor(d2_sum, dtype=torch.float32), torch.tensor(n_hit, dtype=torch.float32))
    carry = (torch.tensor(T, dtype=torch.float32), torch.tensor(done),
             torch.tensor(5, dtype=torch.int32), torch.tensor(0.25),
             torch.tensor(700, dtype=torch.int32))
    got = tk.gicp_carry_update(sums, carry, 0.01, torch.tensor(1e-6))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-6)
    assert bool(got[1]) == bool(want[1])
    assert int(got[2]) == want[2]
    np.testing.assert_allclose(float(got[3]), want[3], rtol=1e-6)
    assert int(got[4]) == want[4]
    if done:
        assert all(torch.equal(a, b) for a, b in zip(got, carry))
        return
    zeroed = case in ("singular", "five_inliers")
    assert torch.equal(got[0], carry[0]) == zeroed
    assert bool(got[1]) or not zeroed  # a zeroed step is done
    if case == "uncapped":
        step = np.linalg.solve(H, -g)
        assert np.linalg.norm(step) > 0.5  # NDT's cap (0.1) would have scaled it down
    if case == "small_twist":
        omega = np.linalg.solve(H, -g)[:3]
        assert 0 < omega @ omega < 1e-8


# -- the wrapper ---------------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_cpu(gicp_problem):
    g = gicp_problem
    src, covs, *_ = _source(g, "reciprocal_on")
    args = _loop_args(g, src, torch.as_tensor(covs), g["tt"], 8, reciprocal=True)
    before = (tk.gicp_align_loop.launches, tk.thread_launches())
    got = tk.gicp_align_loop(*args)
    want = tk.gicp_align_loop_plain(*args)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    assert (tk.gicp_align_loop.launches, tk.thread_launches()) == before


def test_wrapper_refuses_other_devices_and_unsupported_queries(gicp_problem):
    g = gicp_problem
    src, covs, *_ = _source(g, "reciprocal_off")
    args = list(_loop_args(g, src, torch.as_tensor(covs), g["tt"], 8))
    meta = list(args)
    meta[1] = torch.empty(args[1].shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tk.gicp_align_loop(*meta)
    for i, bad, word in ((9, 8, "bucket_cap"), (9, 64, "bucket_cap"), (10, 9, "neighborhood"),
                         (10, 1, "neighborhood")):
        with pytest.raises(ValueError, match=word):
            tk.gicp_align_loop(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="kernel must be one of"):
        tk.worked_launches(kernel="icp_iteration")


@pytest.mark.parametrize("neighborhood,bucket_cap", [(7, 16), (27, 32)])
def test_other_queries_take_the_plain_version_on_cpu(gicp_problem, neighborhood, bucket_cap):
    """The kernel's other instantiations (16-row buckets, the 27-cell ring) on the CPU:
    the plain loop with that query, which undoes the perturbation as the default does."""
    g = gicp_problem
    src, covs, T_true, _ = _source(g, "reciprocal_off")
    args = list(_loop_args(g, src, torch.as_tensor(covs), g["tt"], 16))
    args[9], args[10] = bucket_cap, neighborhood
    got = tk.gicp_align_loop(*args)
    want = tk.gicp_align_loop_plain(*args)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    assert bool(got[1]) and int(got[4]) > 1000
    err = got[0].numpy() @ T_true
    assert np.linalg.norm(err[:3, 3]) < 0.1
