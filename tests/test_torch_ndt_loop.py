"""The NDT loop on the device (`ops.kernels.ndt_align_loop`, the port of the reference's
`lax.while_loop`) through its plain PyTorch version on the CPU; the kernel itself is
tested on a card by `tests/test_torch_cuda.py`.

- The plain loop run to `max_iterations` with its carry frozen after `done` (what the
  kernel loop does on the card) equals the early-stop run bit for bit in all five carry
  fields.
- `ndt_align` and `make_ndt_matcher`'s pyramid make one loop call per align stage and
  match the JAX `ndt_align` at `tests/test_torch_ndt.py`'s tolerances (transform atol
  1e-4; iterations, converged and inliers exact).
- One launch's carry update (`ndt_carry_update`: the step in the kernel's last block)
  against a float64 numpy oracle of the JAX body's step: T to rtol 1e-5 / atol 1e-6,
  fitness to rtol 1e-6, done, iterations and inliers exact.
- The batched plain loop: row b equals the single loop bit for bit.
- The wrappers take the plain version for CPU tensors and refuse other devices.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core.config import NdtConfig as JNdtConfig
from lidar_graph_slam_tpu.registration import ndt as jndt
from lidar_graph_slam_tpu_torch.core.config import NdtConfig as TNdtConfig
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.registration import ndt as tndt
from tests.test_torch_ndt import _init, problems  # noqa: F401  (a fixture)

FIELDS = ("T", "done", "iterations", "fitness", "inliers")


def _loop_args(problem, init, max_iterations, polish_iterations, step_size=0.1):
    _, _, tmap, pts, mask = problem
    d1, d2 = tndt.magnusson_constants(tmap.leaf, 0.55)
    return (tmap, torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(_init(init)),
            d2, -d1 * d2, step_size, 0.01, torch.tensor(1e-6), max_iterations,
            polish_iterations)


# (problem, initial guess, max_iterations): the last runs out of iterations.
LOOP_CASES = [("tiny", "identity", 64), ("dense", "identity", 64), ("dense", "offset", 64),
              ("dense", "offset", 2)]


@pytest.mark.parametrize("polish", [0, 2])
@pytest.mark.parametrize("problem,init,max_iterations", LOOP_CASES,
                         ids=["-".join(map(str, c)) for c in LOOP_CASES])
def test_frozen_loop_equals_early_stop(problems, problem, init, max_iterations, polish):
    args = _loop_args(problems[problem], init, max_iterations, polish)
    early = tk.ndt_align_loop_plain(*args, stop_early=True)
    frozen = tk.ndt_align_loop_plain(*args, stop_early=False)
    for name, a, b in zip(FIELDS, early, frozen):
        assert torch.equal(a, b), name
    iters, done = int(early[2]), bool(early[1])
    if max_iterations == 2:
        assert iters == 2 and not done  # the case that hits max_iterations
    else:
        assert done and 0 < iters < max_iterations


@pytest.mark.parametrize("init", ["identity", "offset"])
def test_ndt_align_calls_the_loop_once_and_matches_reference(problems, monkeypatch, init):
    vm, sc, tmap, pts, mask = problems["dense"]
    calls = []
    loop = tk.ndt_align_loop
    monkeypatch.setattr(tk, "ndt_align_loop", lambda *a: calls.append(a) or loop(*a))
    T0 = _init(init)
    j = jndt.ndt_align(vm, sc.points, sc.mask, jnp.asarray(T0), max_iterations=64)
    t = tndt.ndt_align(tmap, torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(T0),
                       max_iterations=64)
    assert len(calls) == 1
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-4, atol=1e-6)


def test_pyramid_makes_one_loop_call_a_stage(problems, monkeypatch):
    _, _, _, pts, mask = problems["dense"]
    calls = []
    loop = tk.ndt_align_loop
    monkeypatch.setattr(tk, "ndt_align_loop", lambda *a: calls.append(a) or loop(*a))
    jb, ja = jndt.make_ndt_matcher(JNdtConfig(), map_capacity=4096)
    tb, ta = tndt.make_ndt_matcher(TNdtConfig(), map_capacity=4096)
    T0 = _init("offset")
    j = ja(jb(jnp.asarray(pts), jnp.asarray(mask)), jnp.asarray(pts), jnp.asarray(mask),
           jnp.asarray(T0))
    t = ta(tb(torch.as_tensor(pts), torch.as_tensor(mask)), torch.as_tensor(pts),
           torch.as_tensor(mask), torch.as_tensor(T0))
    cfg = TNdtConfig()
    # Coarse (strided source, no polish), then fine.
    assert [(a[1].shape[0], a[9], a[10]) for a in calls] == [
        (pts[::cfg.coarse_subsample].shape[0], cfg.coarse_iterations, 0),
        (pts.shape[0], cfg.max_iterations, 2)]
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)


# -- one launch's carry update against a float64 oracle of the reference's step ------------


def _oracle_se3_exp(xi):
    """`lidar_graph_slam_tpu/core/se3.py:se3_exp` in float64, Taylor branch included."""
    w, v = xi[:3], xi[3:]
    theta_sq = float(w @ w)
    theta = np.sqrt(theta_sq + 1e-16)
    if theta_sq < 1e-8:
        A, B, C = 1 - theta_sq / 6, 0.5 - theta_sq / 24, 1 / 6 - theta_sq / 120
    else:
        A = np.sin(theta) / theta
        B = (1 - np.cos(theta)) / theta_sq
        C = (theta - np.sin(theta)) / (theta_sq * theta)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    E = np.eye(4)
    E[:3, :3] = np.eye(3) + A * W + B * W @ W
    E[:3, 3] = (np.eye(3) + B * W + C * W @ W) @ v
    return E


def _oracle_step(H, g, n_hit, centre_d2, centre_count, carry, step_size, eps, polish):
    """The reference body's step (`registration/ndt.py:96-122`) in float64 after the
    damped system is formed in float32, as both packages form it (so a system that is
    singular in float32 is singular here). Returns the next carry, as the kernel's launch
    updates it."""
    T, done, iters, fitness, inliers = carry
    if done and not polish:
        return carry
    H32 = H.astype(np.float32)
    scale = np.maximum(np.trace(H32) / np.float32(6), np.float32(1e-12))
    A = (H32 + np.float32(1e-6) * scale * np.eye(6, dtype=np.float32)).astype(np.float64)
    try:
        delta = np.linalg.solve(A, -g.astype(np.float64))
    except np.linalg.LinAlgError:
        delta = np.full(6, np.nan)
    nrm = np.sqrt(delta @ delta)
    delta = delta * min(step_size / max(nrm, 1e-12), 1.0)
    n_inliers = int(n_hit)
    if not (np.isfinite(delta).all() and n_inliers > 0):
        delta = np.zeros(6)
    T_new = _oracle_se3_exp(delta) @ T
    fit = centre_d2 / max(centre_count, 1.0)
    if polish:
        return T_new, done, iters, fit, n_inliers
    return T_new, done or np.sqrt(delta @ delta) < eps, iters + 1, fit, n_inliers


def _singular_h():
    """Rows 0 and 1 equal after the float32 damping (1e4 + 1.7e-7 rounds to 1e4)."""
    H = np.zeros((6, 6))
    H[:2, :2] = 1e4
    H[2, 2] = -2e4 + 1.0  # trace 1: the damping is 1e-6 / 6
    return H


def _spd(rng, scale):
    A = rng.normal(size=(6, 6))
    return scale * (A @ A.T + np.eye(6))


# name -> (H, g, n_hit): a step inside the cap, one capped, a singular system (zeroed), no
# inliers (zeroed), and a twist with theta^2 < 1e-8 (the Taylor branch).
def _step_cases(rng):
    return {
        "plain": (_spd(rng, 50.0), rng.normal(size=6), 900.0),
        "capped": (_spd(rng, 1.0), 50.0 * rng.normal(size=6), 900.0),
        "singular": (_singular_h(), rng.normal(size=6), 900.0),
        "no_inliers": (_spd(rng, 50.0), rng.normal(size=6), 0.0),
        "small_twist": (100.0 * np.eye(6), 1e-4 * rng.normal(size=6), 12.0),
    }


# (done on entry, polish): a live launch, a frozen one, and polish after and before done.
MODES = [(False, False), (True, False), (True, True), (False, True)]


@pytest.mark.parametrize("done,polish", MODES, ids=["live", "frozen", "polish-done",
                                                    "polish-live"])
@pytest.mark.parametrize("case", ["plain", "capped", "singular", "no_inliers", "small_twist"])
def test_carry_update_matches_float64_oracle(case, done, polish):
    rng = np.random.default_rng(7)
    H, g, n_hit = _step_cases(rng)[case]
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.array([[c, -s, 0, 4.0], [s, c, 0, -2.0], [0, 0, 1, 0.5], [0, 0, 0, 1]])
    centre_d2, centre_count = 37.5, 310.0
    carry64 = (T, done, 5, 0.25, 700)
    want = _oracle_step(H, g, n_hit, centre_d2, centre_count, carry64, 0.1, 0.01, polish)

    sums = (torch.tensor(H, dtype=torch.float32), torch.tensor(g, dtype=torch.float32),
            torch.tensor(1.0), torch.tensor(n_hit, dtype=torch.float32),
            torch.tensor(centre_d2, dtype=torch.float32),
            torch.tensor(centre_count, dtype=torch.float32))
    carry = (torch.tensor(T, dtype=torch.float32), torch.tensor(done),
             torch.tensor(5, dtype=torch.int32), torch.tensor(0.25),
             torch.tensor(700, dtype=torch.int32))
    got = tk.ndt_carry_update(sums, carry, 0.1, 0.01, torch.tensor(1e-6), polish)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-6)
    assert bool(got[1]) == bool(want[1])
    assert int(got[2]) == want[2]
    np.testing.assert_allclose(float(got[3]), want[3], rtol=1e-6)
    assert int(got[4]) == want[4]
    if case in ("singular", "no_inliers") and (polish or not done):
        # The step was zeroed: T is unchanged, and a live launch is done.
        assert torch.equal(got[0], carry[0])
        assert polish or bool(got[1])
    if case == "small_twist" and not (done and not polish):
        omega = np.linalg.solve(H, -g)[:3]
        assert 0 < omega @ omega < 1e-8 and not torch.equal(got[0], carry[0])


# -- the batched loop ----------------------------------------------------------------------


def test_batched_plain_loop_rows_equal_single_loops(problems):
    """Three sequences of one batch against the dense problem's map: from the identity
    (it finishes early), from the offset guess, and from the offset guess with a third
    of the source masked out. Each row equals the single loop on that sequence bit for
    bit."""
    _, _, tmap, pts, mask = problems["dense"]
    inits = [_init("identity"), _init("offset"), _init("offset")]
    vmaps = tk.stack_maps([tmap] * 3)
    d1, d2 = tndt.magnusson_constants(vmaps.leaf, 0.55)
    P = torch.as_tensor(np.stack([pts] * 3))
    M = torch.as_tensor(np.stack([mask] * 3))
    M[2, ::3] = False  # the third sequence sees another source
    T0 = torch.as_tensor(np.stack(inits))
    damping = torch.tensor(1e-6)
    batched = tk.ndt_align_loop_batched(vmaps, P, M, T0, d2, -d1 * d2, 0.1, 0.01, damping,
                                        64, 2)
    iters = []
    for b in range(3):
        single = tk.ndt_align_loop(tmap, P[b], M[b], T0[b], d2[b], (-d1 * d2)[b], 0.1, 0.01,
                                   damping, 64, 2)
        for name, x, y in zip(FIELDS, batched, single):
            assert torch.equal(x[b], y), (b, name)
        iters.append(int(single[2]))
    assert all(bool(x) for x in batched[1])
    assert iters[0] < iters[1]  # the first sequence finished early


def test_ndt_align_batched_rows_equal_ndt_align(problems):
    _, _, tmap, pts, mask = problems["dense"]
    T0 = torch.as_tensor(np.stack([_init("identity"), _init("offset")]))
    P, M = torch.as_tensor(np.stack([pts] * 2)), torch.as_tensor(np.stack([mask] * 2))
    res = tndt.ndt_align_batched(tk.stack_maps([tmap] * 2), P, M, T0, max_iterations=64)
    for b in range(2):
        one = tndt.ndt_align(tmap, P[b], M[b], T0[b], max_iterations=64)
        for f in ("transform", "converged", "iterations", "fitness", "num_inliers"):
            assert torch.equal(getattr(res, f)[b], getattr(one, f)), (b, f)


# -- the wrappers --------------------------------------------------------------------------


def test_loop_wrappers_take_the_plain_version_on_cpu(problems):
    args = _loop_args(problems["tiny"], "identity", 8, 2)
    before = (tk.ndt_align_loop.launches, tk.ndt_align_loop_batched.launches,
              tk.thread_launches())
    got = tk.ndt_align_loop(*args)
    want = tk.ndt_align_loop_plain(*args)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    vm, P, M, T0 = tk.stack_maps([args[0]]), args[1][None], args[2][None], args[3][None]
    rows = tk.ndt_align_loop_batched(vm, P, M, T0, *args[4:])
    for name, a, b in zip(FIELDS, rows, want):
        assert torch.equal(a[0], b), name
    assert (tk.ndt_align_loop.launches, tk.ndt_align_loop_batched.launches,
            tk.thread_launches()) == before


def test_loop_wrappers_refuse_other_devices(problems):
    args = list(_loop_args(problems["tiny"], "identity", 8, 2))
    args[1] = torch.empty(args[1].shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tk.ndt_align_loop(*args)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tk.ndt_align_loop_batched(args[0], args[1][None], args[2][None], args[3][None],
                                  *args[4:])
