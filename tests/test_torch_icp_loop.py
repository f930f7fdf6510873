"""The ICP loop on the device (`ops.kernels.icp_align_loop`, the port of the reference's
`lax.while_loop` in `registration/icp.py:icp_align`) and the loop gate's fitness
(`ops.kernels.icp_fitness`, `fitness_and_match_fraction`) through their plain PyTorch
versions on the CPU; the kernels themselves (`icp_iteration`, `icp_fitness`,
`csrc/icp_loop.cu`) are tested on a card by `tests/test_torch_cuda.py`.

- `icp_align` (the plain loop on the CPU) against the JAX `icp_align` on the cases of
  `tests/test_torch_icp.py`, a case with PCL's fitness epsilon at the 27-cell query, and
  the verifier's case with both clouds moved 1 km from the origin: the transform to atol
  1e-4, iterations, converged and inliers exact, fitness to rtol 1e-4 — the bounds
  `tests/test_torch_icp.py` holds `icp_align` to. Far from the origin the translation
  column is held to 1e-3 instead: there a float32 coordinate's spacing is 6.1e-5 m, and
  both packages' weighted means (sums of ~6,000 such coordinates, in different orders)
  round apart by several of those each iteration; the rotation block keeps 1e-4.
- The plain loop run to `max_iterations` with its carry frozen after `done` (what the
  kernel loop does on the card) equals the early-stop run bit for bit; the
  `max_iterations` stop; fewer than 3 inliers take the identity step (and end the loop,
  as the reference's test of the identity's zero twist does).
- The kernel's own step, written in torch ops (`icp_moments_plain` about the align's
  anchor, `umeyama_from_moments`, `rotation_of_plain`: the one-sided Jacobi SVD, its
  sweeps ended at convergence, and the rotation from the two largest singular pairs),
  against the JAX `_umeyama_step` on
  random, planar (rank-2), near-collinear and reflected pairs: R and t to atol 1e-5, the
  bound `tests/test_torch_icp.py` holds the plain step to; each also within 1e-5 of a
  float64 evaluation (R) and no farther from it than the reference's own step plus 1e-5
  (t). At 1 km from the origin R keeps 1e-5 against JAX, and t is held to the float64
  evaluation only (no farther from it than the reference's step plus 1e-5): the
  reference's float32 means round at the coordinates' spacing there, several times 1e-5.
  On each of those cases the sweeps stop before the cap of six, the rotation still within
  1e-5 of the JAX step's; over a batch each matrix stops on its own (a diagonal one after
  one sweep, a zero one with non-finite entries).
- `icp_fitness_plain` against the JAX `fitness_and_match_fraction` at the verifier's query
  (7 cells, bucket 16) in both modes, on a nudged source, a half-matched one and one that
  matches nothing: score and fraction to rtol 1e-6.
- The wrappers take the plain versions for CPU tensors (no launch counted), refuse other
  devices, a `bucket_cap` or `neighborhood` the kernels do not take, and an unknown mode;
  `icp_align`, `make_icp_matcher`'s align and a loop verification make one loop call an
  alignment, and the verification one fitness call.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.registration import icp as jicp
from lidar_graph_slam_tpu_torch.core.config import GraphSlamConfig, IcpConfig as TIcpConfig
from lidar_graph_slam_tpu_torch.graph import slam as tslam
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops.voxel import INVALID_KEY, build_ndt_map
from lidar_graph_slam_tpu_torch.registration import icp as ticp
from lidar_graph_slam_tpu_torch.utils.state import hash_grid_from_numpy
from tests.test_registration import perturbation
from tests.test_torch_icp import ICP_CASES, _cloud, _grid_arrays, _grids, _moved, scans  # noqa: F401

FIELDS = ("T", "done", "iterations", "fitness", "inliers")
FAR = np.float32(1000.0)

# The cases of `tests/test_torch_icp.py`, PCL's fitness epsilon at the 27-cell ring, and
# the verifier's case 1 km from the origin (the perturbation about the clouds' centre).
LOOP_CASES = {
    **ICP_CASES,
    "fitness_epsilon_27": dict(seed=3, rot=0.02, trans=0.25, kw=dict(
        max_correspondence_distance=2.0, max_iterations=40, euclidean_fitness_epsilon=1e-6,
        bucket_cap=16, neighborhood=27)),
    "far_origin": dict(ICP_CASES["verifier"], far=True),
}


def _problem(scans, case):
    """(the JAX grid, the port's grid carried from it, source points, mask) of a case."""
    c = LOOP_CASES[case]
    target, source = scans
    off = FAR if c.get("far") else np.float32(0.0)
    tpts, tmask = _cloud(target + off, 8192)
    jg, _ = _grids(tpts, tmask, 2.0)
    tg = hash_grid_from_numpy(_grid_arrays(jg))
    src, smask = _cloud(source + off + np.float32(c.get("shift", 0.0)), 8192)
    if c["seed"] is not None:
        P = np.asarray(perturbation(seed=c["seed"], rot=c["rot"], trans=c["trans"]))
        C = np.eye(4, dtype=np.float32)
        C[:3, 3] = off
        src = _moved(src, smask, C @ P @ np.linalg.inv(C).astype(np.float32))
    return jg, tg, src, smask


def _loop_args(tg, src, smask, kw, **over):
    kw = {**kw, **over}
    d = kw.get("max_correspondence_distance", 2.0)
    return (tg, torch.as_tensor(src), torch.as_tensor(smask), torch.eye(4), d * d,
            kw.get("transform_epsilon", 1e-6), kw.get("euclidean_fitness_epsilon", 0.0),
            kw.get("max_iterations", 50), kw.get("bucket_cap", 32), kw.get("neighborhood", 27))


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_icp_align_plain_loop_matches_reference(scans, case):
    c = LOOP_CASES[case]
    jg, tg, src, smask = _problem(scans, case)
    j = jicp.icp_align(jg, jnp.asarray(src), jnp.asarray(smask), jnp.eye(4), **c["kw"])
    t = ticp.icp_align(tg, torch.as_tensor(src), torch.as_tensor(smask), torch.eye(4),
                       **c["kw"])
    jT = np.asarray(j.transform)
    np.testing.assert_allclose(t.transform.numpy()[:3, :3], jT[:3, :3], atol=1e-4)
    np.testing.assert_allclose(t.transform.numpy()[:3, 3], jT[:3, 3],
                               atol=1e-3 if c.get("far") else 1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-4)
    if case in ("recover", "verifier", "fitness_epsilon_27", "far_origin"):
        assert bool(t.converged) and int(t.iterations) < c["kw"]["max_iterations"]


@pytest.mark.parametrize("case", ["verifier", "five_iters", "garbage"])
def test_frozen_loop_equals_early_stop(scans, case):
    _, tg, src, smask = _problem(scans, case)
    args = _loop_args(tg, src, smask, LOOP_CASES[case]["kw"])
    early = tk.icp_align_loop_plain(*args, stop_early=True)
    frozen = tk.icp_align_loop_plain(*args, stop_early=False)
    for name, a, b in zip(FIELDS, early, frozen):
        assert torch.equal(a, b), name
    assert bool(early[1]) and 0 < int(early[2]) < args[7]


def test_max_iterations_stop(scans):
    """epsilon 0 never stops the loop: it runs max_iterations bodies and converges by the
    max-iterations criterion, as PCL's does."""
    _, tg, src, smask = _problem(scans, "recover")
    args = _loop_args(tg, src, smask, LOOP_CASES["recover"]["kw"], transform_epsilon=0.0,
                      max_iterations=3)
    T, done, iters, _, n_inl = tk.icp_align_loop_plain(*args)
    assert int(iters) == 3 and not bool(done) and int(n_inl) > 1000
    res = ticp.icp_align(tg, *args[1:3], torch.eye(4), max_correspondence_distance=2.0,
                         max_iterations=3, transform_epsilon=0.0)
    assert bool(res.converged) and torch.equal(res.transform, T)


def test_fewer_than_three_inliers_take_the_identity_step(scans):
    """Two source points lie on the target, the rest 1 km away: the step is the identity,
    whose zero twist ends the loop after one iteration with 2 inliers; not converged."""
    target, _ = scans
    src = np.full((64, 3), 5000.0, np.float32)
    src[:2] = target[:2] + np.float32(0.05)
    spts, smask = _cloud(src, 64)
    jg, _ = _grids(*_cloud(target, 8192), 2.0)
    tg = hash_grid_from_numpy(_grid_arrays(jg))
    T0 = torch.as_tensor(np.asarray(perturbation(seed=1, rot=0.0, trans=0.0)))
    args = (tg, torch.as_tensor(spts), torch.as_tensor(smask), T0, 4.0, 1e-7, 0.0, 20, 16, 7)
    T, done, iters, _, n_inl = tk.icp_align_loop_plain(*args, stop_early=False)
    assert int(n_inl) == 2 and bool(done) and int(iters) == 1
    assert torch.equal(T, T0)
    res = ticp.icp_align(tg, *args[1:3], T0, max_iterations=20, bucket_cap=16,
                         neighborhood=7)
    assert not bool(res.converged)
    j = jicp.icp_align(jg, jnp.asarray(spts), jnp.asarray(smask), jnp.asarray(T0.numpy()),
                       max_iterations=20, bucket_cap=16, neighborhood=7)
    assert int(j.num_inliers) == 2 and int(j.iterations) == 1


# -- the kernel's own step against the reference's `_umeyama_step` -------------------------


def _rotation(seed, angle):
    r = np.random.default_rng(seed)
    axis = r.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _step_pair(case, n=300):
    """(src, dst, w) f32 of a step case: dst a rotated, shifted and noisy src, 80% weighted
    in. `planar`: src on the plane z = 0 (a rank-2 cross-covariance); `near_collinear`: a
    10 m line with 1 m of spread across it; `reflected`: dst the mirror image of src (the
    best proper rotation leaves its smallest direction flipped); `far_origin`: `random`
    1 km away."""
    rng = np.random.default_rng({"random": 0, "planar": 1, "near_collinear": 2,
                                 "reflected": 3, "far_origin": 0}[case])
    if case == "planar":
        src = rng.normal(size=(n, 3)) * np.array([8.0, 5.0, 0.0])
    elif case == "near_collinear":
        src = rng.normal(size=(n, 1)) * 10.0 * np.array([[1.0, 0.3, 0.1]]) \
            + rng.normal(size=(n, 3)) * 1.0
    elif case == "reflected":
        src = rng.normal(size=(n, 3)) * np.array([6.0, 3.0, 1.0])
    else:
        src = rng.normal(size=(n, 3)) * 5.0
    if case == "reflected":
        dst = src * np.array([1.0, 1.0, -1.0])
    else:
        dst = src @ _rotation(4, 0.2).T + np.array([0.5, -1.0, 0.3]) \
            + rng.normal(scale=0.01, size=(n, 3))
    if case == "far_origin":
        src, dst = src + 1000.0, dst + 1000.0
    w = (rng.random(n) > 0.2).astype(np.float32)
    return src.astype(np.float32), dst.astype(np.float32), w


def _step_f64(src, dst, w):
    s, d, w = src.astype(np.float64), dst.astype(np.float64), w.astype(np.float64)
    ms, md = (s * w[:, None]).sum(0) / w.sum(), (d * w[:, None]).sum(0) / w.sum()
    U, _, Vt = np.linalg.svd(np.einsum("ni,nj,n->ij", d - md, s - ms, w) / w.sum())
    R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    return R, md - R @ ms


@pytest.mark.parametrize("case", ["random", "planar", "near_collinear", "reflected",
                                  "far_origin"])
def test_kernel_step_formula_matches_reference(case):
    src, dst, w = _step_pair(case)
    jR, jt = (np.asarray(x) for x in jicp._umeyama_step(jnp.asarray(src), jnp.asarray(dst),
                                                        jnp.asarray(w)))
    s, d, wt = torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w)
    anchor = tk.icp_anchor(s, wt > 0, torch.eye(4))
    R, t = tk.umeyama_from_moments(tk.icp_moments_plain(s, d, wt > 0, anchor), anchor)
    R, t = R.numpy(), t.numpy()
    oR, ot = _step_f64(src, dst, w)
    np.testing.assert_allclose(R, jR, atol=1e-5)
    np.testing.assert_allclose(R, oR, atol=1e-5)
    assert abs(np.linalg.det(R.astype(np.float64)) - 1.0) < 1e-5
    if case != "far_origin":
        np.testing.assert_allclose(t, jt, atol=1e-5)
    assert np.abs(t - ot).max() <= np.abs(jt - ot).max() + 1e-5
    if case == "planar":
        assert np.linalg.matrix_rank(np.einsum("ni,nj->ij", dst, src - src.mean(0)),
                                     tol=1e-3) == 2
    if case == "reflected":
        assert np.linalg.det(np.diag([1.0, 1.0, -1.0])) < 0 < np.linalg.det(R)


@pytest.mark.parametrize("case", ["random", "planar", "near_collinear", "reflected",
                                  "far_origin"])
def test_jacobi_stops_before_six_sweeps(case):
    """The kernel's one-sided Jacobi ends at the first sweep that turns no pair of columns
    (each orthogonal to float32): on every step case that is before the cap of six sweeps,
    and the rotation is still the reference's `_umeyama_step` one to 1e-5."""
    src, dst, w = _step_pair(case)
    s, d, wt = torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w)
    anchor = tk.icp_anchor(s, wt > 0, torch.eye(4))
    n, Sp, Sq, Sqp = tk.icp_moments_plain(s, d, wt > 0, anchor)
    inv_w = torch.reciprocal(torch.clamp(n, min=1e-9))
    R, sweeps = tk.rotation_of_plain(Sqp * inv_w - (Sq * inv_w)[:, None] * (Sp * inv_w)[None, :],
                                     return_sweeps=True)
    assert 1 < int(sweeps) < tk.ICP_SVD_SWEEPS
    jR, _ = jicp._umeyama_step(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)


def test_jacobi_sweeps_per_matrix():
    """Over a batch each matrix runs its own sweeps: a diagonal S (orthogonal columns)
    one sweep and the identity; random ones between two and the cap, with R equal to the
    same matrix alone; a zero S one sweep and non-finite entries."""
    rng = np.random.default_rng(4)
    S = torch.as_tensor(rng.normal(size=(200, 3, 3)).astype(np.float32))
    S[0] = torch.diag(torch.tensor([3.0, 2.0, 0.5]))
    S[1] = 0.0
    R, sweeps = tk.rotation_of_plain(S, return_sweeps=True)
    assert int(sweeps[0]) == 1 and torch.equal(R[0], torch.eye(3))
    assert int(sweeps[1]) == 1 and not bool(torch.isfinite(R[1]).any())
    assert 2 <= int(sweeps[2:].min()) and int(sweeps[2:].max()) <= tk.ICP_SVD_SWEEPS
    for b in (2, int(torch.argmax(sweeps)), int(torch.argmin(sweeps[2:])) + 2):
        alone, n = tk.rotation_of_plain(S[b], return_sweeps=True)
        assert torch.equal(alone, R[b]) and int(n) == int(sweeps[b])


def test_rotation_of_plain_batched_and_degenerate():
    """`rotation_of_plain` over a batch equals it one matrix at a time; a zero
    cross-covariance gives non-finite entries (the loop then takes the identity step); a
    rank-1 one u u^T a rotation that keeps u (any such rotation is optimal; the reference's
    SVD picks one too)."""
    rng = np.random.default_rng(9)
    S = torch.as_tensor(rng.normal(size=(5, 3, 3)).astype(np.float32))
    batched = tk.rotation_of_plain(S)
    for b in range(5):
        assert torch.equal(batched[b], tk.rotation_of_plain(S[b]))
        R = batched[b].double()
        torch.testing.assert_close(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-5,
                                   rtol=0)
    assert not bool(torch.isfinite(tk.rotation_of_plain(torch.zeros(3, 3))).all())
    u = torch.tensor([1.0, 2.0, 3.0])
    R = tk.rotation_of_plain(u[:, None] * u[None, :])
    torch.testing.assert_close(R @ u, u, atol=1e-5, rtol=0)
    torch.testing.assert_close(R @ R.T, torch.eye(3), atol=1e-5, rtol=0)


# -- the loop gate's fitness ------------------------------------------------------------


def _fitness_source(target, source):
    if source == "nudged":
        src = np.array(target[:64], dtype=np.float32)
        src[:, 0] += 0.05
        src[:8] = [[999.0 + i, 999.0, 999.0] for i in range(8)]
        return src
    if source == "half":
        src = np.array(target[:200], dtype=np.float32)
        src[::2, 2] += np.float32(8.0)  # half of them lifted 8 m: no target row near
        return src
    return np.full((16, 3), 5000.0, np.float32)


@pytest.mark.parametrize("mode", ["pcl", "penalized"])
@pytest.mark.parametrize("source", ["nudged", "half", "all_miss"])
def test_fitness_plain_matches_reference_at_the_verifier_query(scans, mode, source):
    target, _ = scans
    jg, _ = _grids(*_cloud(target, 8192), 2.0)
    tg = hash_grid_from_numpy(_grid_arrays(jg))
    spts, smask = _cloud(_fitness_source(target, source), 256)
    T = np.asarray(perturbation(seed=2, rot=0.01, trans=0.05))
    js, jf = jicp.fitness_and_match_fraction(jg, jnp.asarray(spts), jnp.asarray(smask),
                                             jnp.asarray(T), max_range=2.0, bucket_cap=16,
                                             neighborhood=7, mode=mode)
    ts, tf = tk.icp_fitness_plain(tg, torch.as_tensor(spts), torch.as_tensor(smask),
                                  torch.as_tensor(T), 2.0, 16, 7, mode)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-6)
    if source == "all_miss":
        assert float(tf) == 0.0 and np.isinf(float(ts)) == (mode == "pcl")
    if source == "half":
        assert 0.3 < float(tf) < 0.7


# -- the wrappers ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_versions_on_cpu(scans):
    _, tg, src, smask = _problem(scans, "verifier")
    args = _loop_args(tg, src, smask, LOOP_CASES["verifier"]["kw"])
    before = (tk.icp_align_loop.launches, tk.icp_fitness.launches, tk.thread_launches())
    got, want = tk.icp_align_loop(*args), tk.icp_align_loop_plain(*args)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    for mode in ("pcl", "penalized"):
        fit = tk.icp_fitness(tg, args[1], args[2], got[0], 2.0, 16, 7, mode)
        ref = tk.icp_fitness_plain(tg, args[1], args[2], got[0], 2.0, 16, 7, mode)
        assert all(torch.equal(a, b) for a, b in zip(fit, ref))
    assert (tk.icp_align_loop.launches, tk.icp_fitness.launches,
            tk.thread_launches()) == before


def test_wrappers_refuse_other_devices_queries_and_modes(scans):
    _, tg, src, smask = _problem(scans, "verifier")
    args = list(_loop_args(tg, src, smask, LOOP_CASES["verifier"]["kw"]))
    meta = list(args)
    meta[1] = torch.empty(args[1].shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tk.icp_align_loop(*meta)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tk.icp_fitness(tg, meta[1], args[2], args[3], 2.0)
    for i, bad, word in ((8, 8, "bucket_cap"), (8, 64, "bucket_cap"), (9, 9, "neighborhood"),
                         (9, 1, "neighborhood")):
        with pytest.raises(ValueError, match=word):
            tk.icp_align_loop(*args[:i], bad, *args[i + 1:])
        kw = {"bucket_cap": bad} if word == "bucket_cap" else {"neighborhood": bad}
        with pytest.raises(ValueError, match=word):
            tk.icp_fitness(tg, args[1], args[2], args[3], 2.0, **kw)
    with pytest.raises(ValueError, match="unknown fitness mode"):
        tk.icp_fitness(tg, args[1], args[2], args[3], 2.0, mode="other")
    assert tk.worked_launches.__doc__ and "icp_iteration" in tk._WORKED


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(tk, name)
    monkeypatch.setattr(tk, name, lambda *a, **k: calls.append((a, k)) or fn(*a, **k))
    return calls


def test_icp_align_and_matcher_make_one_loop_call(scans, monkeypatch):
    """`icp_align` and `make_icp_matcher`'s align (the ICP front end's: 7 cells, bucket 32,
    the gate capped at the cell, epsilon at least 1e-7) are one `icp_align_loop` call an
    alignment, and return its carry."""
    _, tg, src, smask = _problem(scans, "recover")
    calls = _counting(monkeypatch, "icp_align_loop")
    cfg = TIcpConfig(max_iterations=30, transform_epsilon=1e-9)
    _, align = ticp.make_icp_matcher(cfg, cell_size=2.0)
    res = align(tg, torch.as_tensor(src), torch.as_tensor(smask), torch.eye(4))
    assert len(calls) == 1
    a = calls[0][0]
    assert (a[4], a[5], a[6], a[7], a[8], a[9]) == (4.0, 1e-7, 0.0, 30, 32, 7)
    want = tk.icp_align_loop_plain(*a)
    for name, x, y in zip(FIELDS, (res.transform, None, res.iterations, res.fitness,
                                   res.num_inliers), want):
        if x is not None:
            assert torch.equal(x, y), name
    assert bool(res.converged)


def test_verification_makes_one_loop_and_one_fitness_call(scans, monkeypatch):
    """One loop verification (`graph/slam.py:make_verify_one` with the ICP verifier: the
    coarse NDT pre-align, ICP, the gate's fitness) is one `icp_align_loop` call at the
    verifier's query (7 cells, bucket 16, PCL's fitness epsilon) and one `icp_fitness`
    call in the configured mode."""
    jg, tg, src, smask = _problem(scans, "verifier")
    loops = _counting(monkeypatch, "icp_align_loop")
    fits = _counting(monkeypatch, "icp_fitness")
    cfg = GraphSlamConfig(icp=TIcpConfig(max_iterations=40))
    verify = tslam.make_verify_one(cfg, "ICP")
    pts = tg.points
    mask = tg.keys != INVALID_KEY
    pre_map = build_ndt_map(pts, mask, 4.0, capacity=4096)
    T, score, ok = verify(tg, pre_map, None, torch.eye(4), torch.as_tensor(src),
                          torch.as_tensor(smask))
    assert len(loops) == 1 and len(fits) == 1
    a = loops[0][0]
    assert (a[4], a[5], a[6], a[7], a[8], a[9]) == (4.0, 1e-7, 1e-6, 40, 16, 7)
    f = fits[0]
    assert f[1] == dict(bucket_cap=16, neighborhood=7, mode=cfg.fitness_mode)
    assert f[0][4] == 2.0 and torch.equal(f[0][3], T)
    assert bool(ok) and float(score) < 0.3
