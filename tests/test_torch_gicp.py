"""PyTorch port vs the JAX reference: GICP and the neighborhood helpers it brings.

Tolerances:
  * `knn`: idx and valid exact, d2 to rtol 1e-6 (fixtures of `tests/test_neighbors.py`);
    `radius_mask` exact.
  * `_inv3x3`: rtol 1e-5 (atol 1e-6 of entries near 0), and the clamp of |det| < 1e-12
    to +1e-12 (sign dropped) exact.
  * `window_covariances` against the compiled reference: counts exact, mu to 1e-5, the
    covariance to 1e-4 of each matrix's largest entry. E[xx^T] - mu mu^T in world
    coordinates cancels (|x|^2 ~ 1600 m^2 at 40 m against ~0.01 m^2 variances); the
    compiled reference rounds its second-moment steps as fused multiply-adds, and so
    does the port, which is what keeps the two within that bound (rounded separately,
    they differ by up to 3e-4 absolute, ~1e-3 of a patch).
  * `estimate_covariances` / `build_gicp_target`: valid exact; covariances to 1e-4 of
    each matrix's largest entry where the eigen-gap is clear ((l1 - l0) / l2 > 0.05 for
    the raw eigenvalues l0 <= l1 <= l2: only the smallest eigenvector survives the
    regularization, and it is ill-determined in near-isotropic patches).
  * `gicp_align` on the fixtures of `tests/test_registration.py` (recover, reciprocal):
    the transform to atol 1e-4, iterations and converged equal, num_inliers within 1%;
    from the reference's own target and covariances, and from the port's own builds.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core.config import GicpConfig as JGicpConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops import neighbors as jnb
from lidar_graph_slam_tpu.registration import gicp as jgicp
from lidar_graph_slam_tpu_torch.core.config import GicpConfig as TGicpConfig
from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
from lidar_graph_slam_tpu_torch.registration import gicp as tgicp
from lidar_graph_slam_tpu_torch.utils.state import gicp_target_from_numpy, hash_grid_from_numpy
from tests.test_registration import perturbation


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it: the suite
    runs its files in parallel processes, and an OpenMP pool of one thread per core in
    each of them oversubscribes the cores so far that GICP's many small ops (its
    covariances are ~800 of them) slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scans():
    """The fixture of `tests/test_registration.py`."""
    rng = np.random.default_rng(7)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [5.0, -3.0, 1.5]
    target = simulate_scan(world, pose, rng, max_range=45.0, max_points=8192, noise=0.01)
    source = simulate_scan(world, pose, rng, max_range=45.0, max_points=8192, noise=0.01)
    return target, source


def _cloud(xyz, capacity):
    c = PointCloud.from_array(xyz, capacity=capacity)
    return np.array(c.points), np.array(c.mask)


def _arrays(obj) -> dict:
    return {f.name: np.array(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _target_arrays(t) -> dict:
    return {**_arrays(t.grid), "covs": np.array(t.covs), "valid": np.array(t.valid)}


def _moved(points, mask, T):
    moved = points @ T[:3, :3].T + T[:3, 3]
    return np.where(mask[:, None], moved, points).astype(np.float32)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# -- knn and radius_mask ----------------------------------------------------------------

def _knn_case(name, rng):
    """(targets, queries, cell, k, bucket_cap, capacity) of `tests/test_neighbors.py`."""
    if name == "margin":
        targets = rng.uniform(0, 8, size=(1500, 3)).astype(np.float32)
        queries = targets[:100] + rng.normal(size=(100, 3)).astype(np.float32) * 0.05
        return targets, queries, 1.5, 10, 64, 2048
    targets = rng.uniform(0, 4, size=(500, 3)).astype(np.float32)
    if name == "sparse":
        return targets, np.array([[50.0, 50.0, 10.0]], np.float32), 1.0, 5, 16, 512
    qc = PointCloud.from_array(targets[:10], capacity=32)  # 22 padded rows
    return targets, np.array(qc.points), 1.0, 4, 64, 512


@pytest.mark.parametrize("neighborhood", [7, 27])
@pytest.mark.parametrize("case", ["margin", "sparse", "padded"])
def test_knn_matches_reference(case, neighborhood):
    targets, queries, cell, k, bucket_cap, cap = _knn_case(case, np.random.default_rng(0))
    pts, mask = _cloud(targets, cap)
    jg = jnb.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), cell)
    tg = hash_grid_from_numpy(_arrays(jg))
    ji, jd, jv = jnb.knn(jg, jnp.asarray(queries), k=k, bucket_cap=bucket_cap,
                         neighborhood=neighborhood)
    ti, td, tv = tnb.knn(tg, torch.as_tensor(queries), k=k, bucket_cap=bucket_cap,
                         neighborhood=neighborhood)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    if case == "margin" and neighborhood == 27:
        assert tv.numpy().all()
    if case == "sparse":
        assert not tv.numpy().any()
    if case == "padded":
        assert tv.numpy()[:10, 0].all() and not tv.numpy()[10:].any()


def test_radius_mask_matches_reference(rng):
    positions = rng.uniform(-5, 5, size=(100, 3)).astype(np.float32)
    mask = np.ones(100, dtype=bool)
    mask[50:] = False
    query = np.zeros(3, dtype=np.float32)
    want = np.asarray(jnb.radius_mask(jnp.asarray(positions), jnp.asarray(mask),
                                      jnp.asarray(query), 3.0))
    got = tnb.radius_mask(*_t(positions, mask, query), 3.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


# -- _inv3x3 ----------------------------------------------------------------------------

def test_inv3x3_matches_reference(rng):
    A = rng.normal(size=(500, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(3, dtype=np.float32)
    # The clamp: |det| < 1e-12 is replaced by +1e-12, the sign dropped (a singular
    # matrix, one with a tiny negative determinant, and the zero matrix).
    tiny = np.diag([1e-5, 1e-5, -1e-5]).astype(np.float32)
    A[:3] = [np.ones((3, 3), np.float32), tiny, np.zeros((3, 3), np.float32)]
    want = np.asarray(jgicp._inv3x3(jnp.asarray(A)))
    got = tgicp._inv3x3(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[:3], want[:3])
    # tiny: det = -1e-15 -> 1 / 1e-12, so the adjugate is scaled by +1e12.
    np.testing.assert_allclose(got[1], np.diag([-1e2, -1e2, 1e2]), rtol=1e-5)
    np.testing.assert_allclose(got[3:] @ A[3:], np.broadcast_to(np.eye(3), (497, 3, 3)),
                               atol=2e-3)


# -- covariances ------------------------------------------------------------------------

def _clear_gap(raw_cov: np.ndarray) -> np.ndarray:
    """Rows whose smallest eigenvector is well determined: (l1 - l0) / l2 > 0.05."""
    w = np.linalg.eigvalsh(raw_cov.astype(np.float64))
    return (w[:, 1] - w[:, 0]) > 0.05 * np.maximum(w[:, 2], 1e-12)


def _assert_covs_close(got, want, rows, rel):
    scale = np.abs(want[rows]).reshape(-1, 9).max(axis=1)
    err = np.abs(got[rows] - want[rows]).reshape(-1, 9).max(axis=1)
    assert (err <= rel * scale).all(), float((err / scale).max())


def test_window_covariances_match_reference(scans):
    target, _ = scans
    pts, mask = _cloud(target, 8192)
    jg = jnb.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), 2.0)
    tg = hash_grid_from_numpy(_arrays(jg))
    jmu, jcov, jcnt = (np.asarray(x) for x in jax.jit(jnb.window_covariances)(jg))
    tmu, tcov, tcnt = (x.numpy() for x in tnb.window_covariances(tg, window=16))
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_allclose(tmu, jmu, rtol=0, atol=1e-5)
    _assert_covs_close(tcov, jcov, jcnt >= 1, 1e-4)
    np.testing.assert_array_equal(tcov, np.swapaxes(tcov, 1, 2))
    assert (tcnt >= 5).mean() > 0.5 and tcnt.max() <= 33


@pytest.mark.parametrize("which", ["source", "target"])
def test_estimate_covariances_and_target_match_reference(scans, which):
    target, source = scans
    pts, mask = _cloud(target if which == "target" else source, 8192)
    if which == "source":
        jc, jok = (np.asarray(x) for x in jgicp.estimate_covariances(
            jnp.asarray(pts), jnp.asarray(mask), 2.0, k=20))
        tc, tok = (x.numpy() for x in tgicp.estimate_covariances(*_t(pts, mask), 2.0, k=20))
        jg = jnb.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), 2.0)
    else:
        jt = jgicp.build_gicp_target(jnp.asarray(pts), jnp.asarray(mask), 2.0, k=20)
        tt = tgicp.build_gicp_target(*_t(pts, mask), 2.0, k=20)
        for name in ("keys", "order", "table", "num"):
            np.testing.assert_array_equal(getattr(tt.grid, name).numpy(),
                                          np.asarray(getattr(jt.grid, name)), err_msg=name)
        jc, jok, tc, tok = (np.asarray(jt.covs), np.asarray(jt.valid), tt.covs.numpy(),
                            tt.valid.numpy())
        # The target's covariances are estimated from its (already sorted) grid points.
        jg = jnb.build_hash_grid(jt.grid.points, jt.grid.keys != np.iinfo(np.int32).max, 2.0)
    np.testing.assert_array_equal(tok, jok)
    assert 0.5 < tok.mean() <= mask.mean()
    # The raw window covariance of each row, in the row order the outputs use.
    _, raw_sorted, _ = jax.jit(jnb.window_covariances)(jg)
    raw = np.zeros_like(np.asarray(raw_sorted))
    raw[np.asarray(jg.order)] = np.asarray(raw_sorted)
    rows = jok & _clear_gap(raw)
    assert rows.mean() > 0.3
    _assert_covs_close(tc, jc, rows, 1e-4)
    # Rows without a valid estimate carry the identity in both.
    np.testing.assert_array_equal(tc[~tok & mask], np.broadcast_to(np.eye(3), tc[~tok & mask].shape))


# -- gicp_align -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gicp_problem(scans):
    """Both packages' target and source covariances for the registration fixture."""
    target, source = scans
    tpts, tmask = _cloud(target, 8192)
    spts, smask = _cloud(source, 8192)
    jt = jgicp.build_gicp_target(jnp.asarray(tpts), jnp.asarray(tmask), 2.0, k=20)
    jc, _ = jgicp.estimate_covariances(jnp.asarray(spts), jnp.asarray(smask), 2.0, k=20)
    tt = tgicp.build_gicp_target(*_t(tpts, tmask), 2.0, k=20)
    tc, _ = tgicp.estimate_covariances(*_t(spts, smask), 2.0, k=20)
    return dict(jt=jt, jc=np.asarray(jc), tt=tt, tc=tc, spts=spts, smask=smask)


# test_gicp_recovers_transform (covariances rotated with the cloud) and
# test_gicp_reciprocal_converges_and_filters (covariances of the unmoved source).
GICP_CASES = {
    "recover": dict(seed=11, rot=0.04, trans=0.4, rotate_covs=True, reciprocal=False),
    "reciprocal_off": dict(seed=5, rot=0.03, trans=0.3, rotate_covs=False, reciprocal=False),
    "reciprocal_on": dict(seed=5, rot=0.03, trans=0.3, rotate_covs=False, reciprocal=True),
}


def _assert_results_close(t, j):
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert abs(int(t.num_inliers) - int(j.num_inliers)) <= 0.01 * int(j.num_inliers)


@pytest.mark.parametrize("inputs", ["reference", "own"])
@pytest.mark.parametrize("case", list(GICP_CASES))
def test_gicp_align_matches_reference(gicp_problem, case, inputs):
    c, g = GICP_CASES[case], gicp_problem
    T_true = perturbation(seed=c["seed"], rot=c["rot"], trans=c["trans"])
    src = _moved(g["spts"], g["smask"], T_true)
    R = T_true[:3, :3]
    jcovs = np.einsum("ij,njk,lk->nil", R, g["jc"], R) if c["rotate_covs"] else g["jc"]
    kw = dict(max_correspondence_distance=2.0, max_iterations=64)
    jkw, tkw = dict(kw), dict(kw)
    if c["reciprocal"]:
        jkw.update(reciprocal=True, source_grid=jnb.build_hash_grid(
            jnp.asarray(src), jnp.asarray(g["smask"]), 2.0))
        tkw.update(reciprocal=True, source_grid=tnb.build_hash_grid(*_t(src, g["smask"]), 2.0))
    j = jgicp.gicp_align(g["jt"], jnp.asarray(src), jnp.asarray(g["smask"]), jnp.eye(4),
                         jnp.asarray(jcovs, jnp.float32), **jkw)
    if inputs == "reference":
        target, covs = gicp_target_from_numpy(_target_arrays(g["jt"])), torch.as_tensor(
            jcovs.astype(np.float32))
    else:
        Rt = torch.as_tensor(np.array(R))
        target = g["tt"]
        covs = Rt @ g["tc"] @ Rt.T if c["rotate_covs"] else g["tc"]
    t = tgicp.gicp_align(target, *_t(src, g["smask"]), torch.eye(4), covs, **tkw)
    _assert_results_close(t, j)
    assert bool(t.converged) and int(t.num_inliers) > 1000
    # The fixture's own checks: the perturbation is undone.
    err = t.transform.numpy() @ T_true
    assert np.linalg.norm(err[:3, 3]) < 0.1
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-3)


def test_gicp_align_edges(gicp_problem):
    """max_iterations stop (counts as converged, PCL parity), a source with no match
    (fitness +inf, never converged, the solve skipped), and reciprocal without a grid."""
    g = gicp_problem
    target = gicp_target_from_numpy(_target_arrays(g["jt"]))
    covs = torch.as_tensor(np.array(g["jc"]))
    src = _moved(g["spts"], g["smask"], perturbation(seed=5, rot=0.03, trans=0.3))
    for kw in (dict(max_iterations=1, transform_epsilon=1e-12),):
        j = jgicp.gicp_align(g["jt"], jnp.asarray(src), jnp.asarray(g["smask"]), jnp.eye(4),
                             jnp.asarray(g["jc"]), **kw)
        t = tgicp.gicp_align(target, *_t(src, g["smask"]), torch.eye(4), covs, **kw)
        _assert_results_close(t, j)
        assert int(t.iterations) == 1 and bool(t.converged)
    far = (src + np.float32(500.0)).astype(np.float32)
    j = jgicp.gicp_align(g["jt"], jnp.asarray(far), jnp.asarray(g["smask"]), jnp.eye(4),
                         jnp.asarray(g["jc"]))
    t = tgicp.gicp_align(target, *_t(far, g["smask"]), torch.eye(4), covs)
    assert int(t.num_inliers) == int(j.num_inliers) == 0
    assert not bool(t.converged) and not bool(j.converged)
    assert int(t.iterations) == int(j.iterations) == 1
    np.testing.assert_array_equal(t.transform.numpy(), np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="source_grid"):
        tgicp.gicp_align(target, *_t(src, g["smask"]), torch.eye(4), covs, reciprocal=True)


@pytest.mark.parametrize("use_reciprocal", [False, True])
def test_gicp_matcher_matches_reference(scans, use_reciprocal):
    """`make_gicp_matcher` end to end: each package builds its own target, source
    covariances and (with reciprocal) source grid."""
    target, source = scans
    tpts, tmask = _cloud(target, 8192)
    spts, smask = _cloud(source, 8192)
    src = _moved(spts, smask, perturbation(seed=9, rot=0.02, trans=0.2))
    jb, ja = jgicp.make_gicp_matcher(JGicpConfig(use_reciprocal=use_reciprocal))
    tb, ta = tgicp.make_gicp_matcher(TGicpConfig(use_reciprocal=use_reciprocal))
    jc, _ = jgicp.estimate_covariances(jnp.asarray(src), jnp.asarray(smask), 2.0)
    tc, _ = tgicp.estimate_covariances(*_t(src, smask), 2.0)
    j = ja(jb(jnp.asarray(tpts), jnp.asarray(tmask)), jnp.asarray(src), jnp.asarray(smask),
           jnp.eye(4), jc)
    t = ta(tb(*_t(tpts, tmask)), *_t(src, smask), torch.eye(4), tc)
    _assert_results_close(t, j)
    assert bool(t.converged)
