"""PyTorch port vs the JAX reference: FPFH features and RANSAC global registration
(`registration/features.py`), on the CPU at small sizes (4,096-point scans, 256
hypotheses). The same seeded numpy inputs go through both packages.

Tolerances, each beside its cause:
  * `estimate_normals`: the `valid` flags exact; normals to atol 1e-4 on every valid row
    but those whose normal is perpendicular to the view ray within 1e-3 (the flip toward
    the viewpoint is a sign test on that dot product; under 1% of rows: 1 of 2,578 and 0
    of 2,435 here), and at most 0.5% of rows past the tolerance: near-isotropic
    neighbourhoods, where the two smallest eigenvalues almost tie and the eigenvector
    turns by O(1) for a last-ulp change of the covariance (the einsum sums in another
    order). Measured: no row past 3e-6.
  * `compute_fpfh` from the same normals: `valid` exact; per row the L1 distance between
    the 33-bin histograms (each of the 3 blocks sums to 1) is below 0.05 on 99.5% of rows
    and at least 98% of rows are equal to 1e-6 a bin (measured: 100% / 100% of 2,558 rows
    and 99.96% / 99.4% of 2,402, largest L1 0.077): a pair whose alpha, phi or theta lies
    within rounding of a bin edge moves one of k votes to the next bin, and the FPFH
    aggregation spreads that vote over the row's neighbours.
  * `match_features` from the same features: `ok` agrees on at least 99.5% of rows
    (measured: all, 156 matches) and `idx` is equal wherever both say ok (a near-tie of
    two feature distances may resolve differently: the product sums in another order).
  * `_kabsch`: R and t to atol 1e-5 on non-degenerate triples (U and V are not compared:
    their signs are the SVD's choice).
  * `ransac_align_from_draws` fed the reference's threefry draws and the reference's
    keypoints, features and matches: `hits`, `ok` and `diag` exact, T to atol 1e-4.
  * `global_register` with the port's own generator: both offsets of
    `tests/test_features.py` recovered within that test's limits (5 deg, 1 m); two calls
    with one seed are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.core.pointcloud import PointCloud as JCloud
from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops.neighbors import build_hash_grid as j_build_hash_grid
from lidar_graph_slam_tpu.ops.voxel import voxel_downsample as j_voxel_downsample
from lidar_graph_slam_tpu.registration import features as jf
from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid as t_build_hash_grid
from lidar_graph_slam_tpu_torch.registration import features as tf

N_POINTS = 4096
HYPOTHESES = 256
OFFSETS = [(150.0, (18.0, -9.0, 0.3)), (75.0, (-12.0, 20.0, -0.2))]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it: an OpenMP
    pool per core in each of the suite's parallel test processes oversubscribes the cores
    so far that these tests slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _pair(yaw_deg, offset, seed=0):
    """(src, tgt, R, t): a scan and its copy moved by the inverse of (R, t), as
    `tests/test_features.py` builds them."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (8.0, -3.0, 1.5)
    tgt = simulate_scan(world, pose, rng, max_points=N_POINTS, noise=0.015)
    a = np.deg2rad(yaw_deg)
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.asarray(offset, np.float32)
    src = ((tgt - t) @ R).astype(np.float32)
    return src, tgt, R, t


def _errors(T, R, t):
    T = np.asarray(T)
    rot = np.rad2deg(np.arccos(np.clip((np.trace(T[:3, :3].T @ R) - 1.0) / 2.0, -1.0, 1.0)))
    return float(rot), float(np.linalg.norm(T[:3, 3] - t))


@pytest.fixture(scope="module")
def keypoints():
    """The reference's keypoint stage on one pair: per cloud the keypoints, mask, grid
    cell (2 m), normals, features and their flags, as numpy."""
    src, tgt, R, t = _pair(*OFFSETS[0])
    out = {"R": R, "t": t}
    for name, pts, vp in (("src", src, None), ("tgt", tgt, np.zeros(3, np.float32))):
        cloud = JCloud.from_array(pts, capacity=N_POINTS)
        g = j_voxel_downsample(cloud.points, cloud.mask, jnp.float32(1.0), capacity=N_POINTS)
        grid = j_build_hash_grid(g.points, g.mask, 2.0)
        nrm, n_ok = jf.estimate_normals(grid, g.points, g.mask, k=16,
                                        viewpoint=None if vp is None else jnp.asarray(vp))
        feats, f_ok = jf.compute_fpfh(grid, g.points, g.mask, nrm, k=32)
        out[name] = {k: np.asarray(v) for k, v in dict(
            points=g.points, mask=g.mask, normals=nrm, normals_ok=n_ok, feats=feats,
            feats_ok=f_ok).items()}
        out[name]["viewpoint"] = vp
    return out


def _port_grid(side):
    pts, mask = _t(side["points"]), _t(side["mask"])
    return t_build_hash_grid(pts, mask, 2.0), pts, mask


@pytest.mark.parametrize("name", ["src", "tgt"])
def test_estimate_normals_matches_reference(keypoints, name):
    side = keypoints[name]
    grid, pts, mask = _port_grid(side)
    nrm, ok = tf.estimate_normals(grid, pts, mask, k=16, viewpoint=side["viewpoint"])
    np.testing.assert_array_equal(ok.numpy(), side["normals_ok"])
    vp = np.zeros(3, np.float32) if side["viewpoint"] is None else side["viewpoint"]
    dot = np.sum(side["normals"] * (vp[None, :] - side["points"]), axis=-1)
    rows = side["normals_ok"]
    near_zero = rows & (np.abs(dot) < 1e-3)
    assert near_zero.sum() <= 0.01 * rows.sum()
    held = rows & ~near_zero
    diff = np.abs(nrm.numpy() - side["normals"]).max(axis=1)[held]
    assert np.mean(diff > 1e-4) <= 0.005, (np.mean(diff > 1e-4), diff.max())
    # Up to sign, the near-zero rows agree too.
    both = np.abs(np.sum(nrm.numpy() * side["normals"], axis=1))[near_zero]
    assert np.all(both > 0.99)


@pytest.mark.parametrize("name", ["src", "tgt"])
def test_compute_fpfh_matches_reference(keypoints, name):
    side = keypoints[name]
    grid, pts, mask = _port_grid(side)
    feats, ok = tf.compute_fpfh(grid, pts, mask, _t(side["normals"]), k=32)
    np.testing.assert_array_equal(ok.numpy(), side["feats_ok"])
    rows = side["feats_ok"]
    assert rows.sum() > 500
    np.testing.assert_array_equal(feats.numpy()[~rows], 0.0)
    np.testing.assert_allclose(feats.numpy()[rows].reshape(-1, 3, 11).sum(-1), 1.0, atol=1e-5)
    l1 = np.abs(feats.numpy() - side["feats"]).sum(axis=1)[rows]
    assert np.mean(l1 < 0.05) >= 0.995, (np.mean(l1 < 0.05), l1.max())
    assert np.mean(l1 < 1e-6 * 33) >= 0.98, np.mean(l1 < 1e-6 * 33)


def _valid(side):
    return side["normals_ok"] & side["feats_ok"]


def test_match_features_matches_reference(keypoints):
    s, t = keypoints["src"], keypoints["tgt"]
    j_idx, j_ok = jf.match_features(jnp.asarray(s["feats"]), jnp.asarray(_valid(s)),
                                    jnp.asarray(t["feats"]), jnp.asarray(_valid(t)))
    idx, ok = tf.match_features(_t(s["feats"]), _t(_valid(s)), _t(t["feats"]), _t(_valid(t)))
    j_idx, j_ok = np.asarray(j_idx), np.asarray(j_ok)
    assert j_ok.sum() >= 20
    assert np.mean(ok.numpy() == j_ok) >= 0.995
    both = ok.numpy() & j_ok
    np.testing.assert_array_equal(idx.numpy()[both], j_idx[both])


def test_match_features_identity():
    """`tests/test_features.py:test_match_features_identity` on the port."""
    f = _t(np.random.default_rng(0).uniform(size=(64, 33)).astype(np.float32))
    valid = torch.ones(64, dtype=torch.bool)
    idx, ok = tf.match_features(f, valid, f, valid)
    assert torch.equal(idx, torch.arange(64)) and bool(ok.all())


def test_kabsch_matches_reference():
    rng = np.random.default_rng(3)
    src = rng.uniform(-20, 20, size=(256, 3, 3)).astype(np.float32)
    a = rng.uniform(-np.pi, np.pi, size=256)
    R = np.zeros((256, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = (
        np.cos(a), -np.sin(a), np.sin(a), np.cos(a), 1.0)
    tgt = (np.einsum("hij,hpj->hpi", R, src) + rng.uniform(-30, 30, size=(256, 1, 3))
           + rng.normal(scale=0.05, size=(256, 3, 3))).astype(np.float32)
    w = np.ones((256, 3), np.float32)
    Tj = np.asarray(jf._kabsch(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w)))
    Tt = tf._kabsch(_t(src), _t(tgt), _t(w)).numpy()
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=2e-4)  # |t| ~ 50 m in f32
    np.testing.assert_allclose(np.linalg.det(Tt[:, :3, :3]), 1.0, atol=1e-5)
    # One masked cloud with weights, as the refinement calls it.
    cloud_w = (rng.random(500) > 0.4).astype(np.float32)
    s1 = rng.uniform(-20, 20, size=(500, 3)).astype(np.float32)
    t1 = (s1 @ R[0].T + np.float32([3.0, -2.0, 0.5])).astype(np.float32)
    T1j = np.asarray(jf._kabsch(jnp.asarray(s1), jnp.asarray(t1), jnp.asarray(cloud_w)))
    T1t = tf._kabsch(_t(s1), _t(t1), _t(cloud_w)).numpy()
    np.testing.assert_allclose(T1t, T1j, atol=1e-5)


@pytest.mark.parametrize("with_normals", [True, False])
def test_ransac_align_from_reference_draws(keypoints, with_normals):
    """The reference's draws (threefry, bound n_valid) through the port's inner
    function, from the reference's keypoints and matches: the same winner."""
    s, t = keypoints["src"], keypoints["tgt"]
    m_idx, m_ok = jf.match_features(jnp.asarray(s["feats"]), jnp.asarray(_valid(s)),
                                    jnp.asarray(t["feats"]), jnp.asarray(_valid(t)))
    key = jax.random.PRNGKey(5)
    normals = dict(src_normals=jnp.asarray(s["normals"]),
                   tgt_normals=jnp.asarray(t["normals"])) if with_normals else {}
    Tj, hj, okj, dj = jf.ransac_align(
        jnp.asarray(s["points"]), jnp.asarray(s["mask"]), jnp.asarray(t["points"]),
        jnp.asarray(t["mask"]), m_idx, m_ok, key, hypotheses=HYPOTHESES,
        occupancy_leaf=2.0, min_occupancy=0.5, **normals)
    n_valid = max(int(np.asarray(m_ok).sum()), 1)
    pos = np.asarray(jax.random.randint(key, (HYPOTHESES, 3), 0, n_valid))
    pos1 = np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (HYPOTHESES,), 0, n_valid))
    t_normals = dict(src_normals=_t(s["normals"]),
                     tgt_normals=_t(t["normals"])) if with_normals else {}
    Tt, ht, okt, dt = tf.ransac_align_from_draws(
        _t(s["points"]), _t(s["mask"]), _t(t["points"]), _t(t["mask"]), _t(m_idx), _t(m_ok),
        _t(pos), _t(pos1) if with_normals else None, occupancy_leaf=2.0, min_occupancy=0.5,
        **t_normals)
    assert int(ht) == int(hj) and bool(okt) == bool(okj)
    assert {k: int(v) for k, v in dt.items()} == {k: int(v) for k, v in dj.items()}
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    if with_normals:
        assert bool(okt)
        rot, trans = _errors(Tt, keypoints["R"], keypoints["t"])
        assert rot < 5.0 and trans < 1.0


def test_draw_positions_stay_below_the_bound():
    """`floor(rand * n_valid)` on the device: in [0, n_valid), and 0 when nothing is valid."""
    g = torch.Generator().manual_seed(0)
    for n in (0, 1, 7, 5000):
        pos = tf._draw_positions(g, (4096, 3), torch.tensor(n, dtype=torch.int32))
        assert pos.dtype == torch.int64 and int(pos.min()) >= 0
        assert int(pos.max()) <= max(n - 1, 0)
        if n == 5000:
            assert int(pos.max()) > 4900 and len(torch.unique(pos)) > 4000


def _register(src, tgt, **kw):
    sc, tc = JCloud.from_array(src, capacity=N_POINTS), JCloud.from_array(tgt, capacity=N_POINTS)
    return tf.global_register(
        _t(sc.points), _t(sc.mask), _t(tc.points), _t(tc.mask), hypotheses=2 * HYPOTHESES,
        max_keypoints=N_POINTS, tgt_viewpoint=np.zeros(3, np.float32), **kw)


@pytest.mark.parametrize("yaw_deg,offset", OFFSETS)
def test_global_register_recovers_large_offset(yaw_deg, offset):
    """`tests/test_features.py:test_global_register_recovers_large_offset` on the port,
    with its own generator, at 4,096 points and 512 hypotheses."""
    src, tgt, R, t = _pair(yaw_deg, offset)
    T, hits, ok, diag = _register(src, tgt, return_diag=True)
    assert bool(ok), f"global registration failed ({int(hits)} hits)"
    rot, trans = _errors(T, R, t)
    assert rot < 5.0, f"rotation error {rot:.2f} deg"
    assert trans < 1.0, f"translation error {trans:.2f} m"
    assert int(diag["n_3pt_valid"]) + int(diag["n_yaw_valid"]) > 0
    assert diag["best_is_yaw"].dtype == torch.bool


def test_global_register_is_deterministic():
    src, tgt, _, _ = _pair(*OFFSETS[1])
    a = _register(src, tgt, seed=11)
    b = _register(src, tgt, seed=11)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = _register(src, tgt, seed=12)  # another seed: other draws, the offset still found
    assert bool(c[2])
