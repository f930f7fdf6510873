"""PyTorch port vs the JAX reference: voxel downsampling, NDT map and pyramid builds,
the dense table and the DIRECT7 lookup (`ops/voxel.py` of both packages).

Tolerances: keys, counts, `num_voxels`, `overflow`, masks, the dense table and the
lookup hits are EXACT (same float32 key arithmetic, stable sorts on both sides). Means
and centroids to atol 1e-5 (per-voxel sums added in another order). Inverse covariances
to rtol 1e-4 of each voxel's largest entry (the 1e-2 eigenvalue floor makes entries span
two decades within one matrix, so the bound is relative to the matrix, not the entry).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops import voxel as jv
from lidar_graph_slam_tpu_torch.ops import voxel as tv

PAD = 1.0e6


def _padded(xyz, capacity):
    pts = np.full((capacity, 3), PAD, np.float32)
    pts[: len(xyz)] = xyz
    mask = np.zeros(capacity, bool)
    mask[: len(xyz)] = True
    return pts, mask


def _scan_cloud(seed=0, capacity=3000, offset=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=20.0, density=1.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=2048,
                         max_range=25.0)
    return _padded(scan + np.asarray(offset, np.float32), capacity)


CLOUDS = {
    "scan": lambda: _scan_cloud(),
    # Far from the origin: the voxel-local moments must hold at |x| ~ 1e3 m.
    "scan_far": lambda: _scan_cloud(seed=1, offset=(812.5, -433.0, 21.0)),
    "uniform": lambda: _padded(np.random.default_rng(2).uniform(-6, 6, (2500, 3)), 2600),
    "empty": lambda: _padded(np.zeros((0, 3), np.float32), 512),
}


_jax_voxel_stats = jax.jit(jv._sorted_voxel_stats, static_argnums=(3,))


def _both(pts, mask):
    return (jnp.asarray(pts), jnp.asarray(mask)), (torch.as_tensor(pts), torch.as_tensor(mask))


def _assert_map_equal(jm, tm):
    for field in ("keys", "valid", "num_voxels", "table"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jm, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tm.origin.numpy(), np.asarray(jm.origin))
    np.testing.assert_allclose(tm.means.numpy(), np.asarray(jm.means), atol=1e-5, rtol=0)
    ji, ti = np.asarray(jm.inv_covs), tm.inv_covs.numpy()
    scale = np.abs(ji).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(ti - ji) <= 1e-4 * scale), np.abs(ti - ji).max()
    np.testing.assert_array_equal(tm.packed[:, 12].numpy(), np.asarray(jm.packed)[:, 12])
    assert np.isfinite(tm.packed.numpy()).all()


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("leaf,capacity", [(0.3, 4096), (0.3, 600), (1.0, 4096)])
def test_voxel_downsample_matches_reference(cloud, leaf, capacity):
    (jp, jm), (tp, tm) = _both(*CLOUDS[cloud]())
    j = jv.voxel_downsample(jp, jm, jnp.float32(leaf), capacity=capacity)
    t = tv.voxel_downsample(tp, tm, leaf, capacity=capacity)
    assert int(t.num_voxels) == int(j.num_voxels)
    assert bool(t.overflow) == bool(j.overflow)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cloud", list(CLOUDS))
@pytest.mark.parametrize("capacity", [4096, 64])
def test_build_ndt_map_matches_reference(cloud, capacity):
    (jp, jm), (tp, tm) = _both(*CLOUDS[cloud]())
    _assert_map_equal(jv.build_ndt_map(jp, jm, jnp.float32(2.0), capacity=capacity),
                      tv.build_ndt_map(tp, tm, 2.0, capacity=capacity))
    # The raw per-voxel moments: keys and counts exact, sums to atol 1e-5.
    js = _jax_voxel_stats(jp, jm, jnp.float32(2.0), capacity)
    res = tv.as_f32(2.0, tp)
    origin, runs, pts_sorted, _ = tv._sorted_points(tp, tm, res, capacity)
    seg_keys, stats = tv._point_moments(runs, pts_sorted, origin, res)
    occupied = np.asarray(js[6])
    np.testing.assert_array_equal((runs[2][:capacity] > 0).numpy(), occupied)
    np.testing.assert_array_equal(seg_keys.numpy()[occupied], np.asarray(js[0])[occupied])
    np.testing.assert_array_equal(stats[:, 0].numpy(), np.asarray(js[1]))
    np.testing.assert_allclose(stats[:, 1:4].numpy(), np.asarray(js[2]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_build_ndt_pyramid_matches_reference(cloud):
    (jp, jm), (tp, tm) = _both(*CLOUDS[cloud]())
    jc, jf = jv.build_ndt_pyramid(jp, jm, jnp.float32(2.0), 2, capacity=2048, coarse_capacity=1024)
    tc, tf = tv.build_ndt_pyramid(tp, tm, 2.0, 2, capacity=2048, coarse_capacity=1024)
    _assert_map_equal(jf, tf)
    _assert_map_equal(jc, tc)
    if cloud == "empty":
        # The bootstrap target (an all-invalid ring): no voxels, an all-miss table, no NaN.
        for m in (tc, tf):
            assert int(m.num_voxels) == 0
            assert int((m.table >= 0).sum()) == 0


@pytest.mark.parametrize("cloud", ["scan", "scan_far", "uniform"])
def test_lookup_direct7_matches_reference(cloud):
    pts, mask = CLOUDS[cloud]()
    (jp, jm), (tp, tm) = _both(pts, mask)
    jmap = jv.build_ndt_map(jp, jm, jnp.float32(2.0), capacity=4096)
    tmap = tv.build_ndt_map(tp, tm, 2.0, capacity=4096)
    # Queries: jittered cloud points (hits), plus far-away and padded rows (misses).
    q = pts[:700] + np.random.default_rng(3).normal(scale=0.7, size=(700, 3)).astype(np.float32)
    q[:20] += 5000.0
    jmeans, jicovs, jhit = jv.lookup_direct7(jmap, jnp.asarray(q))
    tmeans, ticovs, thit = tv.lookup_direct7(tmap, torch.as_tensor(q))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    h = np.asarray(jhit)
    assert h.any() and not h.all()
    np.testing.assert_allclose(tmeans.numpy()[h], np.asarray(jmeans)[h], atol=1e-5, rtol=0)
    ji = np.asarray(jicovs)[h]
    assert np.all(np.abs(ticovs.numpy()[h] - ji) <= 1e-4 * np.abs(ji).max(axis=(1, 2), keepdims=True))


def test_eigh3x3_matches_reference_including_tau_zero(rng):
    """Random SPD matrices plus the tau = 0 case (equal diagonal entries with nonzero
    coupling), which must take the exact 45-degree rotation."""
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    S = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(3, dtype=np.float32)
    S[:4] = np.array([[2.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    jw, jV = jv._eigh3x3(jnp.asarray(S))
    tw, tV = tv._eigh3x3(torch.as_tensor(S))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), atol=1e-5)
    np.testing.assert_allclose(tw.numpy()[0], [1.0, 1.0, 3.0], atol=1e-6)
    jc, ji = jv.regularize_covariance(jnp.asarray(S))
    tc, ti = tv.regularize_covariance(torch.as_tensor(S))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-4, atol=1e-4)


def test_dense_table_and_keys_match_reference(rng):
    coords = rng.integers(0, 300, size=(500, 3)).astype(np.int32)
    coords[:, 2] %= 80
    coords[-10:] = coords[:10]  # duplicate cells: the first row must win
    valid = rng.random(500) > 0.2
    jk = jv.pack_key(jnp.asarray(coords))
    tk = tv.pack_key(torch.as_tensor(coords))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for a, b in zip(tv.unpack_key(tk), jv.unpack_key(jk)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dims = jv.TABLE_DIMS
    np.testing.assert_array_equal(
        tv.build_dense_table(tk, torch.as_tensor(valid), dims).numpy(),
        np.asarray(jv.build_dense_table(jk, jnp.asarray(valid), dims)))
