"""The NDT voxel finalize and the 3x3 eigensolve of the port (`ops/voxel.py`:
`_finalize_ndt_plain`, `_eigh3x3`, `regularize_covariance`; the plain versions of the
`ndt_finalize` and `eigh3x3` kernels of `csrc/voxel_finalize.cu`) against the JAX
package's `_finalize_ndt`, `_eigh3x3`, `regularize_covariance` and `build_ndt_pyramid`.

The finalize is fed the same raw moments on both sides (the reference's
`_sorted_voxel_stats`), so only its own arithmetic is compared: a far-from-origin cloud,
the empty (bootstrap) ring, voxels of exactly `min_points` and `min_points - 1` points, and
1-point voxels, where `counts - 1` clamps to 1. And CPU tensors never load the kernel
library.

Tolerances: `tests/test_torch_voxel.py`'s. Keys, valid flags and the packed valid column
exact; means to atol 1e-5; inverse covariances to 1e-4 of each matrix's largest entry.
Eigenvalues to rtol/atol 1e-5, eigenvectors to atol 1e-5; already-diagonal matrices,
where neither side rotates, exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.ops import voxel as jv
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import voxel as tv
from lidar_graph_slam_tpu_torch.registration import features, gicp
from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid

PAD = 1.0e6
RES = 2.0

_jax_stats = jax.jit(jv._sorted_voxel_stats, static_argnums=(3,))
_jax_finalize = jax.jit(jv._finalize_ndt, static_argnums=(8, 9, 10))


def _padded(xyz, capacity):
    pts = np.full((capacity, 3), PAD, np.float32)
    pts[: len(xyz)] = xyz
    mask = np.zeros(capacity, bool)
    mask[: len(xyz)] = True
    return pts, mask


def _clusters(sizes, seed=0, offset=(0.0, 0.0, 0.0), spread=0.3):
    """One cluster of `n` points per entry of `sizes`, each inside its own 2 m voxel, moved
    by `offset`. A 1-point anchor at (-20, -20, -20) sets the min corner, so the voxel
    borders fall on even coordinates and each cluster (centres at odd coordinates, points
    within `spread` of them) fills one voxel."""
    rng = np.random.default_rng(seed)
    out = [np.full((1, 3), -20.0)]
    for i, n in enumerate(sizes):
        centre = np.array([10.0 * i + 1.0, 10.0 * (i % 3) + 1.0, 1.0 + 4.0 * (i % 2)])
        out.append(centre + rng.uniform(-spread, spread, (n, 3)))
    return (np.concatenate(out) + np.asarray(offset)).astype(np.float32)


def _scan(seed=0, offset=(0.0, 0.0, 0.0)):
    from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan

    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=20.0, density=1.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=2048,
                         max_range=25.0)
    return scan + np.asarray(offset, np.float32)


# min_points = 6: clusters of exactly 6, 5 (= min_points - 1), 1 and 2 points.
EDGE_SIZES = [6, 5, 1, 2, 6, 7, 5, 1, 40]
CLOUDS = {
    "scan": lambda: _padded(_scan(), 3000),
    "scan_far": lambda: _padded(_scan(seed=1, offset=(812.5, -433.0, 21.0)), 3000),
    "empty": lambda: _padded(np.zeros((0, 3), np.float32), 512),
    "edge_counts": lambda: _padded(_clusters(EDGE_SIZES), 256),
    "edge_counts_far": lambda: _padded(_clusters(EDGE_SIZES, seed=1,
                                                 offset=(-1520.0, 736.0, 48.0)), 256),
}


def _stats(pts, mask, capacity):
    """The reference's raw moments of a cloud, as numpy."""
    out = _jax_stats(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(RES), capacity)
    return [np.array(x) for x in out]


# The inverse of a zero covariance: 1 / (0.01 x 1e-9) on the diagonal, in float32.
ZERO_COV_INV = np.float32(1.0) / (np.float32(0.01) * np.float32(1e-9))


def _assert_rows(j, t, counts, merged=False):
    """j: the reference's NdtVoxelMap; t: the port's rows (keys, means, inv_covs, valid,
    packed) or an NdtVoxelMap; counts: the voxels' point counts.

    A valid 1-point voxel (min_points = 1) has a covariance of exactly 0: the port
    computes 0 (outer - (1 x m) m cancels exactly) and inverts the floor, ZERO_COV_INV x I.
    The reference's XLA program on the CPU contracts that subtraction into an FMA and
    keeps the rounding residue of m^2 (~1e-10), whose regularized "inverse" is noise of
    ~1e8-1e11; those rows are held to the exact value instead. In a coarse map (`merged`)
    the shift of the fine moments leaves such a residue on both sides, so its valid
    1-point voxels' inverses are noise on both and are not compared."""
    if isinstance(t, tuple):
        t = dict(zip(("keys", "means", "inv_covs", "valid", "packed"), t))
    else:
        t = {f: getattr(t, f) for f in ("keys", "means", "inv_covs", "valid", "packed")}
    np.testing.assert_array_equal(t["keys"].numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t["means"].numpy(), np.asarray(j.means), atol=1e-5, rtol=0)
    ji, ti = np.asarray(j.inv_covs), t["inv_covs"].numpy()
    single = np.asarray(j.valid) & (np.asarray(counts) == 1)
    if not merged:
        np.testing.assert_array_equal(ti[single], np.broadcast_to(np.eye(3) * ZERO_COV_INV,
                                                                  ti[single].shape))
    ji, ti = ji[~single], ti[~single]
    scale = np.abs(ji).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(ti - ji) <= 1e-4 * scale), np.abs(ti - ji).max()
    jp, tp = np.asarray(j.packed), t["packed"].numpy()
    np.testing.assert_array_equal(tp[:, 12], jp[:, 12])
    np.testing.assert_array_equal(tp[:, 13:], 0.0)
    # The packed row holds the same mean and inverse as the map's own fields.
    np.testing.assert_array_equal(tp[:, 0:3], t["means"].numpy())
    np.testing.assert_array_equal(tp[:, 3:12], t["inv_covs"].numpy().reshape(-1, 9))
    assert np.isfinite(tp).all()


@pytest.mark.parametrize("min_points", [6, 1])
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_finalize_plain_matches_reference(cloud, min_points):
    pts, mask = CLOUDS[cloud]()
    capacity = 64 if cloud.startswith("edge") else 2048
    seg_keys, counts, sums, outer, origin, num_voxels, occupied = _stats(pts, mask, capacity)
    j = _jax_finalize(jnp.asarray(seg_keys), jnp.asarray(counts), jnp.asarray(sums),
                      jnp.asarray(outer), jnp.asarray(origin), jnp.asarray(num_voxels),
                      jnp.asarray(occupied), jnp.float32(RES), capacity, min_points,
                      jnp.float32)
    args = [torch.as_tensor(x) for x in (seg_keys, counts, sums, outer, occupied, origin)]
    rows = tv._finalize_ndt_plain(*args, tv.as_f32(RES, args[1]), min_points)
    _assert_rows(j, rows, counts)
    if cloud.startswith("edge"):
        n = counts[occupied]
        # Every count of the fixture is present, and validity is exactly n >= min_points.
        assert sorted(set(n.astype(int))) == sorted(set(EDGE_SIZES))
        np.testing.assert_array_equal(rows[3].numpy()[occupied], n >= min_points)
    if cloud == "empty":
        assert not rows[3].any() and not occupied.any()
        assert (rows[0] == tv.INVALID_KEY).all() and (rows[1] == PAD).all()
    # The map built from those rows: the wrapper takes the plain version on the CPU.
    vmap = tv._finalize_ndt(args[0], args[1], args[2], args[3], args[5],
                            torch.as_tensor(num_voxels), args[4], tv.as_f32(RES, args[1]),
                            min_points)
    for a, b in zip(rows, (vmap.keys, vmap.means, vmap.inv_covs, vmap.valid, vmap.packed)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(vmap.table.numpy(), np.asarray(j.table))


@pytest.mark.parametrize("min_points", [6, 1])
@pytest.mark.parametrize("cloud", ["edge_counts", "scan_far", "empty"])
def test_pyramid_matches_reference(cloud, min_points):
    """End to end, each side from its own moments. The far-away clusters are held through
    the finalize alone, on shared moments (above): a 0.3 m cluster at |x| ~ 1.5 km has
    local coordinates rounded to ~1e-3 of its spread, so two summation orders give
    covariances apart by more than the tolerance on either package."""
    pts, mask = CLOUDS[cloud]()
    jc, jf = jv.build_ndt_pyramid(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(RES), 2,
                                  capacity=512, coarse_capacity=256, min_points=min_points)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    tc, tf = tv.build_ndt_pyramid(tp, tm, RES, 2, capacity=512, coarse_capacity=256,
                                  min_points=min_points)
    stats = tv._sorted_voxel_stats(tp, tm, tv.as_f32(RES, tp), 512)
    coarse_counts = tv._coarse_voxel_stats(*stats[:4], stats[6], tv.as_f32(RES, tp), 2,
                                           256)[1]
    for j, t, counts, merged in ((jf, tf, stats[1], False), (jc, tc, coarse_counts, True)):
        _assert_rows(j, t, counts.numpy(), merged)
        np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
        assert int(t.num_voxels) == int(j.num_voxels)


def _structured():
    """Already-diagonal matrices (unsorted, repeated, zero, negative: no rotation is taken,
    so the eigenpairs are exact), then tau = 0 (equal diagonal entries with a nonzero
    coupling) in each of the three planes, and at the first rotation of a fully coupled
    matrix."""
    mats = [np.diag(d) for d in ([3.0, 1.0, 2.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                                 [5.0, 5.0, 0.5], [-1.0, 2.0, -3.0], [1e-6, 4.0, 1e-6])]
    for p, q in ((0, 1), (0, 2), (1, 2)):
        m = np.diag([1.0, 1.0, 1.0]) * 2.0
        m[p, q] = m[q, p] = 1.0
        mats.append(m)
    mats.append(np.full((3, 3), 1.0) + np.eye(3))  # tau = 0 first, the third row coupled
    return np.stack(mats).astype(np.float32)


def test_eigh3x3_structured_matrices_exact():
    S = _structured()
    jw, jV = (np.asarray(x) for x in jv._eigh3x3(jnp.asarray(S)))
    tw, tV = (x.numpy() for x in tv._eigh3x3(torch.as_tensor(S)))
    np.testing.assert_array_equal(tw[:6], jw[:6])
    np.testing.assert_array_equal(tV[:6], jV[:6])
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tV, jV, atol=1e-5)
    # Ascending, and the tau = 0 cases took the 45-degree rotation: w = (1, 2, 3).
    assert np.all(np.diff(tw, axis=1) >= 0)
    for k in range(6, 9):
        np.testing.assert_allclose(tw[k], [1.0, 2.0, 3.0], atol=1e-6)
    np.testing.assert_allclose(np.einsum("mij,mj,mkj->mik", tV, tw, tV), S, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_regularize_covariance_matches_reference(seed):
    """Random covariances at the map's scale (local moments of 2 m voxels), near-planar
    and near-linear ones whose floor is active, and the structured matrices."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(512, 3, 3)).astype(np.float32) * 0.3
    A[128:256, 2] *= 1e-3          # planar: one eigenvalue under the floor
    A[256:384, 1:] *= 1e-3         # linear: two
    S = np.concatenate([A @ np.swapaxes(A, 1, 2), _structured()]).astype(np.float32)
    jc, ji = (np.asarray(x) for x in jv.regularize_covariance(jnp.asarray(S)))
    tc, ti = (x.numpy() for x in tv.regularize_covariance(torch.as_tensor(S)))
    for j, t in ((jc, tc), (ji, ti)):
        scale = np.abs(j).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(t - j) <= 1e-4 * scale), np.abs(t - j).max()
    # The inverse is the regularized covariance's inverse.
    eye = np.einsum("mij,mjk->mik", tc.astype(np.float64), ti.astype(np.float64))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=2e-3)


def test_scaled_gram_sums_in_order():
    """`_scaled_gram` is V diag(d) V^T summed k = 0, 1, 2, each step rounded to float32
    (the kernel's order): equal to that sum written out in numpy's float32."""
    rng = np.random.default_rng(3)
    V = rng.normal(size=(256, 3, 3)).astype(np.float32)
    d = rng.uniform(0.01, 100.0, (256, 3)).astype(np.float32)
    M = V * d[:, None, :]
    ref = (M[:, :, 0, None] * V[:, None, :, 0] + M[:, :, 1, None] * V[:, None, :, 1]) \
        + M[:, :, 2, None] * V[:, None, :, 2]
    out = tv._scaled_gram(torch.as_tensor(V), torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_cpu_tensors_never_load_the_kernel_library(monkeypatch):
    """Every caller of the two kernels takes the plain version on CPU tensors: the NDT
    map and pyramid builds, GICP's covariances and the FPFH normals run with
    `load_library` made to raise, and no launch is counted."""
    def refuse():
        raise AssertionError("load_library called for CPU tensors")

    monkeypatch.setattr(tk, "load_library", refuse)
    before = (tk.ndt_finalize.launches, tk.eigh3x3.launches, tk.thread_launches())
    pts, mask = (torch.as_tensor(x) for x in CLOUDS["scan"]())
    coarse, fine = tv.build_ndt_pyramid(pts, mask, RES, 2, capacity=2048, coarse_capacity=1024)
    vmap = tv.build_ndt_map(pts, mask, RES, capacity=2048)
    assert torch.equal(vmap.packed, fine.packed) and int(fine.valid.sum()) > 0
    covs, ok = gicp.estimate_covariances(pts, mask, 1.0)
    assert bool(ok.any())
    normals, nok = features.estimate_normals(build_hash_grid(pts, mask, 1.0), pts[:256],
                                             mask[:256])
    assert bool(nok.any())
    w, V = tk.eigh3x3(covs[:64].contiguous())
    assert torch.equal(w, tv._eigh3x3(covs[:64])[0])
    assert (tk.ndt_finalize.launches, tk.eigh3x3.launches, tk.thread_launches()) == before
