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


def _levels(pts, mask, capacity, min_points, factor=2):
    """`ndt_finalize_plain` on both levels of a pyramid as `build_ndt_pyramid` calls it:
    ((moments, rows) of the fine level from its sorted points, the same of the coarse
    level from the merged fine moments)."""
    res = tv.as_f32(RES, pts)
    origin, runs, pts_sorted, num_voxels = tv._sorted_points(pts, mask, res, capacity)
    fine = tv.ndt_finalize_plain(runs, origin, res, min_points, points=pts_sorted)
    occupied = torch.arange(capacity) < torch.clamp(num_voxels, max=capacity)
    cruns, order, _ = tv._coarse_runs(fine[0], occupied, factor, capacity // 2)
    coarse = tv.ndt_finalize_plain(cruns, origin, res * factor, min_points,
                                   merge=(order, fine[0], res, factor))
    return fine, coarse


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
    # The map built from those rows.
    vmap = tv._voxel_map(rows, args[5], tv.as_f32(RES, args[1]), torch.as_tensor(num_voxels))
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
    fine, coarse = _levels(tp, tm, 512, min_points)
    for j, t, counts, merged in ((jf, tf, fine[0][1][:, 0], False),
                                 (jc, tc, coarse[0][1][:, 0], True)):
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


# -- the finalize from the sorted rows (`ndt_finalize_plain`, both modes) ----------------

@pytest.mark.parametrize("min_points", [6, 1])
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_ndt_finalize_plain_points_mode_matches_reference(cloud, min_points):
    """Points mode (the fine level from the sorted points) against the reference's
    `_sorted_voxel_stats` + `_finalize_ndt`: counts and keys exact, sums and outer sums to
    atol 1e-5, the rows as `_assert_rows`."""
    pts, mask = CLOUDS[cloud]()
    capacity = 64 if cloud.startswith("edge") else 2048
    moments, rows = _levels(torch.as_tensor(pts), torch.as_tensor(mask), capacity,
                            min_points)[0]
    seg_keys, counts, sums, outer, origin, num_voxels, occupied = _stats(pts, mask, capacity)
    t_keys, t_stats = (x.numpy() for x in moments)
    np.testing.assert_array_equal(t_keys[occupied], seg_keys[occupied])
    np.testing.assert_array_equal(t_stats[:, 0], counts)
    np.testing.assert_allclose(t_stats[:, 1:4], sums, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_stats[:, 4:13], outer.reshape(-1, 9), atol=1e-5, rtol=0)
    j = _jax_finalize(jnp.asarray(seg_keys), jnp.asarray(counts), jnp.asarray(sums),
                      jnp.asarray(outer), jnp.asarray(origin), jnp.asarray(num_voxels),
                      jnp.asarray(occupied), jnp.float32(RES), capacity, min_points,
                      jnp.float32)
    _assert_rows(j, rows, counts)


def _merge64(seg_keys, stats, occupied, factor, coarse_capacity):
    """The coarse level's moments from fine moments in float64: each occupied fine row
    shifted to its parent coarse voxel's corner, the rows of a coarse key summed; the
    first `coarse_capacity` coarse keys in ascending order. Returns (keys, stats)."""
    coords = np.stack([x.numpy() for x in tv.unpack_key(torch.as_tensor(seg_keys))], -1)
    ckeys = tv.pack_key(torch.as_tensor(coords // factor)).numpy()
    off = (coords - (coords // factor) * factor) * RES
    st = stats.astype(np.float64)
    n, s, o = st[:, 0], st[:, 1:4], st[:, 4:13].reshape(-1, 3, 3)
    rows = np.concatenate([n[:, None], s + n[:, None] * off, (
        o + off[:, :, None] * s[:, None, :] + s[:, :, None] * off[:, None, :]
        + n[:, None, None] * off[:, :, None] * off[:, None, :]).reshape(-1, 9)], 1)
    keys = np.unique(ckeys[occupied])[:coarse_capacity]
    out = np.zeros((coarse_capacity, 13))
    for r, k in enumerate(keys):
        out[r] = rows[occupied & (ckeys == k)].sum(0)
    return keys, out


@pytest.mark.parametrize("cloud,min_points", [
    ("scan", 6), ("scan_far", 6), ("scan_far", 1), ("edge_counts", 6), ("edge_counts", 1),
    ("empty", 6), ("empty", 1)])
def test_ndt_finalize_plain_rows_mode_matches_reference(cloud, min_points):
    """Rows mode (a coarse level from the fine moments, `_coarse_runs` then the merge) fed
    the reference's own fine moments: coarse keys and counts exact and sums and outer sums
    to rtol 1e-5 / atol 1e-4 (a float32 sum of up to a few hundred shifted rows against
    the float64 merge `_merge64`), and its rows against the reference's `_finalize_ndt` on
    those coarse moments as `_assert_rows` (merged). End to end against the reference's
    `build_ndt_pyramid`: `test_pyramid_matches_reference`. Its rows are not held to the
    reference where the merged covariance cancels: the far-away clusters (as
    `test_pyramid_matches_reference` says) and `scan` at min_points 1, whose one 2-point
    coarse voxel has a rank-1 covariance that the reference's FMA-contracted
    `outer - (cnt m) m` rounds to another largest eigenvalue (1.5e-4 of the inverse's
    scale); the port's rows there equal the moments-in composition bit for bit
    (`test_cpu_pyramid_bit_equal_to_the_moments_in_composition`)."""
    pts, mask = CLOUDS[cloud]()
    capacity = 64 if cloud.startswith("edge") else 2048
    seg_keys, counts, sums, outer, origin, num_voxels, occupied = _stats(pts, mask, capacity)
    stats = np.concatenate([counts[:, None], sums, outer.reshape(-1, 9)], 1)
    fine = (torch.as_tensor(seg_keys), torch.as_tensor(stats))
    res = tv.as_f32(RES, fine[1])
    cruns, order, cnum = tv._coarse_runs(fine, torch.as_tensor(occupied), 2, capacity // 2)
    (c_keys, c_stats), rows = tv.ndt_finalize_plain(
        cruns, torch.as_tensor(origin), res * 2, min_points, merge=(order, fine, res, 2))
    keys64, stats64 = _merge64(seg_keys, stats, occupied, 2, capacity // 2)
    c_occupied = np.arange(capacity // 2) < len(keys64)
    assert int(cnum) == len(np.unique(tv.pack_key(torch.as_tensor(np.stack(
        [x.numpy() for x in tv.unpack_key(torch.as_tensor(seg_keys[occupied]))], -1) // 2))))
    np.testing.assert_array_equal(c_keys.numpy()[c_occupied], keys64)
    np.testing.assert_array_equal(c_stats.numpy()[:, 0], stats64[:, 0])
    np.testing.assert_allclose(c_stats.numpy()[:, 1:], stats64[:, 1:], rtol=1e-5, atol=1e-4)
    cs = c_stats.numpy()
    j = _jax_finalize(jnp.asarray(c_keys.numpy()), jnp.asarray(cs[:, 0]),
                      jnp.asarray(cs[:, 1:4]), jnp.asarray(cs[:, 4:13].reshape(-1, 3, 3)),
                      jnp.asarray(origin), jnp.asarray(cnum.numpy()), jnp.asarray(c_occupied),
                      jnp.float32(2 * RES), capacity // 2, min_points, jnp.float32)
    _assert_rows(j, rows, cs[:, 0], merged=True)


def _parent_composition(points, mask, capacity, coarse_capacity, min_points, factor=2):
    """The pyramid as the moments-in finalize built it: the [N, 13] column block of the
    sorted points summed by `_segment_sum`, the coarse merge of the fine stat rows, then
    `_finalize_ndt_plain` and the table on each level, written out step by step."""
    res = tv.as_f32(RES, points)
    keys, origin = tv.cell_keys_plain(points, mask, res)
    keys_sorted, order = torch.sort(keys, stable=True)
    pts_sorted = points[order]
    valid_sorted = keys_sorted != tv.INVALID_KEY
    first, _, lengths, starts = tv._sorted_runs(keys_sorted, capacity)
    row_coords = torch.stack(tv.unpack_key(torch.where(valid_sorted, keys_sorted, 0)), dim=-1)
    loc = torch.where(valid_sorted[:, None], pts_sorted - (origin + row_coords.float() * res),
                      0.0)
    cols = torch.cat([valid_sorted.float()[:, None], loc,
                      (loc[:, :, None] * loc[:, None, :]).reshape(-1, 9)], dim=1)
    stats = tv._segment_sum(cols, lengths, capacity)
    seg_keys = tv._segment_keys(keys_sorted, starts, lengths, capacity)
    num = torch.sum(first.to(torch.int32))
    occupied = torch.arange(capacity) < torch.clamp(num, max=capacity)
    counts, sums, outer = stats[:, 0], stats[:, 1:4], stats[:, 4:13].reshape(capacity, 3, 3)
    fine = tv._finalize_ndt_plain(seg_keys, counts, sums, outer, occupied, origin, res,
                                  min_points)
    coords = torch.stack(tv.unpack_key(torch.where(occupied, seg_keys, 0)), dim=-1)
    ccoords = coords // factor
    off = (coords - ccoords * factor).float() * res
    live = occupied & (counts > 0)
    ckeys = torch.where(live, tv.pack_key(ccoords), tv.INVALID_KEY)
    outer_c = (outer + off[:, :, None] * sums[:, None, :] + sums[:, :, None] * off[:, None, :]
               + counts[:, None, None] * off[:, :, None] * off[:, None, :])
    ck_s, order = torch.sort(ckeys, stable=True)
    rows = torch.cat([counts[:, None], sums + counts[:, None] * off,
                      outer_c.reshape(capacity, 9)], dim=1)[order]
    first_c, _, clengths, cstarts = tv._sorted_runs(ck_s, coarse_capacity)
    cstats = tv._segment_sum(torch.where((ck_s != tv.INVALID_KEY)[:, None], rows, 0.0),
                             clengths, coarse_capacity)
    cseg_keys = tv._segment_keys(ck_s, cstarts, clengths, coarse_capacity)
    cnum = torch.sum(first_c.to(torch.int32))
    coccupied = torch.arange(coarse_capacity) < torch.clamp(cnum, max=coarse_capacity)
    coarse = tv._finalize_ndt_plain(cseg_keys, cstats[:, 0], cstats[:, 1:4],
                                    cstats[:, 4:13].reshape(coarse_capacity, 3, 3),
                                    coccupied, origin, res * factor, min_points)
    return coarse, fine, (cnum, num)


@pytest.mark.parametrize("min_points", [6, 1])
@pytest.mark.parametrize("cloud", list(CLOUDS))
def test_cpu_pyramid_bit_equal_to_the_moments_in_composition(cloud, min_points):
    """On the CPU `build_ndt_pyramid` and `build_ndt_map` take the plain version, and
    their maps equal the moments-in composition (`_parent_composition`) bit for bit."""
    pts, mask = (torch.as_tensor(x) for x in CLOUDS[cloud]())
    capacity = 64 if cloud.startswith("edge") else 2048
    coarse, fine, nums = _parent_composition(pts, mask, capacity, capacity // 2, min_points)
    tc, tf = tv.build_ndt_pyramid(pts, mask, RES, 2, capacity=capacity,
                                  coarse_capacity=capacity // 2, min_points=min_points)
    vmap = tv.build_ndt_map(pts, mask, RES, capacity=capacity, min_points=min_points)
    fields = ("keys", "means", "inv_covs", "valid", "packed")
    for ref, maps, num in ((coarse, (tc,), nums[0]), (fine, (tf, vmap), nums[1])):
        for m in maps:
            assert int(m.num_voxels) == int(num)
            for name, r in zip(fields, ref):
                a = getattr(m, name)
                assert a.dtype == r.dtype and torch.equal(
                    a.reshape(-1).view(torch.uint8), r.reshape(-1).view(torch.uint8)), name


# The row the kernel writes without the eigensolve: unoccupied rows' keys, means and
# packed row, and the identity inverse of every row that is not valid.
DEAD_PACKED = np.array([PAD, PAD, PAD, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0], np.float32)


@pytest.mark.parametrize("min_points", [6, 1])
def test_dead_row_constant_equals_the_plain_rows(min_points):
    """The constant an unoccupied or under-`min_points` row takes in the kernel (no
    eigensolve: INVALID_KEY, PAD_VALUE means, the identity inverse, valid 0) is what
    `_finalize_ndt_plain` computes for it, bit for bit, +0.0 in every off-diagonal; the
    identity goes through the eigensolve and the floored inverse unchanged."""
    pts, mask = (torch.as_tensor(x) for x in CLOUDS["edge_counts"]())
    (_, stats), (keys, means, inv_covs, valid, packed) = _levels(pts, mask, 64, min_points)[0]
    eye = np.eye(3, dtype=np.float32)
    unoccupied = (stats[:, 0] == 0).numpy()
    dead = ~valid.numpy()
    assert unoccupied.any() and (dead & ~unoccupied).any() == (min_points > 1)
    np.testing.assert_array_equal(keys.numpy()[unoccupied], tv.INVALID_KEY)
    assert means.numpy()[unoccupied].tobytes() == np.full((unoccupied.sum(), 3), PAD,
                                                          np.float32).tobytes()
    assert packed.numpy()[unoccupied].tobytes() == np.tile(DEAD_PACKED,
                                                           (unoccupied.sum(), 1)).tobytes()
    assert inv_covs.numpy()[dead].tobytes() == np.tile(eye, (dead.sum(), 1, 1)).tobytes()
    assert packed.numpy()[dead][:, 3:].tobytes() == np.tile(DEAD_PACKED[3:],
                                                            (dead.sum(), 1)).tobytes()
    _, inv = tv.regularize_covariance(torch.eye(3).expand(4, 3, 3))
    assert inv.numpy().tobytes() == np.tile(eye, (4, 1, 1)).tobytes()


@pytest.mark.parametrize("cloud", ["scan", "scan_far", "edge_counts_far"])
def test_six_outer_sums_give_the_nine(cloud):
    """loc_i loc_j == loc_j loc_i exactly, so the fine level's outer sums are symmetric
    bit for bit: the kernel sums the 6 distinct products and writes the 9."""
    pts, mask = (torch.as_tensor(x) for x in CLOUDS[cloud]())
    res = tv.as_f32(RES, pts)
    origin, runs, pts_sorted, _ = tv._sorted_points(pts, mask, res, 2048)
    outer = tv._point_moments(runs, pts_sorted, origin, res)[1][:, 4:13].reshape(-1, 3, 3)
    bits = outer.view(torch.int32)
    assert torch.equal(bits, bits.transpose(1, 2)) and bool((outer != 0).any())


def test_segment_sum_adds_each_run_in_order_from_zero():
    """`_segment_sum` (the plain version's run sums) adds each run's rows in order,
    starting from 0.0, in float32: equal bit for bit to that loop written out, on rows
    whose order matters (large and small magnitudes, signed zeros) and empty runs."""
    rng = np.random.default_rng(7)
    lengths = np.array([3, 0, 7, 1, 0, 12, 5])
    data = (rng.normal(size=(lengths.sum(), 4)) * 10.0 ** rng.integers(-4, 5, (lengths.sum(), 4))
            ).astype(np.float32)
    data[0, 0], data[3, 1] = -0.0, -0.0
    out = tv._segment_sum(torch.as_tensor(data), torch.as_tensor(lengths), len(lengths))
    ref = np.zeros((len(lengths), 4), np.float32)
    start = 0
    for r, n in enumerate(lengths):
        for row in data[start:start + n]:
            ref[r] = ref[r] + row
        start += n
    assert out.numpy().tobytes() == ref.tobytes()
