"""The prefilter's kernels' plain versions (`ops/voxel.py:voxel_centroids_plain`,
`ops/neighbors.py:sor_window_stats_plain`) against the JAX reference and against float32
numpy models of the kernels' arithmetic (`csrc/prefilter.cu`), the SOR's slim cell sort
against the full grid, and the prefilter against the reference at the default config.

Inputs are made with numpy from a seed. Tolerances: voxel centroids to atol 1e-5 (the
reference's XLA segment sums may add a run in another order), masks, `num_voxels` and
`overflow` exact; SOR mean distances to atol 1e-6 (the reference sums its k roots in its
reduction's order), neighbor counts exact; the numpy models bit for bit (each float32
operation in the kernels' order); cell keys, points and order exact; prefilter masks
exact, points to atol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core.config import PrefilterConfig as JPrefilterConfig
from lidar_graph_slam_tpu.filters import prefilter as jpf
from lidar_graph_slam_tpu.ops import neighbors as jn
from lidar_graph_slam_tpu.ops import voxel as jv
from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig as TPrefilterConfig
from lidar_graph_slam_tpu_torch.filters import prefilter as tpf
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import neighbors as tn
from lidar_graph_slam_tpu_torch.ops import voxel as tv

PAD = 1.0e6


def _ring_cloud(seed, n, valid, spread=0.0):
    """A seeded ring of points 2-60 m out (LiDAR-like density falling with range), the
    first `valid` of `n` rows valid, the rest PAD_VALUE."""
    rng = np.random.default_rng(seed)
    r = 2.0 + 58.0 * rng.random(valid) ** 2
    az = rng.uniform(-np.pi, np.pi, valid)
    z = rng.normal(0.0, 1.5 + spread, valid)
    pts = np.full((n, 3), PAD, np.float32)
    pts[:valid] = np.stack([r * np.cos(az), r * np.sin(az), z], -1).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:valid] = True
    return pts, mask


def _far(pts, mask, offset=(812.5, -433.0, 21.0)):
    """The valid rows moved ~1 km from the origin."""
    return np.where(mask[:, None], pts + np.float32(offset), pts).astype(np.float32), mask


VOXEL_CASES = {
    # An 8,192-row bucket about 55% valid at the prefilter's leaf.
    "bucket55": lambda: (*_ring_cloud(0, 8192, 4500), 0.1, 4096),
    # More occupied voxels than capacity: runs past C dropped, overflow set.
    "over_capacity": lambda: (*_ring_cloud(1, 8192, 6000), 0.1, 1000),
    # No valid row (the first frame's mask, an empty loop submap).
    "all_invalid": lambda: (np.full((2048, 3), PAD, np.float32), np.zeros(2048, bool), 0.1, 1024),
    # Coarse leaf: long runs, far from the origin.
    "coarse_far": lambda: (*_far(*_ring_cloud(2, 4096, 3000)), 2.0, 1024),
}


def _sorted_inputs(pts, mask, leaf, capacity):
    """`voxel_centroids`' inputs as `voxel_downsample` makes them (torch, CPU)."""
    return tv.centroid_runs(torch.as_tensor(pts), torch.as_tensor(mask), leaf, capacity)[0]


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_voxel_downsample_matches_reference(case):
    pts, mask, leaf, capacity = VOXEL_CASES[case]()
    j = jv.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(leaf), capacity)
    t = tv.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask), leaf, capacity)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert int(t.num_voxels) == int(j.num_voxels)
    assert bool(t.overflow) == bool(j.overflow)
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-5, rtol=0)
    if case == "over_capacity":
        assert bool(t.overflow) and bool(t.mask.all())
    if case == "all_invalid":
        assert int(t.num_voxels) == 0 and not bool(t.mask.any())
        assert bool((t.points == PAD).all())


def _centroids_model(keys_sorted, pts_sorted, starts, lengths, origin, leaf):
    """The `voxel_centroids` kernel's arithmetic in numpy float32: a run's offsets from
    its corner added in order from 0.0, corner + sums / max(count, 1)."""
    f = np.float32
    keys, pts = keys_sorted.numpy(), pts_sorted.numpy()
    st, ln, o, lf = starts.numpy(), lengths.numpy(), origin.numpy(), f(leaf.item())
    C = st.shape[0] - 1
    out = np.full((C, 3), f(PAD), np.float32)
    for r in range(C):
        if ln[r] == 0:
            continue
        key = int(keys[st[r]])
        c = (key >> 19, (key >> 8) & 2047, key & 255)
        corner = [f(o[d] + f(f(c[d]) * lf)) for d in range(3)]
        count, sums = f(0.0), [f(0.0)] * 3
        for i in range(st[r], st[r] + ln[r]):
            count = f(count + f(1.0))
            sums = [f(sums[d] + f(pts[i, d] - corner[d])) for d in range(3)]
        out[r] = [f(corner[d] + f(sums[d] / max(count, f(1.0)))) for d in range(3)]
    return out, ln[:C] > 0


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_voxel_centroids_plain_equals_the_kernel_model(case):
    """The plain version (what the CPU wrapper takes, and what the card's kernel is held
    to bit for bit) equals the kernel's float32 arithmetic run by run."""
    args = _sorted_inputs(*VOXEL_CASES[case]())
    before = tk.voxel_centroids.launches
    got, got_mask = tk.voxel_centroids(*args)
    plain, plain_mask = tv.voxel_centroids_plain(*args)
    assert tk.voxel_centroids.launches == before  # the CPU path launches nothing
    assert torch.equal(got, plain) and torch.equal(got_mask, plain_mask)
    want, want_mask = _centroids_model(*args)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def _one_cell(n=600, valid=560, seed=7):
    """Every valid row in one SOR cell, so rows 0-23 reach the last rows through the
    window's wrap; the invalid rows sort last."""
    rng = np.random.default_rng(seed)
    pts = np.full((n, 3), PAD, np.float32)
    pts[:valid] = rng.uniform(0.05, 0.45, (valid, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:valid] = True
    return pts, mask, 1.0


SOR_CASES = {
    "bucket": lambda: (*_ring_cloud(3, 8192, 5000), 1.0),
    "one_cell": _one_cell,
    "one_cell_full": lambda: _one_cell(n=300, valid=300, seed=8),
    "all_invalid": lambda: (np.full((512, 3), PAD, np.float32), np.zeros(512, bool), 1.0),
    "tiny": lambda: (*_ring_cloud(4, 5, 5), 100.0),
}


def _window_model(keys, points, order, k, window):
    """The `sor_window_stats` kernel's arithmetic in numpy float32: row i's neighbors are
    rows (i - s) mod N, d^2 = ((dx dx) + dy dy) + dz dz, sorted, the roots of the k
    smallest finite ones added in ascending order from 0.0."""
    f = np.float32
    keys, pts, order = keys.numpy(), points.numpy(), order.numpy()
    n = keys.shape[0]
    mean_d, n_found = np.zeros(n, np.float32), np.zeros(n, np.int64)
    for i in range(n):
        d2 = []
        for s in range(1, window + 1):
            for sh in (s, -s):
                j = (i - sh) % n
                if keys[i] != tv.INVALID_KEY and keys[j] == keys[i]:
                    dx, dy, dz = (f(pts[j, c] - pts[i, c]) for c in range(3))
                    d2.append(f(f(f(dx * dx) + f(dy * dy)) + f(dz * dz)))
        acc, cnt = f(0.0), 0
        for v in sorted(d2)[:k]:
            acc = f(acc + np.sqrt(f(v)))
            cnt += 1
        mean_d[order[i]] = f(acc / f(max(cnt, 1)))
        n_found[order[i]] = cnt
    return mean_d, n_found


@pytest.mark.parametrize("case", list(SOR_CASES))
def test_sor_window_stats_plain_matches_reference_and_the_kernel_model(case):
    pts, mask, cell = SOR_CASES[case]()
    k, window = 30, tn.SOR_WINDOW
    grid = jn.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), cell)
    jd_sorted, jc_sorted = jn.window_mean_knn_distance(grid, k, window)
    order = np.asarray(grid.order)
    jd, jc = np.zeros(len(pts), np.float32), np.zeros(len(pts), np.int64)
    jd[order], jc[order] = np.asarray(jd_sorted), np.asarray(jc_sorted)

    cells = tn.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), cell)
    before = tk.sor_window_stats.launches
    td, tc = tk.sor_window_stats(cells.keys, cells.points, cells.order, k)
    assert tk.sor_window_stats.launches == before  # the CPU path launches nothing
    pd, pc = tn.sor_window_stats_plain(cells.keys, cells.points, cells.order, k)
    assert torch.equal(td, pd) and torch.equal(tc, pc)
    assert td.dtype == torch.float32 and tc.dtype == torch.int64
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6, rtol=0)
    md, mc = _window_model(cells.keys, cells.points, cells.order, k, window)
    np.testing.assert_array_equal(tc.numpy(), mc)
    np.testing.assert_array_equal(td.numpy().view(np.uint32), md.view(np.uint32))
    if case.startswith("one_cell"):
        # The wrap: sorted row 0's window reaches the last rows of the same cell only
        # when every row is valid.
        row0 = int(cells.order[0])
        assert int(tc[row0]) == (k if case == "one_cell_full" else 24)
    if case == "all_invalid":
        assert not bool(tc.any()) and not bool(td.any())


@pytest.mark.parametrize("seed,cell", [(0, 1.0), (1, 3.0), (2, 0.5)])
def test_sort_by_cell_equals_the_full_grid(seed, cell):
    pts, mask = _ring_cloud(10 + seed, 4096, 2500)
    p, m = torch.as_tensor(pts), torch.as_tensor(mask)
    cells = tn.sort_by_cell(p, m, cell)
    grid = tn.build_hash_grid(p, m, cell)
    for field in ("keys", "points", "order"):
        a, b = getattr(cells, field), getattr(grid, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _prefilter_both(cfg_kw, pts, mask, capacity_out, voxel_capacity):
    j = jpf.make_prefilter(JPrefilterConfig(**cfg_kw), capacity_out, voxel_capacity)(
        jnp.asarray(pts), jnp.asarray(mask))
    t = tpf.make_prefilter(TPrefilterConfig(**cfg_kw), capacity_out, voxel_capacity)(
        torch.as_tensor(pts), torch.as_tensor(mask))
    return j, t


@pytest.mark.parametrize("seed", [20, 21])
def test_default_prefilter_matches_reference(seed):
    """The default config (0.1 m leaf, k = 30, window 24, 1.2 sigma) on a dense bucket."""
    pts, mask = _ring_cloud(seed, 16384, 12000)
    j, t = _prefilter_both({}, pts, mask, 4096, 8192)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-5, rtol=0)
    assert 0 < int(t.mask.sum()) < 12000


@pytest.mark.parametrize("mean_k,stddev", [(30, 1.2), (10, 1.0), (48, 2.0)])
def test_statistical_outlier_mask_matches_reference_at_default_shapes(mean_k, stddev):
    pts, mask = _ring_cloud(30 + mean_k, 8192, 5000)
    j = jpf.statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(mask), mean_k,
                                     jnp.float32(stddev), cell_size=1.0)
    t = tpf.statistical_outlier_mask(torch.as_tensor(pts), torch.as_tensor(mask), mean_k,
                                     torch.tensor(stddev), cell_size=1.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert 0 < int(t.sum()) < int(mask.sum())


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    keys = torch.zeros(4, dtype=torch.int32, device=meta)
    pts = torch.zeros((4, 3), device=meta)
    runs = torch.zeros(3, dtype=torch.int64, device=meta)
    with pytest.raises(ValueError):
        tk.voxel_centroids(keys, pts, runs, runs, torch.zeros(3, device=meta),
                           torch.zeros((), device=meta))
    with pytest.raises(ValueError):
        tk.sor_window_stats(keys, pts, torch.zeros(4, dtype=torch.int64, device=meta), 30)
