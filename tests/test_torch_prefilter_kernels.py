"""The prefilter's kernels' plain versions (`ops/voxel.py:voxel_centroids_plain`,
`ops/neighbors.py:sor_window_stats_plain`) against the JAX reference and against float32
numpy models of the kernels' designs (`csrc/prefilter.cu`: the centroids' staged rounds
over a block's span of sorted points; the SOR's contiguous same-cell range found by two
key searches, its general path, and its warp-sized odd-even merge networks), the SOR's
slim cell sort against the full grid, the SOR bound of `chip_smoke.py` on a hand-built
input, and the prefilter against the reference at the default config.

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


def _voxel_runs(run_lengths, leaf, n, seed=0):
    """Runs of the given lengths, in this order after the sort: voxel v (along z) holds
    run_lengths[v] points inside it, the rest of the n rows PAD_VALUE."""
    rng = np.random.default_rng(seed)
    total = int(sum(run_lengths))
    pts = np.full((n, 3), PAD, np.float32)
    v = np.repeat(np.arange(len(run_lengths)), run_lengths)
    local = rng.uniform(0.1, 0.9, (total, 3))
    local[0] = 0.1  # the cloud's min corner, so that the voxel frame is this one
    local[:, 2] += v
    pts[:total] = (local * leaf).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:total] = True
    return pts, mask


VOXEL_CASES = {
    # An 8,192-row bucket about 55% valid at the prefilter's leaf.
    "bucket55": lambda: (*_ring_cloud(0, 8192, 4500), 0.1, 4096),
    # More occupied voxels than capacity: runs past C dropped, overflow set.
    "over_capacity": lambda: (*_ring_cloud(1, 8192, 6000), 0.1, 1000),
    # No valid row (the first frame's mask, an empty loop submap).
    "all_invalid": lambda: (np.full((2048, 3), PAD, np.float32), np.zeros(2048, bool), 0.1, 1024),
    # Coarse leaf: long runs, far from the origin.
    "coarse_far": lambda: (*_far(*_ring_cloud(2, 4096, 3000)), 2.0, 1024),
    # Every point in one voxel: one run over three of the kernel's stage rounds.
    "one_voxel": lambda: (*_voxel_runs([8000], 2.0, 8192), 2.0, 512),
    # A run that starts in one stage round and ends in the next.
    "run_across_rounds": lambda: (*_voxel_runs([3000, 1500, 300, 7, 1], 0.5, 8192, 1), 0.5,
                                  256),
    # 200 runs of 21 points: the first block's span (4,200 points) is longer than a round.
    "long_span": lambda: (*_voxel_runs([21] * 200, 0.25, 8192, 2), 0.25, 1024),
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


# `voxel_centroids`' block, stage and direct span (`csrc/prefilter.cu`: kCentroidRows,
# kCentroidStage, kCentroidDirect).
CENTROID_ROWS, CENTROID_STAGE = 256, 3840
CENTROID_DIRECT = 2 * CENTROID_ROWS


def _centroids_model(keys_sorted, pts_sorted, starts, lengths, origin, leaf):
    """The `voxel_centroids` kernel's design in numpy float32: a block of CENTROID_ROWS
    voxel rows whose span of sorted points (its first row's start to its last row's end)
    holds more than CENTROID_DIRECT points copies it in rounds of CENTROID_STAGE points,
    and each row adds its run's offsets from its corner from the round's copy, in run
    order from 0.0, carried across rounds; a shorter span's rows add theirs straight from
    the sorted points; then corner + sums / max(count, 1). Returns (points, mask,
    coverage): the blocks that read directly, the most rounds a staged block took, the
    longest run, and how many runs were summed over more than one round."""
    f = np.float32
    keys, pts = keys_sorted.numpy(), pts_sorted.numpy()
    st, ln, o, lf = starts.numpy(), lengths.numpy(), origin.numpy(), f(leaf.item())
    C = st.shape[0] - 1
    out = np.full((C, 3), f(PAD), np.float32)
    count, sums = np.zeros(C, np.float32), np.zeros((C, 3), np.float32)
    corner = np.zeros((C, 3), np.float32)
    for r in range(C):
        if ln[r]:
            key = int(keys[st[r]])
            c = (key >> 19, (key >> 8) & 2047, key & 255)
            corner[r] = [f(o[d] + f(f(c[d]) * lf)) for d in range(3)]
    rounds, split_runs, direct = 0, set(), 0
    for r0 in range(0, C, CENTROID_ROWS):
        last = min(r0 + CENTROID_ROWS, C) - 1
        lo, hi = int(st[r0]), int(st[last] + ln[last])
        if hi - lo <= CENTROID_DIRECT:
            direct += 1
            for r in range(r0, last + 1):
                for i in range(st[r], st[r] + ln[r]):
                    count[r] = f(count[r] + f(1.0))
                    sums[r] = [f(sums[r, d] + f(pts[i, d] - corner[r, d])) for d in range(3)]
            continue
        rounds = max(rounds, -(-(hi - lo) // CENTROID_STAGE))
        for base in range(lo, hi, CENTROID_STAGE):
            stage = pts[base:min(hi, base + CENTROID_STAGE)].copy()
            for r in range(r0, last + 1):
                a, b = max(st[r] - base, 0), min(st[r] + ln[r] - base, len(stage))
                if a < b and (st[r] < base or st[r] + ln[r] > base + len(stage)):
                    split_runs.add(r)
                for i in range(a, b):
                    count[r] = f(count[r] + f(1.0))
                    sums[r] = [f(sums[r, d] + f(stage[i, d] - corner[r, d])) for d in range(3)]
    for r in range(C):
        if ln[r]:
            out[r] = [f(corner[r, d] + f(sums[r, d] / max(count[r], f(1.0))))
                      for d in range(3)]
    coverage = dict(direct_blocks=direct, rounds=rounds,
                    longest_run=int(ln[:C].max(initial=0)), runs_over_rounds=len(split_runs))
    return out, ln[:C] > 0, coverage


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
    want, want_mask, coverage = _centroids_model(*args)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if case == "one_voxel":
        assert coverage["rounds"] == 3 and coverage["longest_run"] == 8000
    if case in ("run_across_rounds", "long_span", "one_voxel"):
        assert coverage["rounds"] >= 2 and coverage["runs_over_rounds"] >= 1, coverage
    if case == "long_span":
        assert coverage["longest_run"] == 21
    if case == "bucket55":  # ~1 point a run: every block reads its runs directly
        assert coverage["direct_blocks"] == -(-4096 // CENTROID_ROWS), coverage


def _one_cell(n=600, valid=560, seed=7):
    """Every valid row in one SOR cell, so rows 0-23 reach the last rows through the
    window's wrap; the invalid rows sort last."""
    rng = np.random.default_rng(seed)
    pts = np.full((n, 3), PAD, np.float32)
    pts[:valid] = rng.uniform(0.05, 0.45, (valid, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:valid] = True
    return pts, mask, 1.0


def _cells(sizes, invalid=0, seed=0):
    """Cells of the given sizes, in this order after the sort (1 m cells two apart along
    x), then `invalid` PAD_VALUE rows; the rows shuffled so that `order` is not the
    identity."""
    rng = np.random.default_rng(seed)
    c = np.repeat(np.arange(len(sizes)), sizes)
    local = rng.uniform(0.05, 0.95, (len(c), 3))
    local[:, 0] += 2 * c
    pts = np.concatenate([local, np.full((invalid, 3), PAD)]).astype(np.float32)
    mask = np.arange(len(pts)) < len(c)
    perm = rng.permutation(len(pts))
    return pts[perm], mask[perm], 1.0


SOR_CASES = {
    "bucket": lambda: (*_ring_cloud(3, 8192, 5000), 1.0),
    "one_cell": _one_cell,
    "one_cell_full": lambda: _one_cell(n=300, valid=300, seed=8),
    "all_invalid": lambda: (np.full((512, 3), PAD, np.float32), np.zeros(512, bool), 1.0),
    "tiny": lambda: (*_ring_cloud(4, 5, 5), 100.0),
    # Cells at the window's edges: 24 and 25 rows (a row meets all or all but one of its
    # cell), 48 and 49 (the window holds a row's whole cell, or not).
    "cells_24_25_48_49": lambda: _cells([24, 25, 48, 49], invalid=300, seed=1),
    # N at and past the window's span (49 rows): a window meets a row twice below 49.
    "n47": lambda: _cells([20, 27], seed=2),
    "n48": lambda: _cells([24, 24], seed=3),
    "n49": lambda: _cells([30, 19], seed=4),
    "n129": lambda: _cells([60, 40, 29], seed=5),
    # Warps whose rows' counts straddle the networks' widths: 16 and 32, 32 and 40, 40
    # and 48.
    "straddle": lambda: _cells([10, 30, 10, 40, 5, 17, 33, 2, 45, 1, 3], invalid=250,
                               seed=6),
}

# `sor_window_stats`' block and warp, and its networks' widths (`csrc/prefilter.cu`).
SOR_THREADS, SOR_WARP, SOR_WIDTHS = 128, 32, (16, 32, 40, 48)


def _merge_network(width):
    """`merge_sort<width>`'s comparators (`csrc/prefilter.cu`): Batcher's odd-even merge
    network for the next power of two, less those that reach past `width`."""
    size = next(w for w in (16, 32, 64) if w >= width)
    out, p = [], 1
    while p < size:
        k = p
        while k >= 1:
            j = k % p
            while j + k < size:
                for i in range(min(k, size - j - k)):
                    a, b = i + j, i + j + k
                    if b < width and a // (2 * p) == b // (2 * p):
                        out.append((a, b))
                j += 2 * k
            k //= 2
        p *= 2
    return out


def _window_model(keys, points, order, k, window):
    """The `sor_window_stats` kernel's design in numpy float32. Row i's window slot s
    holds row (i + s) mod N. Unless N <= 48 or the window wraps and both its end slots hold
    the row's key (then all 48 slots' keys are tested), two 5-step key searches find the
    same-cell slots -L .. -1, 1 .. R (which must be all of them) and only their d^2 =
    ((dx dx) + dy dy) + dz dz are formed; each warp of 32 rows sorts its rows' values
    with the odd-even merge network of the narrowest of 16, 32, 48 that holds its largest
    count; the roots of the k smallest finite values are added in ascending order from
    0.0. Returns (mean_d, n_found, coverage): per network width the warps that took it and
    the least count of a row among them, and the rows that took the general path."""
    f32 = np.float32
    keys, pts, order = keys.numpy(), points.numpy(), order.numpy()
    n, slots = keys.shape[0], 2 * window
    v = np.full((n, slots), np.inf, np.float32)
    f = np.zeros(n, np.int64)
    general = np.zeros(n, bool)

    def d2(j, i):
        dx, dy, dz = (f32(pts[j, c] - pts[i, c]) for c in range(3))
        return f32(f32(f32(dx * dx) + f32(dy * dy)) + f32(dz * dz))

    for i in range(n):
        key = keys[i]
        if key == tv.INVALID_KEY:
            continue
        slot = lambda s: keys[(i + s) % n]  # noqa: E731
        wraps = i < window or i + window >= n
        if n <= slots or (wraps and slot(-window) == slot(window)):
            general[i] = True
            for s in range(1, window + 1):
                for h, sh in ((0, -s), (1, s)):
                    if slot(sh) == key:
                        v[i, 2 * (s - 1) + h] = d2((i + sh) % n, i)
            f[i] = slots
            continue
        left = right = 0
        for step in (16, 8, 4, 2, 1):
            if left + step <= window and slot(-left - step) == key:
                left += step
            if right + step <= window and slot(right + step) == key:
                right += step
        shifts = list(range(-left, 0)) + list(range(1, right + 1))
        assert shifts == [s for s in range(-window, window + 1)
                          if s != 0 and slot(s) == key], i  # one contiguous range
        for j, sh in enumerate(shifts):
            v[i, j] = d2((i + sh) % n, i)
        f[i] = left + right
    fw = np.repeat(np.pad(f, (0, -n % SOR_WARP)).reshape(-1, SOR_WARP).max(axis=1),
                   SOR_WARP)[:n]
    coverage = {"general_rows": int(general.sum())}
    for w_lo, w in zip((0,) + SOR_WIDTHS, SOR_WIDTHS):
        rows = (fw > w_lo) & (fw <= w)
        valid = rows & (keys != tv.INVALID_KEY)
        x = v[rows, :w]
        for a, b in _merge_network(w):
            x[:, a], x[:, b] = np.minimum(x[:, a], x[:, b]), np.maximum(x[:, a], x[:, b])
        v[rows, :w] = x
        coverage[w] = dict(rows=int(rows.sum()),
                           least_count=int(f[valid].min()) if valid.any() else None)
    acc, found = np.zeros(n, np.float32), np.zeros(n, np.int64)
    roots = np.sqrt(v.astype(np.float64)).astype(np.float32)
    for q in range(slots):
        take = (q < np.minimum(k, fw)) & np.isfinite(v[:, q])
        acc[take] = acc[take] + roots[take, q]
        found += take
    mean_d, n_found = np.zeros(n, np.float32), np.zeros(n, np.int64)
    mean_d[order] = acc / np.maximum(found, 1).astype(np.float32)
    n_found[order] = found
    return mean_d, n_found, coverage


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
    md, mc, coverage = _window_model(cells.keys, cells.points, cells.order, k, window)
    np.testing.assert_array_equal(tc.numpy(), mc)
    np.testing.assert_array_equal(td.numpy().view(np.uint32), md.view(np.uint32))
    _assert_sor_coverage(case, coverage, tc)
    if case.startswith("one_cell"):
        # The wrap: sorted row 0's window reaches the last rows of the same cell only
        # when every row is valid.
        row0 = int(cells.order[0])
        assert int(tc[row0]) == (k if case == "one_cell_full" else 24)
    if case == "all_invalid":
        assert not bool(tc.any()) and not bool(td.any())


def _assert_sor_coverage(case, coverage, n_found):
    """What each SOR case is there to reach in the kernel's design."""
    general = coverage["general_rows"]
    if case == "one_cell_full":  # the first and last 24 rows' windows wrap into the cell
        assert general == 48, coverage
    if case == "one_cell":  # the windows that wrap reach the invalid tail
        assert general == 0 and coverage[48]["rows"], coverage
    if case in ("tiny", "n47", "n48"):  # N <= 48: every row tests all 48 slots
        assert general == (5 if case == "tiny" else int(case[1:])), coverage
    if case == "n49":  # a window's end slots are neighbours: most share a cell
        assert 0 < general < 49, coverage
    if case in ("bucket", "n129", "cells_24_25_48_49", "straddle"):
        assert general == 0, coverage
    if case == "bucket":
        assert coverage[16]["rows"] and coverage[32]["rows"], coverage
    if case == "cells_24_25_48_49":  # 23 and 24 found in the small cells, k in the large
        assert {0, 23, 24, 30} <= set(n_found.tolist()), n_found.unique()
    if case == "straddle":
        assert coverage[32]["least_count"] <= 16 and coverage[40]["least_count"] <= 32, coverage
        assert coverage[48]["least_count"] <= 40, coverage


@pytest.mark.parametrize("k", [10, 48])
@pytest.mark.parametrize("case", ["cells_24_25_48_49", "n47", "n49", "n129", "straddle"])
def test_sor_window_stats_kernel_model_at_other_k(case, k):
    """The kernel's design (`_window_model`) against the plain version at k = 10 (fewer
    than a row's finite distances) and k = 48 (every window slot), bit for bit."""
    pts, mask, cell = SOR_CASES[case]()
    cells = tn.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), cell)
    pd, pc = tn.sor_window_stats_plain(cells.keys, cells.points, cells.order, k)
    md, mc, _ = _window_model(cells.keys, cells.points, cells.order, k, tn.SOR_WINDOW)
    np.testing.assert_array_equal(pc.numpy(), mc)
    np.testing.assert_array_equal(pd.numpy().view(np.uint32), md.view(np.uint32))
    assert int(pc.max()) <= k and (k == 48 or int(pc.max()) == k)


def test_sor_bound_counts_the_comparisons_a_row_needs():
    """`chip_smoke.py:prefilter_bound` on a hand-built SOR input: five rows of one cell
    then 95 invalid rows. Each valid row has f = 4 finite distances, so ordering them
    needs ceil(log2 4!) = 5 comparisons whatever the design; its other operations are the
    two key searches (10) and the mean (1), 8 a same-cell d^2 and 2 a root."""
    import chip_smoke

    assert [chip_smoke.sor_order_comparisons(f, k) for f, k in
            ((0, 30), (1, 30), (3, 30), (4, 30), (4, 2), (31, 30), (48, 48))] == [
        0, 0, 3, 5, 4, 113, 203]
    pts, mask, cell = _cells([5], invalid=95)
    cells = tn.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), cell)
    b = chip_smoke.prefilter_bound("sor_window_stats", (cells.keys, cells.points,
                                                        cells.order, 30), 1980.0)
    assert (b["valid_rows"], b["same_cell_pairs"], b["roots"], b["comparisons"]) == (
        5, 20, 20, 25)
    assert b["instructions"] == 5 * (10 + 1) + 20 * 8 + 20 * 2 + 25
    assert b["bytes"] == 100 * 24 + 5 * 12


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
