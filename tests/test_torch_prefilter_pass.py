"""The prefilter's passes around its two sorts (`csrc/prefilter_pass.cu`): the plain
versions `cell_keys_plain`, `sorted_runs_plain` (`ops/voxel.py`), `sor_threshold_plain`
(`ops/neighbors.py`) and `compact_rows_plain` (`core/pointcloud.py`) against the JAX
functions they port, and numpy models of the kernels' orders held to the plain versions
bit for bit: the runs' block records, carry and fill, a quad of rows a thread, and the
keys' block minima; the
compaction's block scan and fill; the threshold's block trees and partials in index order
(float32).

Inputs are made with numpy from a seed (the ring, far-away and run-length fixtures of
`tests/test_torch_prefilter_kernels.py`). Tolerances: keys, origins, masks, runs, counts
and compaction order exact; the SOR's mu and sigma to rtol 1e-6 (the reference sums in
XLA's order, the port in the kernel's); the numpy models bit for bit; prefilter points to
atol 1e-5 (the reference's segment sums may add a voxel's run in another order).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.core import pointcloud as jpc
from lidar_graph_slam_tpu.core.config import PrefilterConfig as JPrefilterConfig
from lidar_graph_slam_tpu.filters import prefilter as jpf
from lidar_graph_slam_tpu.ops import neighbors as jn
from lidar_graph_slam_tpu.ops import voxel as jv
from lidar_graph_slam_tpu_torch.core import pointcloud as tpc
from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig as TPrefilterConfig
from lidar_graph_slam_tpu_torch.filters import prefilter as tpf
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import neighbors as tn
from lidar_graph_slam_tpu_torch.ops import voxel as tv
from tests.test_torch_prefilter_kernels import _far, _ring_cloud, _voxel_runs

PAD = np.float32(1.0e6)
INVALID = 2**31 - 1
ROWS, THREADS = 1024, 256  # csrc/prefilter_pass.cu: kRows, kThreads


@partial(jax.jit, static_argnames=("bounds",))
def _jax_keys_jit(p, m, leaf, bounds):
    if bounds is not None:
        m = jpf.distance_filter(p, m, bounds[0], bounds[1])
        if bounds[2] is not None:
            m = jpf.crop_filter(p, m, bounds[2], bounds[3])
        p = jpc.pad_points(p, m)
    origin = jv.min_corner(p, m) - leaf
    keys = jnp.where(m, jv.pack_key(jv.voxel_coords(p, origin, 1.0 / leaf)), jv.INVALID_KEY)
    return keys, origin, m, p


def _jax_keys(pts, mask, leaf, bounds=None):
    """The reference's keys: its distance filter and crop, the pad, `min_corner` less one
    leaf, `voxel_coords`, `pack_key` and the INVALID_KEY `where` (one jitted program)."""
    out = _jax_keys_jit(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(leaf), bounds)
    return [np.asarray(x) for x in out]


def _one_valid(seed):
    pts, mask = _ring_cloud(seed, 4096, 1)
    return pts, mask


KEY_CASES = {  # name: (cloud, leaf, bounds)
    "ring_filtered": (lambda: _ring_cloud(1, 4096, 3000), 0.1, (1.0, 0.0, None, None)),
    "ring_crop_max": (lambda: _ring_cloud(2, 4096, 3000), 0.1,
                      (3.0, 40.0, (-30.0, -20.0, -2.0), (30.0, 35.0, 2.5))),
    "ring_sor_cells": (lambda: _ring_cloud(3, 4096, 3000), 1.0, None),
    "far": (lambda: _far(*_ring_cloud(4, 4096, 2500)), 0.5, None),
    "far_filtered": (lambda: _far(*_ring_cloud(5, 4096, 2500)), 0.1, (1.0, 0.0, None, None)),
    "one_valid": (lambda: _one_valid(6), 0.1, None),
    "none_valid": (lambda: _ring_cloud(7, 4096, 0), 0.1, (1.0, 0.0, None, None)),
    "ragged": (lambda: _ring_cloud(8, 1000, 700), 0.3, (2.5, 0.0, None, None)),
    "ragged_crop": (lambda: _ring_cloud(9, 1000, 700), 0.3,
                    (2.5, 30.0, (-20.0, -20.0, -1.0), (20.0, 20.0, 1.0))),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_cell_keys_plain_matches_reference(case):
    """Keys, origin and (with the filter) the kept mask and the padded points equal the
    reference's exactly."""
    make, leaf, bounds = KEY_CASES[case]
    pts, mask = make()
    out = tv.cell_keys_plain(torch.as_tensor(pts), torch.as_tensor(mask),
                             torch.tensor(leaf, dtype=torch.float32),
                             None if bounds is None else tv.KeyFilter(*bounds))
    keys, origin, kept, padded = _jax_keys(pts, mask, leaf, bounds)
    np.testing.assert_array_equal(out[0].numpy(), keys)
    np.testing.assert_array_equal(out[1].numpy(), origin)
    if bounds is not None:
        np.testing.assert_array_equal(out[2].numpy(), kept)
        np.testing.assert_array_equal(out[3].numpy(), padded)
    if case == "none_valid":
        assert bool((out[0] == INVALID).all())


def test_range_is_the_correctly_rounded_root_of_the_ordered_sum():
    """`in_range`'s range is sqrt((x x + y y) + z z) with the float32 sum in that order and
    one rounding of the exact root: rows whose f32 range sits at min_distance by an ulp
    either side keep exactly the rows whose correctly rounded range exceeds it."""
    rng = np.random.default_rng(9)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.float32(1.0) + rng.integers(-3, 4, 20000).astype(np.float32) * np.float32(2**-23)
    pts = (d * r[:, None]).astype(np.float32)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    s = (x * x + y * y) + z * z
    want = np.sqrt(s.astype(np.float64)).astype(np.float32) > np.float32(1.0)
    got = tv.in_range(torch.as_tensor(pts), 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(want.sum()) < 20000


def _spans(n):
    """The kernels' blocks: a quad (4 rows) a thread, ROWS rows a block; [lo, hi) rows of
    each, at least one block."""
    return [(lo, min(lo + ROWS, n)) for lo in range(0, max(n, 1), ROWS)]


def _runs_model(keys, C):
    """The `sorted_runs` kernels in numpy: the first launch's record of each block of ROWS
    rows (first-of-run rows, valid rows, its last first-of-run row); then per block in the
    second launch the carry from the records before it, the totals from all, a scan of
    the block's quads (4 rows a thread, in row order), the starts and lengths its rows
    write, and the fill past the last voxel. Returns (starts, lengths, num_voxels)."""
    n = len(keys)
    rows = np.arange(n)
    valid = keys != INVALID
    first = valid & np.concatenate([[True], keys[1:] != keys[:-1]])
    last = valid & np.concatenate([keys[1:] != keys[:-1], [True]])
    spans = _spans(n)
    rec = []
    for lo, hi in spans:
        f = np.flatnonzero(first[lo:hi])
        rec.append((len(f), int(valid[lo:hi].sum()), lo + f[-1] if len(f) else -1))
    starts = np.full(C + 1, -7, np.int64)
    lengths = np.full(C + 1, -7, np.int64)
    nv, nvalid = sum(r[0] for r in rec), sum(r[1] for r in rec)
    for b, (lo, hi) in enumerate(spans):
        run = sum(r[0] for r in rec[:b])
        start = max([r[2] for r in rec[:b]], default=-1)
        block = rows[lo:hi]
        seg = run + np.cumsum(first[block]) - 1
        st = np.maximum(start, np.maximum.accumulate(np.where(first[block], block, -1)))
        opens = first[block]
        starts[seg[opens & (seg < C)]] = block[opens & (seg < C)]
        if (opens & (seg == C)).any():
            i = block[opens & (seg == C)][0]
            starts[C], lengths[C] = i, n - i
        closes = last[block] & (seg < C)
        lengths[seg[closes]] = block[closes] + 1 - st[closes]
    if nv <= C:
        starts[nv:] = nvalid
        lengths[nv:] = 0
        lengths[C] = n - nvalid
    return starts, lengths, nv


def _corner_model(pts, mask):
    """The `cell_keys` kernels' corner in float32 numpy: each block's minimum over its
    kept rows (PAD_VALUE where none; NaN wherever one takes part), then the blocks' minima
    as the second launch reduces them (`nan_min`; a minimum is exact in any order)."""
    def nan_min(m, v):
        return np.where((v < m) | np.isnan(v), v, m)

    corner = np.full(3, PAD, np.float32)
    for lo, hi in _spans(len(pts)):
        kept = pts[lo:hi][mask[lo:hi]]
        if len(kept):  # np.min propagates NaN
            corner = nan_min(corner, kept.min(axis=0))
    return corner


RUN_CASES = {  # name: (cloud, leaf, C)
    "ring": (lambda: _ring_cloud(11, 8192, 6000), 0.1, 8192),
    "runs_past_c": (lambda: _ring_cloud(12, 8192, 6000), 0.1, 700),
    "runs_across_blocks": (lambda: _voxel_runs([3000, 1500, 300, 7, 1, 2000], 0.5, 8192),
                           0.5, 16),
    "one_voxel": (lambda: _voxel_runs([4000], 2.0, 4096), 2.0, 3),
    "none_valid": (lambda: _ring_cloud(13, 4096, 0), 0.1, 100),
    "ragged": (lambda: _ring_cloud(14, 1000, 700), 0.3, 777),
    "capacity_0": (lambda: _ring_cloud(15, 2000, 300), 0.3, 0),
}


def _sorted(pts, mask, leaf):
    keys, _ = tv.cell_keys_plain(torch.as_tensor(pts), torch.as_tensor(mask),
                                 torch.tensor(leaf, dtype=torch.float32))
    return torch.sort(keys, stable=True)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_sorted_runs_plain_matches_reference_and_the_kernel_model(case):
    """The sorted points equal the reference's `lax.sort`; each run r < C is the
    reference's segment r (its rows' count by `segment_sum` of the reference's segment
    ids) and starts where it does, `num_voxels` is the reference's; and the kernel's
    model gives the same starts, lengths and count, also with more voxels than C."""
    make, leaf, C = RUN_CASES[case]
    pts, mask = make()
    keys_sorted, order = _sorted(pts, mask, leaf)
    pts_sorted, (starts, lengths, nv) = tv.sorted_runs_plain(
        keys_sorted, order, torch.as_tensor(pts), C)
    # The reference's sort and segment ids (ops/voxel.py:voxel_downsample).
    jkeys, _, _, _ = _jax_keys(pts, mask, leaf)
    n = len(jkeys)
    ks, px, py, pz = jax.lax.sort((jnp.asarray(jkeys), *jnp.asarray(pts).T), num_keys=1)
    valid = ks != jv.INVALID_KEY
    jfirst = jnp.concatenate([valid[:1], (ks[1:] != ks[:-1]) & valid[1:]])
    seg = jnp.where(valid, jnp.cumsum(jfirst.astype(jnp.int32)) - 1, C)
    jlen = np.asarray(jax.ops.segment_sum(jnp.ones(n, jnp.int32), seg, num_segments=C + 1))
    jnv = int(jfirst.sum())
    np.testing.assert_array_equal(keys_sorted.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(pts_sorted.numpy(), np.stack([px, py, pz], -1))
    assert int(nv) == jnv and nv.dtype == torch.int64
    np.testing.assert_array_equal(lengths[:C].numpy(), jlen[:C])
    jstart = np.searchsorted(np.asarray(seg), np.arange(C))
    occupied = lengths[:C].numpy() > 0
    np.testing.assert_array_equal(starts[:C].numpy()[occupied], jstart[occupied])
    assert int(lengths.sum()) == n
    model = _runs_model(keys_sorted.numpy(), C)
    np.testing.assert_array_equal(starts.numpy(), model[0])
    np.testing.assert_array_equal(lengths.numpy(), model[1])
    assert model[2] == jnv
    if case == "runs_past_c":
        assert jnv > C


def _model_keys(case):
    """(sorted keys [N] i32, C) of a runs model case: runs that cross blocks, voxels past
    C, valid rows only in the first blocks, one run over every block, N = 13 (a ragged
    last quad), N = 1 and 0, and 69 blocks of short runs."""
    rng = np.random.default_rng(sum(map(ord, case)))

    def runs(n, lo, hi):
        lens = rng.integers(lo, hi, n)
        return np.repeat(np.cumsum(rng.integers(1, 5, n)), lens)[:n].astype(np.int32)

    if case == "runs_across_blocks":
        return runs(24000, 300, 3000), 4096
    if case == "past_c":
        return runs(6000, 1, 5), 500
    if case == "valid_prefix":
        return np.concatenate([runs(3000, 1, 9), np.full(13384, INVALID, np.int32)]), 4096
    if case == "one_run":
        return np.full(9000, 77, np.int32), 4
    if case == "n13":
        return np.int32([0, 0, 1, 2, 2, 2, 3, INVALID, INVALID, INVALID, INVALID, INVALID,
                         INVALID]), 3
    if case == "n1":
        return np.int32([5]), 2
    if case == "n0":
        return np.zeros(0, np.int32), 3
    return runs(70000, 1, 30), 65536  # "many_blocks"


RUN_MODEL_CASES = ["runs_across_blocks", "past_c", "valid_prefix", "one_run", "n13", "n1",
                   "n0", "many_blocks"]


@pytest.mark.parametrize("case", RUN_MODEL_CASES)
def test_runs_model_equals_plain(case):
    """The runs kernels' decomposition (blocks of ROWS rows, the carry from the first
    launch's records, a quad a thread) gives `sorted_runs_plain`'s starts, lengths and
    count (`_model_keys`)."""
    keys, C = _model_keys(case)
    _, (starts, lengths, nv) = tv.sorted_runs_plain(torch.as_tensor(keys), capacity=C)
    model = _runs_model(keys, C)
    np.testing.assert_array_equal(starts.numpy(), model[0])
    np.testing.assert_array_equal(lengths.numpy(), model[1])
    assert model[2] == int(nv)
    if case == "past_c":
        assert int(nv) > C
    if case in ("runs_across_blocks", "one_run"):  # a run crosses blocks
        assert any(keys[lo - 1] == keys[lo] for lo, hi in _spans(len(keys))[1:])


def _corner_cloud(case):
    """(points [N, 3] f32, mask [N] bool) of a corner model case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n = {"n5": 5, "nan_corner": 9000}.get(case, 10000)
    pts = rng.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.7
    if case == "far":
        pts += np.float32([812.5, -433.0, 21.0])
    if case == "none_kept":
        mask[:] = False
    if case == "nan_corner":  # a kept row with a NaN x, a dropped row with a NaN y
        mask[4321], mask[77] = True, False
        pts[4321, 0], pts[77, 1] = np.nan, np.nan
    return pts, mask


@pytest.mark.parametrize("case", ["spread", "far", "nan_corner", "none_kept", "n5"])
def test_corner_model_equals_plain(case):
    """The keys kernels' corner (each block's minimum, then the blocks') less one leaf is
    `cell_keys_plain`'s origin bit for bit, NaN and the empty corner included."""
    pts, mask = _corner_cloud(case)
    leaf = np.float32(0.1)
    _, origin = tv.cell_keys_plain(torch.as_tensor(pts), torch.as_tensor(mask),
                                   torch.tensor(leaf))
    want = _corner_model(pts, mask) - leaf
    assert origin.numpy().tobytes() == want.astype(np.float32).tobytes()
    if case == "nan_corner":
        assert np.isnan(want[0]) and not np.isnan(want[1:]).any()


def test_sorted_runs_plain_gathers_and_pads_the_sor_cells():
    """Without a capacity: the gather alone, the invalid rows parked at PAD_VALUE, equal
    to the reference's hash grid's sorted points and keys."""
    pts, mask = _ring_cloud(16, 8192, 6000)
    pts[6000:] = 5.0  # rows that only the mask drops
    keys_sorted, order = _sorted(pts, mask, 1.0)
    pts_sorted, runs = tv.sorted_runs_plain(keys_sorted, order, torch.as_tensor(pts))
    grid = jn.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(1.0))
    assert runs is None
    np.testing.assert_array_equal(keys_sorted.numpy(), np.asarray(grid.keys))
    np.testing.assert_array_equal(order.numpy(), np.asarray(grid.order))
    np.testing.assert_array_equal(pts_sorted.numpy(), np.asarray(grid.points))


def _tree_model(x):
    """The `sor_threshold` kernel's sum in float32 numpy: per block of 1,024 rows, thread
    t adds rows (t, t + 512) and (t + 256, t + 768), then the two; shared memory halves
    128 .. 32 wide; warp 0's shuffles 16 .. 1; then the block sums in index order from
    0.0 in one thread."""
    n = len(x)
    G = max(1, -(-n // ROWS))
    rows = np.zeros(G * ROWS, np.float32)
    rows[:n] = x
    total = np.float32(0.0)
    for b in range(G):
        v = rows[b * ROWS:(b + 1) * ROWS]
        t = np.arange(THREADS)
        sm = (v[t] + v[t + 512]) + (v[t + 256] + v[t + 768])
        for h in (128, 64, 32):
            sm = sm[:h] + sm[h:2 * h]
        lane = sm.copy()
        for h in (16, 8, 4, 2, 1):
            lane = lane + np.concatenate([lane[h:], lane[32 - h:]])  # lanes past 31 - h: own
        total = np.float32(total + lane[0])
    return total


@pytest.mark.parametrize("n", [1, 5, 1000, 1024, 3001, 65536])
def test_tree_sum_equals_the_kernel_model(n):
    rng = np.random.default_rng(n)
    x = (rng.gamma(2.0, 0.05, n) * (rng.random(n) < 0.9)).astype(np.float32)
    got = tn._tree_sum(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == _tree_model(x).tobytes()


@jax.jit
def _jax_sor_inputs_jit(p, m):
    grid = jn.build_hash_grid(p, m, 1.0)
    md, nf = jn.window_mean_knn_distance(grid, k=30, window=24)
    n = p.shape[0]
    return (jnp.zeros(n, jnp.float32).at[grid.order].set(md),
            jnp.zeros(n, nf.dtype).at[grid.order].set(nf))


def _jax_sor_inputs(pts, mask):
    """The reference's window statistics at k = 30 and 1 m cells in the original row order
    (filters/prefilter.py:statistical_outlier_mask)."""
    return [np.asarray(x) for x in _jax_sor_inputs_jit(jnp.asarray(pts), jnp.asarray(mask))]


@pytest.mark.parametrize("seed,n,valid,stddev", [(21, 6000, 5000, 1.2), (22, 6000, 3500, 1.0),
                                                 (23, 6000, 0, 1.2)])
def test_sor_threshold_plain_matches_reference(seed, n, valid, stddev):
    """On the reference's window statistics: the mask equals the reference's
    `statistical_outlier_mask` exactly, mu and sigma its sums' to rtol 1e-6, the dropped
    rows at PAD_VALUE."""
    pts, mask = _ring_cloud(seed, n, valid)
    md, nf = _jax_sor_inputs(pts, mask)
    kept, padded = tn.sor_threshold_plain(
        torch.as_tensor(md), torch.as_tensor(nf.astype(np.int64)), torch.as_tensor(mask),
        torch.as_tensor(pts), torch.tensor(stddev, dtype=torch.float32))
    want = jpf.statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(mask), 30,
                                        jnp.float32(stddev), cell_size=1.0)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want))
    np.testing.assert_array_equal(padded.numpy(), np.where(kept.numpy()[:, None], pts, PAD))
    contributes = mask & (nf >= 2)
    n_total = max(int(contributes.sum()), 1)
    jmu = jnp.sum(jnp.where(contributes, md, 0.0)) / n_total
    jvar = jnp.sum(jnp.where(contributes, (md - jmu) ** 2, 0.0)) / n_total
    mu, var = tn.sor_moments(torch.as_tensor(md), torch.as_tensor(nf.astype(np.int64)),
                             torch.as_tensor(mask))
    np.testing.assert_allclose(float(mu), float(jmu), rtol=1e-6)
    np.testing.assert_allclose(np.sqrt(float(var)), np.sqrt(float(jvar)), rtol=1e-6)
    if valid:
        assert 0 < int(kept.sum()) < valid


def _compact_model(mask, capacity):
    """The `compact_rows` kernel in numpy: each block's valid count, then per block the
    counts before it and a scan of each tile; each kept row's output index, and the rows
    past the valid count filled. Returns the source row of each output row (-1: fill)."""
    n = len(mask)
    out_rows = min(n, capacity)
    G = max(1, -(-n // ROWS))
    counts = [int(mask[b * ROWS:(b + 1) * ROWS].sum()) for b in range(G)]
    src = np.full(out_rows, -2, np.int64)
    for b in range(G):
        base = sum(counts[:b])
        for t in range(ROWS // THREADS):
            lo = b * ROWS + t * THREADS
            rows = np.arange(lo, min(lo + THREADS, n))
            if not len(rows):
                continue
            incl = np.cumsum(mask[rows])
            for j, i in enumerate(rows):
                if mask[i] and base + incl[j] - 1 < out_rows:
                    src[base + incl[j] - 1] = i
            base += int(incl[-1])
    src[sum(counts):] = -1
    return src


@pytest.mark.parametrize("n,valid,capacity", [(8192, 5000, 2048), (8192, 1000, 2048),
                                              (4096, 0, 1024), (3000, 2000, 5000),
                                              (2049, 1500, 1025)])
def test_compact_rows_plain_matches_reference_and_the_kernel_model(n, valid, capacity):
    """The compacted rows and mask equal the reference's `compact` exactly (valid rows
    scattered through the cloud; more valid rows than the capacity, fewer, none, a
    capacity past N), and the kernel's model sends the same rows to the same places."""
    pts, _ = _ring_cloud(n + valid, n, n)
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(valid).permutation(n)[:valid]] = True
    got_p, got_m = tpc.compact_rows_plain(torch.as_tensor(pts), torch.as_tensor(mask),
                                          capacity)
    jp, jm = jpc.compact(jnp.asarray(pts), jnp.asarray(mask), capacity)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(jm))
    src = _compact_model(mask, capacity)
    want = np.where(src[:, None] >= 0, pts[np.maximum(src, 0)], PAD)
    np.testing.assert_array_equal(got_p.numpy(), want)
    np.testing.assert_array_equal(got_m.numpy(), src >= 0)
    assert int(got_m.sum()) == min(valid, capacity, n)


@pytest.mark.parametrize("cfg_kw", [dict(use_crop=True, min_xyz=(-25.0, -30.0, -3.0),
                                         max_xyz=(40.0, 20.0, 2.0)),
                                    dict(min_distance=4.0, max_distance=45.0)])
def test_prefilter_with_crop_and_max_distance_matches_reference(cfg_kw):
    """The filter's bounds inside the keys' pass: the crop and the max distance, masks
    exact, points to atol 1e-5."""
    pts, mask = _ring_cloud(31, 16384, 12000)
    j = jpf.make_prefilter(JPrefilterConfig(**cfg_kw), 4096, 8192)(jnp.asarray(pts),
                                                                   jnp.asarray(mask))
    t = tpf.make_prefilter(TPrefilterConfig(**cfg_kw), 4096, 8192)(torch.as_tensor(pts),
                                                                   torch.as_tensor(mask))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-5, rtol=0)
    assert 0 < int(t.mask.sum()) < 12000


def test_pass_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    pts = torch.zeros((4, 3), device=meta)
    mask = torch.zeros(4, dtype=torch.bool, device=meta)
    keys = torch.zeros(4, dtype=torch.int32, device=meta)
    order = torch.zeros(4, dtype=torch.int64, device=meta)
    calls = [lambda: tk.cell_keys(pts, mask, torch.zeros((), device=meta)),
             lambda: tk.sorted_runs(keys, order, pts, 4),
             lambda: tk.sor_threshold(torch.zeros(4, device=meta), order, mask, pts,
                                      torch.zeros((), device=meta)),
             lambda: tk.compact_rows(pts, mask, 2)]
    for call in calls:
        with pytest.raises(ValueError):
            call()
