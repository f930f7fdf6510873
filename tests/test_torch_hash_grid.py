"""The hash grid's build and the dense cell table: the port's `build_hash_grid` and
`build_dense_table` against the JAX package's on the CPU, and numpy models of the two
kernels of `csrc/grid.cu` (`grid_rows`, `dense_table`) against their plain versions
(`ops/neighbors.py:grid_rows_plain`, `ops/voxel.py:build_dense_table_plain`).

Inputs are made with numpy from a seed. Every comparison is exact:
  * against the JAX package, every field of the grid (keys, points, packed bits, order,
    starts, origin, cell_size, num, table; the JAX int32 order and starts against the
    port's int64 values) and the whole table;
  * the `grid_rows` model: a block of GRID_THREADS sorted rows, the first-of-run flags,
    each warp's max-scan and the warps' totals, and for the rows before the block's
    first flag the run start that warp 0 finds (the 32 rows before the block, then a
    33-way lower bound), probe for probe as the kernel makes them, equal to the running
    max of `grid_rows_plain`, within five rounds of the search;
  * the `dense_table` model: the passing rows' unsigned atomic min from a table of
    0xFFFFFFFF, in shuffled thread orders, equal to the scatter-min of
    `build_dense_table_plain`; and `grid_rows`' plain stores, whose slots are distinct.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops import neighbors as jnb
from lidar_graph_slam_tpu.ops import voxel as jvx
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
from lidar_graph_slam_tpu_torch.ops import voxel as tvx

INVALID = np.iinfo(np.int32).max
PAD = np.float32(1.0e6)
# `csrc/grid.cu`: kGridThreads sorted rows a block of grid_rows, 32 lanes a warp.
GRID_THREADS, WARP = 256, 32
TABLE_DIMS = tvx.TABLE_DIMS


def _cloud(case: str):
    """(points [N, 3] f32, mask [N]) of a grid case, PAD rows where masked."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "ring":  # a dense-course-like ring of two scans, 2 m cells
        world = make_world(rng, extent=60.0, density=20.0, wall_height=12.0,
                           box_height=(6.0, 25.0), n_boxes=40)
        parts = []
        for k in range(2):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [2.0 * k, 0.5 * k, 0.0]
            parts.append(simulate_scan(world, pose, rng, max_points=6000, n_azimuth=512,
                                       n_elevation=32))
        scan = np.concatenate(parts)
        n = 16384
        pts = np.full((n, 3), PAD, np.float32)
        pts[:len(scan)] = scan
        mask = np.arange(n) < len(scan)
    elif case == "wide":  # 1.4 km across: most cells lie outside the 256-cell table
        n = 3000
        pts = rng.uniform([-700.0, -650.0, -3.0], [700.0, 650.0, 140.0], (n, 3)).astype(
            np.float32)
        mask = rng.random(n) < 0.9
    elif case == "all_masked":
        n = 700
        pts = rng.uniform(-20.0, 20.0, (n, 3)).astype(np.float32)
        mask = np.zeros(n, bool)
    elif case == "one_cell":  # every valid row in one 2 m cell
        n = 600
        pts = (np.array([12.3, -4.1, 0.7]) + rng.uniform(0.0, 1.9, (n, 3))).astype(np.float32)
        mask = rng.random(n) < 0.8
    elif case == "n1":
        pts = np.array([[3.0, -2.0, 1.0]], np.float32)
        mask = np.ones(1, bool)
    else:  # "odd": N = 777, a few masked rows
        n = 777
        pts = rng.normal(0.0, 15.0, (n, 3)).astype(np.float32)
        mask = rng.random(n) < 0.95
    return np.where(mask[:, None], pts, PAD).astype(np.float32), mask


GRID_CASES = ["ring", "wide", "all_masked", "one_cell", "n1", "odd"]


@pytest.mark.parametrize("case", GRID_CASES)
def test_build_hash_grid_equals_the_jax_grid(case):
    pts, mask = _cloud(case)
    jg = jnb.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), 2.0)
    tg = tnb.build_hash_grid(torch.as_tensor(pts), torch.as_tensor(mask), 2.0)
    for name in ("keys", "points", "origin", "cell_size", "table"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), name
    assert np.array_equal(np.asarray(jg.packed).view(np.int32), tg.packed.numpy().view(np.int32))
    # The count's value: the port's 0-d sum of an int32 mask is int64, as torch sums.
    assert tg.num.dim() == 0 and int(tg.num) == int(jg.num) == int(mask.sum())
    for name in ("order", "starts"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.dtype == np.int32 and b.dtype == np.int64
        assert np.array_equal(a.astype(np.int64), b), name
    table = tg.table.numpy()
    if case == "wide":  # valid rows whose cells lie outside the table: no slot
        keys = tg.keys.numpy()
        assert int((table >= 0).sum()) < len(np.unique(keys[keys != INVALID]))
    if case == "all_masked":
        assert (table == -1).all() and (tg.starts.numpy() == 0).all()
    if case == "one_cell":
        assert int((table >= 0).sum()) == 1


def _occupancy_keys(seed: int, n: int = 4096):
    """The RANSAC occupancy table's arguments: unsorted keys of target keypoints in 2 m
    cells, repeats among them, INVALID_KEY where a keypoint is not valid."""
    rng = np.random.default_rng(seed)
    kp = rng.normal(0.0, 25.0, (n, 3)).astype(np.float32)
    kp[::7] = kp[::7][::-1]  # some repeats of a cell far apart in row order
    valid = rng.random(n) < 0.85
    tp, tv = torch.as_tensor(kp), torch.as_tensor(valid)
    leaf = tvx.as_f32(2.0, tp)
    origin = tvx.min_corner(tp, tv) - leaf
    keys = tvx.pack_key(tvx.voxel_coords(tp, origin, 1.0 / leaf))
    keys = torch.where(tv, keys, tvx.INVALID_KEY)
    return keys.numpy(), valid


def _level_rows(resolution: float):
    """An NDT map level's rows (keys, valid) from the port's `build_ndt_map` on the CPU."""
    pts, mask = _cloud("ring")
    vmap = tvx.build_ndt_map(torch.as_tensor(pts), torch.as_tensor(mask), resolution,
                             capacity=4096)
    return vmap.keys.numpy(), vmap.valid.numpy()


@pytest.mark.parametrize("case", ["occupancy", "fine_level", "coarse_level"])
def test_build_dense_table_equals_the_jax_table(case):
    if case == "occupancy":
        keys, valid = _occupancy_keys(3)
        assert len(np.unique(keys[valid])) < int(valid.sum())  # cells repeat
    else:
        keys, valid = _level_rows(2.0 if case == "fine_level" else 4.0)
        assert valid.any() and not valid.all()
    want = np.asarray(jvx.build_dense_table(jnp.asarray(keys), jnp.asarray(valid),
                                            TABLE_DIMS))
    got = tvx.build_dense_table(torch.as_tensor(keys), torch.as_tensor(valid), TABLE_DIMS)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want >= 0).any()


# -- the `grid_rows` kernel's starts: block scan plus the run start's search --------------

def _run_start_model(keys: np.ndarray, b: int, key: int):
    """`csrc/grid.cu:run_start` for the run holding rows b - 1 and b, probe for probe:
    (its first row, the rounds of 32 probes it took)."""
    lanes = np.arange(WARP)
    p = b - WARP + lanes
    less = (p < 0) | (keys[np.maximum(p, 0)] < key)
    if less.any():
        return b - WARP + int(np.flatnonzero(less).max()) + 1, 1
    lo, hi, rounds = 0, b - WARP, 1
    while hi - lo >= WARP:
        rounds += 1
        w = hi - lo
        q = lo + (lanes + 1) * w // (WARP + 1)
        assert (q < hi).all()
        less = keys[q] < key
        c = int(less.sum())
        assert less[:c].all()  # ascending keys: the smaller probes are a prefix of lanes
        next_lo = lo + c * w // (WARP + 1) + 1 if c > 0 else lo
        if c < WARP:
            hi = lo + (c + 1) * w // (WARP + 1)
        lo = next_lo
    q = lo + lanes
    less = (q < hi) & (keys[np.minimum(q, hi)] < key)
    return lo + int(less.sum()), rounds + 1


def _starts_model(keys: np.ndarray):
    """`grid_rows_kernel`'s starts over ascending keys: (starts [N] int64, the most
    rounds a block's search took)."""
    n = keys.shape[0]
    starts = np.empty(n, np.int64)
    most = 0
    for b0 in range(0, n, GRID_THREADS):
        t = np.arange(GRID_THREADS)
        i = b0 + t
        live = i < n
        k = np.where(live, keys[np.minimum(i, n - 1)], INVALID)
        prev = keys[np.clip(i - 1, 0, n - 1)]
        first = live & ((i == 0) | (prev != k))
        v = np.where(first, t, -1).reshape(-1, WARP)
        v = np.maximum.accumulate(v, axis=1)  # each warp's shuffle scan
        last = v[:, -1]
        before = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
        v = np.maximum(v, before[:, None]).reshape(-1)  # the earlier warps' totals
        carry = -1
        if b0 > 0 and keys[b0 - 1] == keys[b0]:
            carry, rounds = _run_start_model(keys, b0, int(keys[b0]))
            most = max(most, rounds)
        got = np.where(v >= 0, b0 + v, carry)
        assert (got[live] >= 0).all()
        starts[i[live]] = got[live]
    return starts, most


def _sorted_keys(case: str) -> np.ndarray:
    """Ascending int32 keys (INVALID_KEY last) whose runs cross the kernel's blocks."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "loop_submap":  # 12,422 voxels of 131,072 rows, then the INVALID tail
        valid = np.sort(rng.choice(2**24, 12422, replace=False))
        return np.concatenate([valid, np.full(131072 - 12422, INVALID)]).astype(np.int32)
    if case == "ring_tail":  # runs of 1 to 60 rows, a 100,000-row INVALID tail
        sizes = rng.integers(1, 61, 20000)
        runs = np.repeat(np.arange(len(sizes)) * 3, sizes)[:555360]
        return np.concatenate([runs, np.full(100000, INVALID)]).astype(np.int32)
    if case == "long_run":  # a run of 1,000 rows across four blocks
        return np.concatenate([np.arange(100), np.full(1000, 100),
                               np.arange(101, 400)]).astype(np.int32)
    if case == "block_edges":  # runs that begin and end on block boundaries
        return np.repeat(np.arange(12), [256, 256, 1, 255, 512, 33, 223, 32, 224, 31, 225,
                                         257]).astype(np.int32)
    if case == "runs_of_33":  # each run straddles a warp and now and then a block
        return np.repeat(np.arange(80), 33).astype(np.int32)
    if case == "all_invalid":
        return np.full(2000, INVALID, np.int32)
    if case == "one_run":
        return np.full(1500, 7, np.int32)
    if case == "negative":  # keys below zero sort first (unpack_key gives cx < 0)
        return np.sort(rng.integers(-5000, 5000, 1200)).astype(np.int32)
    n = {"n1": 1, "n33": 33, "n257": 257}[case]
    return np.sort(rng.integers(0, n // 3 + 2, n)).astype(np.int32)


STARTS_CASES = ["loop_submap", "ring_tail", "long_run", "block_edges", "runs_of_33",
                "all_invalid", "one_run", "negative", "n1", "n33", "n257"]


@pytest.mark.parametrize("case", STARTS_CASES)
def test_grid_rows_starts_model_equals_the_running_max(case):
    keys = _sorted_keys(case)
    pts = np.zeros((keys.shape[0], 3), np.float32)
    want = tnb.grid_rows_plain(torch.as_tensor(keys), torch.as_tensor(pts))[0].numpy()
    got, rounds = _starts_model(keys)
    assert np.array_equal(got, want)
    assert rounds <= 5
    if case in ("loop_submap", "ring_tail", "long_run", "all_invalid", "one_run"):
        assert rounds >= 2  # the lower bound's rounds ran, not only the 32 rows before


# -- the `dense_table` kernel: unsigned atomic min in any thread order ---------------------

def _table_slot(keys: np.ndarray, dims):
    """`csrc/grid.cu:table_slot`: the slot of each key, -1 outside the table."""
    dx, dy, dz = dims
    k = keys.astype(np.int64)
    cx = k >> 19  # arithmetic shift of an int32, as torch's
    cy = (k >> 8) & 2047
    cz = k & 255
    inside = (cx >= 0) & (cx < dx) & (cy < dy) & (cz < dz)
    return np.where(inside, (cx * dy + cy) * dz + cz, -1)


def _dense_table_model(keys, valid, dims, order):
    """`dense_table_kernel`, its threads run in `order`: each passing row an atomicMin of
    its index on its unsigned slot of a table cleared to 0xFFFFFFFF."""
    table = np.full(dims[0] * dims[1] * dims[2], 0xFFFFFFFF, np.uint64)
    slot = _table_slot(keys, dims)
    for i in order:
        if valid[i] and slot[i] >= 0:
            table[slot[i]] = min(table[slot[i]], i)
    return table.astype(np.uint32).view(np.int32)


def _mixed_keys(seed: int, n: int = 3000):
    """Unsorted keys with repeats, INVALID_KEY rows, cells outside the table on each axis
    (cx >= 256, cy >= 256, cz >= 64) and negative keys; a random validity."""
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 300, n)
    cy = rng.integers(0, 300, n)
    cz = rng.integers(0, 80, n)
    keys = ((cx << 19) | (cy << 8) | cz).astype(np.int64)
    keys[n // 2:] = rng.permutation(keys[: n - n // 2])  # every cell again, in another order
    keys[::11] = INVALID
    keys[5::97] = -rng.integers(1, 2**31 - 1, len(keys[5::97]))
    return keys.astype(np.int32), rng.random(n) < 0.8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_table_model_equals_the_scatter_min_in_any_order(seed):
    keys, valid = _mixed_keys(seed)
    want = tvx.build_dense_table_plain(torch.as_tensor(keys), torch.as_tensor(valid),
                                       TABLE_DIMS).numpy()
    rng = np.random.default_rng(100 + seed)
    for order in (np.arange(len(keys)), np.arange(len(keys))[::-1],
                  rng.permutation(len(keys)), rng.permutation(len(keys))):
        assert np.array_equal(_dense_table_model(keys, valid, TABLE_DIMS, order), want)
    assert (want >= 0).any()


@pytest.mark.parametrize("case", ["ring", "wide", "one_cell", "odd"])
def test_grid_rows_table_stores_are_distinct_and_equal_the_plain_table(case):
    """`grid_rows_kernel` stores a first-and-valid row's index with a plain store: those
    rows' slots are distinct, so the table is the same in any order."""
    pts, mask = _cloud(case)
    cells = tnb.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), 2.0)
    keys = cells.keys.numpy()
    n = keys.shape[0]
    first = np.concatenate([[True], keys[1:] != keys[:-1]])
    slot = _table_slot(keys, TABLE_DIMS)
    stored = first & (keys != INVALID) & (slot >= 0)
    assert len(np.unique(slot[stored])) == int(stored.sum())
    table = np.full(int(np.prod(TABLE_DIMS)), -1, np.int32)
    table[slot[stored]] = np.arange(n)[stored]
    want = tnb.grid_rows_plain(cells.keys, cells.points)
    assert np.array_equal(table, want[2].numpy())
    starts, _ = _starts_model(keys)
    assert np.array_equal(starts, want[0].numpy())


# -- the wrappers on the CPU -----------------------------------------------------------

def test_wrappers_take_the_plain_versions_on_the_cpu():
    pts, mask = _cloud("odd")
    cells = tnb.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), 2.0)
    keys, valid = _occupancy_keys(5, 512)
    kt, vt = torch.as_tensor(keys), torch.as_tensor(valid)
    before = (tk.grid_rows.launches, tk.dense_table.launches, tk.thread_launches())
    got = tk.grid_rows(cells.keys, cells.points)
    table = tk.dense_table(kt, vt)
    assert (tk.grid_rows.launches, tk.dense_table.launches, tk.thread_launches()) == before
    for a, b in zip(got, tnb.grid_rows_plain(cells.keys, cells.points)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert torch.equal(table, tvx.build_dense_table_plain(kt, vt, TABLE_DIMS))
    assert torch.equal(tk.dense_table(kt, vt, (64, 32, 16)),
                       tvx.build_dense_table_plain(kt, vt, (64, 32, 16)))


def test_build_hash_grid_and_table_go_through_the_wrappers(monkeypatch):
    calls = []

    def grid_rows(keys, points):
        calls.append("grid_rows")
        return tnb.grid_rows_plain(keys, points)

    def dense_table(keys, row_valid, dims=TABLE_DIMS):
        calls.append("dense_table")
        return tvx.build_dense_table_plain(keys, row_valid, dims)

    monkeypatch.setattr(tk, "grid_rows", grid_rows)
    monkeypatch.setattr(tk, "dense_table", dense_table)
    pts, mask = _cloud("odd")
    tnb.build_hash_grid(torch.as_tensor(pts), torch.as_tensor(mask), 2.0)
    keys, valid = _occupancy_keys(6, 256)
    tvx.build_dense_table(torch.as_tensor(keys), torch.as_tensor(valid), TABLE_DIMS)
    assert calls == ["grid_rows", "dense_table"]


def test_wrappers_refuse_another_device():
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tk.dense_table(keys, torch.ones(4, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError):
        tk.grid_rows(keys, torch.zeros((4, 3), device="meta"))
