"""GICP's covariances: the plain version of the `gicp_covariances` kernel
(`ops/neighbors.py:gicp_covariances_plain`, i.e. `window_covariances` then
`plane_covariances_plain`) and the rerouted `estimate_covariances` / `build_gicp_target`
against the JAX `estimate_covariances`, and a float32/float64 numpy model of the kernel's
window sums (`csrc/covariances.cu`: warp tiles, an all-invalid tile skipped) against the
plain window sums.

Inputs are made with numpy from a seed. Tolerances:
  * the numpy model bit for bit: each float32 operation and each float64 one of the
    plain version, in its order, over the kernel's tiles of 32 rows staged with 16 rows
    on each side, wrapping mod N as `torch.roll` does;
  * against the JAX package, those of `tests/test_torch_gicp.py`: valid exact; the
    covariances to 1e-4 of each matrix's largest entry where the eigen-gap is clear
    ((l1 - l0) / l2 > 0.05 of the raw window covariance: only the smallest eigenvector
    survives the regularization); the identity exact where the window is too thin;
  * the target build's one sort against the reference's two (`build_gicp_target`), and
    the CPU wrapper against the plain version, bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops import neighbors as jnb
from lidar_graph_slam_tpu.registration import gicp as jgicp
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
from lidar_graph_slam_tpu_torch.registration import gicp as tgicp

INVALID = np.iinfo(np.int32).max
PAD = np.float32(1.0e6)
# `csrc/covariances.cu`: kTileRows rows a warp's tile, kCovWindow rows on each side.
TILE_ROWS, COV_WINDOW = 32, 16
MOMENTS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
F32, F64 = np.float32, np.float64


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module (the suite runs files in parallel
    processes; GICP's plain covariances are ~800 small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window_model(keys: np.ndarray, pts: np.ndarray):
    """The `gicp_covariances` kernel's window sums in numpy: each tile of TILE_ROWS sorted
    rows stages slots t = 0 .. TILE_ROWS + 2 COV_WINDOW - 1, slot t holding row
    (t0 - COV_WINDOW + t) mod N (keys, xyz and xyz in float64); row i at slot me = i - t0
    + COV_WINDOW adds slot me - s (shift +s), then me + s (shift -s), s = 1 .. COV_WINDOW,
    each second moment through float64; a tile with no valid row is skipped (its rows keep
    zero sums). Returns (mu, cov, cnt) as `neighbors.window_covariances`."""
    n = keys.shape[0]
    mu, cov, cnt = np.zeros((n, 3), F32), np.zeros((n, 3, 3), F32), np.zeros(n, F32)
    staged = TILE_ROWS + 2 * COV_WINDOW
    for t0 in range(0, n, TILE_ROWS):
        g = (t0 - COV_WINDOW + np.arange(staged)) % n
        skey, sx = keys[g], pts[g]
        sd = sx.astype(F64)
        me = np.arange(min(TILE_ROWS, n - t0)) + COV_WINDOW
        key = skey[me]
        valid = key != INVALID
        if not valid.any():
            continue
        c = np.where(valid, F32(1), F32(0))
        s1 = np.where(valid[:, None], sx[me], F32(0))
        s2 = [np.where(valid, sx[me, a] * sx[me, b], F32(0)) for a, b in MOMENTS]
        for s in range(1, COV_WINDOW + 1):
            for slot in (me - s, me + s):
                same = valid & (skey[slot] == key)
                w = same.astype(F32)
                c = c + w
                s1 = s1 + w[:, None] * sx[slot]
                ws = same.astype(F64)[:, None] * sd[slot]
                s2 = [(m.astype(F64) + ws[:, a] * sd[slot, b]).astype(F32)
                      for m, (a, b) in zip(s2, MOMENTS)]
        denom = np.maximum(c, F32(1))
        m_ = s1 / denom[:, None]
        rows = slice(t0, t0 + len(me))
        mu[rows], cnt[rows] = m_, c
        for m, (a, b) in zip(s2, MOMENTS):
            cij = ((m / denom).astype(F64) - m_[:, a].astype(F64) * m_[:, b].astype(F64))
            cov[rows, a, b] = cov[rows, b, a] = cij.astype(F32)
    return mu, cov, cnt


WINDOW_CASES = ["n0", "n1", "n5", "n32", "n33", "n257", "tile_boundary", "invalid_tail",
                "one_cell", "all_invalid", "mixed_warp", "neg_zero", "n100", "n40",
                "invalid_warps"]


def _window_case(name: str):
    """Sorted cell keys [N] i32 and points [N, 3] f32 (INVALID_KEY / PAD_VALUE rows last).
    The points sit ~40 m out, so E[x x^T] - mu mu^T cancels as on a real scan; some
    coordinates are exactly 0.0 (signed zeros). `mixed_warp`: cells of 1 to 3 rows beside
    cells of 6 to 20, so rows that share a window column sit beside rows that do not;
    `neg_zero`: cells of 6 rows whose x y are all -0 and whose mean is +0, beside every
    fourth cell's +0 products, so a row's second moment xy is -0 until it meets a +0
    product; `invalid_warps`: 64 valid rows, then eight tiles of INVALID_KEY rows."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, valid = {"n0": (0, 0), "n1": (1, 1), "n5": (5, 5), "n32": (32, 29), "n33": (33, 33),
                "n257": (257, 231), "tile_boundary": (384, 384), "invalid_tail": (257, 100),
                "one_cell": (200, 200), "all_invalid": (64, 0), "mixed_warp": (320, 320),
                "neg_zero": (192, 192), "n100": (100, 97), "n40": (40, 40),
                "invalid_warps": (320, 64)}[name]
    if name == "one_cell":
        cells = np.zeros(valid, np.int64)
    elif name == "tile_boundary":  # a 41-row cell across the first blocks' boundary
        cells = np.concatenate([np.repeat(np.arange(9), 12), np.full(41, 9),
                                np.repeat(np.arange(10, 10 + 235 // 5), 5)])[:valid]
    elif name == "mixed_warp":
        sizes = rng.choice([1, 2, 3, 6, 11, 20], size=valid, p=[.3, .2, .15, .15, .1, .1])
        cells = np.repeat(np.arange(valid), sizes)[:valid]
    elif name == "neg_zero":
        cells = np.repeat(np.arange(valid // 6), 6)
    else:
        cells = np.sort(rng.integers(0, max(valid // 6, 1), valid))
    keys = np.full(n, INVALID, np.int32)
    keys[:valid] = 1000 + 37 * cells
    pts = np.full((n, 3), PAD, F32)
    centre = np.stack([40.0 + 2.0 * cells, -25.0 + 0.5 * cells, 1.5 + 0.0 * cells], -1)
    pts[:valid] = (centre + rng.normal(0.0, 0.3, (valid, 3))).astype(F32)
    pts[:valid:7, 2] = 0.0
    pts[1:valid:11, 1] = -0.0
    if name == "neg_zero":  # x = +-0 and y = -+|y| in turn: every x y is -0, the y cancel
        pos = np.arange(valid) % 2 == 0
        y = np.repeat(np.abs(pts[:valid:2, 1]), 2)[:valid]
        pts[:valid, 0] = np.where(pos, F32(0.0), F32(-0.0))
        pts[:valid, 1] = np.where(pos, -y, y)
        last = cells % 4 == 3  # every fourth cell: x = +0, y > 0, so x y = +0
        pts[:valid, 0][last], pts[:valid, 1][last] = F32(0.0), y[last]
    return keys, pts


@pytest.mark.parametrize("name", WINDOW_CASES)
def test_window_model_bit_equal_to_plain(name):
    keys, pts = _window_case(name)
    want = tnb.window_covariances(tnb.CellSort(torch.as_tensor(keys), torch.as_tensor(pts),
                                               None))
    for got, ref in zip(_window_model(keys, pts), want):
        ref = ref.numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    cnt = want[2].numpy()
    if name == "one_cell":
        assert (cnt == 2 * COV_WINDOW + 1).all()
    if name == "n1":  # the row meets itself in every column
        np.testing.assert_array_equal(cnt, [2 * COV_WINDOW + 1])
    if name in ("invalid_tail", "all_invalid", "invalid_warps"):
        valid = keys != INVALID
        assert (cnt[~valid] == 0).all() and (want[1].numpy()[~valid] == 0).all()


@pytest.mark.parametrize("n", [5, 32, 33])
def test_window_counts_follow_the_roll(n):
    """Two cells on a ring shorter than the window: row i's count is 1 plus its same-cell
    rows among (i - s) mod N and (i + s) mod N for s = 1 .. 16, repeats included (at N =
    32 the shifts +16 and -16 meet one row; at N = 5 a row meets itself)."""
    keys = np.where(np.arange(n) < n // 2 + 1, 3, 9).astype(np.int32)
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(F32)
    want = np.array([1 + sum(int(keys[(i + d) % n] == keys[i]) for s_ in range(1, 17)
                             for d in (-s_, s_)) for i in range(n)], F32)
    np.testing.assert_array_equal(_window_model(keys, pts)[2], want)
    plain = tnb.window_covariances(tnb.CellSort(torch.as_tensor(keys), torch.as_tensor(pts),
                                                None))
    np.testing.assert_array_equal(plain[2].numpy(), want)


# -- against the JAX package ------------------------------------------------------------

@pytest.fixture(scope="module")
def clouds():
    """Seeded scans of a synthetic world: the target and source sizes of
    `tests/test_torch_gicp.py` (8,192 rows) and a verifier-like cloud whose last quarter
    is padding."""
    rng = np.random.default_rng(19)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [-4.0, 2.5, 1.0]
    out = {}
    for name, n, keep in (("scan", 8192, 8192), ("padded", 8192, 6144)):
        scan = simulate_scan(world, pose, rng, max_range=45.0, max_points=keep, noise=0.01)
        c = PointCloud.from_array(scan, capacity=n)
        out[name] = (np.array(c.points), np.array(c.mask))
    return out


def _clear_gap(raw_cov: np.ndarray) -> np.ndarray:
    w = np.linalg.eigvalsh(raw_cov.astype(np.float64))
    return (w[:, 1] - w[:, 0]) > 0.05 * np.maximum(w[:, 2], 1e-12)


def _assert_covs_close(got, want, rows, rel):
    scale = np.abs(want[rows]).reshape(-1, 9).max(axis=1)
    err = np.abs(got[rows] - want[rows]).reshape(-1, 9).max(axis=1)
    assert (err <= rel * scale).all(), float((err / scale).max())


def _reference(pts, mask):
    """The JAX `estimate_covariances` and the raw window covariance of each row in the
    original order (for the eigen-gap)."""
    jc, jok = (np.asarray(x) for x in jgicp.estimate_covariances(
        jnp.asarray(pts), jnp.asarray(mask), 2.0, k=20))
    jg = jnb.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), 2.0)
    _, raw_sorted, _ = jax.jit(jnb.window_covariances)(jg)
    raw = np.zeros_like(np.asarray(raw_sorted))
    raw[np.asarray(jg.order)] = np.asarray(raw_sorted)
    return jc, jok, raw


def _assert_matches_reference(tc, tok, jc, jok, raw, mask):
    np.testing.assert_array_equal(tok, jok)
    assert 0.5 < tok.mean() / mask.mean() <= 1.0
    rows = jok & _clear_gap(raw)
    assert rows.mean() > 0.3
    _assert_covs_close(tc, jc, rows, 1e-4)
    thin = ~tok & mask
    np.testing.assert_array_equal(tc[thin], np.broadcast_to(np.eye(3), tc[thin].shape))


@pytest.mark.parametrize("cloud", ["scan", "padded"])
def test_plane_covariances_plain_matches_reference(clouds, cloud):
    """`plane_covariances_plain` over the port's window sums of the cells' rows."""
    pts, mask = clouds[cloud]
    cells = tnb.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), 2.0)
    _, cov, cnt = tnb.window_covariances(cells)
    tc, tok = (x.numpy() for x in tnb.plane_covariances_plain(cov, cnt, cells.order,
                                                               torch.as_tensor(mask)))
    _assert_matches_reference(tc, tok, *_reference(pts, mask), mask)


@pytest.mark.parametrize("cloud", ["scan", "padded"])
def test_gicp_covariances_plain_matches_reference(clouds, cloud):
    """`gicp_covariances_plain` of the cells' rows against the JAX `estimate_covariances`."""
    pts, mask = clouds[cloud]
    cells = tnb.sort_by_cell(torch.as_tensor(pts), torch.as_tensor(mask), 2.0)
    tc, tok = (x.numpy() for x in tnb.gicp_covariances_plain(
        cells.keys, cells.points, cells.order, torch.as_tensor(mask)))
    _assert_matches_reference(tc, tok, *_reference(pts, mask), mask)


@pytest.mark.parametrize("cloud", ["scan", "padded"])
def test_estimate_covariances_matches_reference(clouds, cloud):
    pts, mask = clouds[cloud]
    tc, tok = (x.numpy() for x in tgicp.estimate_covariances(
        torch.as_tensor(pts), torch.as_tensor(mask), 2.0, k=20))
    _assert_matches_reference(tc, tok, *_reference(pts, mask), mask)


@pytest.mark.parametrize("cloud", ["scan", "padded"])
def test_build_gicp_target_matches_reference(clouds, cloud):
    """The target's grid exact, its covariances (in the grid's sorted order) as the
    reference's."""
    pts, mask = clouds[cloud]
    jt = jgicp.build_gicp_target(jnp.asarray(pts), jnp.asarray(mask), 2.0, k=20)
    tt = tgicp.build_gicp_target(torch.as_tensor(pts), torch.as_tensor(mask), 2.0, k=20)
    for name in ("keys", "order", "points"):
        np.testing.assert_array_equal(getattr(tt.grid, name).numpy(),
                                      np.asarray(getattr(jt.grid, name)), err_msg=name)
    sorted_mask = np.asarray(jt.grid.keys) != INVALID
    jg = jnb.build_hash_grid(jt.grid.points, jnp.asarray(sorted_mask), 2.0)
    _, raw, _ = jax.jit(jnb.window_covariances)(jg)
    _assert_matches_reference(tt.covs.numpy(), tt.valid.numpy(), np.asarray(jt.covs),
                              np.asarray(jt.valid), np.asarray(raw), sorted_mask)


@pytest.mark.parametrize("cloud", ["scan", "padded"])
def test_build_gicp_target_equals_the_two_sort_route(clouds, cloud):
    """`build_gicp_target` reads the grid's rows directly; the reference sorts the grid's
    points by cell again (`estimate_covariances` of them): the same covariances and
    validity bit for bit."""
    pts, mask = (torch.as_tensor(a) for a in clouds[cloud])
    tt = tgicp.build_gicp_target(pts, mask, 2.0)
    covs, ok = tgicp.estimate_covariances(tt.grid.points, tt.grid.keys != INVALID, 2.0)
    assert torch.equal(tt.covs.view(torch.int32), covs.view(torch.int32))
    assert torch.equal(tt.valid, ok)


def test_cpu_wrappers_take_the_plain_versions(clouds):
    """On CPU tensors the wrapper is the plain version (the window sums at the default
    window of 16, then the regularization), and counts no launch; N = 0 gives empty
    outputs."""
    pts, mask = (torch.as_tensor(a) for a in clouds["padded"])
    cells = tnb.sort_by_cell(pts, mask, 2.0)
    before = tk.gicp_covariances.launches
    got = tk.gicp_covariances(cells.keys, cells.points, cells.order, mask)
    _, cov, cnt = tnb.window_covariances(cells, 16)
    want = tnb.plane_covariances_plain(cov, cnt, cells.order, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    covs, ok = tk.gicp_covariances(cells.keys[:0], cells.points[:0], cells.order[:0],
                                   mask[:0])
    assert covs.shape == (0, 3, 3) and ok.shape == (0,)
    assert tk.gicp_covariances.launches == before
