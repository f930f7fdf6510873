"""Sorted-grid neighborhoods — the engine's replacement for kd-trees.

Port of `lidar_graph_slam_tpu/ops/neighbors.py`: the grid build (`HashGrid`,
`build_hash_grid`: the sort by cell, then the `grid_rows` kernel of `ops/kernels.py`,
whose plain version is `grid_rows_plain`), the grid queries (`_candidate_scan`, `nearest`
for ICP, GICP and the loop fitness, `knn`), the same-cloud sliding-window neighborhoods
that statistical outlier removal (over `sort_by_cell`'s rows: the grid's keys, points and
order without its lookup structures; its threshold `sor_threshold_plain`, the plain
version of the `sor_threshold` kernel) and GICP's covariances use (`window_covariances`,
then `plane_covariances_plain`: `gicp_covariances_plain`, the plain version of the
`gicp_covariances` kernel of `ops/kernels.py`), and the dense `radius_mask`. Points are
keyed by cell and stably sorted, so the points of one cell are consecutive: a query
gathers a bounded bucket of consecutive rows from each of its 7 or 27 neighbor cells, and
a +-window over the sorted order covers each cell's neighborhood (up to window truncation
in very dense cells) — a sorted-window approximation of kNN that the port reproduces as it
is.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lidar_graph_slam_tpu_torch.core.pointcloud import pad_points
from lidar_graph_slam_tpu_torch.ops.voxel import (
    INVALID_KEY,
    TABLE_DIMS,
    _NX,
    _NY,
    _NZ,
    _eigh3x3,
    _flat_table_index,
    _scaled_gram,
    as_f32,
    build_dense_table_plain,
    const,
    pack_key,
    voxel_coords,
)

_27_OFFSETS = tuple((x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1))
_7_OFFSETS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
# The statistical outlier filter's window: +-24 sorted rows (the reference's default; the
# `sor_window_stats` kernel, `csrc/prefilter.cu:kWindow`, is built for it).
SOR_WINDOW = 24
# The rows of one block of the `sor_threshold` kernel's sums, added as a tree
# (`csrc/prefilter_pass.cu:kRows`, the rows a block of every pass there).
SOR_SUM_ROWS = 1024


@dataclass
class HashGrid:
    """Points sorted by packed cell key; cells resolved by dense-table lookup at query time."""

    keys: torch.Tensor       # [N] int32, ascending, INVALID_KEY padding
    points: torch.Tensor     # [N, 3] sorted to match keys
    packed: torch.Tensor     # [N, 4] f32: x, y, z, key bitcast to f32
    order: torch.Tensor      # [N] int64 original row index of each sorted row
    starts: torch.Tensor     # [N] int64: for each row, index of the first row of its cell
    origin: torch.Tensor     # [3]
    cell_size: torch.Tensor  # 0-d
    num: torch.Tensor        # 0-d int32 valid count
    table: torch.Tensor      # [prod(TABLE_DIMS)] int32 dense cell -> first sorted row (-1)


@dataclass
class CellSort:
    """Points sorted by packed cell key, without the lookup structures of `HashGrid`: what
    the same-cloud window neighborhoods read (statistical outlier removal)."""

    keys: torch.Tensor       # [N] int32, ascending, INVALID_KEY padding
    points: torch.Tensor     # [N, 3] sorted to match keys, padded with PAD_VALUE
    order: torch.Tensor      # [N] int64 original row index of each sorted row


def _sort_by_cell(points: torch.Tensor, mask: torch.Tensor, cell_size):
    """(CellSort, origin [3], cell_size 0-d): the cell frame and the rows sorted in it —
    the keys by `kernels.cell_keys`, the library's stable sort, and the gather and pad by
    `kernels.sorted_runs` (their plain versions on the CPU)."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    cell_size = as_f32(cell_size, points)
    keys, origin = kernels.cell_keys(points, mask, cell_size)
    keys_sorted, order = torch.sort(keys, stable=True)
    pts_sorted, _ = kernels.sorted_runs(keys_sorted, order, points)
    return CellSort(keys=keys_sorted, points=pts_sorted, order=order), origin, cell_size


def sort_by_cell(points: torch.Tensor, mask: torch.Tensor, cell_size) -> CellSort:
    """The key-and-sort part of `build_hash_grid`: keys, sorted points and order, equal to
    that grid's bit for bit."""
    return _sort_by_cell(points, mask, cell_size)[0]


def grid_rows_plain(keys_sorted: torch.Tensor, points_sorted: torch.Tensor):
    """Plain version of the `grid_rows` kernel (`ops/kernels.py`): what `build_hash_grid`
    makes from the rows sorted by cell (`keys_sorted` ascending, `points_sorted` in their
    order). Returns (starts [N] int64: each row's first row of its run of equal keys, the
    running max of the first-of-run rows; packed [N, 4] f32: x, y, z and the key's bits;
    table: `build_dense_table_plain` of the first-of-run valid rows)."""
    n = keys_sorted.shape[0]
    dev = keys_sorted.device
    valid = keys_sorted != INVALID_KEY
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       keys_sorted[1:] != keys_sorted[:-1]])
    idx = torch.arange(n, device=dev)
    # starts[i] = index of the first row sharing keys_sorted[i]'s cell (running max).
    starts = torch.cummax(torch.where(first, idx, 0), dim=0).values
    packed = torch.cat([points_sorted, keys_sorted.view(torch.float32)[:, None]], dim=1)
    return starts, packed, build_dense_table_plain(keys_sorted, first & valid, TABLE_DIMS)


def build_hash_grid(points: torch.Tensor, mask: torch.Tensor, cell_size) -> HashGrid:
    """The grid of `points` (valid where `mask`) at `cell_size`: the rows sorted by cell
    (`sort_by_cell`'s), then their run starts, packed rows and dense table from
    `kernels.grid_rows` (one clear and one launch on the card, `grid_rows_plain` on the
    CPU)."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    cells, origin, cell_size = _sort_by_cell(points, mask, cell_size)
    starts, packed, table = kernels.grid_rows(cells.keys, cells.points)
    return HashGrid(
        keys=cells.keys,
        points=cells.points,
        packed=packed,
        order=cells.order,
        starts=starts,
        origin=origin,
        cell_size=cell_size,
        num=torch.sum(mask.to(torch.int32)),
        table=table,
    )


def _offsets_for(neighborhood: int, device) -> torch.Tensor:
    if neighborhood == 27:
        return const(_27_OFFSETS, torch.int32, device)
    if neighborhood == 7:
        return const(_7_OFFSETS, torch.int32, device)
    raise ValueError(f"neighborhood must be 7 or 27, got {neighborhood}")


def _candidate_scan(grid: HashGrid, queries: torch.Tensor, offsets: torch.Tensor,
                    bucket_cap: int):
    """Candidate squared distances and flat row indices for every (query, cell, slot).

    Returns (d2 [Q, C*B] with +inf for invalid, cand_idx [Q, C*B] int64 row indices).
    Everything a candidate needs (x, y, z, cell key) comes from one packed 4-float row.
    Out-of-table cells read start -1, as the reference's overflow slot does, so a row
    with no candidate at all still indexes the rows of its first cell's clamped start.
    """
    n = grid.keys.shape[0]
    q = queries.shape[0]
    C = offsets.shape[0]
    dev = queries.device
    coords = voxel_coords(queries, grid.origin, 1.0 / grid.cell_size)       # [Q, 3]
    ncoords = coords[:, None, :] + offsets[None, :, :]                       # [Q, C, 3]
    hi = const((_NX - 1, _NY - 1, _NZ - 1), torch.int32, dev)
    cell_keys = pack_key(torch.minimum(torch.clamp(ncoords, min=0), hi))     # [Q, C]
    flat, in_range = _flat_table_index(ncoords, TABLE_DIMS)
    flat, in_range = flat.reshape(-1), in_range.reshape(-1)
    size = grid.table.shape[0]
    start = torch.where(in_range, grid.table[flat.clamp(max=size - 1).long()], -1)
    cell_hit = (start >= 0) & in_range
    start = torch.clamp(start.long(), min=0, max=n - bucket_cap)             # [Q*C]

    slots = torch.arange(bucket_cap, dtype=torch.int64, device=dev)
    cand_idx = (start[:, None] + slots).reshape(-1)
    rows = grid.packed[cand_idx]                                             # [Q*C*B, 4]
    keys_run = rows[:, 3].contiguous().view(torch.int32).reshape(q, C, bucket_cap)
    same_cell = (keys_run == cell_keys[..., None]) & cell_hit.reshape(q, C)[..., None]
    diff = rows[:, :3].reshape(q, C, bucket_cap, 3) - queries[:, None, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    d2 = torch.where(same_cell, d2, torch.inf)
    return d2.reshape(q, -1), cand_idx.reshape(q, -1)


def nearest(grid: HashGrid, queries: torch.Tensor, bucket_cap: int = 32,
            neighborhood: int = 27):
    """Single nearest neighbor within one cell ring: (idx [Q], dist2 [Q], found [Q]).

    `argmin` takes the first minimum, so a row whose candidates are all +inf gives
    idx = cand_idx[:, 0] and found = False, as the reference does."""
    d2, cand_idx = _candidate_scan(grid, queries, _offsets_for(neighborhood, queries.device),
                                   bucket_cap)
    j = torch.argmin(d2, dim=1, keepdim=True)
    best = torch.gather(d2, 1, j)[:, 0]
    idx = torch.gather(cand_idx, 1, j)[:, 0]
    return idx, best, torch.isfinite(best)


def knn(grid: HashGrid, queries: torch.Tensor, k: int, bucket_cap: int = 32,
        neighborhood: int = 27):
    """k nearest neighbors within the neighborhood cells of each query.

    Returns (idx [Q, k] int64 into grid.points, dist2 [Q, k], valid [Q, k]). Padded query
    rows (at PAD_VALUE) return all-invalid results. The selection is a stable sort of the
    candidates by distance, so ties keep the candidates' scan order."""
    d2, cand_idx = _candidate_scan(grid, queries, _offsets_for(neighborhood, queries.device),
                                   bucket_cap)
    d2_sorted, perm = torch.sort(d2, dim=1, stable=True)
    top_d2 = d2_sorted[:, :k]
    idx = torch.gather(cand_idx, 1, perm[:, :k])
    return idx, top_d2, torch.isfinite(top_d2)


def window_neighbor_d2(grid, window: int) -> torch.Tensor:
    """Squared distances from every sorted row of `grid` (it reads `grid.keys` and
    `grid.points`: a `HashGrid`, as in the reference, or a `CellSort`) to its +-window
    sorted neighbors, masked to same-cell pairs: [N, 2*window], +inf where invalid.

    Column order is the reference's (shift +1, -1, +2, -2, ...), and row i's shift-s
    neighbor is row (i - s) mod N, as `roll` gives it; one gather builds all columns.
    """
    n = grid.keys.shape[0]
    dev = grid.keys.device
    shifts = const(tuple(sh for s in range(1, window + 1) for sh in (s, -s)), torch.int64, dev)
    nbr = torch.remainder(torch.arange(n, device=dev)[:, None] - shifts[None, :], n)  # [N, 2w]
    keys = grid.keys
    same = (keys[nbr] == keys[:, None]) & (keys != INVALID_KEY)[:, None]
    d2 = 0
    for c in range(3):
        comp = grid.points[:, c]
        d2 = d2 + (comp[nbr] - comp[:, None]) ** 2
    return torch.where(same, d2, torch.inf)


def window_mean_knn_distance(grid, k: int, window: int = 24):
    """Per sorted row: mean distance to its k nearest window neighbors and the neighbor
    count: (mean_d [N], n_found [N] int64). The k roots are added in ascending order, one
    column at a time from 0.0 (the `sor_window_stats` kernel's order: equal distances give
    equal roots, and the +inf columns add 0.0 at the end). Each root is taken in float64
    and rounded once to float32, which is the correctly rounded float32 root on every
    device (the CPU's vectorized float32 `sqrt` is not always, and which rows take it
    varies from call to call)."""
    d2 = window_neighbor_d2(grid, window)
    d2_sorted = torch.sort(d2, dim=1).values[:, :k]
    found = torch.isfinite(d2_sorted)
    dk = torch.sqrt(torch.where(found, d2_sorted, 0.0).double()).float()
    n_found = torch.sum(found.to(torch.int32), dim=1)
    total = dk.new_zeros(dk.shape[0])
    for j in range(dk.shape[1]):
        total = total + dk[:, j]
    mean_d = total / torch.clamp(n_found, min=1)
    return mean_d, n_found


def sor_window_stats_plain(keys: torch.Tensor, points: torch.Tensor, order: torch.Tensor,
                           k: int):
    """Plain version of the `sor_window_stats` kernel (`ops/kernels.py`): the window
    statistics (+-SOR_WINDOW rows) of rows sorted by cell key (`window_mean_knn_distance`),
    scattered back to the original row order `order` (a permutation): (mean_d [N] f32,
    n_found [N] int64)."""
    mean_sorted, found_sorted = window_mean_knn_distance(
        CellSort(keys=keys, points=points, order=order), k, SOR_WINDOW)
    n = keys.shape[0]
    mean_d = torch.zeros((n,), dtype=points.dtype, device=points.device)
    mean_d[order] = mean_sorted
    n_found = torch.zeros((n,), dtype=found_sorted.dtype, device=points.device)
    n_found[order] = found_sorted
    return mean_d, n_found


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a float32 [N] in the `sor_threshold` kernel's order: each block of
    SOR_SUM_ROWS rows (the last padded with 0.0) as a tree, x[i] + x[i + h] for h = half
    the width down to 1, then the block sums added in index order from 0.0."""
    n = x.shape[0]
    blocks = max(1, -(-n // SOR_SUM_ROWS))
    rows = torch.zeros(blocks * SOR_SUM_ROWS, dtype=x.dtype, device=x.device)
    rows[:n] = x
    rows = rows.reshape(blocks, SOR_SUM_ROWS)
    while rows.shape[1] > 1:
        h = rows.shape[1] // 2
        rows = rows[:, :h] + rows[:, h:]
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for b in range(blocks):
        total = total + rows[b, 0]
    return total


def sor_threshold_plain(mean_d: torch.Tensor, n_found: torch.Tensor, mask: torch.Tensor,
                        points: torch.Tensor, stddev_mult):
    """Plain version of the `sor_threshold` kernel (`ops/kernels.py`): the rest of the
    statistical outlier filter after the window statistics (mean_d [N] f32, n_found [N]
    i64 in the original row order). The rows with 2 or more neighbours that `mask` keeps
    contribute; mu and the variance are their means (`sor_moments`, the kernel's order);
    a row is kept where `mask`, 2 or more neighbours and mean_d <= mu + stddev_mult *
    sigma, sigma's root taken in float64 and rounded once. Returns (kept [N] bool, points
    [N, 3] with the other rows at PAD_VALUE)."""
    mu, var = sor_moments(mean_d, n_found, mask)
    thresh = mu + stddev_mult * torch.sqrt(var.double()).float()
    kept = mask & (n_found >= 2) & (mean_d <= thresh)
    return kept, pad_points(points, kept)


def sor_moments(mean_d: torch.Tensor, n_found: torch.Tensor, mask: torch.Tensor):
    """The mean and the variance (0-d f32) of mean_d over the rows that `mask` keeps with
    2 or more neighbours, each sum in the `sor_threshold` kernel's order (`_tree_sum`)."""
    contributes = mask & (n_found >= 2)
    n_total = torch.clamp(torch.sum(contributes.to(torch.int32)), min=1)
    mu = _tree_sum(torch.where(contributes, mean_d, 0.0)) / n_total
    dev = mean_d - mu
    return mu, _tree_sum(torch.where(contributes, dev * dev, 0.0)) / n_total


def window_covariances(grid, window: int = 16):
    """Per sorted row: mean/covariance over its same-cell window neighborhood (self
    included): (mu [N, 3], cov [N, 3, 3], count [N]). It reads `grid.keys` and
    `grid.points` (a `HashGrid` or a `CellSort`). The window sums of the
    `gicp_covariances` kernel (`ops/kernels.py`), bit for bit on the card.

    The reference's arithmetic, in its order: raw first and second moments in world
    coordinates, the row itself first, then shifts +1, -1, +2, -2, ... (row i's shift-s
    neighbor is row (i - s) mod N, as `torch.roll` gives it), and E[xx^T] - mu mu^T at the
    end. The reference's compiled program contracts each second-moment step
    s2 + (w x_i) x_j and the final s2 / n - mu_i mu_j into fused multiply-adds; these
    terms cancel (|x|^2 ~ 1600 m^2 at 40 m against patch variances ~0.01 m^2), so the
    port rounds them the same way: the product is exact in float64 and the sum is
    rounded once to float32. The sums accumulate in place, so one shifted copy of the
    cloud is alive at a time, not 2 x window of them."""
    pts = grid.points
    f64 = torch.float64
    comps = [pts[:, c] for c in range(3)]
    keys = grid.keys
    valid_self = keys != INVALID_KEY
    cnt = valid_self.to(pts.dtype)
    s1 = [torch.where(valid_self, c, 0.0) for c in comps]
    s2 = {(i, j): torch.where(valid_self, comps[i] * comps[j], 0.0)
          for i in range(3) for j in range(i, 3)}
    for s in range(1, window + 1):
        for shift in (s, -s):
            w = ((torch.roll(keys, shift) == keys) & valid_self).to(pts.dtype)
            shifted = torch.roll(pts, shift, dims=0)
            shifted64 = shifted.to(f64)
            cnt += w
            for i in range(3):
                ws = w * shifted[:, i]
                s1[i] += ws
                ws64 = ws.to(f64)
                for j in range(i, 3):
                    s2[(i, j)].copy_(torch.addcmul(s2[(i, j)], ws64, shifted64[:, j]))
    denom = torch.clamp(cnt, min=1.0)
    mu = torch.stack([s1[i] / denom for i in range(3)], dim=-1)
    mu64 = mu.to(f64)
    cov = torch.empty((pts.shape[0], 3, 3), dtype=pts.dtype, device=pts.device)
    for (i, j), s2ij in s2.items():
        cij = torch.addcmul(s2ij / denom, mu64[:, i], mu64[:, j], value=-1.0)
        cov[:, i, j] = cij
        cov[:, j, i] = cij
    return mu, cov, cnt


def window_covariances_plain(keys: torch.Tensor, points: torch.Tensor, window: int = 16):
    """`window_covariances` of the rows sorted by cell (`keys`, `points`)."""
    return window_covariances(CellSort(keys=keys, points=points, order=None), window)


def plane_covariances_plain(cov: torch.Tensor, cnt: torch.Tensor, order: torch.Tensor,
                            mask: torch.Tensor):
    """What `estimate_covariances` does after the window sums (the rest of the
    `gicp_covariances` kernel of `ops/kernels.py`). From the window covariances and
    counts of rows sorted by cell (`window_covariances`): the identity where fewer than 5
    points were summed, else fast_gicp's PLANE regularization V diag(1e-3, 1, 1) V^T of
    the eigenvectors V (`_eigh3x3`), scattered back to the original row order by `order`
    (a permutation). Returns (covs [N, 3, 3], ok [N]: count >= 5 and `mask`, in the
    original order). The product is `_scaled_gram`'s sum k = 0, 1, 2 of mul-then-add,
    the kernel's order on every device: the reference's batched `@` sums in its
    library's order, which on the card is cuBLAS's and changes with the batch (an FMA
    chain at N >= 5, another order at N = 1)."""
    ok_s = cnt >= 5.0
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    cov_safe = torch.where(ok_s[:, None, None], cov, eye)
    _w, V = _eigh3x3(cov_safe)
    target = const((1e-3, 1.0, 1.0), cov.dtype, cov.device)  # ascending eigenvalues
    cov_reg = _scaled_gram(V, target)
    cov_reg = torch.where(ok_s[:, None, None], cov_reg, cov_safe)  # the identity where not ok
    # Back to the original row order: `order` is a permutation, so this is exact.
    n = cov.shape[0]
    covs = torch.empty((n, 3, 3), dtype=cov.dtype, device=cov.device)
    covs[order] = cov_reg
    ok = torch.empty((n,), dtype=torch.bool, device=cov.device)
    ok[order] = ok_s
    return covs, ok & mask


def gicp_covariances_plain(keys: torch.Tensor, points: torch.Tensor, order: torch.Tensor,
                           mask: torch.Tensor):
    """Plain version of the `gicp_covariances` kernel (`ops/kernels.py`): the window sums
    of the rows sorted by cell (`keys`, `points`), then their plane regularization at each
    row's index in `order`, valid where `mask`. Returns (covs [N, 3, 3], ok [N])."""
    return plane_covariances_plain(*window_covariances_plain(keys, points)[1:], order, mask)


def radius_mask(positions: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
                radius) -> torch.Tensor:
    """Dense radius search over a small point set (keyframe positions): `mask` and
    squared distance to `query` below `radius`^2."""
    d2 = torch.sum((positions - query[None, :]) ** 2, dim=-1)
    return mask & (d2 < radius * radius)
