"""Sorted-grid neighborhoods — the engine's replacement for kd-trees.

Port of `lidar_graph_slam_tpu/ops/neighbors.py`: the grid build (`HashGrid`,
`build_hash_grid`), the grid queries (`_candidate_scan`, `nearest` for ICP, GICP and the
loop fitness, `knn`), the same-cloud sliding-window neighborhoods that statistical outlier
removal and GICP's covariances use, and the dense `radius_mask`. Points are keyed by cell
and stably sorted, so the points of one cell are consecutive: a query gathers a bounded
bucket of consecutive rows from each of its 7 or 27 neighbor cells, and a +-window over
the sorted order covers each cell's neighborhood (up to window truncation in very dense
cells) — a sorted-window approximation of kNN that the port reproduces as it is.
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
    _flat_table_index,
    as_f32,
    build_dense_table,
    const,
    min_corner,
    pack_key,
    voxel_coords,
)

_27_OFFSETS = tuple((x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1))
_7_OFFSETS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


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


def build_hash_grid(points: torch.Tensor, mask: torch.Tensor, cell_size) -> HashGrid:
    cell_size = as_f32(cell_size, points)
    origin = min_corner(points, mask) - cell_size
    keys = pack_key(voxel_coords(points, origin, 1.0 / cell_size))
    keys = torch.where(mask, keys, INVALID_KEY)
    n = keys.shape[0]
    keys_sorted, order = torch.sort(keys, stable=True)
    valid = keys_sorted != INVALID_KEY
    pts_sorted = pad_points(points[order], valid)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=points.device),
                       keys_sorted[1:] != keys_sorted[:-1]])
    idx = torch.arange(n, device=points.device)
    # starts[i] = index of the first row sharing keys_sorted[i]'s cell (running max).
    starts = torch.cummax(torch.where(first, idx, 0), dim=0).values
    packed = torch.cat([pts_sorted, keys_sorted.view(torch.float32)[:, None]], dim=1)
    return HashGrid(
        keys=keys_sorted,
        points=pts_sorted,
        packed=packed,
        order=order,
        starts=starts,
        origin=origin,
        cell_size=cell_size,
        num=torch.sum(mask.to(torch.int32)),
        table=build_dense_table(keys_sorted, first & valid, TABLE_DIMS),
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


def window_neighbor_d2(grid: HashGrid, window: int) -> torch.Tensor:
    """Squared distances from every sorted row to its +-window sorted neighbors, masked to
    same-cell pairs: [N, 2*window], +inf where invalid.

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


def window_mean_knn_distance(grid: HashGrid, k: int, window: int = 24):
    """Per sorted row: mean distance to its k nearest window neighbors and the neighbor
    count: (mean_d [N], n_found [N])."""
    d2 = window_neighbor_d2(grid, window)
    d2_sorted = torch.sort(d2, dim=1).values[:, :k]
    found = torch.isfinite(d2_sorted)
    dk = torch.sqrt(torch.where(found, d2_sorted, 0.0))
    n_found = torch.sum(found.to(torch.int32), dim=1)
    mean_d = torch.sum(dk, dim=1) / torch.clamp(n_found, min=1)
    return mean_d, n_found


def window_covariances(grid: HashGrid, window: int = 16):
    """Per sorted row: mean/covariance over its same-cell window neighborhood (self
    included): (mu [N, 3], cov [N, 3, 3], count [N]).

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


def radius_mask(positions: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
                radius) -> torch.Tensor:
    """Dense radius search over a small point set (keyframe positions): `mask` and
    squared distance to `query` below `radius`^2."""
    d2 = torch.sum((positions - query[None, :]) ** 2, dim=-1)
    return mask & (d2 < radius * radius)
