"""Sorted-grid neighborhoods — the engine's replacement for kd-trees.

Port of the odometry slice of `lidar_graph_slam_tpu/ops/neighbors.py`: the grid build
(`HashGrid`, `build_hash_grid`) and the same-cloud sliding-window neighborhoods that
statistical outlier removal uses. Points are keyed by cell and stably sorted, so the
points of one cell are consecutive and a +-window over the sorted order covers each
cell's neighborhood (up to window truncation in very dense cells) — a sorted-window
approximation of kNN that the port reproduces as it is.

The grid-query functions (`_candidate_scan`, `knn`, `nearest`, `window_covariances`)
serve ICP and GICP only and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lidar_graph_slam_tpu_torch.core.pointcloud import pad_points
from lidar_graph_slam_tpu_torch.ops.voxel import (
    INVALID_KEY,
    TABLE_DIMS,
    as_f32,
    build_dense_table,
    const,
    min_corner,
    pack_key,
    voxel_coords,
)


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
