"""Scan prefiltering pipeline — the points_prefiltering node.

Port of `lidar_graph_slam_tpu/filters/prefilter.py`: min-distance filter -> [optional
crop box] -> voxel-grid downsample -> statistical outlier removal (SOR) -> [optional
random sample] -> compaction. Filters mark rows invalid in the mask; one stable
compaction hands the next stage a fixed-capacity cloud, so nothing here reads a count
back from the device. The reference compiles it all as one program; on the card the
port runs it as hand-written kernels around the library's two stable key sorts
(`ops/kernels.py`): `cell_keys` (the distance filter and crop, the pad and the voxel
keys), `sorted_runs`, `voxel_centroids`, then the SOR's `cell_keys`, `sorted_runs`
(the gather alone), `sor_window_stats` and `sor_threshold` (mu, sigma, the mask and the
pad), and `compact_rows`. On the CPU each takes its plain version.
"""

from __future__ import annotations

import torch

from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud, compact, pad_points
from lidar_graph_slam_tpu_torch.ops import kernels, neighbors, voxel


def filter_bounds(cfg: PrefilterConfig) -> voxel.KeyFilter:
    """The distance filter and the crop as `kernels.cell_keys` applies them."""
    crop = cfg.use_crop
    return voxel.KeyFilter(cfg.min_distance, cfg.max_distance, cfg.min_xyz if crop else None,
                           cfg.max_xyz if crop else None)


def statistical_outlier_filter(points: torch.Tensor, mask: torch.Tensor, mean_k: int,
                               stddev_mult, cell_size=1.0):
    """pcl::StatisticalOutlierRemoval semantics: mean distance to k nearest neighbors,
    global mean/std over the cloud, drop points above mean + stddev_mult * std. Returns
    (mask, points with the dropped rows at PAD_VALUE).

    Neighborhoods come from the sorted-grid sliding window (+-`neighbors.SOR_WINDOW` rows,
    the reference's default) over the rows sorted by cell (`neighbors.sort_by_cell`);
    `kernels.sor_window_stats` gives each row's statistics in the original row order, and
    `kernels.sor_threshold` the mean, the deviation, the mask and the pad (one and three
    launches on the card; on the CPU `sor_window_stats_plain` and `sor_threshold_plain`).
    Points with < 2 window neighbors are outliers outright.
    """
    cells = neighbors.sort_by_cell(points, mask, cell_size)
    mean_d, n_found = kernels.sor_window_stats(cells.keys, cells.points, cells.order, mean_k)
    return kernels.sor_threshold(mean_d, n_found, mask, points,
                                 voxel.as_f32(stddev_mult, points))


def statistical_outlier_mask(points: torch.Tensor, mask: torch.Tensor, mean_k: int,
                             stddev_mult, cell_size=1.0) -> torch.Tensor:
    """The mask of `statistical_outlier_filter`."""
    return statistical_outlier_filter(points, mask, mean_k, stddev_mult, cell_size)[0]


def random_sample_mask(points: torch.Tensor, mask: torch.Tensor, num: int,
                       generator: torch.Generator) -> torch.Tensor:
    """Uniform random subsample to `num` points (the reference's dormant
    `random_sampling`) by ranking uniform scores. The generator's numbers differ from
    the reference's threefry bits; the distribution is the same."""
    scores = torch.rand(points.shape[0], generator=generator, device=points.device)
    return sample_by_scores(mask, num, scores)


def sample_by_scores(mask: torch.Tensor, num: int, scores: torch.Tensor) -> torch.Tensor:
    """`mask` cut to the `num` valid rows of least `scores` ([N] uniform draws)."""
    ranked = torch.where(mask, scores, 2.0)  # invalid rows rank last
    order = torch.argsort(ranked)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=scores.device)
    return mask & (rank < num)


def sor_cell_size(cfg: PrefilterConfig) -> float:
    """The SOR's neighborhood cell: ~10 voxel leaves covers pcl's k=30 neighborhood at
    typical post-voxel densities while keeping buckets small."""
    return max(cfg.leaf_size * 10.0, 0.5)


def make_prefilter(cfg: PrefilterConfig, capacity_out: int, voxel_capacity: int):
    """Build a scan -> filtered-scan function for a fixed config.

    Returns fn(points [N,3], mask [N]) -> PointCloud with capacity_out rows.

    With `use_random_sampling` every scan ranks its rows by the draws of a generator
    seeded anew (with 0), as the reference's fixed PRNGKey(0); those draws are the same
    for every scan, so they are drawn once, at the first call, and kept: a captured
    program (`utils/capture.py`) reads them as it reads any other constant, where a draw
    inside its graph would advance the generator at each replay.
    """
    draws: dict = {}  # (rows, device) -> the per-scan draws

    def per_scan_draws(n: int, device) -> torch.Tensor:
        key = (n, str(device))
        if key not in draws:
            gen = torch.Generator(device=device).manual_seed(0)
            draws[key] = torch.rand(n, generator=gen, device=device)
        return draws[key]

    bounds = filter_bounds(cfg)

    def prefilter(points: torch.Tensor, mask: torch.Tensor) -> PointCloud:
        # The distance filter (and crop) and the pad run in the voxel keys' kernel.
        grid = voxel.voxel_downsample(points, mask, cfg.leaf_size, capacity=voxel_capacity,
                                      bounds=bounds)
        pts, msk = grid.points, grid.mask

        if cfg.use_outlier_filter:
            msk, pts = statistical_outlier_filter(pts, msk, cfg.mean_k, cfg.stddev,
                                                  cell_size=sor_cell_size(cfg))

        if cfg.use_random_sampling:
            msk = sample_by_scores(msk, cfg.random_sample_num,
                                   per_scan_draws(pts.shape[0], pts.device))
            pts = pad_points(pts, msk)

        out_pts, out_mask = compact(pts, msk, capacity_out)
        return PointCloud(points=out_pts, mask=out_mask)

    return prefilter
