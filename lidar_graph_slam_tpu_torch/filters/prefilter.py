"""Scan prefiltering pipeline — the points_prefiltering node.

Port of `lidar_graph_slam_tpu/filters/prefilter.py`: min-distance filter -> [optional
crop box] -> voxel-grid downsample -> statistical outlier removal (SOR) -> [optional
random sample] -> compaction. Filters mark rows invalid in the mask; one stable
compaction hands the next stage a fixed-capacity cloud, so nothing here reads a count
back from the device.
"""

from __future__ import annotations

import torch

from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud, compact, pad_points
from lidar_graph_slam_tpu_torch.ops import neighbors, voxel


def _range(points: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(points * points, dim=-1))


def distance_filter(points: torch.Tensor, mask: torch.Tensor, min_distance,
                    max_distance=0.0) -> torch.Tensor:
    """Drop points with range <= min_distance (and >= max_distance when enabled)."""
    r = _range(points)
    keep = mask & (r > min_distance)
    if max_distance > 0.0:
        keep = keep & (r < max_distance)
    return keep


def crop_filter(points: torch.Tensor, mask: torch.Tensor, min_xyz, max_xyz) -> torch.Tensor:
    """Axis-aligned crop box (the reference's dormant `crop`)."""
    lo = voxel.const(tuple(min_xyz), points.dtype, points.device)
    hi = voxel.const(tuple(max_xyz), points.dtype, points.device)
    inside = torch.all((points >= lo) & (points <= hi), dim=-1)
    return mask & inside


def statistical_outlier_mask(points: torch.Tensor, mask: torch.Tensor, mean_k: int,
                             stddev_mult, cell_size=1.0, window: int = 24) -> torch.Tensor:
    """pcl::StatisticalOutlierRemoval semantics: mean distance to k nearest neighbors,
    global mean/std over the cloud, drop points above mean + stddev_mult * std.

    Neighborhoods come from the sorted-grid sliding window (`window_mean_knn_distance`).
    Points with < 2 window neighbors are outliers outright.
    """
    grid = neighbors.build_hash_grid(points, mask, cell_size)
    mean_d_sorted, n_found_sorted = neighbors.window_mean_knn_distance(
        grid, k=mean_k, window=window)
    # Map per-sorted-row stats back to the original row order (a permutation scatter).
    n = points.shape[0]
    mean_d = torch.zeros((n,), dtype=points.dtype, device=points.device)
    mean_d[grid.order] = mean_d_sorted
    n_found = torch.zeros((n,), dtype=n_found_sorted.dtype, device=points.device)
    n_found[grid.order] = n_found_sorted
    has_neighbors = n_found >= 2

    contributes = mask & has_neighbors
    n_total = torch.clamp(torch.sum(contributes.to(torch.int32)), min=1)
    mu = torch.sum(torch.where(contributes, mean_d, 0.0)) / n_total
    var = torch.sum(torch.where(contributes, (mean_d - mu) ** 2, 0.0)) / n_total
    thresh = mu + stddev_mult * torch.sqrt(var)
    return mask & has_neighbors & (mean_d <= thresh)


def random_sample_mask(points: torch.Tensor, mask: torch.Tensor, num: int,
                       generator: torch.Generator) -> torch.Tensor:
    """Uniform random subsample to `num` points (the reference's dormant
    `random_sampling`) by ranking uniform scores. The generator's numbers differ from
    the reference's threefry bits; the distribution is the same."""
    scores = torch.rand(points.shape[0], generator=generator, device=points.device)
    scores = torch.where(mask, scores, 2.0)  # invalid rows rank last
    order = torch.argsort(scores)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=points.device)
    return mask & (rank < num)


def make_prefilter(cfg: PrefilterConfig, capacity_out: int, voxel_capacity: int):
    """Build a scan -> filtered-scan function for a fixed config.

    Returns fn(points [N,3], mask [N]) -> PointCloud with capacity_out rows.
    """

    def prefilter(points: torch.Tensor, mask: torch.Tensor) -> PointCloud:
        mask = distance_filter(points, mask, cfg.min_distance, cfg.max_distance)
        if cfg.use_crop:
            mask = crop_filter(points, mask, cfg.min_xyz, cfg.max_xyz)
        points = pad_points(points, mask)

        grid = voxel.voxel_downsample(points, mask, cfg.leaf_size, capacity=voxel_capacity)
        pts, msk = grid.points, grid.mask

        if cfg.use_outlier_filter:
            # SOR neighborhood cell: ~10 voxel leaves covers pcl's k=30 neighborhood at
            # typical post-voxel densities while keeping buckets small.
            cell = max(cfg.leaf_size * 10.0, 0.5)
            msk = statistical_outlier_mask(pts, msk, cfg.mean_k,
                                           voxel.as_f32(cfg.stddev, pts), cell_size=cell)
            pts = pad_points(pts, msk)

        if cfg.use_random_sampling:
            # Seeded anew per scan, as the reference's fixed PRNGKey(0) is.
            gen = torch.Generator(device=pts.device).manual_seed(0)
            msk = random_sample_mask(pts, msk, cfg.random_sample_num, gen)
            pts = pad_points(pts, msk)

        out_pts, out_mask = compact(pts, msk, capacity_out)
        return PointCloud(points=out_pts, mask=out_mask)

    return prefilter
