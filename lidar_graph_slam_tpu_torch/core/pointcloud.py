"""Fixed-capacity masked point cloud — the engine's wire format.

Port of `lidar_graph_slam_tpu/core/pointcloud.py`. A scan is a `[capacity, 3]` float32
tensor plus a `[capacity]` bool mask; invalid rows are parked far away (PAD_VALUE) so
distance-based ops (NN search, NDT voxel lookup) ignore them even before masking. The
fixed capacity keeps every per-frame tensor one shape, so nothing on the frame path has
to read a count back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# Padding sentinel: far outside any realistic LiDAR range so padded rows never win a
# nearest-neighbor query nor land in a real voxel.
PAD_VALUE = 1.0e6


@dataclass
class PointCloud:
    """SoA masked cloud. `points[i]` valid iff `mask[i]`."""

    points: torch.Tensor  # [capacity, 3] float32
    mask: torch.Tensor    # [capacity] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d device tensor)."""
        return torch.sum(self.mask.to(torch.int32))

    @classmethod
    def from_array(cls, xyz, capacity: Optional[int] = None, device=None) -> "PointCloud":
        """Build from a host-side [n, 3] array, padding/truncating to `capacity`."""
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if n > cap:
            xyz = xyz[:cap]
            n = cap
        pts = np.full((cap, 3), PAD_VALUE, dtype=np.float32)
        pts[:n] = xyz
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        return cls(points=torch.as_tensor(pts, device=device),
                   mask=torch.as_tensor(mask, device=device))

    def to_array(self) -> np.ndarray:
        """Host-side [n_valid, 3] array (drops padding)."""
        pts = self.points.cpu().numpy()
        return pts[self.mask.cpu().numpy()]


def pad_points(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Park invalid rows at PAD_VALUE (keeps NN/voxel ops mask-oblivious)."""
    return torch.where(mask[:, None], points, torch.full_like(points, PAD_VALUE))


def compact(points: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Stable-compact valid rows to the front, emitting `capacity` rows (fewer when the
    input has fewer rows, as the reference's slice does).

    A filter marks rows invalid, then compaction produces the next stage's fixed-shape
    input: a stable argsort on the inverted mask (valid-first), with no count read back.
    """
    order = torch.argsort(torch.logical_not(mask).to(torch.uint8), stable=True)
    order = order[:capacity]
    new_mask = mask[order]
    new_points = pad_points(points[order], new_mask)
    return new_points, new_mask


def concat_clouds(points_list, masks_list, capacity: int):
    """Concatenate fixed-capacity clouds then compact to `capacity` rows."""
    pts = torch.cat(points_list, dim=0)
    msk = torch.cat(masks_list, dim=0)
    return compact(pts, msk, capacity)
