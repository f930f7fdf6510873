"""Carry front-end state across from the JAX package.

Builds the port's `FrontEndState`, `SubmapRing` and `NdtVoxelMap` from the reference's
state given as numpy arrays, so a run (or a test) can start the port from exactly the
state the JAX package reached:

  * front end and ring: the keys `lidar_graph_slam_tpu/utils/checkpoint.py` writes
    (`front_pose`, `front_last_motion`, `front_last_kf_pose`, `front_accum`,
    `front_n_keyframes`, `ring_clouds`, `ring_masks`, `ring_poses`, `ring_used`);
  * voxel map: the `NdtVoxelMap` field names (`keys`, `means`, `inv_covs`, `valid`,
    `origin`, `leaf`, `num_voxels`, `table`, `packed`);
  * NN grid: the `HashGrid` field names (`keys`, `points`, `packed`, `order`, `starts`,
    `origin`, `cell_size`, `num`, `table`);
  * GICP target: the grid's field names plus `covs` and `valid`;
  * pose graph: the `PoseGraph` field names (`poses`, `pose_mask`, `odom_meas`,
    `prior_pose`, `odom_info`, `loop_i`, `loop_j`, `loop_meas`, `loop_info`,
    `loop_mask`, `num_poses`, `num_loops`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.graph.solver import PoseGraph
from lidar_graph_slam_tpu_torch.odometry.fused import FrontEndState
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import SubmapRing
from lidar_graph_slam_tpu_torch.ops.neighbors import HashGrid
from lidar_graph_slam_tpu_torch.ops.voxel import NdtVoxelMap
from lidar_graph_slam_tpu_torch.registration.gicp import GicpTarget


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype).contiguous()


def front_end_state_from_numpy(arrays, device=None) -> FrontEndState:
    return FrontEndState(
        pose=_t(arrays["front_pose"], torch.float32, device),
        last_motion=_t(arrays["front_last_motion"], torch.float32, device),
        last_kf_pose=_t(arrays["front_last_kf_pose"], torch.float32, device),
        accum_distance=_t(arrays["front_accum"], torch.float32, device).reshape(()),
        n_keyframes=_t(arrays["front_n_keyframes"], torch.int32, device).reshape(()),
    )


def ring_from_numpy(arrays, device=None) -> SubmapRing:
    return SubmapRing(
        clouds=_t(arrays["ring_clouds"], torch.float32, device),
        masks=_t(arrays["ring_masks"], torch.bool, device),
        poses=_t(arrays["ring_poses"], torch.float32, device),
        used=_t(arrays["ring_used"], torch.bool, device),
    )


_MAP_DTYPES = {"keys": torch.int32, "valid": torch.bool, "num_voxels": torch.int32,
               "table": torch.int32}


_GRID_DTYPES = {"keys": torch.int32, "order": torch.int64, "starts": torch.int64,
                "num": torch.int32, "table": torch.int32}
_GRAPH_DTYPES = {"pose_mask": torch.bool, "loop_i": torch.int64, "loop_j": torch.int64,
                 "loop_mask": torch.bool, "num_poses": torch.int64, "num_loops": torch.int64}


def _from_numpy(cls, dtypes: dict, arrays, device):
    """`cls` from the arrays of its fields; a field derived in `__post_init__` (such as
    `NdtVoxelMap.inv_leaf`) is made there."""
    return cls(**{
        f.name: _t(arrays[f.name], dtypes.get(f.name, torch.float32), device)
        for f in dataclasses.fields(cls) if f.init
    })


def ndt_map_from_numpy(arrays, device=None) -> NdtVoxelMap:
    return _from_numpy(NdtVoxelMap, _MAP_DTYPES, arrays, device)


def hash_grid_from_numpy(arrays, device=None) -> HashGrid:
    """`packed` keeps its bits: column 3 is the int32 cell key stored as float32."""
    return _from_numpy(HashGrid, _GRID_DTYPES, arrays, device)


def gicp_target_from_numpy(arrays, device=None) -> GicpTarget:
    """`arrays`: the `HashGrid` fields of `GicpTarget.grid`, plus `covs` and `valid`."""
    return GicpTarget(grid=hash_grid_from_numpy(arrays, device),
                      covs=_t(arrays["covs"], torch.float32, device),
                      valid=_t(arrays["valid"], torch.bool, device))


def pose_graph_from_numpy(arrays, device=None) -> PoseGraph:
    return _from_numpy(PoseGraph, _GRAPH_DTYPES, arrays, device)
