"""Fused front end: prefilter + align + keyframe decision in one step over device state.

Port of `lidar_graph_slam_tpu/odometry/fused.py`, with its three matchers (NDT, GICP,
ICP). Per frame:

    raw scan -> prefilter -> align(target) -> health gate -> masked pose update
             -> keyframe decision (displacement trigger, accum distance)

The reference's data-dependent branches (first-scan bootstrap, convergence drop,
displacement keyframe trigger) stay masked selects on device tensors, so the step reads
nothing back beyond the NDT loop's per-iteration `done` flag; the host reads a frame's
outputs later (`pipeline/runner.py`, lagged readback).

The submap ring and target rebuild stay OUTSIDE the step, driven by the host after it
reads a keyframe flag, exactly as in the reference: the target therefore lags the newest
keyframe by one frame, and the tests hold the port to that semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, PrefilterConfig, ScanMatcherConfig
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import (
    assemble_submap,
    init_ring,
    make_matcher,
    make_register,
    ring_insert,
)
from lidar_graph_slam_tpu_torch.registration.base import norm


@dataclass
class FrontEndState:
    """Compact device-resident front-end state. The submap ring and target are owned by
    the host driver — see module docstring."""

    pose: torch.Tensor            # [4,4] current odometry estimate (map frame)
    last_motion: torch.Tensor     # [4,4] T_{t-1}^{-1} T_t, for the constant-velocity guess
    last_kf_pose: torch.Tensor    # [4,4] pose at the last keyframe
    accum_distance: torch.Tensor  # f32 — total keyframe path length
    n_keyframes: torch.Tensor     # i32


@dataclass
class FrameOut:
    """Per-frame outputs plus the keyframe record the back end and the ring need."""

    pose: torch.Tensor            # [4,4]
    converged: torch.Tensor       # bool (after the inlier health gate)
    is_keyframe: torch.Tensor     # bool
    fitness: torch.Tensor         # f32
    iterations: torch.Tensor      # i32
    num_inliers: torch.Tensor     # i32
    keyframe_id: torch.Tensor     # i32 — id assigned IF this frame is a keyframe
    accum_distance: torch.Tensor  # f32 — after this frame's (potential) keyframe update
    kf_cloud: torch.Tensor        # [N,3] the filtered base-frame cloud (keyframe payload)
    kf_mask: torch.Tensor         # [N]


def make_fused_frontend(
    cfg: ScanMatcherConfig,
    prefilter_cfg: PrefilterConfig,
    capacity: CapacityConfig,
    device=None,
) -> Tuple[Callable[[], FrontEndState], Callable, dict]:
    """Build (init_state, step, aux) for the fused front end on `device` (None: the CUDA
    card, `core/device.py`); every tensor the front end allocates lives there.

    step(state, raw_points [R,3], target, imu_R [3,3], use_imu: bool, T_ext [4,4],
         use_ext: bool) -> (state', FrameOut)

    aux = {"init_ring", "rebuild", "insert_and_rebuild", "window"}: the ring/target
    functions for the host to drive.
    """
    device = resolve_device(device)
    method = cfg.registration_method.upper()
    if method not in ("NDT", "GICP", "ICP"):
        raise ValueError(f"unknown registration_method {cfg.registration_method!r}")

    prefilter = make_prefilter(
        prefilter_cfg,
        capacity_out=capacity.filtered_points,
        voxel_capacity=min(capacity.raw_points, 2 * capacity.filtered_points),
    )
    build_target, align = make_matcher(cfg, capacity.voxel_capacity)
    register = make_register(cfg, align)
    window = cfg.max_scan_accumulate_num
    n_filtered = capacity.filtered_points

    def init_state() -> FrontEndState:
        def eye():
            return torch.eye(4, dtype=torch.float32, device=device)

        return FrontEndState(
            pose=eye(), last_motion=eye(), last_kf_pose=eye(),
            accum_distance=torch.zeros((), dtype=torch.float32, device=device),
            n_keyframes=torch.zeros((), dtype=torch.int32, device=device),
        )

    def step(state: FrontEndState, raw_points, target, imu_R, use_imu: bool, T_ext,
             use_ext: bool):
        # Validity comes from the PAD_VALUE sentinel: the host uploads one [R, 3] array.
        raw_mask = raw_points[:, 0] < (0.5 * PAD_VALUE)
        if use_ext:
            # Per-frame sensor->base extrinsic (the reference's per-callback TF lookup).
            raw_points = torch.where(raw_mask[:, None],
                                     se3.transform_points(T_ext, raw_points), raw_points)
        filtered = prefilter(raw_points, raw_mask)
        bootstrap = state.n_keyframes == 0

        # Initial guess: constant velocity or the reference's constant pose; the IMU
        # gyro rotation overrides when provided.
        if cfg.initial_guess == "constant_velocity":
            guess = state.pose @ state.last_motion
        else:
            guess = state.pose.clone()
        if use_imu:
            guess[:3, :3] = state.pose[:3, :3] @ imu_R

        res = register(target, filtered.points, filtered.mask, guess)

        # Health gate: converged with almost no matched points is a silent failure;
        # NDT counts 7 correspondences per point (DIRECT7).
        n_valid = torch.clamp(torch.sum(filtered.mask.to(torch.int32)), min=1)
        denom = n_valid * 7 if method == "NDT" else n_valid
        healthy = res.converged & (
            res.num_inliers.to(torch.float32) >= cfg.min_inlier_fraction * denom.to(torch.float32))
        ok = healthy & torch.logical_not(bootstrap)

        new_pose = torch.where(ok, res.transform, state.pose)
        new_motion = torch.where(ok, se3.inverse(state.pose) @ new_pose, state.last_motion)
        delta = norm(new_pose[:3, 3] - state.last_kf_pose[:3, 3])
        is_kf = bootstrap | (ok & (delta >= cfg.displacement))
        accum_delta = torch.where(bootstrap, 0.0, delta)
        kf_id = state.n_keyframes

        new_state = FrontEndState(
            pose=new_pose,
            last_motion=new_motion,
            last_kf_pose=torch.where(is_kf, new_pose, state.last_kf_pose),
            accum_distance=state.accum_distance + torch.where(is_kf, accum_delta, 0.0),
            n_keyframes=state.n_keyframes + is_kf.to(torch.int32),
        )
        out = FrameOut(
            pose=new_pose,
            converged=ok | bootstrap,
            is_keyframe=is_kf,
            fitness=torch.where(bootstrap, 0.0, res.fitness.to(torch.float32)),
            iterations=torch.where(bootstrap, 0, res.iterations.to(torch.int32)),
            num_inliers=res.num_inliers.to(torch.int32),
            keyframe_id=kf_id,
            accum_distance=new_state.accum_distance,
            kf_cloud=filtered.points,
            kf_mask=filtered.mask,
        )
        return new_state, out

    def rebuild(ring):
        return build_target(*assemble_submap(ring, stride=cfg.map_build_stride))

    def insert_and_rebuild(ring, slot: int, points, mask, pose):
        ring = ring_insert(ring, slot, points, mask, pose)
        return ring, rebuild(ring)

    aux = {
        "init_ring": lambda: init_ring(window, n_filtered, device=device),
        "rebuild": rebuild,
        "insert_and_rebuild": insert_and_rebuild,
        "window": window,
    }
    return init_state, step, aux
