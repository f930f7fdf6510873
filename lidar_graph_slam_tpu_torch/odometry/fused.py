"""Fused front end: prefilter + align + keyframe decision in one step over device state.

Port of `lidar_graph_slam_tpu/odometry/fused.py`, with its three matchers (NDT, GICP,
ICP). Per frame:

    raw scan -> prefilter -> align(target) -> health gate -> masked pose update
             -> keyframe decision (displacement trigger, accum distance)

The reference's data-dependent branches (first-scan bootstrap, convergence drop,
displacement keyframe trigger) stay masked selects on device tensors, and each matcher's
loop runs on the device (`ops.kernels.ndt_align_loop`, `gicp_align_loop`,
`icp_align_loop`: its early stop is a kernel that exits on the carry's `done`), so the
step, given its inputs on the card, makes no synchronous read: the host dispatches frame
t+1 and reads frame t's compact outputs afterwards (`pipeline/runner.py`, lagged
readback), as in the reference.

The submap ring and target rebuild stay OUTSIDE the step, driven by the host after it
reads a keyframe flag, exactly as in the reference: the target therefore lags the newest
keyframe by one frame, and the tests hold the port to that semantics.

Dispatch. The reference jits the step and the keyframe's insert-and-rebuild as one program
each (`lidar_graph_slam_tpu/odometry/fused.py:141,206-225`, the state and the ring donated),
so a frame costs the host one dispatch and a keyframe one more. `FusedFrontEnd` is the
port's counterpart: the same two bodies over fixed buffers (the state and the ring updated
in place, one fixed target, one fixed raw-scan buffer a bucket of
`pipeline/runner.py:_pad_bucket`, and an output slot for each frame in flight), each run
as one `utils/capture.py:Program` — on the card a CUDA graph, captured once a raw-scan
bucket for the step and once for the insert, then replayed. `make_fused_frontend`'s
`step`, `rebuild` and `insert_and_rebuild` stay the plain functions the tests call.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, PrefilterConfig, ScanMatcherConfig
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import (
    SubmapRing,
    init_ring,
    make_matcher,
    make_register,
    rebuild_target,
    ring_insert,
)
from lidar_graph_slam_tpu_torch.registration.base import norm
from lidar_graph_slam_tpu_torch.utils.capture import Program, copy_into


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

    step(state, raw_points [R,3], target, imu_R [3,3], use_imu, T_ext [4,4], use_ext)
         -> (state', FrameOut); `use_imu` and `use_ext` are bools or 0-d bool tensors on
         the device (the reference's traced flags)

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

    def flag(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.full((), bool(x), dtype=torch.bool, device=device)

    def step(state: FrontEndState, raw_points, target, imu_R, use_imu, T_ext, use_ext):
        # Validity comes from the PAD_VALUE sentinel: the host uploads one [R, 3] array.
        raw_mask = raw_points[:, 0] < (0.5 * PAD_VALUE)
        # Per-frame sensor->base extrinsic (the reference's per-callback TF lookup), a
        # masked select on the device flag as in the reference: with the flag off the
        # select returns the raw points' own bits.
        raw_points = torch.where(raw_mask[:, None] & flag(use_ext),
                                 se3.transform_points(T_ext, raw_points), raw_points)
        filtered = prefilter(raw_points, raw_mask)
        bootstrap = state.n_keyframes == 0

        # Initial guess: constant velocity or the reference's constant pose; the IMU
        # gyro rotation overrides when the flag is on (a masked select, as above).
        if cfg.initial_guess == "constant_velocity":
            guess = state.pose @ state.last_motion
        else:
            guess = state.pose.clone()
        guess[:3, :3] = torch.where(flag(use_imu), state.pose[:3, :3] @ imu_R, guess[:3, :3])

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

    rebuild = partial(rebuild_target, build_target, cfg.map_build_stride)

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


# -- the two programs on fixed buffers -----------------------------------------------------

# A frame's outputs in one float32 row (ids and counts stay exact below 2^24), so one copy
# reads a frame: pose (16) | converged | is_keyframe | fitness | iterations | keyframe_id |
# accum_distance | num_inliers.
SCALARS = 23
SCALAR_KEYFRAME_ID = 20
# The step's per-frame inputs in one float32 row: imu_R (9) | T_ext (16) | use_imu |
# use_ext | the frame's output slot.
FRAME_INPUTS = 28


def pack_scalars(out: FrameOut) -> torch.Tensor:
    """`out`'s scalars and pose as one [SCALARS] f32 row (see `SCALARS`)."""
    f32 = torch.float32
    return torch.cat([out.pose.reshape(16), torch.stack([
        out.converged.to(f32), out.is_keyframe.to(f32), out.fitness.to(f32),
        out.iterations.to(f32), out.keyframe_id.to(f32), out.accum_distance.to(f32),
        out.num_inliers.to(f32)])])


@dataclass
class FrameSlots:
    """The step's outputs, one row for each frame in flight: frame t writes slot t % S and
    is read after frames t+1 .. t+S-1 were dispatched, so S = pipeline depth + 1."""

    scalars: torch.Tensor   # [S, SCALARS] f32 (`pack_scalars`)
    kf_cloud: torch.Tensor  # [S, N, 3] the filtered cloud (keyframe payload)
    kf_mask: torch.Tensor   # [S, N]


def _step_body(step, state, target, frame_in, slots: FrameSlots, raw) -> None:
    """The step program: frame `raw` from `state` against `target`, with the inputs of
    `frame_in`; its outputs into the slot `frame_in` names, the state in place. (The
    programs' bodies take their buffers as arguments: a body bound to the front end
    would make a cycle that only the garbage collector frees.)"""
    new, out = step(state, raw, target, frame_in[0:9].view(3, 3), frame_in[25] > 0.5,
                    frame_in[9:25].view(4, 4), frame_in[26] > 0.5)
    slot = frame_in[27:28].to(torch.int64)
    slots.scalars.index_copy_(0, slot, pack_scalars(out)[None])
    slots.kf_cloud.index_copy_(0, slot, out.kf_cloud[None])
    slots.kf_mask.index_copy_(0, slot, out.kf_mask[None])
    copy_into(state, new)


def _insert_body(rebuild, window: int, ring, target, slots: FrameSlots, kf_in) -> None:
    """The insert program: output slot `kf_in`'s keyframe into ring slot keyframe_id %
    window, then the target rebuilt from the ring, in place."""
    row = slots.scalars.index_select(0, kf_in)[0]
    ring_slot = torch.remainder(
        row[SCALAR_KEYFRAME_ID:SCALAR_KEYFRAME_ID + 1].to(torch.int64), window)
    ring_insert(ring, ring_slot, slots.kf_cloud.index_select(0, kf_in)[0],
                slots.kf_mask.index_select(0, kf_in)[0], row[:16].view(4, 4))
    copy_into(target, rebuild(ring))


class FusedFrontEnd:
    """The fused front end as the reference dispatches it: the step and the keyframe's
    insert-and-rebuild, one program each (`utils/capture.py:Program`: on the card a CUDA
    graph, captured at first use and replayed after), over fixed buffers:

      * `state` (`FrontEndState`) and `ring` (`SubmapRing`), updated in place by the
        programs (the reference donates them);
      * `target`, the registration target every step program reads, written in place by
        the insert program (its first contents, the empty ring's map, are built here);
      * one raw-scan input buffer and one step program a bucket of rows (`_pad_bucket`'s
        powers of two), and the per-frame inputs row `frame_in` (`FRAME_INPUTS`);
      * `slots`, the outputs of `slots` frames in flight; `kf_in` the output slot whose
        keyframe the insert program writes into ring slot keyframe_id % window.

    `dispatch` uploads a padded scan and its inputs and runs the bucket's step program;
    `insert_and_rebuild(slot)` runs the insert program on a frame's output slot; `load`
    copies a resumed state and ring into the fixed buffers and rebuilds the target there.
    """

    def __init__(self, cfg: ScanMatcherConfig, prefilter_cfg: PrefilterConfig,
                 capacity: CapacityConfig, slots: int, device=None):
        self.device = resolve_device(device)
        init_state, self.step, aux = make_fused_frontend(cfg, prefilter_cfg, capacity,
                                                         device=self.device)
        self.rebuild, self.window = aux["rebuild"], aux["window"]
        self.state = init_state()
        self.ring = aux["init_ring"]()
        self.target = self.rebuild(self.ring)  # the empty map; frame 0 bootstraps
        n, dev = capacity.filtered_points, self.device
        self.slots = FrameSlots(
            scalars=torch.zeros((slots, SCALARS), dtype=torch.float32, device=dev),
            kf_cloud=torch.full((slots, n, 3), PAD_VALUE, dtype=torch.float32, device=dev),
            kf_mask=torch.zeros((slots, n), dtype=torch.bool, device=dev))
        self.frame_in = torch.zeros(FRAME_INPUTS, dtype=torch.float32, device=dev)
        self.kf_in = torch.zeros(1, dtype=torch.int64, device=dev)
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._raw: dict = {}                # bucket rows -> fixed [rows, 3] raw buffer
        self.programs: dict = {}            # bucket rows -> the step's Program
        self.insert_program = Program(
            partial(_insert_body, self.rebuild, self.window, self.ring, self.target,
                    self.slots, self.kf_in), dev, self._stream)

    @property
    def captures(self) -> int:
        """Programs captured so far: the step's (one a bucket seen) and the insert's."""
        return sum(p.captured for p in self.programs.values()) + self.insert_program.captured

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        src = torch.from_numpy(arr)
        if self.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    def dispatch(self, raw: np.ndarray, imu_R: Optional[np.ndarray],
                 T_ext: Optional[np.ndarray], slot: int) -> None:
        """Run the step on `raw` ([rows, 3] f32, PAD_VALUE rows after the scan) into output
        slot `slot`; `imu_R` / `T_ext` None switch the gyro guess / the extrinsic off."""
        rows = raw.shape[0]
        program = self.programs.get(rows)
        if program is None:
            buf = self._raw[rows] = torch.empty((rows, 3), dtype=torch.float32,
                                                device=self.device)
            program = self.programs[rows] = Program(
                partial(_step_body, self.step, self.state, self.target, self.frame_in,
                        self.slots, buf), self.device, self._stream)
        fin = np.zeros(FRAME_INPUTS, np.float32)
        fin[0:9] = (np.eye(3) if imu_R is None else np.asarray(imu_R)).reshape(9)
        fin[9:25] = (np.eye(4) if T_ext is None else np.asarray(T_ext)).reshape(16)
        fin[25:28] = (imu_R is not None, T_ext is not None, slot)
        self._upload(self._raw[rows], raw)
        self._upload(self.frame_in, fin)
        program()

    def outputs(self, slot: int) -> dict:
        """Views of output slot `slot`: `scalars`, `kf_cloud` and `kf_mask`."""
        return {"scalars": self.slots.scalars[slot], "kf_cloud": self.slots.kf_cloud[slot],
                "kf_mask": self.slots.kf_mask[slot]}

    def insert_and_rebuild(self, slot: int) -> None:
        """Insert output slot `slot`'s keyframe into the ring and rebuild the target."""
        self._upload(self.kf_in, np.array([slot], np.int64))
        self.insert_program()

    def load(self, state: FrontEndState, ring: SubmapRing) -> None:
        """Copy a resumed state and ring into the fixed buffers and rebuild the target
        there; the captured programs go on reading the same buffers."""
        copy_into(self.state, state)
        copy_into(self.ring, ring)
        copy_into(self.target, self.rebuild(self.ring))
