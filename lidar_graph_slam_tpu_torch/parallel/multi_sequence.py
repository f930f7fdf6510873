"""Batched multi-sequence odometry and SLAM: several scan streams at once.

Port of `lidar_graph_slam_tpu/parallel/multi_sequence.py`. The reference runs the whole
front end — align, keyframe trigger, submap-ring update, NDT map rebuild — as one jitted
`lax.scan` over frames with the batch axis vmapped over sequences. Here a batch frame is
one `utils/capture.py:Program` run over fixed buffers (`BatchBuffers`): the state and the
ring as [B, ...] tensors updated in place (the scan's carry), the [B, F, ...] scans and
masks read at a device frame counter (its xs), and [B, F, ...] outputs written at it (its
ys). On the card the first frame warms the body up and captures it as a CUDA graph, and
every later frame is one replay; on the CPU the body runs eagerly on the same buffers.
The body:

  * each sequence's two NDT maps (coarse and fine) are rebuilt from its ring every frame,
    with two `build_ndt_map` calls as in the reference (not the pyramid), one sequence
    after another, and stacked for the batched kernel;
  * the coarse and the fine alignment run for the whole batch at once
    (`registration/ndt.py:ndt_align_batched`: one launch of the batched NDT iteration
    kernel per iteration, no host read; a finished sequence's blocks exit on its own
    `done`);
  * keyframing is a masked state update, per sequence; the ring insert writes only the
    slot kf_count % window of each sequence, behind the displacement trigger.

A sequence's result does not depend on the others in its batch: on the card, a batch of
B equals B runs of one, bit for bit.

`batch_slam` adds per-sequence graph back ends fed in lockstep, with the due sequences'
loop verifications as one batch over the mesh and one block-diagonal f64 solve.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import (
    CapacityConfig,
    GraphSlamConfig,
    ScanMatcherConfig,
)
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu_torch.graph import refine64, solver
from lidar_graph_slam_tpu_torch.ops.kernels import stack_maps
from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu_torch.parallel.distributed import (
    Mesh,
    all_slots,
    gather_slot_items,
    shard_batch,
)
from lidar_graph_slam_tpu_torch.registration.base import norm
from lidar_graph_slam_tpu_torch.registration.ndt import ndt_align_batched
from lidar_graph_slam_tpu_torch.utils.capture import Program


@dataclass
class BatchFrontState:
    """Every field carries a leading batch axis [B, ...]."""

    pose: torch.Tensor          # [B, 4, 4]
    last_motion: torch.Tensor   # [B, 4, 4]
    last_kf_pos: torch.Tensor   # [B, 3]
    accum_dist: torch.Tensor    # [B]
    kf_count: torch.Tensor      # [B] int32
    ring_clouds: torch.Tensor   # [B, W, N, 3] sensor-frame keyframe clouds
    ring_masks: torch.Tensor    # [B, W, N]
    ring_poses: torch.Tensor    # [B, W, 4, 4]
    ring_used: torch.Tensor     # [B, W]


def _init_state(batch: int, window: int, n: int, device) -> BatchFrontState:
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.eye(4, **f32)
    return BatchFrontState(
        pose=eye.repeat(batch, 1, 1),
        last_motion=eye.repeat(batch, 1, 1),
        last_kf_pos=torch.zeros((batch, 3), **f32),
        accum_dist=torch.zeros(batch, **f32),
        kf_count=torch.zeros(batch, dtype=torch.int32, device=device),
        ring_clouds=torch.full((batch, window, n, 3), PAD_VALUE, **f32),
        ring_masks=torch.zeros((batch, window, n), dtype=torch.bool, device=device),
        ring_poses=eye.repeat(batch, window, 1, 1),
        ring_used=torch.zeros((batch, window), dtype=torch.bool, device=device),
    )


@dataclass
class BatchBuffers:
    """The fixed buffers of a batched run, which the frame program reads and writes in
    place: the carry (`state`), the frames in (`scans` [B, F, N, 3], `masks` [B, F, N]),
    the frame they are read at (`frame`, [1] int64), and the outputs written at it
    (`outs`: "pose" [B, F, 4, 4], "is_keyframe", "converged", "fitness", "accum_dist"
    [B, F])."""

    state: BatchFrontState
    scans: torch.Tensor
    masks: torch.Tensor
    frame: torch.Tensor
    outs: dict


def _buffers(scans, masks, window: int) -> BatchBuffers:
    """A batched run's buffers on the device of `scans`, the state at its start."""
    B, F, N = scans.shape[:3]
    dev = scans.device
    f32, flag = dict(dtype=torch.float32, device=dev), dict(dtype=torch.bool, device=dev)
    return BatchBuffers(
        state=_init_state(B, window, N, dev), scans=scans, masks=masks,
        frame=torch.zeros(1, dtype=torch.int64, device=dev),
        outs={"pose": torch.zeros((B, F, 4, 4), **f32),
              "is_keyframe": torch.zeros((B, F), **flag),
              "converged": torch.zeros((B, F), **flag),
              "fitness": torch.zeros((B, F), **f32),
              "accum_dist": torch.zeros((B, F), **f32)})


def _lane_maps(state: BatchFrontState, b: int, cfg: ScanMatcherConfig, map_capacity: int):
    """Sequence b's target maps from its current ring: (fine, coarse or None)."""
    world = se3.transform_points(state.ring_poses[b], state.ring_clouds[b])
    m = state.ring_masks[b] & state.ring_used[b][:, None]
    world = torch.where(m[..., None], world, PAD_VALUE).reshape(-1, 3)
    m = m.reshape(-1)
    fine = build_ndt_map(world, m, cfg.ndt.resolution, capacity=map_capacity)
    coarse = None
    if cfg.ndt.coarse_resolution > 0.0:
        coarse = build_ndt_map(world, m, cfg.ndt.coarse_resolution,
                               capacity=map_capacity // 2)
    return fine, coarse


def _lane_update(state: BatchFrontState, b: int, res, cfg):
    """Sequence b's masked state update after its alignment `res` (lane b of the batched
    result). Returns (its new pose, motion, keyframe position, distance and count, its
    frame outputs); the ring insert is `_ring_insert`'s."""
    eye = torch.eye(4, dtype=torch.float32, device=state.pose.device)
    pose, kf_count = state.pose[b], state.kf_count[b]
    healthy = res.converged[b] & (res.num_inliers[b] > 0)
    is_first = kf_count == 0
    new_pose = torch.where(is_first, eye, torch.where(healthy, res.transform[b], pose))
    last_motion = torch.where(healthy & ~is_first, se3.inverse(pose) @ new_pose,
                              state.last_motion[b])
    delta = norm(new_pose[:3, 3] - state.last_kf_pos[b])
    trigger = is_first | (healthy & (delta >= cfg.displacement))
    accum = state.accum_dist[b] + torch.where(trigger & ~is_first, delta, 0.0)
    lane = dict(
        pose=new_pose,
        last_motion=last_motion,
        last_kf_pos=torch.where(trigger, new_pose[:3, 3], state.last_kf_pos[b]),
        accum_dist=accum,
        kf_count=kf_count + trigger.to(torch.int32),
    )
    out = {"pose": new_pose, "is_keyframe": trigger, "converged": healthy,
           "fitness": res.fitness[b], "accum_dist": accum}
    return lane, out


def _ring_insert(state: BatchFrontState, trigger, scans, masks, poses) -> None:
    """Each sequence's frame into its ring slot kf_count % window where `trigger` [B]
    holds, in place: the reference's `jnp.where(trigger, ring.at[slot].set(x), ring)`,
    written to that slot alone. Reads `state.kf_count` before the frame's update."""
    B, W = state.ring_used.shape
    rows = (torch.arange(B, device=trigger.device) * W
            + torch.remainder(state.kf_count, W).to(torch.int64))
    for ring, value in ((state.ring_clouds, scans), (state.ring_masks, masks),
                        (state.ring_poses, poses),
                        (state.ring_used, torch.ones_like(trigger))):
        flat = ring.view(B * W, *ring.shape[2:])
        keep = flat.index_select(0, rows)
        put = trigger.view(B, *(1,) * (keep.dim() - 1))
        flat.index_copy_(0, rows, torch.where(put, value, keep))


def _step(state: BatchFrontState, scans, masks, cfg: ScanMatcherConfig, map_capacity: int):
    """One front-end frame for the whole batch, the state updated in place: scans
    [B, N, 3], masks [B, N]. Returns the frame's outputs [B, ...]."""
    B = scans.shape[0]
    fines, coarses = zip(*(_lane_maps(state, b, cfg, map_capacity) for b in range(B)))
    # Initial-guess model as the live front end: the reference's constant pose by default;
    # constant velocity extrapolates the last accepted motion once a keyframe exists.
    if cfg.initial_guess == "constant_velocity":
        eye = torch.eye(4, dtype=torch.float32, device=scans.device)
        guess = torch.stack([torch.where(state.kf_count[b] > 0,
                                         state.pose[b] @ state.last_motion[b], eye)
                             for b in range(B)])
    else:
        guess = state.pose
    ndt = cfg.ndt
    if coarses[0] is not None:
        vm_coarse = stack_maps(coarses)
        coarses = None
        pre = ndt_align_batched(vm_coarse, scans, masks, guess,
                                step_size=ndt.step_size * 4.0,
                                transform_epsilon=ndt.transform_epsilon,
                                outlier_ratio=ndt.outlier_ratio,
                                max_iterations=ndt.coarse_iterations)
        del vm_coarse
        guess = pre.transform
    vm = stack_maps(fines)
    fines = None
    res = ndt_align_batched(vm, scans, masks, guess, step_size=ndt.step_size,
                            transform_epsilon=ndt.transform_epsilon,
                            outlier_ratio=ndt.outlier_ratio, max_iterations=ndt.max_iterations)
    del vm
    lanes, outs = zip(*(_lane_update(state, b, res, cfg) for b in range(B)))
    out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    _ring_insert(state, out["is_keyframe"], scans, masks, out["pose"])
    for name in lanes[0]:
        getattr(state, name).copy_(torch.stack([ln[name] for ln in lanes]))
    return out


def _frame_body(buf: BatchBuffers, cfg: ScanMatcherConfig, map_capacity: int) -> None:
    """The frame program: frame `buf.frame` of the scans through `_step`, its outputs
    into column `buf.frame` of `buf.outs`, then the counter moved on, all in place."""
    f = buf.frame
    out = _step(buf.state, buf.scans.index_select(1, f)[:, 0],
                buf.masks.index_select(1, f)[:, 0], cfg, map_capacity)
    for k, v in out.items():
        buf.outs[k].index_copy_(1, f, v[:, None])
    f.add_(1)


def _run_frames(program: Program, frames: int, program_log: list | None) -> None:
    """`frames` runs of the frame program, then its graph and pool released; a failed
    capture or replay raises and nothing runs after it. Appends the program's record
    (device, captures, replays, pool bytes) to `program_log` if one is given."""
    try:
        for _ in range(frames):
            program()
        if program_log is not None:
            program_log.append({"device": str(program.device), "captures": program.captures,
                                "replays": program.replays,
                                "pool_bytes": program.pool_bytes()})
    finally:
        program.release()


def _run_batch(scans, masks, cfg: ScanMatcherConfig, map_capacity: int,
               program_log: list | None = None):
    """Frames 0..F-1 of [B, F, N, 3] scans on their device, one run of the frame program
    each (on the card: a capture at frame 0, a replay after, on a stream of its own).
    Returns (final state, outputs [B, F, ...])."""
    buf = _buffers(scans, masks, cfg.max_scan_accumulate_num)
    dev = scans.device
    program = Program(partial(_frame_body, buf, cfg, map_capacity), dev,
                      torch.cuda.Stream(dev) if dev.type == "cuda" else None)
    _run_frames(program, scans.shape[1], program_log)
    return buf.state, buf.outs


def batch_odometry(scans, masks, cfg: ScanMatcherConfig, map_capacity: int = 32768,
                   mesh: Mesh | None = None, device=None, program_log: list | None = None):
    """Run NDT front-end odometry on [B, F, N, 3] scan batches (numpy or tensors) with
    [B, F, N] masks, on the card unless `device` names another.

    With `mesh`, the batch axis is split over the mesh's slots (the batch must divide it,
    as the reference's sharded inputs must), each slot's sequences on its device; slots
    that share a device run as one batch there, which gives the same answer. On a mesh
    that spans processes each process runs its own slots' sequences and the results are
    all-gathered (`all_slots`), so every process returns the whole batch. Each device's
    sequences run as one frame program (`_run_batch`); `program_log`, a list, gets one
    record a program: its device, captures, replays and pool bytes. Returns
    (final_state, outs): outs["pose"] [B, F, 4, 4], "is_keyframe", "converged",
    "fitness", "accum_dist" [B, F].
    """
    scans = torch.as_tensor(np.asarray(scans, np.float32) if not isinstance(
        scans, torch.Tensor) else scans)
    masks = torch.as_tensor(np.asarray(masks, bool) if not isinstance(
        masks, torch.Tensor) else masks)
    if mesh is None:
        dev = resolve_device(device)
        return _run_batch(scans.to(dev), masks.to(dev), cfg, map_capacity, program_log)
    B = scans.shape[0]
    if B % mesh.size:
        raise ValueError(f"a batch of {B} sequences does not divide the mesh's {mesh.size} "
                         f"slots")
    per = B // mesh.size
    groups: dict = {}  # device -> the sequences of this process's slots, in slot order
    for s in mesh.local_slots:
        groups.setdefault(mesh.devices[s], []).extend(range(s * per, (s + 1) * per))
    dev0 = mesh.devices[mesh.local_slots[0]]
    parts = []
    for dev, seqs in groups.items():
        idx = torch.as_tensor(seqs)
        parts.append((seqs, _run_batch(scans[idx].to(dev), masks[idx].to(dev), cfg,
                                       map_capacity, program_log)))
    order = torch.as_tensor(np.argsort(np.concatenate([s for s, _ in parts])))
    final = BatchFrontState(**{
        f.name: torch.cat([getattr(st, f.name).to(dev0) for _, (st, _) in parts])[order.to(dev0)]
        for f in fields(BatchFrontState)})
    outs = {k: torch.cat([o[k].to(dev0) for _, (_, o) in parts])[order.to(dev0)]
            for k in parts[0][1][1]}
    if mesh.spans_processes:
        keys = list(outs)
        per_slot = [(_take(final, j * per, (j + 1) * per),
                     tuple(outs[k][j * per:(j + 1) * per] for k in keys))
                    for j in range(len(mesh.local_slots))]
        slots = all_slots(mesh, per_slot)
        final = BatchFrontState(**{
            f.name: torch.cat([getattr(st, f.name) for st, _ in slots]).to(dev0)
            for f in fields(BatchFrontState)})
        outs = {k: torch.cat([o[i] for _, o in slots]).to(dev0) for i, k in enumerate(keys)}
    return final, outs


def _take(state: BatchFrontState, lo: int, hi: int) -> BatchFrontState:
    return BatchFrontState(**{f.name: getattr(state, f.name)[lo:hi]
                              for f in fields(BatchFrontState)})


# --- multi-sequence SLAM ------------------------------------------------------------------


def _batched_loop_attempts(backs, due, mesh: Mesh | None) -> None:
    """One cross-sequence loop-verification round and block-diagonal solve.

    Each due sequence's detection and input builds run through the same
    `GraphBasedSLAM._build_verify_inputs` the live pipeline uses; the verifications then
    run as one batch whose axis spans sequences x candidates, laid out over the mesh by
    `shard_batch` (each candidate with its own sequence's source). A batch that does not
    divide the mesh stays on the back ends' device (the reference pads it with repeats of
    its last candidate to shard it evenly; here the slots run one after another, so a pad
    would only cost time). Sequences are independent, so batching changes no decision.
    Every sequence that accepts a factor is then solved in `_solve_block_diagonal`."""
    from lidar_graph_slam_tpu_torch.graph.slam import host_results

    inputs = [(b, inp) for b in due if (inp := backs[b]._build_verify_inputs()) is not None]
    if not inputs:
        return
    items = [(target, inp["source"], inp["T_latest"])
             for _, inp in inputs for target in inp["targets"]]
    slots = [None] * len(items)
    local = set()
    if mesh is not None:
        items, _, slots = shard_batch(mesh, items, None)
        local = set(mesh.local_slots)
    verify = backs[inputs[0][0]]._verify_candidate
    results = {}
    for i, item in enumerate(items):
        if slots[i] is None or slots[i] in local:  # another process verifies the rest
            results[i] = tuple(x.cpu() for x in verify(*item))
    host = (gather_slot_items(mesh, slots, results) if mesh is not None
            else [results[i] for i in range(len(items))])
    res = host_results(host)

    accepted, off = [], 0
    for b, inp in inputs:
        k = len(inp["cands"])
        part = slice(off, off + k)
        pend = {"cands": inp["cands"], "latest": inp["latest"], "T_latest": inp["T_latest"],
                "results": {
                    "Ts": res["Ts"][part], "scores": res["scores"][part],
                    "convs": res["convs"][part], "launches": 0, "seconds": 0.0,
                    "slots": slots[part], "global_diags": res["global_diags"][part]}}
        off += k
        if backs[b]._consume_verify(pend):
            accepted.append(b)
    if accepted:
        _solve_block_diagonal(backs, accepted)


def _solve_block_diagonal(backs, seqs) -> None:
    """Solve the accepted sequences' pose graphs as one block-diagonal f64 system:
    per-sub-graph priors plus a chain masked at the sequence boundaries
    (`refine64.GraphView(prior_rows=..., chain_mask=...)`), equal to separate
    per-sequence solves."""
    views = [backs[b]._host_view() for b in seqs]
    Ks = [v.poses.shape[0] for v in views]
    offs = np.concatenate([[0], np.cumsum(Ks)]).astype(np.int64)
    chain_mask = np.ones(int(offs[-1]), bool)
    chain_mask[offs[1:-1]] = False
    combined = refine64.GraphView(
        np.concatenate([v.poses for v in views]),
        np.concatenate([v.odom_meas for v in views]),
        views[0].prior_pose, views[0].odom_info,
        np.concatenate([v.loop_i + offs[i] for i, v in enumerate(views)]),
        np.concatenate([v.loop_j + offs[i] for i, v in enumerate(views)]),
        np.concatenate([v.loop_meas for v in views]),
        np.concatenate([v.loop_info for v in views]),
        robust_delta=views[0].robust_delta,
        prior_rows=offs[:-1],
        prior_poses=np.stack([v.prior_pose for v in views]),
        chain_mask=chain_mask,
    )
    poses64, _info = solver.escalate_f64(combined, device_lm=lambda p: p)
    for i, b in enumerate(seqs):
        p32 = poses64[offs[i]:offs[i + 1]].astype(np.float32)
        backs[b]._apply_solved([p32[k] for k in range(p32.shape[0])])
        backs[b].is_loop_closed = True


def batch_slam(scans, masks, cfg: ScanMatcherConfig, graph_cfg=None, capacity=None,
               map_capacity: int = 32768, mesh: Mesh | None = None,
               loop_every_keyframes: int = 5, device=None):
    """Multi-sequence SLAM: batched odometry, then per-sequence `GraphBasedSLAM` back ends
    fed in lockstep (keyframe ordinal t across sequences). Every `loop_every_keyframes`
    inserts a sequence attempts a loop closure; the due sequences' verifications run as
    one batch over the mesh (`_batched_loop_attempts`), followed by one block-diagonal
    f64 solve of every accepted graph. Per-sequence trajectories equal the per-sequence
    path's: the same detector, verifier and solver as the live pipeline.

    Returns a list of B dicts: {"odometry_poses" [F,4,4], "keyframe_poses" [K,4,4],
    "keyframe_frame_indices" [K], "num_loop_closures", "loop_log"}.
    """
    from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM

    graph_cfg = graph_cfg or GraphSlamConfig()
    capacity = capacity or CapacityConfig()
    scans_np = np.asarray(scans, np.float32)
    masks_np = np.asarray(masks, bool)
    dev = mesh.devices[mesh.local_slots[0]] if mesh is not None else resolve_device(device)
    _, outs = batch_odometry(scans_np, masks_np, cfg, map_capacity, mesh, dev)
    outs = {k: v.cpu().numpy() for k, v in outs.items()}
    B = scans_np.shape[0]

    backs = [GraphBasedSLAM(graph_cfg, capacity, device=dev) for _ in range(B)]
    kf_frames_all = [np.nonzero(outs["is_keyframe"][b])[0] for b in range(B)]
    since = [0] * B
    max_kf = max((len(k) for k in kf_frames_all), default=0)
    for t in range(max_kf):
        due = []
        for b in range(B):
            if t >= len(kf_frames_all[b]):
                continue
            f = kf_frames_all[b][t]
            backs[b].add_keyframe({
                "pose": outs["pose"][b, f].astype(np.float32),
                "cloud": scans_np[b, f],
                "cloud_mask": masks_np[b, f],
                "accum_distance": float(outs["accum_dist"][b, f]),
            })
            since[b] += 1
            if since[b] >= loop_every_keyframes:
                since[b] = 0
                due.append(b)
        if due:
            _batched_loop_attempts(backs, due, mesh)
    # Final attempt for sequences whose tail keyframes came in after their last cadence
    # tick (since == 0: the last insert already attempted this exact pair).
    tail_due = [b for b in range(B) if since[b] and len(kf_frames_all[b])]
    if tail_due:
        _batched_loop_attempts(backs, tail_due, mesh)

    return [{
        "odometry_poses": outs["pose"][b],
        "keyframe_poses": backs[b].optimized_poses(),
        "keyframe_frame_indices": kf_frames_all[b],
        "num_loop_closures": sum(1 for rec in backs[b].loop_log if rec["accepted"]),
        "loop_log": backs[b].loop_log,
    } for b in range(B)]
