"""Checkpoint / exact resume for the SLAM pipeline.

Port of `lidar_graph_slam_tpu/utils/checkpoint.py`. The full SLAM state — keyframe store
(poses + clouds + accumulated distances), factor list, front-end pose/ring/motion —
serializes to one compressed .npz, and `load_pipeline` reconstructs a pipeline that
continues where it stopped. The file has the reference's keys, shapes and dtypes, so a
checkpoint written by either package loads in the other.

With the classic driver the resume is exact. With the fused driver the one-frame submap
lag collapses at the checkpoint (`flush()` drains the frames in flight and the target is
rebuilt from the ring), so the resumed trajectory may differ by a small, damped amount;
the keyframe schedule is the same. Either driver's ring (and the fused driver's state) is
copied into the fixed buffers its programs read (`odometry/fused.py:FusedFrontEnd.load`,
`odometry/scan_matcher.py:ScanMatcher.load`), so a resumed run equals a run flushed at
the same frame and continued.

A multi-process pipeline (sharded keyframe store, `parallel/multihost.py`) is refused, as
the reference refuses it: each process holds only its share of the clouds.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import config as config_mod
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from lidar_graph_slam_tpu_torch.utils import state as state_mod


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _json_default(obj):
    """Loop-log records hold numpy values (the verifier's transform, numpy scalars)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def save_pipeline(pipe: SlamPipeline, path: str) -> None:
    """Write `pipe`'s state to `path` (.npz). Nothing is left in flight first: the fused
    driver's pending frames are consumed, a pending verification (its thread and CUDA
    stream) is joined and its factors solved, a running solve thread is joined, and the
    deferred keyframe inserts are flushed into the device graph before it is read."""
    pipe.flush()
    back = pipe.back
    if back.cloud_store is not None:
        raise NotImplementedError(
            "checkpointing a multi-host pipeline (sharded keyframe store) is not "
            "supported: each host holds only its cloud shard — save the map via "
            "save_map() (allgathers) or checkpoint from a single-host run")
    back.finish_async()  # flush() settles the back end only with loop closure enabled
    g = back.graph       # the property applies the pending keyframe inserts
    n_kf = back.n_keyframes

    # Keyframe clouds are ragged host-side; store concatenated + offsets
    # (back._cloud materializes any still-lazy clouds).
    if n_kf:
        clouds = [back._cloud(k) for k in range(n_kf)]
        cloud_cat = np.concatenate(clouds)
        cloud_offsets = np.cumsum([0] + [c.shape[0] for c in clouds])
    else:
        cloud_cat = np.zeros((0, 3), np.float32)
        cloud_offsets = np.zeros((1,), np.int64)

    cfg_json = json.dumps(_config_to_dict(pipe.cfg))
    loop_log_json = json.dumps(back.loop_log, default=_json_default)
    np.savez_compressed(
        path,
        config_json=np.frombuffer(cfg_json.encode(), dtype=np.uint8),
        # back end graph (the reference's dtypes: int32 ids, Python-int counts)
        graph_poses=_np(g.poses),
        graph_pose_mask=_np(g.pose_mask),
        graph_odom_meas=_np(g.odom_meas),
        graph_prior_pose=_np(g.prior_pose),
        graph_loop_i=_np(g.loop_i).astype(np.int32),
        graph_loop_j=_np(g.loop_j).astype(np.int32),
        graph_loop_meas=_np(g.loop_meas),
        graph_loop_info=_np(g.loop_info),
        graph_loop_mask=_np(g.loop_mask),
        graph_num_poses=int(g.num_poses),
        graph_num_loops=int(g.num_loops),
        # keyframe store
        kf_cloud_cat=cloud_cat,
        kf_cloud_offsets=np.asarray(cloud_offsets, np.int64),
        kf_accum_dist=np.asarray(back.kf_accum_dist, np.float64),
        kf_front_poses=(np.stack(back.kf_front_poses) if n_kf
                        else np.zeros((0, 4, 4), np.float32)),
        kf_frame_indices=np.asarray(pipe.kf_frame_indices, np.int64),
        loop_log=np.frombuffer(loop_log_json.encode(), dtype=np.uint8),
        # front end (both drivers serialize the same logical state)
        **_front_state_arrays(pipe),
        odometry_poses=(np.stack(pipe.odometry_poses) if pipe.odometry_poses
                        else np.zeros((0, 4, 4), np.float32)),
    )


def _front_state_arrays(pipe: SlamPipeline) -> dict:
    if pipe.fused:
        st, ring = pipe.fused_front.state, pipe.fused_front.ring
        front = dict(
            front_pose=_np(st.pose),
            front_last_motion=_np(st.last_motion),
            front_last_kf_pose=_np(st.last_kf_pose),
            front_accum=_np(st.accum_distance),
            front_n_keyframes=_np(st.n_keyframes),
            front_n_frames=len(pipe.odometry_poses),
        )
    else:
        f, ring = pipe.front, pipe.front.ring
        front = dict(
            front_pose=f.pose,
            front_last_motion=f.last_motion,
            front_last_kf_pose=f.last_kf_pose,
            front_accum=f.accum_distance,
            front_n_keyframes=f.n_keyframes,
            front_n_frames=f.n_frames,
        )
    return dict(front, ring_clouds=_np(ring.clouds), ring_masks=_np(ring.masks),
                ring_poses=_np(ring.poses), ring_used=_np(ring.used))


def load_pipeline(path: str, device=None) -> SlamPipeline:
    """A pipeline on `device` (None: the CUDA card, `core/device.py`) that continues the
    run saved at `path`, by this package or by the reference."""
    z = np.load(path)
    cfg = _config_from_dict(json.loads(bytes(z["config_json"]).decode()))
    pipe = SlamPipeline(cfg, device=device)
    dev = pipe.device

    # Back end: the device graph (odom_info comes from the config) ...
    back = pipe.back
    arrays = {name: z[f"graph_{name}"] for name in (
        "poses", "pose_mask", "odom_meas", "prior_pose", "loop_i", "loop_j", "loop_meas",
        "loop_info", "loop_mask", "num_poses", "num_loops")}
    arrays["odom_info"] = _np(back.graph.odom_info)
    back.graph = state_mod.pose_graph_from_numpy(arrays, device=dev)
    n_kf = int(z["graph_num_poses"])
    offsets = z["kf_cloud_offsets"]
    cat = z["kf_cloud_cat"]
    back.kf_clouds = [cat[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]
    back.kf_accum_dist = [float(v) for v in z["kf_accum_dist"]]
    back.kf_front_poses = [np.asarray(p, np.float32) for p in z["kf_front_poses"]]
    back.kf_stamps = [None] * n_kf  # not in the file: unstamped keyframes pass every gate
    back.loop_log = json.loads(bytes(z["loop_log"]).decode())
    for rec in back.loop_log:
        if "transform" in rec:
            rec["transform"] = np.asarray(rec["transform"], np.float32)
    back.n_keyframes = n_kf
    back.is_loop_closed = any(rec.get("accepted") for rec in back.loop_log)

    # ... and the host mirrors it solves and chains from.
    back._poses_host = [np.asarray(p, np.float32) for p in z["graph_poses"][:n_kf]]
    back._host_odoms = [np.asarray(o, np.float32) for o in z["graph_odom_meas"][:n_kf]]
    back._host_prior = np.asarray(z["graph_prior_pose"], np.float64)
    n_loops = int(z["graph_num_loops"])
    back.n_loops = n_loops
    back._host_loops = [
        (int(z["graph_loop_i"][k]), int(z["graph_loop_j"][k]),
         np.asarray(z["graph_loop_meas"][k], np.float64),
         np.asarray(z["graph_loop_info"][k], np.float64))
        for k in range(n_loops) if bool(z["graph_loop_mask"][k])
    ]
    pipe._loop_attempts_emitted = len(back.loop_log)

    # Front end.
    ring = state_mod.ring_from_numpy(z, device=dev)
    if pipe.fused:
        # Into the fixed buffers the front end's captured programs read and write.
        pipe.fused_front.load(state_mod.front_end_state_from_numpy(z, device=dev), ring)
    else:
        front = pipe.front
        front.pose = np.asarray(z["front_pose"], np.float32)
        front.last_motion = np.asarray(z["front_last_motion"], np.float32)
        front.last_kf_pose = np.asarray(z["front_last_kf_pose"], np.float32)
        front.accum_distance = float(z["front_accum"])
        front.n_keyframes = int(z["front_n_keyframes"])
        front.n_frames = int(z["front_n_frames"])
        # Into the fixed ring and target the matcher's programs read and write.
        front.load(ring)
        # Historical keyframes live in the back end; the front-end log restarts empty, so
        # the runner's consumption cursor restarts at 0 alongside it.
        front.keyframe_log = []
        pipe._kf_consumed = 0
    pipe.kf_frame_indices = [int(v) for v in z["kf_frame_indices"]]
    pipe.odometry_poses = [np.asarray(p, np.float32) for p in z["odometry_poses"]]
    return pipe


def _config_to_dict(cfg) -> dict:
    def conv(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if isinstance(obj, tuple):
            return list(obj)
        return obj

    return conv(cfg)


def _config_from_dict(d: dict):
    """JSON turned the tuples into lists; `_update_dataclass` restores them."""
    return config_mod._update_dataclass(config_mod.PipelineConfig(), d)
