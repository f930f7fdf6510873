"""Graph-based SLAM back end: keyframe graph, loop closure, global correction, map export.

Port of `lidar_graph_slam_tpu/graph/slam.py` (the `graph_based_slam` node's behavior):
keyframe insertion with host pose chaining, loop detection (accumulated-distance gap +
Euclidean gate; the dormant radius and accum detectors), loop verification (coarse NDT
pre-align, then the ICP, NDT or GICP verifier, then the PCL fitness gate), loop factors, the
hybrid f64-host / f32-device pose-graph solve, and map assembly.

Concurrency, as in the reference's concurrent back end:
  * Verification runs in a worker thread on its own CUDA stream (on a CUDA device),
    which waits on the main stream's input builds. Its loops (the NDT pre-align, then the
    ICP, NDT or GICP verifier) and the fitness read nothing back; the thread's one wait is
    the read of its results, which would otherwise block the frame for the whole
    verification. `_consume_verify` joins the thread at the frame at
    which the reference reads its dispatched program's results (`loop_verify_lag_frames`),
    so which frame a loop factor lands on does not depend on timing. A failure in the
    thread is raised in the caller.
  * The solve runs in a `threading.Thread` over numpy (f64), as in the reference.
  * `async_backend=False` runs the same verification inline — the deterministic path.

With `use_global_init` each candidate's verification starts from its own FPFH+RANSAC
guess (`registration/features.py`), built by `_verify` ahead of the pre-align: in the
worker thread, on the candidate's stream, with the asynchronous back end (inline with the
synchronous one). On a CUDA device `torch.linalg.svd` reads its status on the host (three
calls a guess), so that wait falls on the worker, inside `verify_seconds`, and not on the
frame's thread. The RANSAC family counts are read with the results, on the same stream.

With a mesh (`parallel/distributed.py:Mesh`, from `ParallelConfig.use_mesh`), the top-k
candidates are laid out over the mesh's slots (`shard_batch`) and each slot's candidates
are verified on that slot's device, still in the worker thread, on one stream per device;
and the device f32 LM of the escalation ladder is `mesh_optimize` (Schur-decomposed or
chain steps, `ParallelConfig.backend_solver`).

Multi-process (`parallel/multihost.py`): with a `HostShardedKeyframeStore` each process
keeps only the keyframe clouds it owns, and every cloud read (the latest keyframe, a loop
submap, the map) goes through the store's all-gather; poses and factors replicate. Every
process must then issue the same collectives in the same order, so with more than one
process the verification and the solve run inline (`async_enabled` is off), and on a mesh
that spans processes each process verifies its own slots' candidates and the results are
all-gathered (`parallel/distributed.py:gather_slot_items`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, GraphSlamConfig
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud
from lidar_graph_slam_tpu_torch.graph import refine64, solver
from lidar_graph_slam_tpu_torch.io.pcd import write_pcd
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid
from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_map, voxel_downsample
from lidar_graph_slam_tpu_torch.parallel.distributed import (
    gather_slot_items,
    mesh_optimize,
    process_count,
    shard_batch,
)
from lidar_graph_slam_tpu_torch.registration import gicp as gicp_mod
from lidar_graph_slam_tpu_torch.registration import icp as icp_mod
from lidar_graph_slam_tpu_torch.registration.features import global_register
from lidar_graph_slam_tpu_torch.registration import ndt as ndt_mod


class _LazyCloud:
    """Deferred keyframe-cloud materialization: holds the driver's tensors (host copies
    of the device payload, or CPU tensors) until someone needs the numpy points."""

    __slots__ = ("_dev", "_mask", "_np")

    def __init__(self, cloud, mask):
        self._dev = cloud
        self._mask = mask
        self._np = None

    def get(self) -> np.ndarray:
        if self._np is None:
            c, m = self._dev.cpu().numpy(), self._mask.cpu().numpy()
            self._np = c[m].astype(np.float32)
            self._dev = self._mask = None  # release the buffers
        return self._np


def _host_cloud(kf) -> np.ndarray:
    """A keyframe record's valid points as float32 numpy (numpy or tensor payloads)."""
    cloud, mask = kf["cloud"], kf["cloud_mask"]
    if isinstance(cloud, torch.Tensor):
        cloud, mask = cloud.cpu().numpy(), mask.cpu().numpy()
    return np.asarray(cloud)[np.asarray(mask)].astype(np.float32)


PRE_ALIGN_OUTLIER_RATIO = 0.55
# `global_register`'s RANSAC family diagnostics, in the order `_verify` carries them.
_RANSAC_COUNTS = ("n_3pt_valid", "n_yaw_valid", "best_is_yaw")


def loop_pre_align(pre_map, src_p, src_m, guess):
    """Stage 1 of every loop verification: coarse NDT against the 4 m submap map."""
    return ndt_mod.ndt_align(pre_map, src_p, src_m, guess, step_size=0.4,
                             outlier_ratio=PRE_ALIGN_OUTLIER_RATIO, max_iterations=16)


def make_verify_one(cfg: GraphSlamConfig, method: str):
    """Single-candidate loop-verification function: coarse NDT pre-align -> configured
    verifier -> uniform PCL-style fitness. Returns (transform [4,4], fitness, ok) tensors.

    The NN grid cell is the configured correspondence distance capped at 2 m: the NDT
    pre-align brings correspondences within ~a cell, so the 7-cell neighborhood suffices.
    `extra` is the verifier's own target (the NDT map, the `GicpTarget`, None for ICP);
    `src_covs` the source's GICP covariances (None for the other verifiers).
    """
    corr_dist = min(cfg.icp.max_correspondence_distance, 2.0)

    def one(grid, pre_map, extra, guess, src_p, src_m, src_covs=None):
        # Stage 1: coarse NDT pre-align from `guess` (identity, the reference's ICP guess,
        # or the candidate's FPFH+RANSAC guess).
        pre = loop_pre_align(pre_map, src_p, src_m, guess)
        # Stage 2: refine with the configured verifier.
        if method == "ICP":
            res = icp_mod.icp_align(
                grid, src_p, src_m, pre.transform,
                max_correspondence_distance=corr_dist,
                max_iterations=cfg.icp.max_iterations,
                transform_epsilon=max(cfg.icp.transform_epsilon, 1e-7),
                euclidean_fitness_epsilon=cfg.icp.euclidean_fitness_epsilon,
                bucket_cap=16, neighborhood=7,
            )
        elif method == "GICP":
            res = gicp_mod.gicp_align(
                extra, src_p, src_m, pre.transform, src_covs,
                max_correspondence_distance=cfg.gicp.max_correspondence_distance,
                transform_epsilon=max(cfg.gicp.transform_epsilon, 1e-7),
                max_iterations=cfg.gicp.max_iterations,
            )
        else:  # NDT
            res = ndt_mod.ndt_align(
                extra, src_p, src_m, pre.transform,
                step_size=cfg.ndt.step_size,
                transform_epsilon=cfg.ndt.transform_epsilon,
                outlier_ratio=cfg.ndt.outlier_ratio,
                max_iterations=cfg.ndt.max_iterations,
            )
        # The decision quantity is always the PCL-style fitness, so the 0.3 gate means
        # the same for every method; too sparse a match fails the convergence flag.
        score, frac = icp_mod.fitness_and_match_fraction(
            grid, src_p, src_m, res.transform, max_range=corr_dist,
            bucket_cap=16, neighborhood=7, mode=cfg.fitness_mode,
        )
        ok = res.converged & (frac >= cfg.min_loop_match_fraction)
        return res.transform, score, ok

    return one


def host_results(host) -> dict:
    """The verification results of a batch (`_verify_candidate`'s outputs per item, as
    host tensors, in item order) as numpy arrays: Ts, scores, convs, and `global_diags`,
    one dict of RANSAC family counts per item (empty without `use_global_init`)."""
    out = {name: torch.stack([h[i] for h in host]).numpy()
           for i, name in enumerate(("Ts", "scores", "convs", "counts")[:len(host[0])])}
    out["global_diags"] = [
        {"n_3pt_valid": int(c[0]), "n_yaw_valid": int(c[1]), "best_is_yaw": bool(c[2])}
        for c in out.pop("counts", ())]
    return out


class GraphBasedSLAM:
    """Host-side back end. Keyframe clouds are kept host-side (numpy) and shipped to the
    device only for loop verification and map assembly. The pose graph lives twice: on
    the device (the f32 LM fallback) and as host f64 mirrors feeding the refinement tier
    (`_host_view`). Runs on the CUDA card unless `device` names another
    (`core/device.py`)."""

    _FLUSH_BATCH = 32

    def __init__(self, cfg: GraphSlamConfig, capacity: CapacityConfig, device=None,
                 mesh=None, backend_solver: str = "schur", cloud_store=None):
        self.cfg = cfg
        self.capacity = capacity
        self.device = resolve_device(device)
        # Multi-process keyframe-cloud sharding (`parallel/multihost.py`): with a
        # `HostShardedKeyframeStore` each process keeps only the clouds it owns and every
        # cloud read goes through the store's all-gather. Every process must make the same
        # decisions (SPMD), which feeding each the same scan stream gives.
        self.cloud_store = cloud_store
        self.method = cfg.registration_method.upper()
        if self.method not in ("ICP", "GICP", "NDT"):
            raise ValueError(f"unknown loop registration_method {cfg.registration_method!r}")
        # Mesh routing: the device LM runs over the mesh and the verification batch is laid
        # out over its slots.
        self.mesh = mesh
        self.backend_solver = backend_solver
        if backend_solver not in ("schur", "chain"):
            raise ValueError(f"unknown parallel.backend_solver {backend_solver!r}: "
                             f"'schur' or 'chain'")
        if mesh is not None and (capacity.max_keyframes % mesh.size != 0
                                 or capacity.max_keyframes // mesh.size < 2):
            # Divisibility AND >= 2 poses per slot: the Schur interior elimination indexes
            # U_loc[m-2], so m = 1 would wrap around to a wrong solve.
            raise ValueError(
                f"capacity.max_keyframes={capacity.max_keyframes} must be a multiple of "
                f"the mesh size {mesh.size} with at least 2 keyframes per slot for the "
                f"Schur domain decomposition")
        self._verify_one = make_verify_one(cfg, self.method)
        # Keyframe inserts into the device graph are deferred and flushed in batches;
        # `self.graph` (property) flushes on read.
        self._pending_kf: list = []
        self.graph = solver.init_graph(capacity.max_keyframes, capacity.max_loop_factors,
                                       cfg.odom_noise_var, device=self.device)
        self.kf_clouds: list = []  # [n_i, 3] numpy sensor-frame clouds or _LazyCloud
        self.kf_accum_dist: list[float] = []
        self.kf_stamps: list[Optional[float]] = []
        self.kf_front_poses: list[np.ndarray] = []  # front-end (odometry) poses
        self._poses_host: list[np.ndarray] = []      # optimized keyframe estimates
        self._host_odoms: list[np.ndarray] = []
        self._host_loops: list[tuple] = []           # (i, j, Z [4,4], info [6])
        self._host_prior: np.ndarray = np.eye(4, dtype=np.float64)
        self.loop_log: list[dict] = []
        self.n_keyframes = 0
        self.n_loops = 0
        self._frames_since_loop_check = 0
        self.is_loop_closed = False
        # Collectives (the store's gathers, a mesh that spans processes) must be issued
        # in lockstep by every process; the concurrent back end starts work by thread
        # liveness, which differs between processes. So with more than one process the
        # synchronous path runs.
        self.async_enabled = cfg.async_backend and process_count() == 1
        self._pending_verify = None
        self._verify_streams: dict = {}  # device -> the verification worker's stream
        self._solve_thread = None
        self._solve_result = None
        self._solve_error: Optional[BaseException] = None
        self._solve_epoch = 0
        self._lazy_pending: list = []
        self.keyframe_overflow = False
        self.loop_overflow = False
        # Telemetry: kernel launches made by verifications, the wall seconds of each
        # verification (in its thread), and per solve its wall seconds, f64 iterations
        # and whether the device f32 LM had to run.
        self.verify_launches = 0
        self.verify_seconds: list[float] = []
        self.solve_log: list[dict] = []
        self._map_cache = None

    # -- deferred device-graph population ------------------------------------------------

    @property
    def graph(self) -> solver.PoseGraph:
        """Device pose graph with all pending keyframe inserts applied."""
        self._flush_graph()
        return self._graph

    @graph.setter
    def graph(self, g: solver.PoseGraph) -> None:
        self._graph = g

    def _flush_graph(self) -> None:
        while self._pending_kf:
            chunk = self._pending_kf[: self._FLUSH_BATCH]
            self._pending_kf = self._pending_kf[self._FLUSH_BATCH:]
            B = self._FLUSH_BATCH
            poses = np.zeros((B, 4, 4), np.float32)
            odoms = np.zeros((B, 4, 4), np.float32)
            for i, (p, o) in enumerate(chunk):
                poses[i], odoms[i] = p, o
            self._graph = solver.graph_add_keyframes_batch(
                self._graph, torch.as_tensor(poses, device=self.device),
                torch.as_tensor(odoms, device=self.device), len(chunk))

    # -- keyframe insertion ---------------------------------------------------------------

    def add_keyframe(self, kf) -> None:
        """Insert a front-end keyframe record (`core.msgs.KeyFrame` or a mapping with
        pose, cloud, cloud_mask, accum_distance). At `max_keyframes` capacity the insert
        is refused and `keyframe_overflow` is flagged."""
        if self.n_keyframes >= self.capacity.max_keyframes:
            self.keyframe_overflow = True
            return
        pose = np.asarray(kf["pose"], dtype=np.float32)
        if self.n_keyframes == 0:
            odom = np.eye(4, dtype=np.float32)
        else:
            prev = self.kf_front_poses[-1]
            odom = (np.linalg.inv(prev) @ pose).astype(np.float32)
            # Chain the measurement onto the *optimized* previous pose (iSAM2's
            # initialization of new keys from composed odometry).
            prev_opt = self._poses_host[self.n_keyframes - 1]
            pose = (prev_opt @ odom).astype(np.float32)
        self._pending_kf.append((pose, odom))
        self._host_odoms.append(odom)
        if self.n_keyframes == 0:
            self._host_prior = np.asarray(pose, np.float64)
        if self.cloud_store is not None:
            # The owner stores the materialized cloud; the others only the metadata.
            owns = self.cloud_store.owns(self.n_keyframes)
            self.cloud_store.add(self.n_keyframes, _host_cloud(kf) if owns else None)
        elif isinstance(kf["cloud"], np.ndarray):
            self.kf_clouds.append(_host_cloud(kf))
        else:
            # Tensors handed over by the fused driver: the numpy conversion waits for
            # `drain_lazy_clouds` (a couple of keyframes later) or a loop attempt.
            self.kf_clouds.append(_LazyCloud(kf["cloud"], kf["cloud_mask"]))
            self._lazy_pending.append(self.n_keyframes)
        self.kf_accum_dist.append(float(kf["accum_distance"]))
        stamp = kf.get("stamp") if hasattr(kf, "get") else None
        self.kf_stamps.append(None if stamp is None else float(stamp))
        self.kf_front_poses.append(np.asarray(kf["pose"], dtype=np.float32))
        self._poses_host.append(pose)
        self.n_keyframes += 1

    # -- loop detection ---------------------------------------------------------------------

    def detect_loop(self, mode: str = "inline") -> Optional[int]:
        """A loop candidate for the latest keyframe, or None.

        mode="inline": the active detector — accumulated-distance gap AND Euclidean gate
          (`search_for_candidate_threshold`), keep the nearest.
        mode="radius": the dormant kd-tree variant — `search_radius` with the same gap,
          plus the `temporal_gate_sec` gate when keyframes carry stamps.
        mode="accum": the dormant accumulated-distance-only variant (no Euclidean gate).
        """
        cands = self.detect_loop_topk(1, mode=mode)
        return cands[0] if cands else None

    def detect_loop_topk(self, k: int, mode: str = "inline") -> list:
        """The k nearest gated candidates, closest first, with successive picks separated
        by at least `search_key_frame_num` keyframes."""
        if self.n_keyframes < 2:
            return []
        latest = self.n_keyframes - 1
        positions = np.stack([T[:3, 3] for T in self._poses_host])
        cur_pos = positions[latest]
        cur_accum = self.kf_accum_dist[latest]
        accum = np.asarray(self.kf_accum_dist[: self.n_keyframes])
        d = np.linalg.norm(positions - cur_pos[None, :], axis=1)

        gate = (cur_accum - accum) >= self.cfg.accumulate_distance_threshold
        if mode == "inline":
            gate &= d < self.cfg.search_for_candidate_threshold
        elif mode == "radius":
            gate &= d < self.cfg.search_radius
            # Unstamped keyframes (stamp None) pass the temporal gate.
            cur_stamp = self.kf_stamps[latest]
            if cur_stamp is not None and self.cfg.temporal_gate_sec > 0:
                ages = np.array([
                    np.inf if s is None else cur_stamp - s
                    for s in self.kf_stamps[: self.n_keyframes]
                ])
                gate &= ages > self.cfg.temporal_gate_sec
        elif mode != "accum":
            raise ValueError(f"unknown loop detection mode {mode!r}")
        if not gate.any():
            return []
        order = np.argsort(np.where(gate, d, np.inf))
        chosen: list[int] = []
        min_sep = max(1, self.cfg.search_key_frame_num)
        for idx in order:
            if not gate[idx]:
                break
            if all(abs(int(idx) - c) >= min_sep for c in chosen):
                chosen.append(int(idx))
            if len(chosen) >= k:
                break
        return chosen

    # -- loop verification + factor insertion ---------------------------------------------

    def _assemble_submap(self, center: int, half_window: int,
                         max_points: Optional[int] = None) -> np.ndarray:
        """Map-frame concat of keyframes [center-w, center+w] under current estimates.
        An over-budget submap is UNIFORM-STRIDE subsampled to exactly `max_points`, so it
        still spans the full window (head truncation would keep only its left edge)."""
        lo = max(0, center - half_window)
        hi = min(self.n_keyframes, center + half_window + 1)
        if self.cloud_store is not None:
            out = self.cloud_store.assemble_submap(lo, hi, np.stack(self._poses_host))
        else:
            chunks = []
            for k, T in zip(range(lo, hi), self._poses_host[lo:hi]):
                chunks.append(self._cloud(k) @ T[:3, :3].T + T[:3, 3])
            out = np.concatenate(chunks).astype(np.float32)
        if max_points is not None and out.shape[0] > max_points:
            idx = np.linspace(0, out.shape[0] - 1, max_points).astype(np.int64)
            out = np.ascontiguousarray(out[idx])
        return out

    def _cloud(self, k: int) -> np.ndarray:
        """Keyframe k's sensor/base-frame cloud (all-gathered when sharded, a collective;
        materialized on first access when lazily stored)."""
        if self.cloud_store is not None:
            return self.cloud_store.get_cloud(k)
        c = self.kf_clouds[k]
        if isinstance(c, _LazyCloud):
            c = c.get()
            self.kf_clouds[k] = c
        return c

    def drain_lazy_clouds(self, max_items: int = 1, min_age: int = 2) -> None:
        """Materialize up to `max_items` pending keyframe clouds that are at least
        `min_age` keyframes old. Called once per frame by the pipeline."""
        drained = 0
        while (self._lazy_pending and drained < max_items
               and self._lazy_pending[0] <= self.n_keyframes - min_age):
            self._cloud(self._lazy_pending.pop(0))
            drained += 1

    def try_close_loop(self) -> bool:
        """One SYNCHRONOUS loop-closure attempt for the latest keyframe: verify the top-k
        gated candidates, add a factor per accepted candidate, then re-optimize once.
        Returns True if any factor was added."""
        pending = self.begin_loop_attempt()
        if pending is None:
            return False
        if not self._consume_verify(pending):
            return False
        self._run_optimize()
        self.is_loop_closed = True
        return True

    def _build_verify_inputs(self):
        """Detection + verification-input builds for the latest keyframe (on the back
        end's device, on the calling thread's stream). Returns None (gated/capacity) or a
        dict with the per-candidate `targets` (grid, pre-align map, verifier map, initial
        guess's inputs: None, or with `use_global_init` the candidate's filtered submap
        and viewpoint, from which `_verify` builds the FPFH+RANSAC guess), the source
        cloud and attempt metadata."""
        if self.n_loops >= self.capacity.max_loop_factors:
            # Refuse at capacity and surface it (the device graph drops the write).
            if not self.loop_overflow:
                self.loop_log.append({
                    "latest": self.n_keyframes - 1, "candidate": -1, "fitness": np.inf,
                    "converged": False, "accepted": False, "overflow": True,
                })
            self.loop_overflow = True
            return None
        cands = self.detect_loop_topk(max(1, self.cfg.loop_topk))
        if not cands:
            return None
        latest = self.n_keyframes - 1
        dev = self.device

        # Latest keyframe cloud in the map frame under the current estimate.
        T_latest = self._poses_host[latest]
        src = self._cloud(latest) @ T_latest[:3, :3].T + T_latest[:3, 3]
        src_cloud = PointCloud.from_array(src, capacity=self.capacity.keyframe_points,
                                          device=dev)
        corr_dist = min(self.cfg.icp.max_correspondence_distance, 2.0)
        targets = []
        for cand in cands:
            submap = self._assemble_submap(cand, self.cfg.search_key_frame_num,
                                           max_points=self.capacity.loop_submap_points)
            sub_cloud = PointCloud.from_array(submap, capacity=self.capacity.loop_submap_points,
                                              device=dev)
            filtered = voxel_downsample(sub_cloud.points, sub_cloud.mask,
                                        self.cfg.loop_submap_leaf,
                                        capacity=self.capacity.loop_submap_points)
            # Stage 0's inputs (optional): the FPFH+RANSAC global guess is built by
            # `_verify`, off the frame's thread when the back end is asynchronous.
            glob = None
            if self.cfg.use_global_init:
                glob = (filtered.points, filtered.mask, self._poses_host[cand][:3, 3])
            grid = build_hash_grid(filtered.points, filtered.mask, corr_dist)
            pre_map = build_ndt_map(filtered.points, filtered.mask, 4.0,
                                    capacity=self.capacity.voxel_capacity // 4)
            extra = None
            if self.method == "NDT":
                extra = build_ndt_map(filtered.points, filtered.mask, self.cfg.ndt.resolution,
                                      capacity=self.capacity.voxel_capacity // 4)
            elif self.method == "GICP":
                extra = gicp_mod.build_gicp_target(
                    filtered.points, filtered.mask, self.cfg.gicp.max_correspondence_distance,
                    k=self.cfg.gicp.correspondence_randomness)
            targets.append((grid, pre_map, extra, glob))
        src_covs = None
        if self.method == "GICP":
            # The source's covariances, once per attempt, shared by every candidate.
            src_covs, _ = gicp_mod.estimate_covariances(
                src_cloud.points, src_cloud.mask, self.cfg.gicp.max_correspondence_distance,
                k=self.cfg.gicp.correspondence_randomness)
        return {
            "cands": cands, "latest": latest, "T_latest": T_latest, "targets": targets,
            "source": (src_cloud.points, src_cloud.mask, src_covs),
        }

    def _verify_candidate(self, target, source, T_latest):
        """One candidate's verification from its `_build_verify_inputs` target and the
        source, on the caller's thread and stream: `_initial_guess`, then the verifier.
        Returns device tensors (transform, fitness, ok), then the RANSAC family counts
        with `use_global_init`."""
        grid, pre_map, extra, glob = target
        src_p, src_m, src_covs = source
        guess, counts = self._initial_guess(glob, src_p, src_m, T_latest)
        return (*self._verify_one(grid, pre_map, extra, guess, src_p, src_m, src_covs),
                *counts)

    def _initial_guess(self, glob, src_p, src_m, T_latest):
        """Stage 0 of a verification, on the caller's thread and stream: the identity, or
        with `use_global_init` the FPFH+RANSAC global initial guess — it recovers
        candidates whose drift lies far outside any local verifier's basin. The select
        stays on the device: no host branch on `ok`. Returns (guess [4,4], the RANSAC
        family counts as a tuple of one int64 [3] tensor, empty without the option)."""
        eye = torch.eye(4, dtype=torch.float32, device=src_p.device)
        if glob is None:
            return eye, ()
        tgt_p, tgt_m, tgt_viewpoint = glob
        gr = self.cfg.global_reg
        T_g, _, g_ok, diag = global_register(
            src_p, src_m, tgt_p, tgt_m, keypoint_leaf=gr.keypoint_leaf,
            normal_k=gr.normal_k, fpfh_k=gr.fpfh_k, hypotheses=gr.hypotheses,
            inlier_threshold=gr.inlier_threshold, min_occupancy=gr.min_occupancy,
            max_keypoints=gr.max_keypoints, src_viewpoint=T_latest[:3, 3],
            tgt_viewpoint=tgt_viewpoint, return_diag=True)
        counts = torch.stack([diag[k].to(torch.int64) for k in _RANSAC_COUNTS])
        return torch.where(g_ok, T_g, eye), (counts,)

    def _verify(self, inp, streams=None) -> dict:
        """Run every candidate's verification (the reference's vmap over candidates: each
        one is independent), each on its own device (`inp["sources"]` holds its source
        there) and, given `streams`, on that device's stream. On a mesh that spans
        processes this process verifies its own slots' candidates and the others' results
        are all-gathered. Each verification starts from `_initial_guess` (with
        `use_global_init`, the FPFH+RANSAC guess, built here on the candidate's stream).
        Returns host results and this thread's kernel launches."""
        t0 = time.perf_counter()
        before = kernels.thread_launches()

        def on_stream(dev):
            return torch.cuda.stream(streams[dev]) if streams else contextlib.nullcontext()

        n = len(inp["targets"])
        sources = inp.get("sources") or [inp["source"]] * n
        slots = inp.get("slots") or [None] * n
        local = set(self.mesh.local_slots) if self.mesh is not None else set()
        mine = [i for i in range(n) if slots[i] is None or slots[i] in local]
        results = {}
        for i in mine:
            with on_stream(sources[i][0].device):
                results[i] = self._verify_candidate(inp["targets"][i], sources[i],
                                                    inp["T_latest"])
        # Each result is read on the stream that computed it: another stream of the
        # thread would not wait for it.
        for i in mine:
            with on_stream(sources[i][0].device):
                results[i] = tuple(x.cpu() for x in results[i])
        host = (gather_slot_items(self.mesh, slots, results) if self.mesh is not None
                else [results[i] for i in range(n)])
        out = host_results(host)
        out["launches"] = kernels.thread_launches() - before
        out["seconds"] = time.perf_counter() - t0
        return out

    def begin_loop_attempt(self):
        """Detect + start verification for the latest keyframe; returns a pending record
        (or None if gated/at capacity). With `async_enabled` the verification runs in a
        worker thread (on its own CUDA stream on a card) and `_consume_verify` joins it;
        otherwise it runs inline here."""
        inp = self._build_verify_inputs()
        if inp is None:
            return None
        pending = {k: inp[k] for k in ("cands", "latest", "T_latest")}
        pending["age"] = 0
        if self.mesh is not None:
            # Each slot's candidates (and a copy of the source) on the slot's device.
            inp["targets"], inp["sources"], inp["slots"] = shard_batch(
                self.mesh, inp["targets"], inp["source"])
            pending["slots"] = inp["slots"]
        if not self.async_enabled:
            pending["results"] = self._verify(inp)
            return pending

        streams = {}
        for src in inp.get("sources") or [inp["source"]]:
            dev = src[0].device
            if dev.type == "cuda" and dev not in streams:
                if dev not in self._verify_streams:
                    self._verify_streams[dev] = torch.cuda.Stream(dev)
                streams[dev] = self._verify_streams[dev]
                # The inputs were built (or placed) on this thread's stream. The worker
                # holds `inp` until its streams are synchronized, so no input buffer is
                # freed (and reused by that stream) while the verification may read it.
                streams[dev].wait_stream(torch.cuda.current_stream(dev))

        def run():
            if not streams:
                return self._verify(inp)
            try:
                return self._verify(inp, streams)
            finally:
                for stream in streams.values():
                    stream.synchronize()

        def work():
            try:
                pending["results"] = run()
            except BaseException as e:  # noqa: BLE001 — relayed to the joining thread
                pending["error"] = e

        pending["thread"] = threading.Thread(target=work, name="loop-verify", daemon=True)
        pending["thread"].start()
        return pending

    def _consume_verify(self, pending) -> bool:
        """Join a started verification and insert a loop factor per accepted candidate.
        Returns True if any factor was added. A failure in the verification is raised."""
        thread = pending.pop("thread", None)
        if thread is not None:
            thread.join()
        if "error" in pending:
            raise pending.pop("error")
        res = pending["results"]
        self.verify_launches += res["launches"]
        self.verify_seconds.append(res["seconds"])
        cands, latest, T_latest = pending["cands"], pending["latest"], pending["T_latest"]

        any_accepted = False
        for b, cand in enumerate(cands):
            fitness = float(res["scores"][b])
            converged = bool(res["convs"][b])
            record = {
                "latest": latest,
                "candidate": cand,
                "fitness": fitness,
                "converged": converged,
                "accepted": False,
                "transform": res["Ts"][b],  # verifier's map-frame correction
            }
            if res["global_diags"]:
                record["ransac_families"] = res["global_diags"][b]
            self.loop_log.append(record)
            if not converged or fitness >= self.cfg.score_threshold:
                continue
            if self.n_loops >= self.capacity.max_loop_factors:
                record["overflow"] = True
                self.loop_overflow = True
                continue
            # Loop factor: corrected latest pose vs candidate pose. The verifier maps the
            # current-map-frame latest cloud onto the candidate submap, so the corrected
            # latest pose is T_b @ T_latest.
            T_corrected = res["Ts"][b] @ T_latest
            Z = (np.linalg.inv(T_corrected) @ self._poses_host[cand]).astype(np.float32)
            info = np.full((6,), 1.0 / max(fitness, 1e-6), dtype=np.float32)
            self.graph = solver.graph_add_loop(
                self.graph, latest, cand, torch.as_tensor(Z, device=self.device),
                torch.as_tensor(info, device=self.device))
            self._host_loops.append(
                (latest, cand, Z.astype(np.float64), info.astype(np.float64)))
            self.n_loops += 1
            record["accepted"] = True
            any_accepted = True
        return any_accepted

    def _host_view(self) -> refine64.GraphView:
        """f64 `GraphView` assembled from the HOST factor mirrors — no device read."""
        n = self.n_keyframes
        if self._host_loops:
            li, lj, lz, linfo = zip(*self._host_loops)
            lz = np.stack(lz)
            linfo = np.stack(linfo)
        else:
            li, lj = (), ()
            lz = np.zeros((0, 4, 4), np.float64)
            linfo = np.zeros((0, 6), np.float64)
        return refine64.GraphView(
            np.stack(self._poses_host), np.stack(self._host_odoms[:n]),
            self._host_prior,
            1.0 / np.asarray(self.cfg.odom_noise_var, np.float64),
            li, lj, lz, linfo,
            robust_delta=self.cfg.loop_robust_delta,
        )

    def _bucket_size(self) -> int:
        """Active-size bucket for the device solve: the smallest power of two >=
        n_keyframes (min 256), capped at capacity, so its cost tracks the live graph."""
        b = 256
        while b < self.n_keyframes:
            b *= 2
        cap = self.capacity.max_keyframes
        if self.mesh is not None:
            n = self.mesh.size
            # Schur needs divisibility + >= 2 poses per slot. The capacity has both (checked
            # at construction), so doubling stops there at the latest: a mesh size that is
            # not a power of two never divides a doubled 256 (the reference loops forever).
            while (b % n or b // n < 2) and b < cap:
                b *= 2
        return min(b, cap)

    def _bucket_graph(self) -> solver.PoseGraph:
        """A snapshot of the device graph cut to the active-size bucket. Graph updates
        build new tensors (`solver.graph_add_*`, `set_poses`), so views are a snapshot."""
        B = self._bucket_size()
        g = self.graph
        return g.replace(poses=g.poses[:B], pose_mask=g.pose_mask[:B], odom_meas=g.odom_meas[:B])

    def _make_device_lm(self, gb: solver.PoseGraph):
        """Escalation-ladder device callback: the f32 LM on the bucketed graph `gb` —
        over the mesh (`mesh_optimize` with the configured solver) when there is one.
        Shared by the synchronous and threaded solve paths."""

        def device_lm(poses64):
            gd = solver.set_poses(gb, poses64)
            if self.mesh is not None:
                gd = mesh_optimize(self.mesh, gd, max_iterations=30,
                                   solver=self.backend_solver)
            else:
                gd = solver.optimize(gd, max_iterations=30)
            return gd.poses[: poses64.shape[0]].cpu().numpy().astype(np.float64)

        return device_lm

    def _solve(self, view: refine64.GraphView, device_lm):
        """The escalation ladder (`solver.escalate_f64`), logged in `solve_log`."""
        t0 = time.perf_counter()
        poses64, info = solver.escalate_f64(view, device_lm, tail_iterations=6)
        self.solve_log.append({"seconds": time.perf_counter() - t0,
                               "iterations": info["iterations"],
                               "device_lm": info["device_lm"]})
        return poses64, info

    def _apply_solved(self, new_host: list) -> None:
        """Write solved (and re-chained) host poses into the mirrors and the device graph."""
        self._poses_host = new_host
        self.graph = solver.set_poses(self.graph, np.stack(new_host))
        self._solve_epoch += 1

    def _run_optimize(self) -> None:
        """Global re-solve after factor insertion: host f64 Gauss-Newton from the current
        estimates, with the device f32 LM only if f64 stalls (`solver.escalate_f64`);
        poses are written back into the full-capacity graph."""
        poses64, _info = self._solve(self._host_view(), self._make_device_lm(self._bucket_graph()))
        p32 = poses64.astype(np.float32)
        self._apply_solved([p32[k] for k in range(p32.shape[0])])

    # -- concurrent back end (async verification + threaded solve) ----------------------

    def _start_solve_async(self) -> None:
        """Launch the escalation-ladder solve on a snapshot of the graph in a worker
        thread; the front end keeps appending keyframes meanwhile, and `_finish_solve`
        re-chains those onto the solved poses."""
        view = self._host_view()
        device_lm = self._make_device_lm(self._bucket_graph())

        def work():
            # Capture, don't swallow: `_finish_solve` re-raises with the real traceback.
            try:
                self._solve_result = self._solve(view, device_lm)
            except BaseException as e:  # noqa: BLE001 — relayed, not suppressed
                self._solve_error = e

        self._solve_error = None
        self._solve_thread = threading.Thread(target=work, name="pose-graph-solve",
                                              daemon=True)
        self._solve_thread.start()

    def _finish_solve(self) -> None:
        """Join the solve thread and apply its result: solved poses for the snapshot's
        keyframes, composed odometry re-chaining for keyframes appended while it ran."""
        self._solve_thread.join()
        self._solve_thread = None
        if self._solve_error is not None:
            err, self._solve_error = self._solve_error, None
            raise err
        poses64, _info = self._solve_result
        self._solve_result = None
        p32 = poses64.astype(np.float32)
        new_host = [p32[k] for k in range(p32.shape[0])]
        for k in range(len(new_host), self.n_keyframes):
            new_host.append((new_host[k - 1] @ self._host_odoms[k]).astype(np.float32))
        self._apply_solved(new_host)
        self.is_loop_closed = True

    def poll_async(self) -> None:
        """Advance the concurrent back end by one frame: harvest a finished solve
        (non-blocking), then consume a lagged verification and kick off its solve."""
        if self._solve_thread is not None and not self._solve_thread.is_alive():
            self._finish_solve()
        if self._pending_verify is not None and self._solve_thread is None:
            self._pending_verify["age"] += 1
            if self._pending_verify["age"] > max(0, self.cfg.loop_verify_lag_frames):
                pending = self._pending_verify
                self._pending_verify = None
                if self._consume_verify(pending):
                    self._start_solve_async()

    def finish_async(self) -> None:
        """Drain the concurrent back end: join any in-flight solve, then consume a
        still-pending verification synchronously. Called by the pipeline's flush."""
        if self._solve_thread is not None:
            self._finish_solve()
        if self._pending_verify is not None:
            pending = self._pending_verify
            self._pending_verify = None
            if self._consume_verify(pending):
                self._run_optimize()
                self.is_loop_closed = True

    def on_frame(self) -> bool:
        """Per-frame cadence hook: a loop check every `loop_search_period_frames` (<= 0
        derives it from `rate` at the nominal 10 Hz sensor). With `async_backend` the
        check only starts verification; factors land `loop_verify_lag_frames` later and
        the solve overlaps later frames. Returns True the frame a solve's corrections
        were applied."""
        closed_before = self._solve_epoch
        self.drain_lazy_clouds()
        if self.async_enabled:
            self.poll_async()
        period = self.cfg.loop_search_period_frames
        if period <= 0:
            period = max(1, int(round(10.0 / max(self.cfg.rate, 1e-6))))
        self._frames_since_loop_check += 1
        if self._frames_since_loop_check >= period:
            self._frames_since_loop_check = 0
            if not self.async_enabled:
                return self.try_close_loop()
            # Skip the tick while the previous attempt is still in flight.
            if self._pending_verify is None and self._solve_thread is None:
                self._pending_verify = self.begin_loop_attempt()
        return self._solve_epoch != closed_before

    # -- outputs ------------------------------------------------------------------------

    def optimized_poses(self) -> np.ndarray:
        if self.n_keyframes == 0:
            return np.zeros((0, 4, 4), dtype=np.float32)
        return np.stack(self._poses_host).astype(np.float32)

    def assemble_map(self, resolution: float = 0.0, max_points: Optional[int] = None) -> np.ndarray:
        """All keyframe clouds under optimized poses; optional voxel filter at `resolution`
        (run on the back end's device). Cached per (keyframes, loops, solve epoch,
        resolution, max_points): poses change only through keyframe appends or solves."""
        if self.n_keyframes == 0:
            return np.zeros((0, 3), dtype=np.float32)
        key = (self.n_keyframes, self.n_loops, self._solve_epoch, float(resolution), max_points)
        if self._map_cache is not None and self._map_cache[0] == key:
            return self._map_cache[1]
        poses = self.optimized_poses()
        if self.cloud_store is not None:
            pts = self.cloud_store.assemble_submap(0, self.n_keyframes, poses)
        else:
            chunks = [
                self._cloud(k) @ poses[k][:3, :3].T + poses[k][:3, 3]
                for k in range(self.n_keyframes)
            ]
            pts = np.concatenate(chunks).astype(np.float32)
        if resolution > 0.0:
            cap = max_points or pts.shape[0]
            cloud = PointCloud.from_array(pts, capacity=pts.shape[0], device=self.device)
            grid = voxel_downsample(cloud.points, cloud.mask, resolution, capacity=cap)
            pts = grid.points[grid.mask].cpu().numpy()
        self._map_cache = (key, pts)
        return pts

    def save_map(self, path: str, resolution: float = 0.0) -> bool:
        """The `/save_map` service: resolution <= 0 exports the raw map."""
        try:
            pts = self.assemble_map(resolution)
            write_pcd(path, pts)
            return True
        except OSError:
            return False
