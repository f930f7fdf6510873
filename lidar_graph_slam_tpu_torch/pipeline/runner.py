"""End-to-end SLAM pipeline driver (front end + graph back end).

Port of `lidar_graph_slam_tpu/pipeline/runner.py`, with its two front-end drivers:

  * fused (default): each frame runs the fused front-end step (`odometry/fused.py`) on
    the device, and the host reads frame t's outputs AFTER dispatching frame t+1
    (lagged readback). A frame's outputs are copied to pinned host memory with
    non-blocking copies started right after its step; the consume waits on that frame's
    event only. `process_scan` therefore returns the PREVIOUS frame's record.
  * classic (`fused_frontend=False`): stage by stage — prefilter, then
    `odometry/scan_matcher.py:ScanMatcher` (one batched read per frame, the target
    rebuilt at once on a keyframe), then the back end — with per-stage wall times; the
    prefilter stage waits for the card's stream, as the reference blocks on its output.

`flush()` / `result()` drain the frames in flight and settle the concurrent back end
(loop verification and solve, `graph/slam.py`). `utils/checkpoint.py` saves a pipeline and
resumes it. With `parallel.use_mesh` the back end gets a mesh
(`parallel/distributed.py:make_mesh(parallel.mesh_devices or None)` on the pipeline's
device): loop candidates are verified over its slots and the device LM runs over it with
`parallel.backend_solver`; the front end stays on one device, as in the reference.

Multi-process runs are detected, as the reference's are: once a process group of more
than one process is up (the CLI's `--multihost`, or `parallel/multihost.py:
initialize_from_env()`), every process feeds the same scan stream, the keyframe clouds
shard over the processes (`HostShardedKeyframeStore`), and the mesh of `parallel.use_mesh`
spans every process's slots.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.config import PipelineConfig
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.core.msgs import KeyFrame
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, PointCloud
from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import ScanMatcher, integrate_gyro
from lidar_graph_slam_tpu_torch.parallel.distributed import make_mesh, process_count
from lidar_graph_slam_tpu_torch.parallel.multihost import HostShardedKeyframeStore
from lidar_graph_slam_tpu_torch.utils.telemetry import MetricsWriter


@dataclass
class PipelineResult:
    odometry_poses: np.ndarray          # [F, 4, 4] per-frame front-end poses
    keyframe_poses: np.ndarray          # [K, 4, 4] keyframe poses
    keyframe_frame_indices: np.ndarray  # [K] which frame each keyframe came from
    num_loop_closures: int
    loop_log: list
    metrics: dict = field(default_factory=dict)


class _HostCopy:
    """A frame's outputs on the host: non-blocking copies into pinned memory, started
    when the frame is dispatched, waited on (by event) when it is consumed. CPU tensors
    are kept as they are."""

    def __init__(self, tensors: dict):
        self.event = None
        if all(t.device.type == "cpu" for t in tensors.values()):
            self.host = tensors
            return
        self.host = {}
        for name, t in tensors.items():
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self.host[name] = buf
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _pack_scalars(out) -> torch.Tensor:
    """pose (16) | converged | is_keyframe | fitness | iterations | keyframe_id | accum —
    one f32 row (ids and counts stay exact below 2^24), so one copy reads a frame."""
    f32 = torch.float32
    return torch.cat([out.pose.reshape(16), torch.stack([
        out.converged.to(f32), out.is_keyframe.to(f32), out.fitness.to(f32),
        out.iterations.to(f32), out.keyframe_id.to(f32), out.accum_distance.to(f32)])])


class SlamPipeline:
    """Host driver: feed raw scans, get trajectories, map, and metrics. Runs on the CUDA
    card unless `device` names another (`core/device.py`)."""

    def __init__(self, cfg: PipelineConfig, metrics_path: Optional[str] = None,
                 extrinsic_provider=None, device=None, mesh=None):
        """`mesh` (a `parallel.distributed.Mesh`) replaces the one `parallel.use_mesh`
        builds, e.g. several slots on one card."""
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is None and cfg.parallel.use_mesh:
            self.mesh = make_mesh(cfg.parallel.mesh_devices or None, device=self.device)
        self.metrics_writer = MetricsWriter(metrics_path)
        self.cfg = cfg
        # Per-frame sensor->base extrinsic hook: callable stamp -> [4,4] | None (None
        # falls back to the static config extrinsic, then identity).
        self.extrinsic_provider = extrinsic_provider
        cap = cfg.capacity
        cloud_store = None
        if process_count() > 1:
            cloud_store = HostShardedKeyframeStore(pad_points=cap.keyframe_points)
        self.back = GraphBasedSLAM(cfg.graph_slam, cap, device=self.device, mesh=self.mesh,
                                   backend_solver=cfg.parallel.backend_solver,
                                   cloud_store=cloud_store)
        self.timings: dict[str, list] = {"prefilter": [], "register": [], "backend": []}
        self.raw_truncation_count = 0
        self.odometry_poses: list[np.ndarray] = []
        self.kf_frame_indices: list[int] = []
        self._loop_attempts_emitted = 0
        self.fused = cfg.fused_frontend
        if not self.fused:
            # The voxel stage's output capacity bounds the SOR working set: twice the
            # final budget, as in the fused step.
            self.prefilter = make_prefilter(
                cfg.prefilter, capacity_out=cap.filtered_points,
                voxel_capacity=min(cap.raw_points, 2 * cap.filtered_points))
            self.front = ScanMatcher(cfg.scan_matcher, scan_capacity=cap.filtered_points,
                                     map_voxel_capacity=cap.voxel_capacity,
                                     device=self.device)
            self.front.extrinsic_provider = extrinsic_provider
            self._kf_consumed = 0
            return
        self.front = None
        init_state, self._step, aux = make_fused_frontend(
            cfg.scan_matcher, cfg.prefilter, cap, device=self.device)
        self._state = init_state()
        self._static_ext = None
        if any(abs(v) > 1e-12 for v in cfg.scan_matcher.extrinsic_xyzrpy):
            x, y, z, roll, pitch, yaw = cfg.scan_matcher.extrinsic_xyzrpy
            self._static_ext = se3.make_transform(
                se3.so3_exp(torch.tensor([roll, pitch, yaw], dtype=torch.float32)),
                torch.tensor([x, y, z], dtype=torch.float32)).numpy()
        self._eye4 = torch.eye(4, dtype=torch.float32, device=self.device)
        self._eye3 = torch.eye(3, dtype=torch.float32, device=self.device)
        self._ring = aux["init_ring"]()
        self._insert_and_rebuild = aux["insert_and_rebuild"]
        self._rebuild = aux["rebuild"]
        self._window = aux["window"]
        self._target = self._rebuild(self._ring)  # empty map; frame 0 bootstraps
        self._pending: deque = deque()  # (frame_idx, wall_t0, stamp, FrameOut, _HostCopy)
        self._last_out: dict = {}
        # Gyro samples queue here and integrate host-side between consecutive scan
        # stamps; the result rides into the step as (imu_R, use_imu).
        self._imu_queue: list = []
        self._last_dispatch_stamp = None

    def _emit_loop_attempts(self, frame_idx: int) -> None:
        """Stream every loop-closure attempt (accepted AND rejected) into the metrics."""
        while self._loop_attempts_emitted < len(self.back.loop_log):
            rec = self.back.loop_log[self._loop_attempts_emitted]
            self._loop_attempts_emitted += 1
            self.metrics_writer.emit({
                "event": "loop_attempt",
                "frame": frame_idx,
                "latest": rec.get("latest"),
                "candidate": rec.get("candidate"),
                "fitness": float(rec.get("fitness", np.inf)),
                "converged": bool(rec.get("converged", False)),
                "accepted": bool(rec.get("accepted", False)),
                "overflow": bool(rec.get("overflow", False)),
            })

    def _loops_accepted(self) -> int:
        return sum(1 for rec in self.back.loop_log if rec["accepted"])

    # -- fused driver -------------------------------------------------------------------

    def _consume_fused(self, item) -> dict:
        """Read one pending frame's outputs and run the back end."""
        frame_idx, t0, stamp, out, host = item
        t1 = time.perf_counter()
        h = host.wait()
        s = h["scalars"].numpy()
        t2 = time.perf_counter()
        pose = s[:16].reshape(4, 4).copy()
        kf_id = int(s[20])
        info = {
            "pose": pose,
            "is_keyframe": bool(s[17] > 0.5),
            "converged": bool(s[16] > 0.5),
            "fitness": float(s[18]),
            "iterations": int(s[19]),
        }
        if info["is_keyframe"]:
            # Insert into the device-side submap ring and rebuild the registration
            # target; it takes effect at the next dispatched frame (one-frame lag).
            self._ring, self._target = self._insert_and_rebuild(
                self._ring, kf_id % self._window, out.kf_cloud, out.kf_mask, out.pose)
            self.back.add_keyframe(KeyFrame(
                id=kf_id, pose=pose, accum_distance=float(s[21]),
                cloud=h["kf_cloud"], cloud_mask=h["kf_mask"],  # tensors — lazy numpy
                frame_index=frame_idx, stamp=stamp,
            ))
            self.kf_frame_indices.append(frame_idx)
        if self.cfg.enable_loop_closure:
            self.back.on_frame()
        else:
            self.back.drain_lazy_clouds()
        self._emit_loop_attempts(frame_idx)
        t3 = time.perf_counter()

        self.odometry_poses.append(pose)
        self.timings["register"].append(t2 - t1)
        self.timings["backend"].append(t3 - t2)
        self.metrics_writer.emit({
            "frame": frame_idx,
            "converged": info["converged"],
            "fitness": info["fitness"],
            "iterations": info["iterations"],
            "is_keyframe": info["is_keyframe"],
            "n_keyframes": self.back.n_keyframes,
            "loops_accepted": self._loops_accepted(),
            "register_ms": 1000 * (t2 - t1),
            "backend_ms": 1000 * (t3 - t2),
        })
        self._last_out = info
        return info

    def _pad_bucket(self, scan: np.ndarray) -> np.ndarray:
        """Pad the raw scan to the smallest power-of-two bucket (min 8192) that holds it,
        capped at `capacity.raw_points`. Scans larger than that are truncated — surfaced
        via `raw_truncation_count` and a metrics event."""
        n = min(scan.shape[0], self.cfg.capacity.raw_points)
        if scan.shape[0] > self.cfg.capacity.raw_points:
            self.raw_truncation_count += 1
            self.metrics_writer.emit({
                "event": "raw_scan_truncated",
                "frame": len(self.odometry_poses) + len(self._pending),
                "scan_points": int(scan.shape[0]),
                "capacity": int(self.cfg.capacity.raw_points),
            })
        b = 8192
        while b < n:
            b *= 2
        b = min(b, self.cfg.capacity.raw_points)
        out = np.full((b, 3), PAD_VALUE, dtype=np.float32)
        out[:n] = scan[:n]
        return out

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _process_fused(self, scan: np.ndarray, stamp: Optional[float]) -> dict:
        t0 = time.perf_counter()
        frame_idx = len(self.odometry_poses) + len(self._pending)
        raw_pts = self._upload(self._pad_bucket(np.asarray(scan, dtype=np.float32)))
        # Gyro-integrated rotation since the previously DISPATCHED frame.
        imu_R = integrate_gyro(self._imu_queue, self._last_dispatch_stamp, stamp)
        self._last_dispatch_stamp = stamp
        use_imu = imu_R is not None and frame_idx > 0
        # Per-frame extrinsic: provider (TF-lookup analog) -> static config -> identity.
        T_ext = None
        if self.extrinsic_provider is not None:
            T_ext = self.extrinsic_provider(stamp)
        if T_ext is None:
            T_ext = self._static_ext
        self._state, out = self._step(
            self._state, raw_pts, self._target,
            torch.as_tensor(imu_R, dtype=torch.float32, device=self.device) if use_imu else self._eye3,
            use_imu,
            self._eye4 if T_ext is None else torch.as_tensor(
                np.asarray(T_ext, np.float32), device=self.device),
            T_ext is not None,
        )
        host = _HostCopy({"scalars": _pack_scalars(out), "kf_cloud": out.kf_cloud,
                          "kf_mask": out.kf_mask})
        t1 = time.perf_counter()
        self.timings["prefilter"].append(t1 - t0)  # host pad + upload + step
        self._pending.append((frame_idx, t0, stamp, out, host))
        if frame_idx == 0:
            # Bootstrap frame: consume immediately so keyframe 0 lands in the ring and the
            # target is real before frame 1 dispatches.
            return self._consume_fused(self._pending.popleft())
        # Lagged readback: keep `pipeline_depth` frames in flight.
        if len(self._pending) > max(1, self.cfg.pipeline_depth):
            return self._consume_fused(self._pending.popleft())
        return dict(self._last_out) if self._last_out else {
            "pose": np.eye(4, dtype=np.float32), "is_keyframe": False,
            "converged": True, "fitness": 0.0, "iterations": 0,
        }

    def flush(self) -> None:
        """Drain in-flight frames (fused driver) and settle the concurrent back end (join
        any solve thread, consume a pending verification)."""
        while self.fused and self._pending:
            self._consume_fused(self._pending.popleft())
        if self.cfg.enable_loop_closure:
            self.back.finish_async()
            self._emit_loop_attempts(len(self.odometry_poses))

    # -- classic driver -----------------------------------------------------------------

    def _process_classic(self, scan: np.ndarray, stamp: Optional[float]) -> dict:
        t0 = time.perf_counter()
        raw = PointCloud.from_array(scan, capacity=self.cfg.capacity.raw_points,
                                    device=self.device)
        filtered = self.prefilter(raw.points, raw.mask)
        if self.device.type == "cuda":  # the stage's time includes its device work
            torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()

        out = self.front.process(filtered, stamp=stamp)
        t2 = time.perf_counter()

        # Hand new keyframes to the back end.
        while self._kf_consumed < len(self.front.keyframe_log):
            kf = self.front.keyframe_log[self._kf_consumed]
            self.back.add_keyframe(kf)
            self.kf_frame_indices.append(kf["frame_index"])
            self._kf_consumed += 1
        if self.cfg.enable_loop_closure:
            self.back.on_frame()
        self._emit_loop_attempts(len(self.odometry_poses))
        t3 = time.perf_counter()

        self.timings["prefilter"].append(t1 - t0)
        self.timings["register"].append(t2 - t1)
        self.timings["backend"].append(t3 - t2)
        self.odometry_poses.append(out["pose"])
        self.metrics_writer.emit({
            "frame": len(self.odometry_poses) - 1,
            "converged": out["converged"],
            "fitness": out["fitness"],
            "iterations": out["iterations"],
            "is_keyframe": out["is_keyframe"],
            "n_keyframes": self.front.n_keyframes,
            "loops_accepted": self._loops_accepted(),
            "prefilter_ms": 1000 * (t1 - t0),
            "register_ms": 1000 * (t2 - t1),
            "backend_ms": 1000 * (t3 - t2),
        })
        return out

    # -- public API ---------------------------------------------------------------------

    def add_imu(self, stamp: float, angular_velocity, linear_acceleration=None) -> None:
        """Queue an IMU sample; only the gyro is used (rotation prediction). The classic
        driver hands it to `ScanMatcher`; the fused one integrates it on the host between
        dispatched frames."""
        if not self.fused:
            self.front.add_imu(stamp, angular_velocity, linear_acceleration)
            return
        self._imu_queue.append((float(stamp), np.asarray(angular_velocity, dtype=np.float64)))
        if len(self._imu_queue) > 2000:
            self._imu_queue = self._imu_queue[-1000:]

    def process_scan(self, scan: np.ndarray, stamp: Optional[float] = None) -> dict:
        """Feed one raw sensor-frame scan [n, 3]. With the fused driver the returned dict
        describes the PREVIOUS frame (one frame of readback lag); call flush() to drain."""
        if not self.fused:
            return self._process_classic(scan, stamp)
        return self._process_fused(scan, stamp)

    def run(self, scans: Iterable, progress_every: int = 0) -> PipelineResult:
        for i, item in enumerate(scans):
            scan = item[0] if isinstance(item, tuple) else item
            self.process_scan(np.asarray(scan))
            if progress_every and (i + 1) % progress_every == 0:
                print(f"[slam-torch] frame {i + 1}, keyframes={self.back.n_keyframes}, "
                      f"loops={self._loops_accepted()}")
        return self.result()

    def result(self) -> PipelineResult:
        self.flush()
        metrics = {
            name: {
                "mean_ms": 1000 * float(np.mean(ts)) if ts else 0.0,
                "p50_ms": 1000 * float(np.median(ts)) if ts else 0.0,
                "max_ms": 1000 * float(np.max(ts)) if ts else 0.0,
            }
            for name, ts in self.timings.items()
        }
        return PipelineResult(
            odometry_poses=(np.stack(self.odometry_poses) if self.odometry_poses
                            else np.zeros((0, 4, 4))),
            keyframe_poses=self.back.optimized_poses(),
            keyframe_frame_indices=np.asarray(self.kf_frame_indices, dtype=np.int64),
            num_loop_closures=self._loops_accepted(),
            loop_log=self.back.loop_log,
            metrics=metrics,
        )

    def save_map(self, path: str, resolution: float = 0.0) -> bool:
        self.flush()
        return self.back.save_map(path, resolution)
