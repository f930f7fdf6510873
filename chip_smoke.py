"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Drives `lidar_graph_slam_tpu_torch` through its entry points at the default capacities
(131,072 raw points, 32,768 filtered, a 20-keyframe ring = 655,360 map points, two
16 MB dense voxel tables per target) on the HDL-64-class dense course of
`bench.py:bench_e2e_dense` (~70-90k points per frame), loop closure off. Phases:

  1. refuse without CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernel from `lidar_graph_slam_tpu_torch/csrc/` (nvcc), print seconds;
  3. the kernel against its plain PyTorch version on the card at the main path's shapes
     (K = 229,376 fine, 57,344 coarse), on random inputs and on correspondences from a
     real map; bit-identical reruns; median time of 50 calls each;
  4. `build_ndt_pyramid` twice on a full 20 x 32,768 ring: bit-identical maps;
  5. the first 3 frames through the card and through the CPU plain path: poses agree to
     1 cm / 1 mrad;
  6. `SlamPipeline` on the 40-frame course: all frames converge, keyframe ATE within
     max(0.05 x travelled, 0.35) m, the kernel launched on the main path; p50 frame ms;
  7. the CLI in a subprocess on the synthetic course (60 frames, --no-loop-closure).

Every phase prints one line of its numbers; a failure raises (exit code != 0, no
result). The line before the last is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. Needs one card; runs in a checkout of the repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence, make_world, simulate_scan
from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import ring_insert
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.voxel import NdtVoxelMap, lookup_direct7
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from lidar_graph_slam_tpu_torch.registration.ndt import magnusson_constants
from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
# Kernel vs plain: max |kernel - plain| <= REL * max|plain| + ABS, per output. Both sum
# ~1e5 float32 terms in different orders (measured: ~1e-7 of the scale).
REL, ABS = 1e-5, 2e-3
POSE_TRANS_M, POSE_ROT_RAD = 0.01, 1e-3


def say(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def loops_off_config(overrides=()) -> PipelineConfig:
    return apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *overrides])


def dense_course(n_frames: int, max_points: int = 131072):
    """The HDL-64-class urban-canyon course of `bench.py:bench_e2e_dense`, seed 2.
    Returns (scans, ground-truth poses relative to the first)."""
    rng = np.random.default_rng(2)
    world = make_world(rng, extent=60.0, density=60.0, wall_height=12.0,
                       box_height=(6.0, 25.0), n_boxes=60)
    seq = SyntheticSequence(n_frames=n_frames, seed=2, radius=35.0, laps=0.25,
                            max_points=max_points, n_azimuth=2048, n_elevation=64)
    scans = [simulate_scan(world, seq.poses[i], rng, max_points=max_points,
                           n_azimuth=2048, n_elevation=64) for i in range(n_frames)]
    T0_inv = np.linalg.inv(seq.poses[0])
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])
    return scans, gt


def median_ms(fn, *args, calls: int = 50, warmup: int = 5) -> float:
    """Median of `calls` single-call times, each between CUDA events after a sync."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare_kernel(label: str, args, d2, w_scale) -> float:
    """Kernel vs plain on the same card tensors, plus a bit-identical rerun; returns the
    max abs error."""
    out = kernels.ndt_accumulate(*args, d2, w_scale)
    again = kernels.ndt_accumulate(*args, d2, w_scale)
    ref = kernels.ndt_accumulate_plain(*args, d2, w_scale)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b, c in zip(("H", "g", "sum_w", "n_hit"), out, again, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs between two launches")
        e = float((a - c).abs().max())
        bound = 0.0 if name == "n_hit" else REL * float(c.abs().max()) + ABS
        if not e <= bound:
            raise AssertionError(f"{label}: {name} max err {e} > {bound}")
        err = max(err, e)
    say("kernel-check", case=label, K=args[0].shape[0], max_abs_err=err,
        H_scale=float(ref[0].abs().max()), bit_identical=True)
    return err


def random_inputs(K: int, dev, seed: int):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(K, 3)).astype(np.float32)
    A = rng.normal(size=(K, 3, 3)).astype(np.float32)
    icovs = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3, dtype=np.float32)
    p = (rng.normal(size=(K, 3)) * 5.0).astype(np.float32)
    hit = rng.random(K) > 0.3
    return [torch.as_tensor(x, device=dev) for x in (e, icovs, p, hit)]


def full_ring(cfg: PipelineConfig, scans, gt, dev):
    """A full submap ring: the first `window` scans, prefiltered on `dev`, at their
    ground-truth poses. Returns (aux, ring, last filtered cloud)."""
    cap = cfg.capacity
    prefilter = make_prefilter(cfg.prefilter, cap.filtered_points,
                               min(cap.raw_points, 2 * cap.filtered_points))
    _, _, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter, cap, device=dev)
    ring = aux["init_ring"]()
    for i in range(aux["window"]):
        raw = np.full((cap.raw_points, 3), PAD_VALUE, np.float32)
        s = scans[i][: cap.raw_points]
        raw[: len(s)] = s
        raw_t = torch.as_tensor(raw, device=dev)
        cloud = prefilter(raw_t, raw_t[:, 0] < 0.5 * PAD_VALUE)
        ring_insert(ring, i, cloud.points, cloud.mask, torch.as_tensor(gt[i], device=dev))
    return aux, ring, cloud


def map_correspondences(vmap: NdtVoxelMap, points, mask, stride: int):
    """The (e, icovs, p, hit) rows one NDT iteration hands the kernel."""
    src, msk = points[::stride], mask[::stride]
    means, icovs, hit = lookup_direct7(vmap, src)
    n = src.shape[0]
    K = n * 7
    e = (src[:, None, :] - means).reshape(K, 3)
    p = src[:, None, :].expand(n, 7, 3).reshape(K, 3).contiguous()
    return [e, icovs.reshape(K, 3, 3).contiguous(), p, (hit & msk[:, None]).reshape(K)]


def map_build_twice(aux, ring, dev) -> dict:
    """Rebuild the target from the same ring twice; the maps must be bit-identical."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    first = aux["rebuild"](ring)
    sync()
    build_ms = 1000 * (time.perf_counter() - t0)
    second = aux["rebuild"](ring)
    sync()
    for a, b in zip(first, second):
        for name in NdtVoxelMap.__dataclass_fields__:
            if not torch.equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"build_ndt_pyramid not bit-identical: {name}")
    return dict(ring_points=int(ring.masks.sum()), ring_capacity=ring.masks.numel(),
                fine_voxels=int(first[1].num_voxels), coarse_voxels=int(first[0].num_voxels),
                rebuild_ms=round(build_ms, 3), bit_identical=True)


def rotation_angle(A: np.ndarray, B: np.ndarray) -> float:
    """Angle [rad] between two poses' rotations, from the chordal distance
    ||Ra - Rb||_F = 2 sqrt(2) sin(theta / 2): exact 0 for equal float32 matrices, where the
    arccos-of-trace form reads ~5e-4 rad of rounding noise."""
    chord = np.linalg.norm(A[:3, :3].astype(np.float64) - B[:3, :3].astype(np.float64))
    return float(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)))


def first_frames_agree(cfg: PipelineConfig, scans, devices, n: int = 3) -> dict:
    """The first `n` frames through two devices; poses must agree to 1 cm / 1 mrad."""
    poses = {}
    for device in devices:
        t0 = time.perf_counter()
        pipe = SlamPipeline(cfg, device=device)
        for s in scans[:n]:
            pipe.process_scan(s)
        poses[device] = pipe.result().odometry_poses
        say("card-vs-cpu", device=device, seconds=round(time.perf_counter() - t0, 3))
    a, b = (poses[d] for d in devices)
    dt = float(np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max())
    dr = max(rotation_angle(x, y) for x, y in zip(a, b))
    if not (dt < POSE_TRANS_M and dr < POSE_ROT_RAD):
        raise AssertionError(f"poses differ between {devices}: {dt} m, {dr} rad")
    return dict(frames=n, max_trans_m=dt, max_rot_rad=dr)


def run_pipeline(cfg: PipelineConfig, scans, gt, device) -> dict:
    """The main path: every scan through `SlamPipeline`; all frames must converge and the
    keyframe ATE stay within max(0.05 x travelled, 0.35) m."""
    pipe = SlamPipeline(cfg, device=device)
    walls = []
    for s in scans:
        a = time.perf_counter()
        pipe.process_scan(s)
        walls.append(time.perf_counter() - a)
    res = pipe.result()
    frames = [r for r in pipe.metrics_writer.records if "frame" in r and "event" not in r]
    if len(frames) != len(scans) or not all(r["converged"] for r in frames):
        raise AssertionError(f"not all frames converged: {[r['converged'] for r in frames]}")
    kf = res.keyframe_frame_indices
    ate = ate_rmse(res.keyframe_poses, gt[kf], align=False)
    travelled = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    bound = max(0.05 * travelled, 0.35)
    if not (np.isfinite(res.odometry_poses).all() and ate < bound):
        raise AssertionError(f"keyframe ATE {ate} m >= {bound} m")
    p50 = 1000 * float(np.median(walls[1:]))
    return dict(frames=len(scans), keyframes=len(kf), ate_keyframes_m=ate, ate_bound_m=bound,
                travelled_m=travelled, p50_frame_ms=p50, fps=1000.0 / p50,
                mean_raw_points=int(np.mean([len(s) for s in scans])),
                iterations_mean=float(np.mean([r["iterations"] for r in frames])))


def run_cli(out_dir: str, frames: int, extra=()) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lidar_graph_slam_tpu_torch.pipeline.cli", "--dataset",
         "synthetic", "--frames", str(frames), "--no-loop-closure", "--output", out_dir,
         "--progress-every", "0", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        summary = json.load(f)
    if summary["frames"] != frames:
        raise AssertionError(f"CLI summary: {summary}")
    return dict(seconds=round(time.perf_counter() - t0, 3), frames=summary["frames"],
                keyframes=summary["keyframes"], device=summary["device"],
                ate_odometry_m=summary["ate_odometry_m"],
                ate_keyframes_m=summary["ate_keyframes_m"])


def main() -> int:
    # -- 1. the card ------------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs a CUDA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("card", name=json.dumps(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build -----------------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load_library()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(kernels.build_info["seconds"], 3), library=kernels.build_info["path"])
    for line in kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. kernel vs plain at the main path's shapes ------------------------------------
    cfg = loops_off_config()
    ndt_cfg = cfg.scan_matcher.ndt
    t0 = time.perf_counter()
    scans, gt = dense_course(40)
    say("course", frames=len(scans), seconds=round(time.perf_counter() - t0, 3))
    fine_K = cfg.capacity.filtered_points * 7
    coarse_K = (cfg.capacity.filtered_points // ndt_cfg.coarse_subsample) * 7
    d2, w_scale = torch.tensor(0.25, device=dev), torch.tensor(1.05, device=dev)
    max_err, timing = 0.0, {}
    for K, seed in ((fine_K, 0), (coarse_K, 1)):
        args = random_inputs(K, dev, seed)
        max_err = max(max_err, compare_kernel(f"random-K{K}", args, d2, w_scale))
        timing[K] = (median_ms(kernels.ndt_accumulate, *args, d2, w_scale),
                     median_ms(kernels.ndt_accumulate_plain, *args, d2, w_scale))
        say("kernel-time", K=K, kernel_ms=timing[K][0], plain_ms=timing[K][1], calls=50,
            card=json.dumps(card))
    aux, ring, last = full_ring(cfg, scans, gt, dev)
    coarse, fine = aux["rebuild"](ring)
    # The last ring scan in the map frame, as the NDT iterations see it at convergence.
    T = torch.as_tensor(gt[aux["window"] - 1], device=dev)
    pts = torch.where(last.mask[:, None], last.points @ T[:3, :3].T + T[:3, 3], last.points)
    for label, vmap, stride in (("map-fine", fine, 1),
                                ("map-coarse", coarse, ndt_cfg.coarse_subsample)):
        md1, md2 = magnusson_constants(vmap.leaf, ndt_cfg.outlier_ratio)
        args = map_correspondences(vmap, pts, last.mask, stride)
        max_err = max(max_err, compare_kernel(f"{label}-K{args[0].shape[0]}", args, md2,
                                              -md1 * md2))

    # -- 4. deterministic map build on the full ring -------------------------------------
    say("map-build", **map_build_twice(aux, ring, dev))

    # -- 5. card vs the CPU plain path, first 3 frames -----------------------------------
    say("card-vs-cpu", **first_frames_agree(cfg, scans, ("cuda", "cpu")))

    # -- 6. the main path on the card; the kernel's launches are counted here only --------
    kernels.ndt_accumulate.launches = 0
    stats = run_pipeline(cfg, scans, gt, "cuda")
    torch.cuda.synchronize()
    launches = kernels.ndt_accumulate.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the ndt_accumulate kernel")
    say("pipeline", **stats, kernel_launches=launches, card=json.dumps(card))

    # -- 7. the CLI ------------------------------------------------------------------------
    cli = run_cli(os.path.join(OUT_DIR, "cli"), 60)
    if cli["device"] != "cuda":
        raise AssertionError(f"CLI ran on {cli['device']}")
    say("cli", **cli)

    print(json.dumps({"kernels": [{
        "name": "ndt_accumulate",
        "route": "cuda",
        "source": "lidar_graph_slam_tpu_torch/csrc/ndt_accumulate.cu",
        "replaces": "lidar_graph_slam_tpu/ops/pallas_kernels.py:160",
        "replaces_commit": "4350000^",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[fine_K][0],
        "plain_ms": timing[fine_K][1],
        "K": fine_K,
        "ms_coarse": timing[coarse_K][0],
        "plain_ms_coarse": timing[coarse_K][1],
        "K_coarse": coarse_K,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
