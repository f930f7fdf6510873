"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Drives `lidar_graph_slam_tpu_torch` through its entry points at the default capacities
(131,072 raw points, 32,768 filtered, a 20-keyframe ring = 655,360 map points, two
16 MB dense voxel tables per target): the front end on the HDL-64-class dense course of
`bench.py:bench_e2e_dense` (~70-90k points per frame) with loop closure off, then the
default pipeline (loop closure on, asynchronous back end) on the three-lap drift course
of `bench.py:bench_e2e`. Phases:

  1. refuse without CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `lidar_graph_slam_tpu_torch/csrc/` (nvcc), print seconds
     and ptxas's registers per kernel;
  3. both kernels against their plain PyTorch versions on the card at the main path's
     shapes: `ndt_accumulate` on random rows (K = 229,376 fine, 57,344 coarse) and on a
     real map's correspondences, `ndt_direct7_accumulate` on the same map and source (N =
     32,768 against the 2 m map, 8,192 against the 4 m map); counts exact, bit-identical
     reruns; per kernel and shape, device and host time per call (`split_times`), the
     plain version's time, the bound and the share of the bound;
  4. `build_ndt_pyramid` twice on a full 20 x 32,768 ring: bit-identical maps;
  5. the first 3 frames through the card and through the CPU plain path: poses agree to
     1 cm / 1 mrad;
  6. `SlamPipeline` on the 40-frame course: all frames converge, keyframe ATE within
     max(0.05 x travelled, 0.35) m, the fused kernel launched on the main path and the
     gathered-rows one not; p50 frame ms;
  7. one fine-stage `ndt_align` under torch.profiler (`scripts/torch_profile_ndt.py`):
     device kernel launches, device ms and wall ms per NDT body; with `--parent DIR` (the
     parent commit unpacked by `git archive`) also that tree's, on the same input;
  8. `ndt_accumulate`'s own path, `ndt_align(line_search=True)`: one launch per body;
  9. the CLI in a subprocess on the synthetic course (60 frames, --no-loop-closure);
 10. the loop course: `SlamPipeline` with the default config on the 360-frame drift
     course, then again with loops off — all frames converge, loops are accepted, and
     keyframe ATE with loops on is below ATE with loops off; the fused kernel's launches
     on the verify path are counted;
 11. grid NN, card against CPU: `build_hash_grid` + `nearest` on a loop submap of that
     course at the verifier's shapes (2 m cells, 7 cells, bucket 16);
 12. one verification, card against CPU, from the same keyframes: the same decision, and
     its coarse NDT pre-align alone: the same iteration count and transform; both kernels
     against their plain versions on the pre-align's own inputs (16,384 points, K =
     114,688, against the 4 m map, at the identity guess and at the pre-align's result),
     and their times at that shape;
 13. the CLI with its default (loops on), 100 frames;
 14. `ndt_accumulate` on GICP's own rows: the front end's (a GICP target of phase 3's
     full ring, the last ring scan at its ground-truth pose, N = K = 32,768) and the
     verifier's (a GICP target of a loop submap of phase 10, its 16,384-point keyframe at
     the coarse pre-align's result), each with unmatched rows whose residuals are
     padding-sized (~1e6); held against the plain version (REL/ABS, hit counts exact,
     bit-identical reruns), with device and host time, the bound and its share;
 15. the GICP front end (fused driver, loops off) on the 40-frame dense course: the
     first 3 frames card against CPU (1 cm / 1 mrad), then the whole course —
     `ndt_accumulate` launched on this path, `ndt_direct7_accumulate` not; phase 6's
     assertions; keyframe ATE, p50 frame;
 16. the classic stage-by-stage driver (`fused_frontend=False`) on the same course: NDT,
     then ICP, each with phase 6's assertions; each stage's p50 for both;
 17. the GICP loop verifier: the default pipeline with
     `graph_slam.registration_method=GICP` on the drift course — loops accepted, keyframe
     ATE below phase 10's loops-off ATE, `ndt_accumulate` launched by the verify thread
     (the odometry launches only the fused kernel); verify p50;
 18. the CLI with `--set fused_frontend=false --set scan_matcher.registration_method=GICP`,
     60 frames: it runs on the card, with that driver and matcher.

Each path's launches are counted from 0 just before it runs and read just after.
Every phase prints one line of its numbers; a failure raises (exit code != 0, no
result). The line before the last is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. Needs one card; runs in a checkout of the repo.
`python3 chip_smoke.py --parent DIR` adds the parent tree's profile to phase 7.

CPU rehearsal: import this module and call the phase functions with device "cpu" at a
small config, e.g. `run_pipeline(loops_off_config([...]), *dense_course(40,
max_points=12000), "cpu")`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, PointCloud
from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu_torch.graph.slam import (
    PRE_ALIGN_OUTLIER_RATIO,
    GraphBasedSLAM,
    loop_pre_align,
)
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence, make_world, simulate_scan
from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import assemble_submap, ring_insert
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid, nearest
from lidar_graph_slam_tpu_torch.ops.voxel import (
    DIRECT7_OFFSETS,
    TABLE_DIMS,
    NdtVoxelMap,
    lookup_direct7,
    voxel_coords,
    voxel_downsample,
)
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from lidar_graph_slam_tpu_torch.registration import gicp
from lidar_graph_slam_tpu_torch.registration.ndt import magnusson_constants, ndt_align
from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
# Kernel vs plain: max |kernel - plain| <= REL * max|plain| + ABS, per output. Both sum
# ~1e5 float32 terms in different orders (measured: ~1e-7 of the scale). Hit and centre
# counts exact.
REL, ABS = 1e-5, 2e-3
DIRECT7_OUT = ("H", "g", "sum_w", "n_hit", "centre_d2", "centre_count")
KERNELS = ("ndt_direct7_accumulate", "ndt_accumulate")
POSE_TRANS_M, POSE_ROT_RAD = 0.01, 1e-3
# Grid NN, card vs CPU: idx and found equal, d2 to this relative tolerance.
NN_RTOL = 1e-6
# One verification, card vs CPU on the same inputs: the same decision, fitness to rtol
# 1e-3 and the transform to atol 1e-3 (entries of the 4x4: ~1 mm, ~1 mrad). Up to ~120
# float32 NDT and ICP iterations, whose reductions sum in different orders.
VERIFY_FIT_RTOL, VERIFY_T_ATOL = 1e-3, 1e-3


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
    """Median of `calls` single-call times, each between CUDA events after a sync. The
    device idles while the host runs the call, so this is host time plus device time."""
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


def split_times(fn, *args, calls: int = 200, warmup: int = 10) -> dict:
    """Time per call of `fn` on fixed inputs, split into device and host time:
      device_us  one CUDA event pair around `calls` back-to-back calls, / calls. A spin
                 kernel (`torch.cuda._sleep`) holds the stream while the host enqueues
                 them, so the device runs them back to back and the pair reads device
                 time, not the host's enqueue (the spin is lengthened until it outlasts
                 the enqueue);
      host_us    the host clock around the same enqueue (no synchronize inside), / calls;
      single_ms  the median of 50 single calls between events (`median_ms`).
    No profiler runs here: a profiler session in the process that later drives the
    main path may change its host timings."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    spin_cycles = 20_000_000
    for _ in range(6):
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(spin_cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if held.elapsed_time(start) > 1000 * host_s:  # the spin outlasted the enqueue
            return dict(device_us=1000 * start.elapsed_time(end) / calls,
                        host_us=1e6 * host_s / calls, single_ms=median_ms(fn, *args))
        spin_cycles *= 4
    raise RuntimeError("split_times: the spin kernel never outlasted the host's enqueue")


# The card's peak rates for a bound (H100 SXM at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Float operations per hit correspondence in the accumulation that the 21 upper-triangle
# entries of H need, an FMA counted as two: W e (15), e^T W e (5), the weight (3: the
# scale by -d2/2, exp as one, w_scale), the 8 entries of W A that H_ww's upper triangle
# reads (24), H_ww's 6 upper entries (18), H_wv's 9 (27), the 21 weighted sums of H (42),
# g (21), sum_w and n_hit (2). The fused form adds e = p - mean (3).
ACCUM_FLOPS_PER_HIT = 157
RESIDUAL_FLOPS_PER_HIT = 3
# Per masked-in point, the fused form's cell arithmetic floor((p - origin) * inv_leaf):
# 3 subtractions and 3 products (the neighbour offsets are integer adds). Per centre
# hit, |e|^2 (5) and its sum and count (2).
CELL_FLOPS_PER_POINT = 6
CENTRE_FLOPS_PER_HIT = 7


def accumulate_bound_us(hit: torch.Tensor) -> dict:
    """The least time for `ndt_accumulate` on these inputs: it must read every hit flag
    (1 B) and, for each hit row only, e, W and p (60 B), and write 44 floats; and it does
    ACCUM_FLOPS_PER_HIT per hit row. Returns bound_us, bytes, flops and bound_by."""
    n_hit = int(hit.sum())
    nbytes = hit.numel() + 60 * n_hit + 4 * 44
    flops = ACCUM_FLOPS_PER_HIT * n_hit
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return dict(bound_us=1e6 * max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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


def compare_direct7(label: str, vmap: NdtVoxelMap, p, mask, d2, w_scale) -> float:
    """The fused kernel vs its plain version on the same card tensors, plus a
    bit-identical rerun; returns the max abs error."""
    out = kernels.ndt_direct7_accumulate(vmap, p, mask, d2, w_scale)
    again = kernels.ndt_direct7_accumulate(vmap, p, mask, d2, w_scale)
    ref = kernels.ndt_direct7_accumulate_plain(vmap, p, mask, d2, w_scale)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b, c in zip(DIRECT7_OUT, out, again, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs between two launches")
        e = float((a - c).abs().max())
        exact = name in ("n_hit", "centre_count")
        bound = 0.0 if exact else REL * float(c.abs().max()) + ABS
        if not e <= bound:
            raise AssertionError(f"{label}: {name} max err {e} > {bound}")
        err = max(err, e)
    say("direct7-check", case=label, N=p.shape[0], n_hit=int(ref[3]),
        centre_count=int(ref[5]), max_abs_err=err, H_scale=float(ref[0].abs().max()),
        bit_identical=True)
    return err


def direct7_bound_us(vmap: NdtVoxelMap, p, mask, n_hit: float, n_centre: float) -> dict:
    """The least time for `ndt_direct7_accumulate` on these inputs, counted on the card
    from this run's data. Bytes: the mask (1 B a point), each masked-in point (12 B), each
    distinct table cell its in-range neighbours read (4 B), each distinct row those cells
    name (52 B of mean, inv_cov and valid for a valid voxel, the 4 B flag for another),
    the scalars (24 B) and the 46 output floats. Operations: CELL_FLOPS_PER_POINT a
    masked-in point, ACCUM_FLOPS_PER_HIT + RESIDUAL_FLOPS_PER_HIT a hit,
    CENTRE_FLOPS_PER_HIT a centre hit."""
    src = p[mask]
    offsets = torch.tensor(DIRECT7_OFFSETS, dtype=torch.int32, device=p.device)
    nc = voxel_coords(src, vmap.origin, vmap.inv_leaf)[:, None, :] + offsets
    in_range = ((nc >= 0) & (nc < torch.tensor(TABLE_DIMS, device=p.device))).all(-1)
    _, dy, dz = TABLE_DIMS
    cells = torch.unique(((nc[..., 0] * dy + nc[..., 1]) * dz + nc[..., 2])[in_range])
    rows = torch.unique(vmap.table[cells.long()])
    rows = rows[rows >= 0].long()
    n_valid = int((vmap.packed[rows, 12] > 0.5).sum())
    nbytes = (p.shape[0] + 12 * src.shape[0] + 4 * cells.numel() + 52 * n_valid
              + 4 * (rows.numel() - n_valid) + 24 + 4 * 46)
    flops = (CELL_FLOPS_PER_POINT * src.shape[0]
             + (ACCUM_FLOPS_PER_HIT + RESIDUAL_FLOPS_PER_HIT) * n_hit
             + CENTRE_FLOPS_PER_HIT * n_centre)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return dict(bound_us=1e6 * max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                table_cells=cells.numel(), rows=rows.numel(), valid_rows=n_valid)


def kernel_timings(kern, shape: str, vmap: NdtVoxelMap, src, msk, d2, w_scale,
                   rounds: int = 1) -> dict:
    """Each kernel wrapper of the module `kern` (this tree's `ops.kernels`, or another
    tree's: one without the fused kernel times only `ndt_accumulate`) on one shape of the
    path: `split_times` (the median of each number over `rounds` rounds), the plain
    version's single-call ms, the bound and the share of the bound. `src`, `msk` are the
    source the fused kernel takes; `ndt_accumulate` gets the rows it gathers. Returns
    {kernel name: record}."""
    rows = map_correspondences(vmap, src, msk, 1)
    cases = {"ndt_accumulate": (kern.ndt_accumulate, kern.ndt_accumulate_plain,
                                (*rows, d2, w_scale), accumulate_bound_us(rows[3]))}
    if hasattr(kern, "ndt_direct7_accumulate"):
        fused = kern.ndt_direct7_accumulate(vmap, src, msk, d2, w_scale)
        cases = {"ndt_direct7_accumulate": (
            kern.ndt_direct7_accumulate, kern.ndt_direct7_accumulate_plain,
            (vmap, src, msk, d2, w_scale),
            direct7_bound_us(vmap, src, msk, float(fused[3]), float(fused[5]))), **cases}
    out = {}
    for name, (fn, plain, args, bound) in cases.items():
        runs = [split_times(fn, *args) for _ in range(rounds)]
        t = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
        t.update(plain_ms=median_ms(plain, *args), **bound,
                 share_of_bound=bound["bound_us"] / t["device_us"])
        out[name] = dict(kernel=name, shape=shape, N=src.shape[0], K=rows[0].shape[0], **t)
    return out


def say_timings(timing: dict, card: str) -> dict:
    """One `kernel-time` line per record of `kernel_timings`; returns `timing`."""
    for rec in timing.values():
        say("kernel-time", **rec, card=json.dumps(card))
    return timing


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
    """A front-end path: every scan through `SlamPipeline` (either driver); all frames
    must converge and the keyframe ATE stay within max(0.05 x travelled, 0.35) m."""
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
    return dict(driver="fused" if pipe.fused else "classic", frames=len(scans),
                keyframes=len(kf),
                ate_keyframes_m=ate, ate_bound_m=bound, travelled_m=travelled,
                p50_frame_ms=p50, fps=1000.0 / p50,
                mean_raw_points=int(np.mean([len(s) for s in scans])),
                iterations_mean=float(np.mean([r["iterations"] for r in frames])),
                stage_p50_ms={k: round(v["p50_ms"], 3) for k, v in res.metrics.items()})


def drift_course(n_frames: int = 360, max_points: int = 131072):
    """The three-lap drift course of `bench.py:bench_e2e`, seed 1: a sparse world (~9k
    points per frame) at ~1.9 m per frame, where NDT odometry drifts and loop closure
    has work to do. Returns (scans, ground-truth poses relative to the first)."""
    seq = SyntheticSequence(n_frames=n_frames, seed=1, extent=60.0, radius=35.0,
                            max_points=max_points, noise=0.02, laps=3.05,
                            n_azimuth=2048, n_elevation=64)
    scans = [scan for scan, _ in seq]
    T0_inv = np.linalg.inv(seq.poses[0])
    return scans, np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])


def run_loop_course(cfg: PipelineConfig, scans, gt, device):
    """Every scan through `SlamPipeline`; all frames must converge. Returns (pipeline,
    result, numbers)."""
    pipe = SlamPipeline(cfg, device=device)
    walls = []
    for s in scans:
        a = time.perf_counter()
        pipe.process_scan(s)
        walls.append(time.perf_counter() - a)
    res = pipe.result()
    frames = [r for r in pipe.metrics_writer.records if "frame" in r and "event" not in r]
    if len(frames) != len(scans) or not all(r["converged"] for r in frames):
        raise AssertionError(f"loop course: {sum(not r['converged'] for r in frames)} frames "
                             f"did not converge")
    kf = res.keyframe_frame_indices
    return pipe, res, dict(
        frames=len(scans), keyframes=len(kf),
        ate_keyframes_m=ate_rmse(res.keyframe_poses, gt[kf], align=False),
        p50_frame_ms=1000 * float(np.median(walls[1:])),
        loops_attempted=sum(r["candidate"] >= 0 for r in res.loop_log),
        loops_accepted=res.num_loop_closures,
        iterations_mean=float(np.mean([r["iterations"] for r in frames])),
        stage_p50_ms={k: round(v["p50_ms"], 3) for k, v in res.metrics.items()})


def grid_nn_card_vs_cpu(back: GraphBasedSLAM, rec: dict, devices=("cuda", "cpu")) -> dict:
    """`build_hash_grid` + `nearest` at the verifier's shapes (2 m cells, 7 cells, bucket
    16) on the loop submap of attempt `rec`, queried with its latest keyframe's cloud:
    the same filtered submap goes to both devices; idx and found must be equal."""
    cap = back.capacity
    submap = back._assemble_submap(rec["candidate"], back.cfg.search_key_frame_num,
                                   max_points=cap.loop_submap_points)
    sub = PointCloud.from_array(submap, capacity=cap.loop_submap_points)
    filt = voxel_downsample(sub.points, sub.mask, back.cfg.loop_submap_leaf,
                            capacity=cap.loop_submap_points)
    T = back._poses_host[rec["latest"]]
    src = PointCloud.from_array(back._cloud(rec["latest"]) @ T[:3, :3].T + T[:3, 3],
                                capacity=cap.keyframe_points)
    out, ms = [], []
    for device in devices:
        grid = build_hash_grid(filt.points.to(device), filt.mask.to(device), 2.0)
        q = src.points.to(device)
        out.append([t.cpu() for t in nearest(grid, q, bucket_cap=16, neighborhood=7)])
        if device == "cuda":
            ms.append(median_ms(nearest, grid, q, 16, 7, calls=20))
        else:
            t0 = time.perf_counter()
            nearest(grid, q, bucket_cap=16, neighborhood=7)
            ms.append(1000 * (time.perf_counter() - t0))
    (ci, cd, cf), (pi, pd, pf) = out
    if not (torch.equal(ci, pi) and torch.equal(cf, pf)):
        raise AssertionError(f"grid NN: idx or found differ ({int((ci != pi).sum())} idx, "
                             f"{int((cf != pf).sum())} found)")
    rel = float(((cd[cf] - pd[pf]).abs() / pd[pf].abs().clamp(min=1e-12)).max())
    if not rel <= NN_RTOL:
        raise AssertionError(f"grid NN: d2 relative error {rel} > {NN_RTOL}")
    return dict(submap_points=int(filt.mask.sum()), queries=int(src.mask.sum()),
                found=int(cf.sum()), candidates_per_query=7 * 16, d2_max_rel_err=rel,
                card_ms=ms[0], cpu_ms=round(ms[1], 3))


def pre_align_kernel_check(pre_map: NdtVoxelMap, src_p, src_m, T_pre, card: str) -> dict:
    """Both kernels against their plain versions at the verify path's own shapes: the
    pre-align's source (16,384 keyframe points; K = 114,688 correspondences) against the
    4 m map with that map's Magnusson constants, at the identity guess (its first
    iteration) and at its result (its last); `kernel_timings` on the first."""
    md1, md2 = magnusson_constants(pre_map.leaf, PRE_ALIGN_OUTLIER_RATIO)
    w_scale = -md1 * md2
    moved = torch.where(src_m[:, None], src_p @ T_pre[:3, :3].T + T_pre[:3, 3], src_p)
    first = map_correspondences(pre_map, src_p, src_m, 1)
    last = map_correspondences(pre_map, moved, src_m, 1)
    K = first[0].shape[0]
    err = {"ndt_accumulate": max(
        compare_kernel(f"verify-pre-identity-K{K}", first, md2, w_scale),
        compare_kernel(f"verify-pre-result-K{K}", last, md2, w_scale))}
    err["ndt_direct7_accumulate"] = max(
        compare_direct7(f"verify-pre-identity-N{src_p.shape[0]}", pre_map,
                        src_p.contiguous(), src_m, md2, w_scale),
        compare_direct7(f"verify-pre-result-N{src_p.shape[0]}", pre_map,
                        moved.contiguous(), src_m, md2, w_scale))
    return dict(kernel_K=K, kernel_max_abs_err=err, timing=say_timings(kernel_timings(
        kernels, "verify", pre_map, src_p.contiguous(), src_m, md2, w_scale), card))


def verify_card_vs_cpu(cfg: PipelineConfig, back: GraphBasedSLAM, rec: dict, card: str,
                       devices=("cuda", "cpu")) -> dict:
    """One `_build_verify_inputs` + verification on each device, from the keyframes the
    pipeline had at attempt `rec` (the first, so no loop factor has moved them yet).
    The coarse NDT pre-align is also run alone on each device: its iteration count must
    be equal and its transform agree to VERIFY_T_ATOL; on the card the kernels are held
    against their plain versions at the pre-align's shapes (`pre_align_kernel_check`)."""
    recs, launches, ms, pre, check = [], [], [], [], {}
    for device in devices:
        b = GraphBasedSLAM(cfg.graph_slam, cfg.capacity, device=device)
        for k in range(rec["latest"] + 1):
            cloud = back._cloud(k)
            b.add_keyframe({"pose": back.kf_front_poses[k], "cloud": cloud,
                            "cloud_mask": np.ones(cloud.shape[0], bool),
                            "accum_distance": back.kf_accum_dist[k]})
        inp = b._build_verify_inputs()
        _grid, pre_map, _extra = inp["targets"][0]
        src_p, src_m, _ = inp["source"]
        p = loop_pre_align(pre_map, src_p, src_m, torch.eye(4, device=src_p.device))
        pre.append((p.transform.cpu().numpy(), int(p.iterations)))
        if device == "cuda":
            check = pre_align_kernel_check(pre_map, src_p, src_m, p.transform, card)
        t0 = time.perf_counter()
        b._consume_verify(b.begin_loop_attempt())
        ms.append(1000 * (time.perf_counter() - t0))
        recs.append(b.loop_log[-1])
        launches.append(b.verify_launches)
    a, c = recs
    if (a["candidate"], a["accepted"], a["converged"]) != (c["candidate"], c["accepted"],
                                                          c["converged"]):
        raise AssertionError(f"verify: card {a} vs CPU {c}")
    if a["candidate"] != rec["candidate"]:
        raise AssertionError(f"verify: candidate {a['candidate']}, pipeline had {rec}")
    dfit = abs(a["fitness"] - c["fitness"])
    dT = float(np.abs(a["transform"] - c["transform"]).max())
    if not (dfit <= VERIFY_FIT_RTOL * abs(c["fitness"]) and dT <= VERIFY_T_ATOL):
        raise AssertionError(f"verify: fitness {a['fitness']} vs {c['fitness']}, "
                             f"transform max diff {dT}")
    if [n > 0 for n in launches] != [d == "cuda" for d in devices]:
        raise AssertionError(f"verify: kernel launches {launches} on {devices}")
    (pa, ia), (pc, ic) = pre
    dpre = float(np.abs(pa - pc).max())
    if not (ia == ic and dpre <= VERIFY_T_ATOL):
        raise AssertionError(f"verify pre-align: {ia} vs {ic} iterations, transform max "
                             f"diff {dpre}")
    return dict(latest=rec["latest"], candidate=a["candidate"], accepted=a["accepted"],
                fitness_card=a["fitness"], fitness_cpu=c["fitness"], transform_max_diff=dT,
                pre_iterations=ia, pre_transform_max_diff=dpre, **check,
                kernel_launches=launches[0], card_ms=round(ms[0], 3), cpu_ms=round(ms[1], 3))


def gicp_rows(target, src_p, src_m, src_covs, T: torch.Tensor, corr_dist: float):
    """The (e, M, p, matched) rows one GICP iteration at `T` hands `ndt_accumulate`
    (`registration/gicp.py:gicp_align`'s body): every source row, matched or not."""
    p = src_p @ T[:3, :3].T + T[:3, 3]
    idx, _d2, matched = gicp.match(target, p, src_m, corr_dist * corr_dist)
    e, M = gicp.residual_rows(target, idx, p, T[:3, :3], src_covs)
    return [e, M, p, matched]


def gicp_rows_check(label: str, rows, card: str):
    """`ndt_accumulate` on GICP rows (d2 = 0, w_scale = 1) against its plain version, and
    its times at that shape. The rows must include unmatched ones with padding-sized
    residuals, which the kernel has to weigh 0. Returns (max abs err, timing record)."""
    K = rows[0].shape[0]
    far = int(((rows[0].abs().amax(dim=1) > 1e5) & ~rows[3]).sum())
    if far == 0 or not bool(rows[3].any()):
        raise AssertionError(f"gicp rows {label}: {far} padding-sized unmatched rows, "
                             f"{int(rows[3].sum())} matched")
    err = compare_kernel(f"gicp-{label}-K{K}", rows, 0.0, 1.0)
    out = kernels.ndt_accumulate(*rows, 0.0, 1.0)
    if not (all(bool(torch.isfinite(t).all()) for t in out)
            and float(out[2]) == float(out[3]) == float(rows[3].sum())):
        raise AssertionError(f"gicp rows {label}: sum_w {float(out[2])}, n_hit "
                             f"{float(out[3])}, matched {int(rows[3].sum())}")
    t = split_times(kernels.ndt_accumulate, *rows, 0.0, 1.0)
    bound = accumulate_bound_us(rows[3])
    rec = dict(kernel="ndt_accumulate", shape=label, N=K, K=K, matched=int(rows[3].sum()),
               padding_rows=far, **t,
               plain_ms=median_ms(kernels.ndt_accumulate_plain, *rows, 0.0, 1.0), **bound,
               share_of_bound=bound["bound_us"] / t["device_us"])
    say("kernel-time", **rec, card=json.dumps(card))
    return err, {"ndt_accumulate": rec}


def gicp_front_rows(cfg: PipelineConfig, ring, last, T_last: np.ndarray):
    """The front end's GICP rows: the target the GICP front end builds from the full ring,
    the last ring scan (N = 32,768) at its ground-truth pose with its own covariances.
    Its last 512 rows are made padding (as a scan with fewer points has), whose residuals
    are then ~1e6."""
    g = cfg.scan_matcher.gicp
    build_target, _ = gicp.make_gicp_matcher(g)
    target = build_target(*assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride))
    pts, msk = last.points.clone(), last.mask.clone()
    pts[-512:], msk[-512:] = PAD_VALUE, False
    covs, _ = gicp.estimate_covariances(pts, msk, g.max_correspondence_distance,
                                        k=g.correspondence_randomness)
    T = torch.as_tensor(T_last, device=pts.device)
    return gicp_rows(target, pts, msk, covs, T, g.max_correspondence_distance)


def gicp_verify_rows(back: GraphBasedSLAM, rec: dict):
    """The GICP verifier's rows for attempt `rec` of a back end: its inputs built by a
    GICP back end fed the same keyframes (the candidate's GICP target, the latest
    keyframe at 16,384 points with its covariances), at the coarse pre-align's result —
    the verifier's first GICP iteration. Its last 512 rows are made padding, as in
    `gicp_front_rows` (a drift-course keyframe holds ~9k points, so most are already)."""
    cfg = dataclasses.replace(back.cfg, registration_method="GICP", async_backend=False)
    b = GraphBasedSLAM(cfg, back.capacity, device=back.device)
    for k in range(rec["latest"] + 1):
        cloud = back._cloud(k)
        b.add_keyframe({"pose": back.kf_front_poses[k], "cloud": cloud,
                        "cloud_mask": np.ones(cloud.shape[0], bool),
                        "accum_distance": back.kf_accum_dist[k]})
    inp = b._build_verify_inputs()
    _grid, pre_map, target = inp["targets"][0]
    src_p, src_m, src_covs = inp["source"]
    pre = loop_pre_align(pre_map, src_p, src_m, torch.eye(4, device=src_p.device))
    src_p, src_m = src_p.clone(), src_m.clone()
    src_p[-512:], src_m[-512:] = PAD_VALUE, False
    return gicp_rows(target, src_p, src_m, src_covs, pre.transform,
                     cfg.gicp.max_correspondence_distance)


def reset_counts() -> None:
    """Set every kernel's launch count to 0, just before a path is driven."""
    for name in KERNELS:
        getattr(kernels, name).launches = 0


def read_counts() -> dict:
    """Every kernel's launches since `reset_counts`, read just after a path ran."""
    torch.cuda.synchronize()
    return {name: getattr(kernels, name).launches for name in KERNELS}


def perturbed(T: np.ndarray) -> np.ndarray:
    """`T` moved by (0.3, -0.2, 0.05) m and 0.01 rad of yaw: an initial guess that NDT
    has a few iterations of work to correct."""
    c, s = np.cos(0.01), np.sin(0.01)
    D = np.eye(4, dtype=np.float32)
    D[:2, :2] = [[c, -s], [s, c]]
    D[:3, 3] = [0.3, -0.2, 0.05]
    return (T @ D).astype(np.float32)


def profile_ndt_align(cfg: PipelineConfig, ring, last, T_last: np.ndarray,
                      parent: str | None) -> dict:
    """One fine-stage `ndt_align` on the dense course under torch.profiler, by
    `scripts/torch_profile_ndt.py` in a subprocess: the last ring scan against the full
    ring's map from a perturbed guess. With `parent` (the parent commit unpacked by `git
    archive`) the same input goes through both trees in turns (this, parent, parent,
    this), and this tree must launch at least 40 fewer device kernels per NDT body."""
    points, mask = assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride)
    os.makedirs(os.path.join(REPO, ".chip_scratch"), exist_ok=True)
    path = os.path.join(REPO, ".chip_scratch", "ndt_profile_input.npz")
    np.savez(path, points=points.cpu().numpy(), mask=mask.cpu().numpy(),
             source=last.points.cpu().numpy(), source_mask=last.mask.cpu().numpy(),
             init=perturbed(T_last))
    out = {}
    order = [("this", REPO)] if parent is None else [
        ("this", REPO), ("parent", parent), ("parent", parent), ("this", REPO)]
    try:
        for tree, root in order:
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "scripts", "torch_profile_ndt.py"),
                 "--input", path, "--root", os.path.abspath(root)],
                cwd=os.path.abspath(root), capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"ndt profile ({tree}) failed:\n{proc.stderr[-3000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            out.setdefault(tree, []).append(rec)
            rec = {k: v for k, v in rec.items() if k not in ("root", "transform")}
            say("ndt-profile", tree=tree, **{
                k: json.dumps(v, separators=(",", ":")) if isinstance(v, (list, dict)) else v
                for k, v in rec.items()})
    finally:
        os.remove(path)
    this = out["this"][0]
    if not all(r["converged"] and r["wrapper_launches_per_body"].get(
            "ndt_direct7_accumulate") == 1.0 for r in out["this"]):
        raise AssertionError(f"ndt profile: {out['this']}")
    summary = {tree: {k: float(np.mean([r[k] for r in runs])) for k in
                      ("launches_per_body", "device_ms_per_body", "wall_ms_per_body")}
               for tree, runs in out.items()}
    if "parent" in out:
        par = out["parent"][0]
        fewer = par["launches_per_body"] - this["launches_per_body"]
        dT = float(np.abs(np.asarray(par["transform"]) - np.asarray(this["transform"])).max())
        say("ndt-profile", fewer_launches_per_body=fewer, transform_max_diff=dT,
            mean=json.dumps(summary, separators=(",", ":")))
        if not (fewer >= 40 and dT <= 1e-3):
            raise AssertionError(f"ndt profile: {fewer} fewer launches per body, transform "
                                 f"diff {dT}")
    return summary


def line_search_path(cfg: PipelineConfig, fine: NdtVoxelMap, last, T_last) -> dict:
    """`ndt_accumulate`'s own path: `ndt_align` with `line_search` (it keeps the gathered
    rows for the step search) on the dense course's fine map, counts set to 0 just before
    and read just after: one launch of it per NDT body, none of the fused kernel."""
    ndt_cfg = cfg.scan_matcher.ndt
    init = torch.as_tensor(perturbed(T_last), device=last.points.device)
    reset_counts()
    res = ndt_align(fine, last.points, last.mask, init, step_size=ndt_cfg.step_size,
                    transform_epsilon=ndt_cfg.transform_epsilon,
                    outlier_ratio=ndt_cfg.outlier_ratio,
                    max_iterations=ndt_cfg.max_iterations, line_search=True)
    counts = read_counts()
    bodies = int(res.iterations) + 2
    if not (bool(res.converged) and counts == {"ndt_direct7_accumulate": 0,
                                                "ndt_accumulate": bodies}):
        raise AssertionError(f"line search: converged {bool(res.converged)}, {bodies} "
                             f"bodies, launches {counts}")
    err = float(np.abs(res.transform.cpu().numpy() - T_last).max())
    return dict(iterations=int(res.iterations), bodies=bodies,
                launches=counts["ndt_accumulate"], transform_vs_truth_max=err)


def run_cli(out_dir: str, frames: int, loops: bool = False, sets=()) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lidar_graph_slam_tpu_torch.pipeline.cli", "--dataset",
         "synthetic", "--frames", str(frames), "--output", out_dir, "--progress-every", "0",
         *([] if loops else ["--no-loop-closure"]), *(a for v in sets for a in ("--set", v))],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        summary = json.load(f)
    if summary["frames"] != frames:
        raise AssertionError(f"CLI summary: {summary}")
    return dict(seconds=round(time.perf_counter() - t0, 3), frames=summary["frames"],
                keyframes=summary["keyframes"], loop_closures=summary["loop_closures"],
                device=summary["device"], fused_frontend=summary["fused_frontend"],
                registration_method=summary["registration_method"],
                loop_verifier=summary["loop_verifier"],
                ate_odometry_m=summary["ate_odometry_m"],
                ate_keyframes_m=summary["ate_keyframes_m"])


def kernel_record(name: str, timing: dict, max_err: float, shape: str = "fine",
                  **launches) -> dict:
    """One kernel's entry of the JSON record: times at `shape`, its main path's (the
    others by shape), launches per path."""
    t = timing[shape][name]
    return {
        "name": name,
        "route": "cuda",
        "source": "lidar_graph_slam_tpu_torch/csrc/ndt_accumulate.cu",
        "replaces": "lidar_graph_slam_tpu/ops/pallas_kernels.py:160",
        "replaces_commit": "4350000^",
        **launches,
        "max_abs_err": max_err,
        "ms": t["device_us"] / 1000,
        "host_ms": t["host_us"] / 1000,
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_us"] / 1000,
        "bound_by": t["bound_by"],
        "library_ms": None,
        "shape": shape,
        "shapes": {s: {k: v[name][k] for k in ("device_us", "host_us", "single_ms",
                                               "plain_ms", "bound_us", "bytes",
                                               "share_of_bound")}
                   for s, v in timing.items() if name in v},
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one card.")
    ap.add_argument("--parent", default=None,
                    help="a tree of the parent commit (git archive): phase 7 profiles it too")
    args = ap.parse_args(argv)
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
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. both kernels vs their plain versions at the main path's shapes, and times -----
    cfg = loops_off_config()
    ndt_cfg = cfg.scan_matcher.ndt
    t0 = time.perf_counter()
    scans, gt = dense_course(40)
    say("course", frames=len(scans), seconds=round(time.perf_counter() - t0, 3))
    fine_K = cfg.capacity.filtered_points * 7
    coarse_K = (cfg.capacity.filtered_points // ndt_cfg.coarse_subsample) * 7
    d2, w_scale = torch.tensor(0.25, device=dev), torch.tensor(1.05, device=dev)
    max_err = dict.fromkeys(KERNELS, 0.0)
    for K, seed in ((fine_K, 0), (coarse_K, 1)):
        args_ = random_inputs(K, dev, seed)
        max_err["ndt_accumulate"] = max(max_err["ndt_accumulate"],
                                        compare_kernel(f"random-K{K}", args_, d2, w_scale))
    aux, ring, last = full_ring(cfg, scans, gt, dev)
    coarse, fine = aux["rebuild"](ring)
    # The last ring scan in the map frame, as the NDT iterations see it at convergence.
    T_last = gt[aux["window"] - 1]
    T = torch.as_tensor(T_last, device=dev)
    pts = torch.where(last.mask[:, None], last.points @ T[:3, :3].T + T[:3, 3], last.points)
    timing = {}
    for label, vmap, stride in (("fine", fine, 1),
                                ("coarse", coarse, ndt_cfg.coarse_subsample)):
        md1, md2 = magnusson_constants(vmap.leaf, ndt_cfg.outlier_ratio)
        rows = map_correspondences(vmap, pts, last.mask, stride)
        src, msk = pts[::stride].contiguous(), last.mask[::stride].contiguous()
        max_err["ndt_accumulate"] = max(max_err["ndt_accumulate"], compare_kernel(
            f"map-{label}-K{rows[0].shape[0]}", rows, md2, -md1 * md2))
        max_err["ndt_direct7_accumulate"] = max(max_err["ndt_direct7_accumulate"], compare_direct7(
            f"map-{label}-N{src.shape[0]}", vmap, src, msk, md2, -md1 * md2))
        timing[label] = say_timings(kernel_timings(kernels, label, vmap, src, msk, md2,
                                                   -md1 * md2), card)

    # -- 4. deterministic map build on the full ring -------------------------------------
    say("map-build", **map_build_twice(aux, ring, dev))

    # -- 5. card vs the CPU plain path, first 3 frames -----------------------------------
    say("card-vs-cpu", **first_frames_agree(cfg, scans, ("cuda", "cpu")))

    # -- 6. the main path on the card; launches counted here only --------------------------
    reset_counts()
    stats = run_pipeline(cfg, scans, gt, "cuda")
    launches = read_counts()
    if launches["ndt_direct7_accumulate"] <= 0 or launches["ndt_accumulate"] != 0:
        raise AssertionError(f"the main path's kernel launches: {launches}")
    say("pipeline", **stats, kernel_launches=launches["ndt_direct7_accumulate"],
        card=json.dumps(card))

    # -- 7. one ndt_align under the profiler (and the parent's, given --parent) ----------
    prof = profile_ndt_align(cfg, ring, last, T_last, args.parent)

    # -- 8. ndt_accumulate's own path: ndt_align with line search; counted here only ------
    ls = line_search_path(cfg, fine, last, T_last)
    say("line-search", **ls)

    # -- 9. the CLI ------------------------------------------------------------------------
    cli = run_cli(os.path.join(OUT_DIR, "cli"), 60)
    if cli["device"] != "cuda":
        raise AssertionError(f"CLI ran on {cli['device']}")
    say("cli", **cli)

    # -- 10. the loop course: the default pipeline (loops on); launches counted here only --
    t0 = time.perf_counter()
    dscans, dgt = drift_course()
    say("drift-course", frames=len(dscans), seconds=round(time.perf_counter() - t0, 3),
        mean_raw_points=int(np.mean([len(s) for s in dscans])))
    cfg_on = PipelineConfig()
    reset_counts()
    pipe_on, res_on, on = run_loop_course(cfg_on, dscans, dgt, "cuda")
    launches_course = read_counts()
    back = pipe_on.back
    # The verify path launches only the fused kernel (the line search is off), so the
    # verify thread's launches are all of it; ndt_accumulate must not have launched.
    launches_verify = back.verify_launches
    _, res_off, off = run_loop_course(loops_off_config(), dscans, dgt, "cuda")
    if not (on["loops_accepted"] >= 1 and launches_verify > 0
            and launches_course["ndt_accumulate"] == 0
            and on["ate_keyframes_m"] < off["ate_keyframes_m"]):
        raise AssertionError(f"loop course: loops on {on}, off {off}, launches "
                             f"{launches_course}, verify {launches_verify}")
    odom_diff = float(np.abs(res_on.odometry_poses - res_off.odometry_poses).max())
    say("loop-course", p50_frame_ms=on["p50_frame_ms"], p50_frame_ms_loops_off=off["p50_frame_ms"],
        loops_accepted=on["loops_accepted"], loops_attempted=on["loops_attempted"],
        ate_keyframes_on_m=on["ate_keyframes_m"], ate_keyframes_off_m=off["ate_keyframes_m"],
        keyframes=on["keyframes"], iterations_mean_on=on["iterations_mean"],
        iterations_mean_off=off["iterations_mean"],
        stage_p50_ms_on=json.dumps(on["stage_p50_ms"], separators=(",", ":")),
        stage_p50_ms_off=json.dumps(off["stage_p50_ms"], separators=(",", ":")),
        verify_ms_p50=1000 * float(np.median(back.verify_seconds)),
        verify_ms_max=1000 * float(np.max(back.verify_seconds)),
        solve_ms_p50=1000 * float(np.median([r["seconds"] for r in back.solve_log])),
        solve_ms_max=1000 * float(np.max([r["seconds"] for r in back.solve_log])),
        solves=len(back.solve_log), solves_device_lm=sum(r["device_lm"] for r in back.solve_log),
        ndt_launches_verify=launches_verify,
        ndt_launches_total=launches_course["ndt_direct7_accumulate"],
        odometry_on_vs_off_max_diff=odom_diff, card=json.dumps(card))

    # -- 11-12. grid NN and one verification, card against CPU ------------------------------
    first = next(r for r in back.loop_log if r["candidate"] >= 0)
    say("grid-nn", **grid_nn_card_vs_cpu(back, first))
    ver = verify_card_vs_cpu(cfg_on, back, first, card)
    timing["verify"] = ver.pop("timing")
    for name, err in ver.pop("kernel_max_abs_err").items():
        max_err[name] = max(max_err[name], err)
    say("verify", **ver)

    # -- 13. the CLI's default run: loops on ---------------------------------------------------
    cli_on = run_cli(os.path.join(OUT_DIR, "cli_loops"), 100, loops=True)
    if cli_on["device"] != "cuda":
        raise AssertionError(f"CLI ran on {cli_on['device']}")
    say("cli-loops", **cli_on)

    # -- 14. ndt_accumulate on GICP's own rows: front-end and verify shapes ----------------
    for label, rows in (("gicp_front", gicp_front_rows(cfg, ring, last, T_last)),
                        ("gicp_verify", gicp_verify_rows(back, first))):
        err, timing[label] = gicp_rows_check(label, rows, card)
        max_err["ndt_accumulate"] = max(max_err["ndt_accumulate"], err)
    del ring

    # -- 15. the GICP front end (fused driver, loops off); launches counted here only -----
    cfg_gicp = loops_off_config(["scan_matcher.registration_method=GICP"])
    say("gicp-card-vs-cpu", **first_frames_agree(cfg_gicp, scans, ("cuda", "cpu")))
    reset_counts()
    # The JAX package holds phase 6's bound with GICP and with classic ICP on this
    # course (`scripts/jax_reference_dense.py`), so phases 15-16 assert it too.
    gicp_front = run_pipeline(cfg_gicp, scans, gt, "cuda")
    launches_gicp = read_counts()
    if launches_gicp["ndt_accumulate"] <= 0 or launches_gicp["ndt_direct7_accumulate"] != 0:
        raise AssertionError(f"the GICP front end's kernel launches: {launches_gicp}")
    say("gicp-front-end", **gicp_front, kernel_launches=launches_gicp["ndt_accumulate"],
        card=json.dumps(card))

    # -- 16. the classic driver: NDT (phase 6's assertions), then ICP --------------------
    reset_counts()
    classic_ndt = run_pipeline(loops_off_config(["fused_frontend=False"]), scans, gt, "cuda")
    launches_classic = read_counts()
    classic_icp = run_pipeline(loops_off_config(["fused_frontend=False",
                                                 "scan_matcher.registration_method=ICP"]),
                               scans, gt, "cuda")
    if not (classic_ndt["driver"] == classic_icp["driver"] == "classic"
            and launches_classic["ndt_direct7_accumulate"] > 0):
        raise AssertionError(f"classic driver: {classic_ndt}, {classic_icp}, launches "
                             f"{launches_classic}")
    for name, st in (("ndt", classic_ndt), ("icp", classic_icp)):
        say("classic", method=name, **{k: json.dumps(v, separators=(",", ":"))
                                       if isinstance(v, dict) else v for k, v in st.items()},
            card=json.dumps(card))

    # -- 17. the GICP loop verifier on the drift course; launches counted here only --------
    reset_counts()
    pipe_g, res_g, gv = run_loop_course(
        apply_cli_overrides(PipelineConfig(), ["graph_slam.registration_method=GICP"]),
        dscans, dgt, "cuda")
    launches_gv = read_counts()
    # The odometry (NDT) launches only the fused kernel: every ndt_accumulate launch of
    # this run is the verify thread's.
    if not (gv["loops_accepted"] >= 1 and gv["ate_keyframes_m"] < off["ate_keyframes_m"]
            and launches_gv["ndt_accumulate"] > 0
            and pipe_g.back.verify_launches >= launches_gv["ndt_accumulate"]):
        raise AssertionError(f"GICP verifier: {gv}, loops off {off['ate_keyframes_m']}, "
                             f"launches {launches_gv}, verify {pipe_g.back.verify_launches}")
    say("gicp-verify", loops_accepted=gv["loops_accepted"],
        loops_attempted=gv["loops_attempted"], ate_keyframes_m=gv["ate_keyframes_m"],
        ate_keyframes_off_m=off["ate_keyframes_m"], ate_keyframes_icp_m=on["ate_keyframes_m"],
        p50_frame_ms=gv["p50_frame_ms"],
        stage_p50_ms=json.dumps(gv["stage_p50_ms"], separators=(",", ":")),
        verify_ms_p50=1000 * float(np.median(pipe_g.back.verify_seconds)),
        verify_ms_max=1000 * float(np.max(pipe_g.back.verify_seconds)),
        ndt_accumulate_launches_verify=launches_gv["ndt_accumulate"],
        verify_launches_all=pipe_g.back.verify_launches,
        odometry_vs_loops_off_max_diff=float(
            np.abs(res_g.odometry_poses - res_off.odometry_poses).max()),
        card=json.dumps(card))

    # -- 18. the CLI: classic driver, GICP front end --------------------------------------
    cli_g = run_cli(os.path.join(OUT_DIR, "cli_classic_gicp"), 60, loops=True,
                    sets=("fused_frontend=false", "scan_matcher.registration_method=GICP"))
    if not (cli_g["device"] == "cuda" and cli_g["fused_frontend"] is False
            and cli_g["registration_method"] == "GICP"):
        raise AssertionError(f"CLI classic GICP: {cli_g}")
    say("cli-classic-gicp", **cli_g)

    print(json.dumps({"kernels": [
        kernel_record(
            "ndt_direct7_accumulate", timing, max_err["ndt_direct7_accumulate"],
            launches=launches["ndt_direct7_accumulate"], launches_verify=launches_verify,
            launches_loop_course=launches_course["ndt_direct7_accumulate"],
            fuses="lidar_graph_slam_tpu/ops/voxel.py:447 (lookup_direct7)",
            device_launches_per_ndt_body=prof["this"]["launches_per_body"],
            parent_device_launches_per_ndt_body=(prof["parent"]["launches_per_body"]
                                                 if "parent" in prof else None)),
        kernel_record(
            "ndt_accumulate", timing, max_err["ndt_accumulate"], shape="gicp_front",
            launches=launches_gicp["ndt_accumulate"], path="GICP front end (phase 15)",
            launches_gicp_front_end=launches_gicp["ndt_accumulate"],
            launches_gicp_verify=launches_gv["ndt_accumulate"],
            launches_line_search=ls["launches"],
            launches_ndt_main_path=launches["ndt_accumulate"],
            launches_icp_loop_course=launches_course["ndt_accumulate"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
