"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Drives `lidar_graph_slam_tpu_torch` through its entry points at the default capacities
(131,072 raw points, 32,768 filtered, a 20-keyframe ring = 655,360 map points, two
16 MB dense voxel tables per target): the front end on the HDL-64-class dense course of
`bench.py:bench_e2e_dense` (~70-90k points per frame) with loop closure off, then the
default pipeline (loop closure on, asynchronous back end) on the three-lap drift course
of `bench.py:bench_e2e`. Phases:

  1. refuse without CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `lidar_graph_slam_tpu_torch/csrc/` (nvcc), print seconds
     and ptxas's registers per kernel; the SM clock and `eigh3x3`'s SASS instructions a
     matrix (`cuobjdump -sass`);
  3. both kernels against their plain PyTorch versions on the card at the main path's
     shapes: `ndt_accumulate` on random rows (K = 229,376 fine, 57,344 coarse) and on a
     real map's correspondences, `ndt_direct7_accumulate` on the same map and source (N =
     32,768 against the 2 m map, 8,192 against the 4 m map); counts exact, bit-identical
     reruns; per kernel and shape, device and host time per call (`split_times`), the
     plain version's time, the bound and the share of the bound;
 3b. ndt-loop: the NDT loop kernel `ndt_iteration` (`ndt_align_loop`: one launch an
     iteration, the step in its last block, the carry on the device) against the plain
     loop on the same card tensors — the last ring scan from a perturbed guess at the
     fine (N = 32,768, 2 m) and the coarse stage (N = 8,192, 4 m, no polish), and a fine
     loop cut at 3 iterations: T within 1e-4, the same iterations and done, inliers within
     0.1% and fitness within rtol 1e-4, bit-identical reruns; `ndt_iteration_batched` at B = 4 (four guesses, one at the true pose) row by
     row bit-equal to single loops; device us of a working and of an early-exit launch,
     host and device us of an align stage, the bound, the kernel's registers, shared
     memory and blocks; with `--parent DIR` the same times of that tree's kernel, in
     turns (this, parent, parent, this); then 5 dense frames of the fused step under
     `torch.cuda.set_sync_debug_mode("error")` (no synchronous read);
  4. the target rebuild (`build_ndt_pyramid`) on a full 20 x 32,768 ring: twice,
     bit-identical maps; `ndt_finalize` on the ring's two levels (the fine one from the
     sorted points, C = 65,536; the coarse one from the merged fine moments, 32,768)
     against `ndt_finalize_plain`, moments and rows bit for bit with reruns, and its rows
     against the parent tree's moments-plus-finalize on the same rows (`--parent`);
     `eigh3x3` against `_eigh3x3` on GICP's window covariances (the ring's 655,360
     points, the last ring scan's 32,768), bit for bit with reruns; each kernel's device
     and host us (with `--parent`, `ndt_finalize`'s in turns with the parent's
     moments-plus-finalize), the plain version's ms, `torch.linalg.eigh`'s ms on the same
     matrices (where cuSOLVER takes the batch), the bound (bytes, and issue slots: the
     summed points or rows, and `eigh3x3`'s SASS instructions a matrix, `sass_fast_path`,
     for each valid row); the wrappers' launches a rebuild; the rebuild and
     `insert_and_rebuild` under `torch.cuda.set_sync_debug_mode("error")`, both
     sync-free; `scripts/torch_profile_rebuild.py` in a subprocess: wall ms a rebuild on
     the kernel path, the plain path and, with `--parent DIR`, the parent tree's, in
     turns, and each one's device kernel launches (fewer than 216 on the kernel path),
     `segment_reduce` launches (none on the kernel path) and device ms under
     torch.profiler;
  5. the first 3 frames through the card and through the CPU plain path: poses agree to
     1 cm / 1 mrad;
  6. `SlamPipeline` on the 40-frame course: all frames converge, keyframe ATE within
     max(0.05 x travelled, 0.35) m, the NDT loop kernel launched 16 + 64 + 2 times a
     frame (and how many of those did work), the accumulate kernels not, `ndt_finalize`
     twice a target build, `eigh3x3` not; p50 frame ms;
  7. one fine-stage `ndt_align` under torch.profiler (`scripts/torch_profile_ndt.py`):
     device kernel launches, device ms and wall ms per align and per NDT body; with
     `--parent DIR` (the parent commit unpacked by `git archive`) also that tree's, on the
     same input, in turns;
  8. `ndt_accumulate`'s own path, `ndt_align(line_search=True)`: one launch per body;
  9. the CLI in a subprocess on the synthetic course (60 frames, --no-loop-closure);
 10. the loop course: `SlamPipeline` with the default config on the 360-frame drift
     course, then again with loops off — all frames converge, loops are accepted, and
     keyframe ATE with loops on is below ATE with loops off; the loop kernels' launches
     on the verify path are counted (the NDT pre-align's, `icp_iteration`'s — and how
     many of those did work — and `icp_fitness`'s); the back-end stage p50 with loops on
     and off, verify p50 and max;
 10b. `ndt_finalize` on the course's last ring (~28% of its rows valid) as in phase 4,
     and its rebuild profile;
 11. grid NN, card against CPU: `build_hash_grid` + `nearest` on a loop submap of that
     course at the verifier's shapes (2 m cells, 7 cells, bucket 16);
 12. one verification, card against CPU, from the same keyframes: the same decision, and
     its coarse NDT pre-align alone: the same iteration count and transform; both kernels
     against their plain versions on the pre-align's own inputs (16,384 points, K =
     114,688, against the 4 m map, at the identity guess and at the pre-align's result),
     and their times at that shape;
 13. the CLI with its default (loops on), 100 frames;
 14. `ndt_accumulate` on GICP's own rows (GICP no longer launches it; kept as a
     measurement): the front end's (a GICP target of phase 3's full ring, the last ring
     scan at its ground-truth pose, N = K = 32,768) and the verifier's (a GICP target of
     a loop submap of phase 10, its 16,384-point keyframe at the coarse pre-align's
     result), each with unmatched rows whose residuals are padding-sized (~1e6); held
     against the plain version (REL/ABS, hit counts exact, bit-identical reruns), with
     device and host time, the bound and its share;
 14b. gicp-loop, GICP's counterpart of 3b: the GICP loop kernel `gicp_iteration`
     (`gicp_align_loop`: one launch an iteration — the grid-NN match from a tile's
     staged cell runs, the plane-to-plane rows, the sums and the 6x6 step — the carry on
     the device) against the plain loop on the same card tensors, on phase 14's fixtures
     without padding: the front end's from a perturbed guess, cut at one iteration
     (inliers exact) and with the reciprocal test, and the verifier's from its
     pre-align's result: T within 1e-4, the same iterations and done, inliers within
     0.1%, fitness within rtol 1e-4, bit-identical reruns; what a working launch stages
     at each fixture (distinct cells, runs and candidate rows a tile, p50 and max, and
     the runs past the stage); device us of a working and of an early-exit launch, host
     and device us of an align stage, the bound, the plain version's ms, the kernel's
     registers, shared memory, blocks and warps an SM and the runs its stage holds; with
     `--parent DIR` the parent tree's kernel on both fixtures and with the reciprocal
     test: its carry bit-identical to this tree's after the whole loop and after one
     iteration, and its times in turns with this tree's; then 5 dense frames of the
     fused GICP step under `torch.cuda.set_sync_debug_mode("error")`;
 14c. icp-loop, ICP's counterpart of 3b and 14b: `icp_iteration` (`icp_align_loop`: one
     launch an iteration — the grid-NN match from a tile's staged cell runs, the sums
     about the align's anchor, the closed-form step with its 3x3 SVD and stop test in the
     last block — the carry on the device) against the plain loop on the same card
     tensors: the verifier's fixture (phase 12's loop submap grid, 2 m cells, 7 cells,
     bucket 16, its 16,384-point keyframe from the pre-align's result) and the ICP front
     end's (the full ring's grid, the last ring scan, N = 32,768, bucket 32, from a
     perturbed guess), and the latter cut at one iteration (inliers exact): T within
     1e-4, the same iterations and done, inliers within 0.1%, fitness within rtol 1e-4,
     bit-identical reruns; `icp_fitness` against its plain version in both modes (counts
     exact, score and fraction to rtol 1e-6); device us of a working and an early-exit
     launch, host and device us of an align stage, the bounds, the plain versions' ms,
     the kernels' registers, shared memory and blocks; each fixture's `icp_align` under
     torch.profiler (`scripts/torch_profile_icp.py`), with `--parent DIR` in turns with
     that tree's host loop (wall and device ms, launches, its iterations and transform);
     then one whole verification and 5 dense frames of the fused ICP step under
     `torch.cuda.set_sync_debug_mode("error")`;
 15. the GICP front end (fused driver, loops off) on the 40-frame dense course: the
     first 3 frames card against CPU (1 cm / 1 mrad), then the whole course — the GICP
     loop kernel launched 64 times a frame (and how many did work), `eigh3x3` at least
     once a frame, `ndt_accumulate`, `ndt_direct7_accumulate`, `ndt_finalize` and the NDT
     loop kernel not; phase 6's assertions; keyframe ATE, p50 frame, the `prefilter`
     stage p50 (the host's enqueue of the step);
 16. the classic stage-by-stage driver (`fused_frontend=False`) on the same course: NDT,
     then ICP, each with phase 6's assertions, ICP launching `icp_iteration`; each
     stage's p50 for both; with `--parent DIR`, phase 10's course (verify p50 and max)
     and this classic ICP run (register p50) through `scripts/torch_trajectories.py` for
     this tree and that one in turns;
 17. the GICP loop verifier: the default pipeline with
     `graph_slam.registration_method=GICP` on the drift course — loops accepted, keyframe
     ATE below phase 10's loops-off ATE, the GICP loop kernel launched by the verify
     thread (the odometry launches only the NDT loop kernel) and `ndt_accumulate` not;
     verify p50;
 18. the CLI with `--set fused_frontend=false --set scan_matcher.registration_method=GICP`,
     60 frames: it runs on the card, with that driver and matcher, launching the GICP
     loop kernel and not `ndt_accumulate`;
 19. `global_register` (FPFH + RANSAC, default `GlobalRegConfig`: 8,192 keypoints, 2,048
     hypotheses, fpfh_k 32) on an 8,192-point scan moved by 150 deg / (18, -9, 0.3) m and
     by 75 deg / (-12, 20, -0.2) m: ok, rotation error < 5 deg, translation error < 1 m, on
     the card and on the CPU; ms per call, and the time of its batched 3x3 SVDs and of its
     [Q, M] feature product alone;
 20. loop verification from the global guess: the 31-keyframe fixture with 0.4 rad /
     (4.0, -4.2) m of drift on the latest keyframe — with `use_global_init` the loop
     closes and the corrected pose lies within 0.3 m of truth, the identity guess misses
     it or reads a worse fitness; the loop kernel's launches on this path (the pre-align
     from the global guess) are counted from 0, with those that did work; the guess is
     built in the verify worker; `ransac_families` is in the log. Then the
     default pipeline with `graph_slam.use_global_init=true` on the drift course: loops
     accepted, keyframe ATE below phase 10's loops-off ATE, verify p50 beside phase 10's;
 21. checkpoint: the dense course cut at frame 20 of 40, saved, loaded onto the card and
     continued — the classic driver equals the uninterrupted run to 1e-4 with the same
     keyframe schedule, the fused driver to 5e-2 with the same schedule; file size, save
     and load ms;
 22. KITTI layout: the 40 dense frames written as velodyne .bin files with poses and
     calib, the native library built (`native.available()`, no numpy fallback), the scans
     from the read-ahead equal to `np.fromfile`'s, and the CLI in a subprocess with
     `--dataset kitti --live-render 20`: frames, keyframes, ATE from the poses file, the
     output files;
 23. `trace("frame", profile_dir=...)` around a few frames in a subprocess
     (`scripts/torch_trace_frames.py`): a trace file exists and `trace.last_ms` is set;
 24. the batched fused kernel (`ndt_direct7_accumulate_batched`) at B = 4, N = 32,768
     against four dense-course-like maps (the dense world at seeds 2-5, a full 20-frame
     ring each): against its plain version, and row b bit-equal to the single kernel on
     sequence b; device and host time beside four single launches', the bound;
 25. `parallel.multi_sequence.batch_odometry` on those four 40-frame sequences at the
     default `ScanMatcherConfig` (20 x 32,768 ring points a sequence): ATE within the
     dense bound each, keyframes, the batch equal to four runs of one bit for bit, the
     first 3 frames card against CPU to 1e-4; frames per second, launches, and the
     device's idle share (`scripts/torch_profile_batch.py` in a subprocess);
 26. the mesh solves on `Mesh((cuda:0,) * 4)` at the capacity K = 4096: Schur and chain
     steps against the single-device step, `mesh_optimize` (both) against `optimize`
     (the slots run one after another on one card: no multi-card speed);
 27. the mesh pipeline on the drift course: `parallel.use_mesh=true` (one slot on one
     card) against phase 10's run, and a 4-slot mesh of the card with `loop_topk=4`
     against the unmeshed `loop_topk=4` run on the course's first 130 frames (>= 1 loop):
     the same loops, keyframes within 0.02 m, fitness within 1e-4; frame p50s;
 28. `batch_slam` on four drift-course-like sequences (seeds 1, 6, 7, 8; 130 frames, 1.1
     laps) on a 4-slot mesh, loop attempts every 4 keyframes: >= 1 loop, and each
     sequence's optimized ATE <= 1.2 x its odometry's + 0.05 m;
 29. multi-host, two processes on the one card joined by a gloo process group
     (`parallel/multihost.py`, `LGS_*` on localhost): (a) phase 13's CLI run again as two
     `--multihost` processes on `cuda:0` — both exit 0, their trajectory files are equal,
     the keyframes and loops are phase 13's and the keyframe poses within 1e-4 of its,
     each process owns part of the keyframe clouds and launched the loop kernel; each
     process's seconds, frame p50 and launches beside phase 13's; (b) the Schur and chain
     steps at K = 4096 on phase 26's graphs over 2 processes x 2 slots of `cuda:0`
     (`python3 chip_smoke.py --mesh-worker OUT` is one such process) against the
     one-process 4-slot mesh: max difference 0.0 asserted, ms a step.

Each path's launches are counted from 0 just before it runs and read just after (and the
device's count of the loop kernels' launches that did work).
Every phase prints one line of its numbers; a failure raises (exit code != 0, no
result). The line before the last is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`. Needs one card; runs in a checkout of the repo.
`python3 chip_smoke.py --parent DIR` adds the parent tree's loop-kernel timings to phase
3b, its profile to phase 7, its GICP loop kernel to phase 14b (the carry bit for bit,
the times in turns with this tree's), its ICP aligns to phase 14c and its verifications
and classic ICP front end to phase 16 (in turns).

CPU rehearsal: import this module and call the phase functions with device "cpu" at a
small config, e.g. `run_pipeline(loops_off_config([...]), *dense_course(40,
max_points=12000), "cpu")`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from lidar_graph_slam_tpu_torch import native
from lidar_graph_slam_tpu_torch.core.config import (
    CapacityConfig,
    GlobalRegConfig,
    GraphSlamConfig,
    IcpConfig,
    PipelineConfig,
    apply_cli_overrides,
)
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, PointCloud
from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
from lidar_graph_slam_tpu_torch.graph.slam import (
    PRE_ALIGN_OUTLIER_RATIO,
    GraphBasedSLAM,
    loop_pre_align,
)
from lidar_graph_slam_tpu_torch.io.kitti import KittiSequence
from lidar_graph_slam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    make_loop_trajectory,
    make_world,
    simulate_scan,
)
from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import assemble_submap, ring_insert
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.ops import voxel
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
from lidar_graph_slam_tpu_torch.registration import features, gicp
from lidar_graph_slam_tpu_torch.registration import icp as icp_module
from lidar_graph_slam_tpu_torch.registration import ndt as ndt_module
from lidar_graph_slam_tpu_torch.registration.ndt import (
    magnusson_constants,
    ndt_align,
)
from lidar_graph_slam_tpu_torch.utils import checkpoint
from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse
from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.graph import solver as gsolver
from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu_torch.parallel.distributed import (
    Mesh,
    distributed_graph_step,
    mesh_optimize,
)
from lidar_graph_slam_tpu_torch.parallel.multi_sequence import batch_odometry, batch_slam
from lidar_graph_slam_tpu_torch.parallel.schur import schur_graph_step

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
# Kernel vs plain: max |kernel - plain| <= REL * max|plain| + ABS, per output. Both sum
# ~1e5 float32 terms in different orders (measured: ~1e-7 of the scale). Hit and centre
# counts exact.
REL, ABS = 1e-5, 2e-3
DIRECT7_OUT = ("H", "g", "sum_w", "n_hit", "centre_d2", "centre_count")
KERNELS = ("ndt_direct7_accumulate", "ndt_accumulate", "ndt_direct7_accumulate_batched",
           "ndt_align_loop", "ndt_align_loop_batched", "gicp_align_loop", "icp_align_loop",
           "icp_fitness", "ndt_finalize", "eigh3x3")
POSE_TRANS_M, POSE_ROT_RAD = 0.01, 1e-3
# Grid NN, card vs CPU: idx and found equal, d2 to this relative tolerance.
NN_RTOL = 1e-6
# One verification, card vs CPU on the same inputs: the same decision, fitness to rtol
# 1e-3 and the transform to atol 1e-3 (entries of the 4x4: ~1 mm, ~1 mrad). Up to ~120
# float32 NDT and ICP iterations, whose reductions sum in different orders.
VERIFY_FIT_RTOL, VERIFY_T_ATOL = 1e-3, 1e-3
# Global registration: the limits of the reference's own test of it.
GLOBAL_ROT_DEG, GLOBAL_TRANS_M = 5.0, 1.0
GLOBAL_OFFSETS = ((150.0, (18.0, -9.0, 0.3)), (75.0, (-12.0, 20.0, -0.2)))
# Loop verification from the global guess: the corrected pose against truth.
GLOBAL_LOOP_TRANS_M = 0.3
# Resume against the uninterrupted run: classic driver, fused driver (its one-frame submap
# lag collapses at the checkpoint).
RESUME_ATOL = {False: 1e-4, True: 5e-2}
# The multi-sequence phases' worlds: dense-course-like (24-25) and drift-course-like (28).
BATCH_SEEDS = (2, 3, 4, 5)
# Phase 27's top-4 pair runs the drift course's first frames only, up to and past its
# first loop, so that the whole run with phase 29 stays under 900 s (PERF.md section 4).
TOPK_PAIR_FRAMES = 130
SLAM_SEEDS = (1, 6, 7, 8)


def say(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def loops_off_config(overrides=()) -> PipelineConfig:
    return apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *overrides])


def dense_course(n_frames: int, max_points: int = 131072, seed: int = 2):
    """The HDL-64-class urban-canyon course of `bench.py:bench_e2e_dense`, seed 2 (another
    seed: another world, the same trajectory). Returns (scans, ground-truth poses relative
    to the first)."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=60.0, density=60.0, wall_height=12.0,
                       box_height=(6.0, 25.0), n_boxes=60)
    seq = SyntheticSequence(n_frames=n_frames, seed=seed, radius=35.0, laps=0.25,
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


# -- the target build's voxel finalize and the 3x3 eigensolve (phase 4) -----------------

FINALIZE_OUT = ("seg_keys", "stats", "keys", "means", "inv_covs", "valid", "packed")
# `build_ndt_pyramid`'s default, which the NDT matcher builds with.
MIN_POINTS = 6
# Bytes `ndt_finalize` must move: each point of a fine run read once (its xyz, 12 B), each
# fine moment row of a coarse run (its order index, key and 13 moments, 64 B), each run
# (start and length, 16 B), the key of each occupied run (4 B: one key names a run); each
# row written (seg_key, 13 moments, key, mean, inverse, valid and the 64 B packed row:
# 173 B). Float instructions a summed point (3 subtractions, 6 products, 10 adds) and a
# merged fine row (the shift: 3 + 6 + 63, and 13 adds); a valid row's eigensolve takes
# `eigh3x3`'s SASS instructions a matrix (`sass_fast_path`). `eigh3x3` reads 36 B and
# writes 48 B a matrix.
FINALIZE_POINT_BYTES, FINALIZE_MERGED_ROW_BYTES = 12, 64
FINALIZE_RUN_BYTES, FINALIZE_RUN_KEY_BYTES, FINALIZE_ROW_BYTES = 16, 4, 173
FINALIZE_POINT_OPS, FINALIZE_MERGED_ROW_OPS = 19, 85
EIGH_BYTES_PER_MATRIX = 36 + 48
# The issue rate of the H100 SXM: one warp instruction a cycle on each of 4 schedulers of
# each of its 132 SMs, at the SM clock (`nvidia-smi --query-gpu=clocks.max.sm`).
SMS, SCHEDULERS_PER_SM, WARP = 132, 4, 32


def issue_us(instructions: float, clock_mhz: float) -> float:
    """The least time for `instructions` thread instructions: WARP a warp instruction,
    one warp instruction a cycle per scheduler."""
    return instructions / WARP / (SMS * SCHEDULERS_PER_SM * clock_mhz)


def bound_us(nbytes: float, instructions: float, clock_mhz: float) -> dict:
    """The larger of the bytes over the HBM rate and the instructions over the issue
    rate, with both counts and which one bounds."""
    t_bytes, t_ops = 1e6 * nbytes / HBM_BYTES_PER_S, issue_us(instructions, clock_mhz)
    return dict(bound_us=max(t_bytes, t_ops), bytes=nbytes, instructions=instructions,
                bytes_us=t_bytes, issue_us=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


SASS_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
SASS_TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")


def sass_fast_path(sass: str, kernel: str, trips: int) -> dict:
    """The SASS instructions a thread of `kernel` (part of a function name in `sass`, the
    output of `cuobjdump -sass`) issues on its fast path: the function's own code (up to
    its first called subroutine, the IEEE divide's and square root's slow paths), its one
    loop counted `trips` times, and the code a conditional forward branch skips to call a
    slow path left out. Raises if the function has no loop or more than one."""
    funcs = [f for f in sass.split("Function : ")[1:] if kernel in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"sass: {len(funcs)} functions named like {kernel}")
    ops = [(int(m.group(1), 16), m.group(2).strip())
           for m in SASS_INSTRUCTION.finditer(funcs[0])]
    index = {addr: i for i, (addr, _) in enumerate(ops)}

    def target(op):
        t = SASS_TARGET.search(op)
        return None if t is None else index.get(int(t.group(1), 16))

    ends = [target(op) for _, op in ops if "CALL" in op]
    ends += [i for i, (_, op) in enumerate(ops) if "BRA" in op and target(op) == i]
    end = min([e for e in ends if e is not None] + [len(ops)])
    counted, loops = [True] * end, []
    for i in range(end):
        op = ops[i][1]
        j = target(op) if "BRA" in op else None
        if j is None:
            continue
        if j <= i:
            loops.append((j, i))
        elif op.startswith("@") and any("CALL" in o for _, o in ops[i + 1:j]):
            counted[i + 1:j] = [False] * (j - i - 1)
    if len(loops) != 1:
        raise AssertionError(f"sass: {kernel} has {len(loops)} loops: {loops}")
    j, i = loops[0]
    return dict(instructions=sum(counted) + (trips - 1) * sum(counted[j:i + 1]),
                static=end, loop_body=sum(counted[j:i + 1]), skipped=end - sum(counted))


def library_sass() -> str:
    """`cuobjdump -sass` of the kernel library this process built or loaded."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", kernels.build_info["path"]], capture_output=True,
                          text=True, check=True).stdout


def flat(out):
    """`ndt_finalize`'s ((seg_keys, stats), rows) as one tuple, in FINALIZE_OUT's order."""
    return (*out[0], *out[1])


def ring_finalize_inputs(cfg: PipelineConfig, ring) -> dict:
    """The two `ndt_finalize` calls of a rebuild of `ring`, (args, kwargs) each: the fine
    level's sorted points and the coarse level's runs over the fine moments, as
    `build_ndt_pyramid` makes them."""
    ndt_cfg, cap = cfg.scan_matcher.ndt, cfg.capacity.voxel_capacity
    points, mask = assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride)
    res = voxel.as_f32(ndt_cfg.resolution, points)
    origin, runs, pts_sorted, num_voxels = voxel._sorted_points(points, mask, res, cap)
    factor = round(ndt_cfg.coarse_resolution / ndt_cfg.resolution)
    fine_moments, _ = kernels.ndt_finalize(runs, origin, res, MIN_POINTS, points=pts_sorted)
    occupied = torch.arange(cap, device=points.device) < torch.clamp(num_voxels, max=cap)
    cruns, order, _ = voxel._coarse_runs(fine_moments, occupied, factor, cap // 2)
    return {"fine": ((runs, origin, res), {"points": pts_sorted}),
            "coarse": ((cruns, origin, res * factor),
                       {"merge": (order, fine_moments, res, factor)})}


def parent_finalize(parent_kern, args, kw):
    """The parent tree's work on the same sorted rows: its `ndt_finalize` (another tree's
    `ops.kernels`) on them when it takes sorted rows too; for a tree whose kernel took
    moments, the moments by the plain column block and `torch.segment_reduce`
    (`ops/voxel.py:_point_moments` / `_merged_moments`, that tree's operations), then its
    `ndt_finalize` over them. Returns its rows."""
    if next(iter(inspect.signature(parent_kern.ndt_finalize).parameters)) == "runs":
        return parent_kern.ndt_finalize(*args, MIN_POINTS, **kw)[1]
    runs, origin, res = args
    if "points" in kw:
        seg_keys, stats = voxel._point_moments(runs, kw["points"], origin, res)
    else:
        seg_keys, stats = voxel._merged_moments(runs, *kw["merge"])
    C = stats.shape[0]
    return parent_kern.ndt_finalize(seg_keys, stats[:, 0], stats[:, 1:4],
                                    stats[:, 4:13].reshape(C, 3, 3), runs[2][:C] > 0, origin,
                                    res, MIN_POINTS)


def same_bits(label: str, names, out, again, ref) -> None:
    """Two launches and the plain version on the same card tensors: equal bit for bit."""
    torch.cuda.synchronize()
    for name, a, b, c in zip(names, out, again, ref):
        if not (torch.equal(a, b) and torch.equal(a, c)
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                c.reshape(-1).view(torch.uint8))):
            raise AssertionError(f"{label}: {name} not bit-equal to the plain version")


def finalize_phase(tag: str, cfg: PipelineConfig, ring, card: str, parent_kern,
                   eigh_instructions: int, clock_mhz: float) -> dict:
    """`ndt_finalize` on a ring's two levels (fine from the sorted points, coarse from the
    merged fine moments): bit for bit against `ndt_finalize_plain` with a rerun, and its
    rows against the parent tree's moments-plus-finalize on the same rows; device and
    host us (`split_times`), with `parent_kern` in turns (this, parent, parent, this); the
    plain version's ms; the bound from this ring's runs (bytes, and issue slots: points
    or merged rows summed and `eigh_instructions` a valid row). Returns {label: timing}."""
    timing = {}
    for level, (args, kw) in ring_finalize_inputs(cfg, ring).items():
        label = f"finalize_{level}" + ("" if tag == "dense" else f"_{tag}")

        def this(args=args, kw=kw):
            return kernels.ndt_finalize(*args, MIN_POINTS, **kw)

        ref = flat(voxel.ndt_finalize_plain(*args, MIN_POINTS, **kw))
        same_bits(label, FINALIZE_OUT, flat(this()), flat(this()), ref)
        turns = {"this": this}
        if parent_kern is not None:
            same_bits(f"{label} parent rows", FINALIZE_OUT[2:], flat(this())[2:],
                      flat(this())[2:], parent_finalize(parent_kern, args, kw))
            turns["parent"] = lambda args=args, kw=kw: parent_finalize(parent_kern, args, kw)
        times = {name: [] for name in turns}
        for name in ("this", "parent", "parent", "this"):
            if name in turns:
                times[name].append(split_times(turns[name], calls=20, warmup=3))
        t = {k: float(np.mean([r[k] for r in times["this"]])) for k in times["this"][0]}
        if "parent" in times:
            t.update({f"parent_{k}": float(np.mean([r[k] for r in times["parent"]]))
                      for k in times["parent"][0]},
                     device_us_turns=json.dumps([round(r["device_us"], 3)
                                                 for name in ("this", "parent")
                                                 for r in times[name]]))
        runs = args[0]
        C = runs[2].shape[0] - 1
        summed, valid_rows = int(runs[2][:C].sum()), int(ref[5].sum())
        occupied = int((runs[2][:C] > 0).sum())
        merged = "merge" in kw
        nbytes = (summed * (FINALIZE_MERGED_ROW_BYTES if merged else FINALIZE_POINT_BYTES)
                  + occupied * FINALIZE_RUN_KEY_BYTES
                  + C * (FINALIZE_RUN_BYTES + FINALIZE_ROW_BYTES))
        instructions = (summed * (FINALIZE_MERGED_ROW_OPS if merged else FINALIZE_POINT_OPS)
                        + valid_rows * eigh_instructions)
        t.update(plain_ms=median_ms(lambda args=args, kw=kw: voxel.ndt_finalize_plain(
                     *args, MIN_POINTS, **kw), calls=10, warmup=2),
                 library_ms=None, rows=C, summed=summed, valid_rows=valid_rows,
                 occupied_rows=occupied,
                 max_run=int(runs[2][:C].max()) if C else 0,
                 **bound_us(nbytes, instructions, clock_mhz))
        t["share_of_bound"] = t["bound_us"] / t["device_us"]
        say("kernel-time", kernel="ndt_finalize", shape=label, **t, card=json.dumps(card))
        timing[label] = {"ndt_finalize": dict(kernel="ndt_finalize", shape=label, **t)}
    return timing


def sync_sites(fn) -> dict:
    """`fn()` under `torch.cuda.set_sync_debug_mode("error")` (after a warm call); if it
    raises, `fn()` again under "warn", which names every synchronizing call's line. No
    site may lie in `ops/kernels.py` (the kernel wrappers read nothing back)."""
    fn()
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        fn()
        return dict(sync_free=True, sync_sites="[]")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            torch.cuda.set_sync_debug_mode("warn")
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = sorted({f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    if any(site.startswith(os.path.join("lidar_graph_slam_tpu_torch", "ops", "kernels.py"))
           for site in sites):
        raise AssertionError(f"a kernel wrapper synchronizes: {sites}")
    return dict(sync_free=False, sync_sites=json.dumps(sites))


def profile_rebuild(cfg: PipelineConfig, ring, parent: str | None, card: str,
                    tag: str = "dense") -> dict:
    """The target build of `ring` by `scripts/torch_profile_rebuild.py` in a subprocess:
    wall ms a build on the kernel path, the plain path and (with `parent`) the parent
    tree's, in turns; device kernel launches, device ms, `segment_reduce`'s launches and
    wrapper launches of one build of each under torch.profiler, one `rebuild-profile` line
    a path. The kernel path must launch fewer device kernels than the plain path, no
    `segment_reduce`, and build the same maps bit for bit (the parent's too)."""
    points, mask = assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride)
    os.makedirs(os.path.join(REPO, ".chip_scratch"), exist_ok=True)
    path = os.path.join(REPO, ".chip_scratch", f"rebuild_profile_input_{tag}.npz")
    np.savez(path, points=points.cpu().numpy(), mask=mask.cpu().numpy())
    cmd = [sys.executable, os.path.join(REPO, "scripts", "torch_profile_rebuild.py"),
           "--input", path]
    if parent is not None:
        cmd += ["--parent", os.path.abspath(parent)]
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    finally:
        os.remove(path)
    if proc.returncode != 0:
        raise AssertionError(f"rebuild profile failed:\n{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (rec["bit_equal_kernel_plain"] and rec["kernel"]["wrapper_launches"] == 2
            and rec["kernel"]["launches"] < rec["plain"]["launches"]
            and rec["kernel"]["segment_reduce_launches"] == 0):
        raise AssertionError(f"rebuild profile: {rec}")
    for name in ("kernel", "plain", "parent"):
        if name in rec:
            say("rebuild-profile", ring=tag, path=name,
                **{k: json.dumps(v, separators=(",", ":")) if isinstance(v, list) else v
                   for k, v in rec[name].items()}, card=json.dumps(card))
    return rec


EIGH_CHUNK = 4096


def eigh_library_ms(A) -> tuple:
    """The ms of one library call that solves A's eigenproblems: `torch.linalg.eigh`
    (cuSOLVER's batched solver); where that raises, the same under
    `torch.backends.cuda.preferred_linalg_library("magma")`; where that raises too,
    `torch.linalg.eigh` over chunks of EIGH_CHUNK matrices in one timed call. Returns
    (ms or None, the route that ran or None, {route: its error})."""
    routes = (("cusolver", "default", lambda: torch.linalg.eigh(A)),
              ("magma", "magma", lambda: torch.linalg.eigh(A)),
              ("cusolver_chunks", "default",
               lambda: [torch.linalg.eigh(c) for c in A.split(EIGH_CHUNK)]))
    errors = {}
    for name, backend, fn in routes:
        before = torch.backends.cuda.preferred_linalg_library()
        try:
            torch.backends.cuda.preferred_linalg_library(backend)
            return median_ms(fn, calls=5, warmup=1), name, errors
        except RuntimeError as e:
            errors[name] = str(e).split("\n")[0][:100]
        finally:
            torch.backends.cuda.preferred_linalg_library(before)
    return None, None, errors


def rebuild_phase(cfg: PipelineConfig, aux, ring, last, card: str,
                  parent: str | None, sass: dict, clock_mhz: float) -> dict:
    """Phase 4: the full ring's target rebuilt twice, bit-identical; `ndt_finalize` on the
    ring's two levels (`finalize_phase`); `eigh3x3` against `_eigh3x3` on GICP's matrices
    at the front end's shapes (the ring's 655,360-point target, the last ring scan's
    32,768), bit for bit, with reruns, its device and host us, the plain version's ms,
    torch.linalg.eigh's ms on the same matrices, the bound (bytes, and `sass`'s
    instructions a matrix); the wrappers' launches a rebuild; the rebuild and
    `insert_and_rebuild` make no synchronous read; the profile of `profile_rebuild`:
    fewer than 216 device launches a rebuild (the moments-in build's count), none of them
    `segment_reduce`.
    Returns the kernels' timings and the numbers."""
    dev = ring.masks.device
    out = map_build_twice(aux, ring, dev)
    before = kernels.thread_launches()
    aux["rebuild"](ring)
    out["wrapper_launches_per_rebuild"] = kernels.thread_launches() - before
    parent_kern = None if parent is None else tree_kernels(parent, "parent_kernels_finalize")
    timing = finalize_phase("dense", cfg, ring, card, parent_kern,
                            sass["eigh3x3"]["instructions"], clock_mhz)
    cell = cfg.scan_matcher.gicp.max_correspondence_distance
    points, mask = assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride)
    eigh_in = {"eigh_target": gicp.safe_window_covariances(points, mask, cell)[1],
               "eigh_source": gicp.safe_window_covariances(last.points, last.mask, cell)[1]}
    for label, A in eigh_in.items():
        same_bits(label, ("w", "V"), kernels.eigh3x3(A), kernels.eigh3x3(A), voxel._eigh3x3(A))
        rows = A.shape[0]
        t = split_times(kernels.eigh3x3, A)
        library_ms, route, errors = eigh_library_ms(A)
        t.update(library_route=route, library_errors=json.dumps(errors))
        t.update(plain_ms=median_ms(voxel._eigh3x3, A, calls=20), library_ms=library_ms,
                 rows=rows, **bound_us(rows * EIGH_BYTES_PER_MATRIX,
                                       rows * sass["eigh3x3"]["instructions"], clock_mhz))
        t["share_of_bound"] = t["bound_us"] / t["device_us"]
        say("kernel-time", kernel="eigh3x3", shape=label, **t, card=json.dumps(card))
        timing[label] = {"eigh3x3": dict(kernel="eigh3x3", shape=label, **t)}
    out["bit_equal"] = True
    # The rebuild, and the whole keyframe step the back end calls (slot 0 written again
    # with its own contents, which leaves the ring as it was).
    for label, fn in (("rebuild", lambda: aux["rebuild"](ring)),
                      ("insert_and_rebuild", lambda: aux["insert_and_rebuild"](
                          ring, 0, ring.clouds[0].clone(), ring.masks[0].clone(),
                          ring.poses[0].clone()))):
        out.update({f"{label}_{k}": v for k, v in sync_sites(fn).items()})
    prof = profile_rebuild(cfg, ring, parent, card)
    out.update(launches_per_rebuild=prof["kernel"]["launches"],
               plain_launches_per_rebuild=prof["plain"]["launches"],
               rebuild_wall_ms=prof["kernel"]["wall_ms"],
               rebuild_device_ms=prof["kernel"]["device_ms"],
               plain_rebuild_wall_ms=prof["plain"]["wall_ms"],
               parent_rebuild_wall_ms=prof.get("parent", {}).get("wall_ms"),
               parent_rebuild_device_ms=prof.get("parent", {}).get("device_ms"))
    if not (out["rebuild_sync_free"] and out["insert_and_rebuild_sync_free"]
            and out["launches_per_rebuild"] < 216):
        raise AssertionError(f"rebuild: {out}")
    return dict(timing=timing, numbers=out)


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


def drift_course(n_frames: int = 360, max_points: int = 131072, seed: int = 1,
                 laps: float = 3.05):
    """The three-lap drift course of `bench.py:bench_e2e`, seed 1: a sparse world (~9k
    points per frame) at ~1.9 m per frame, where NDT odometry drifts and loop closure
    has work to do (another seed: another world). Returns (scans, ground-truth poses
    relative to the first)."""
    seq = SyntheticSequence(n_frames=n_frames, seed=seed, extent=60.0, radius=35.0,
                            max_points=max_points, noise=0.02, laps=laps,
                            n_azimuth=2048, n_elevation=64)
    scans = [scan for scan, _ in seq]
    T0_inv = np.linalg.inv(seq.poses[0])
    return scans, np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])


def run_loop_course(cfg: PipelineConfig, scans, gt, device, mesh=None):
    """Every scan through `SlamPipeline` (with `mesh`, that mesh in place of the one
    `cfg.parallel` would build); all frames must converge. Returns (pipeline, result,
    numbers)."""
    pipe = SlamPipeline(cfg, device=device, mesh=mesh)
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
        _grid, pre_map, _extra, _glob = inp["targets"][0]
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


def gicp_front_inputs(cfg: PipelineConfig, ring, last):
    """The GICP front end's inputs on the dense course: the target it builds from the full
    ring and the last ring scan (N = 32,768) with its own covariances. Returns (target,
    points, mask, covs)."""
    g = cfg.scan_matcher.gicp
    build_target, _ = gicp.make_gicp_matcher(g)
    target = build_target(*assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride))
    covs, _ = gicp.estimate_covariances(last.points, last.mask, g.max_correspondence_distance,
                                        k=g.correspondence_randomness)
    return target, last.points, last.mask, covs


def gicp_front_rows(cfg: PipelineConfig, inputs, T_last: np.ndarray):
    """The front end's GICP rows (`gicp_front_inputs`) at the last ring scan's
    ground-truth pose. Its last 512 rows are made padding (as a scan with fewer points
    has), whose residuals are then ~1e6, and its covariances are estimated again."""
    g = cfg.scan_matcher.gicp
    target, points, mask, _ = inputs
    pts, msk = points.clone(), mask.clone()
    pts[-512:], msk[-512:] = PAD_VALUE, False
    covs, _ = gicp.estimate_covariances(pts, msk, g.max_correspondence_distance,
                                        k=g.correspondence_randomness)
    T = torch.as_tensor(T_last, device=pts.device)
    return gicp_rows(target, pts, msk, covs, T, g.max_correspondence_distance)


def gicp_verify_inputs(back: GraphBasedSLAM, rec: dict):
    """The GICP verifier's inputs for attempt `rec` of a back end: built by a GICP back
    end fed the same keyframes (the candidate's GICP target, the latest keyframe at 16,384
    points with its covariances) and the coarse pre-align's result, where the verifier's
    GICP loop starts. Returns (target, points, mask, covs, T_pre, the GICP config)."""
    cfg = dataclasses.replace(back.cfg, registration_method="GICP", async_backend=False)
    b = GraphBasedSLAM(cfg, back.capacity, device=back.device)
    for k in range(rec["latest"] + 1):
        cloud = back._cloud(k)
        b.add_keyframe({"pose": back.kf_front_poses[k], "cloud": cloud,
                        "cloud_mask": np.ones(cloud.shape[0], bool),
                        "accum_distance": back.kf_accum_dist[k]})
    inp = b._build_verify_inputs()
    _grid, pre_map, target, _glob = inp["targets"][0]
    src_p, src_m, src_covs = inp["source"]
    pre = loop_pre_align(pre_map, src_p, src_m, torch.eye(4, device=src_p.device))
    return target, src_p, src_m, src_covs, pre.transform, cfg.gicp


def gicp_verify_rows(inputs):
    """The GICP verifier's rows (`gicp_verify_inputs`) at the coarse pre-align's result —
    the verifier's first GICP iteration. Its last 512 rows are made padding, as in
    `gicp_front_rows` (a drift-course keyframe holds ~9k points, so most are already)."""
    target, src_p, src_m, src_covs, T_pre, g = inputs
    src_p, src_m = src_p.clone(), src_m.clone()
    src_p[-512:], src_m[-512:] = PAD_VALUE, False
    return gicp_rows(target, src_p, src_m, src_covs, T_pre, g.max_correspondence_distance)


def reset_counts() -> None:
    """Set every kernel's launch count to 0, and the device's count of the loop kernels'
    working launches, just before a path is driven."""
    for name in KERNELS:
        getattr(kernels, name).launches = 0
    if torch.cuda.is_available():
        kernels.worked_launches(reset=True)


def read_counts() -> dict:
    """Every kernel's launches since `reset_counts`, read just after a path ran, and
    `ndt_iteration_worked` / `gicp_iteration_worked` / `icp_iteration_worked`: how many of
    each loop kernel's launches (one per sequence of a batch) did work rather than exit on
    a finished carry."""
    torch.cuda.synchronize()
    counts = {name: getattr(kernels, name).launches for name in KERNELS}
    for name in ("ndt_iteration", "gicp_iteration", "icp_iteration"):
        counts[f"{name}_worked"] = kernels.worked_launches(kernel=name)
    return counts


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
    ring's map from a perturbed guess; this tree's align is one loop call of
    max_iterations + 2 launches. With `parent` (the parent commit unpacked by `git
    archive`) the same input goes through both trees in turns (this, parent, parent,
    this): this tree must launch as many device kernels per align as the parent (the loop
    kernel's redesign keeps its launches) and give its transform to 1e-3."""
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
    loop_launches = cfg.scan_matcher.ndt.max_iterations + 2
    if not all(r["converged"] and r["wrapper_launches_per_align"] == {
            "ndt_accumulate": 0, "ndt_direct7_accumulate": 0, "ndt_align_loop": loop_launches}
               for r in out["this"]):
        raise AssertionError(f"ndt profile: {out['this']}")
    summary = {tree: {k: float(np.mean([r[k] for r in runs])) for k in
                      ("launches_per_align", "device_ms_per_align", "wall_ms_per_align",
                       "launches_per_body", "device_ms_per_body", "wall_ms_per_body")}
               for tree, runs in out.items()}
    if "parent" in out:
        par = out["parent"][0]
        fewer = par["launches_per_align"] - this["launches_per_align"]
        dT = float(np.abs(np.asarray(par["transform"]) - np.asarray(this["transform"])).max())
        say("ndt-profile", fewer_launches_per_align=fewer, transform_max_diff=dT,
            mean=json.dumps(summary, separators=(",", ":")))
        if not (fewer == 0 and dT <= 1e-3):
            raise AssertionError(f"ndt profile: {fewer} fewer launches per align, transform "
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
    if not (bool(res.converged)
            and counts == {**dict.fromkeys(counts, 0), "ndt_accumulate": bodies}):
        raise AssertionError(f"line search: converged {bool(res.converged)}, {bodies} "
                             f"bodies, launches {counts}")
    err = float(np.abs(res.transform.cpu().numpy() - T_last).max())
    return dict(iterations=int(res.iterations), bodies=bodies,
                launches=counts["ndt_accumulate"], transform_vs_truth_max=err)


# -- the NDT loop on the device (the ndt-loop phase) ---------------------------------------

# The loop kernel against its plain loop (torch ops, the carry frozen after done) on the
# same card tensors: T within LOOP_T_ATOL and the same iterations and done. Both sum in
# float32 in different orders, and the kernel's in-register transform rounds differently
# from cuBLAS's `points @ R^T`; inliers within LOOP_INLIERS_RTOL and fitness within
# LOOP_FITNESS_RTOL of the plain loop's. Batched rows bit-equal to single loops.
LOOP_T_ATOL = 1e-4
LOOP_INLIERS_RTOL = 1e-3
LOOP_FITNESS_RTOL = 1e-4
# Float operations a working launch adds to `ndt_direct7_accumulate`'s: the transform of a
# masked-in point (9 products, 9 additions and 3 translations: 21) and the step in one
# thread (the damping 14, the LU factorization with its pivot search ~140, the two
# substitutions 66, the cap 20, se3_exp ~110, the 3x4 by 4x4 product 84, the fitness and
# the test ~25): ~460.
TRANSFORM_FLOPS_PER_POINT = 21
STEP_FLOPS = 460
# The carry a working launch reads and writes (T 64 B, done 1, iterations 4, fitness 4,
# inliers 4) and the damping (4 B).
CARRY_BYTES = 81


def loop_args(vmap: NdtVoxelMap, points, mask, T0, ndt_cfg, coarse: bool,
              max_iterations: int | None = None):
    """`ndt_align_loop`'s arguments for one align stage as `make_ndt_matcher` runs it: the
    fine stage (every point, the configured step, max_iterations, 2 polish) or the coarse
    one (every `coarse_subsample`-th point, 4x the step, coarse_iterations, no polish)."""
    d1, d2 = magnusson_constants(vmap.leaf, ndt_cfg.outlier_ratio)
    stride = ndt_cfg.coarse_subsample if coarse else 1
    its = ndt_cfg.coarse_iterations if coarse else ndt_cfg.max_iterations
    return (vmap, points[::stride].contiguous(), mask[::stride].contiguous(), T0, d2,
            -d1 * d2, ndt_cfg.step_size * (4.0 if coarse else 1.0), ndt_cfg.transform_epsilon,
            torch.full((), 1e-6, device=points.device),
            its if max_iterations is None else max_iterations, 0 if coarse else 2)


def compare_loop(label: str, args) -> dict:
    """The kernel loop vs its plain loop on the same card tensors, plus a bit-identical
    rerun; returns the numbers of the comparison."""
    out = kernels.ndt_align_loop(*args)
    again = kernels.ndt_align_loop(*args)
    ref = kernels.ndt_align_loop_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{label}: two kernel loops differ")
    err = float((out[0] - ref[0]).abs().max())
    rec = dict(case=label, N=args[1].shape[0], max_iterations=args[9], polish=args[10],
               iterations=int(out[2]), iterations_plain=int(ref[2]), done=bool(out[1]),
               done_plain=bool(ref[1]), T_max_abs_err=err, inliers=int(out[4]),
               inliers_plain=int(ref[4]), fitness=float(out[3]),
               fitness_plain=float(ref[3]), bit_identical=True)
    say("ndt-loop-check", **rec)
    if not (err <= LOOP_T_ATOL and rec["iterations"] == rec["iterations_plain"]
            and rec["done"] == rec["done_plain"]
            and abs(rec["inliers"] - rec["inliers_plain"]) <= LOOP_INLIERS_RTOL
            * rec["inliers_plain"]
            and abs(rec["fitness"] - rec["fitness_plain"]) <= LOOP_FITNESS_RTOL
            * abs(rec["fitness_plain"])):
        raise AssertionError(f"{label}: kernel loop vs plain {rec}")
    return rec


def loop_bound_us(args) -> dict:
    """The least time for one working launch of the loop kernel on these inputs: the
    bytes and operations of `ndt_direct7_accumulate` at the stage's T0 (counted on the
    card from this run's data, `direct7_bound_us`), plus the transform, the step and the
    carry."""
    vmap, src, msk, T0, d2, ws = args[:6]
    moved = torch.where(msk[:, None], se3.transform_points(T0, src), src).contiguous()
    sums = kernels.ndt_direct7_accumulate(vmap, moved, msk, d2, ws)
    b = direct7_bound_us(vmap, moved, msk, float(sums[3]), float(sums[5]))
    nbytes = b["bytes"] + CARRY_BYTES
    flops = b["flops"] + TRANSFORM_FLOPS_PER_POINT * int(msk.sum()) + STEP_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return dict(bound_us=1e6 * max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def tree_kernels(root: str, name: str = "parent_kernels"):
    """The `ops.kernels` module of another tree of the package (such as the parent commit
    unpacked by `git archive`), loaded beside this tree's under `name`: it builds that
    tree's `csrc/` into that tree's `build/`, and its other imports are this tree's."""
    path = os.path.join(os.path.abspath(root), "lidar_graph_slam_tpu_torch", "ops",
                        "kernels.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_registration(root: str, module: str, kern, name: str):
    """The `registration.<module>` module (`ndt`, `gicp`) of another tree, loaded beside
    this tree's under `name`, its kernel calls bound to `kern` (that tree's `ops.kernels`,
    `tree_kernels`); its other imports are this tree's."""
    path = os.path.join(os.path.abspath(root), "lidar_graph_slam_tpu_torch", "registration",
                        f"{module}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # its dataclasses look their module up while they are made
    spec.loader.exec_module(mod)
    mod.kernels = kern
    return mod


def loop_timings(args, align, batched: bool = False, kern=kernels, ndt=ndt_module) -> dict:
    """Device us per working launch and per early-exit launch of the loop kernel of the
    module `kern` (this tree's `ops.kernels`, or another tree's), and the host and device
    us of a whole align stage (`align(ndt)`, `ndt` the `registration.ndt` module whose
    `ndt_align` runs on `kern`), `split_times` on fixed inputs: a
    loop of 20 launches that all work (epsilon 0), a loop of 1 working launch, and one of
    1 working and 40 early-exit launches (epsilon 1e9: done after the first), the carry's
    set-up cancelling in the differences. Few calls per timing, so that the launches
    queued behind the spin kernel stay a few hundred."""
    wrapper = kern.ndt_align_loop_batched if batched else kern.ndt_align_loop

    def loop(eps, its):
        return lambda: wrapper(*args[:7], eps, args[8], its, 0)

    work = split_times(loop(0.0, 20), calls=10, warmup=2)
    one = split_times(loop(1e9, 1), calls=40, warmup=2)
    dead = split_times(loop(1e9, 41), calls=5, warmup=2)
    stage = split_times(lambda: align(ndt), calls=3, warmup=2)
    return dict(working_launch_us=(work["device_us"] - one["device_us"]) / 19,
                early_exit_launch_us=(dead["device_us"] - one["device_us"]) / 40,
                loop_host_us_20=work["host_us"], stage_host_us=stage["host_us"],
                stage_device_us=stage["device_us"], stage_single_ms=stage["single_ms"])


def plain_launch_ms(args) -> float:
    """The plain version's time for one working launch's work: the transform, the plain
    gather and accumulation, and `ndt_carry_update`, on the card."""
    vmap, src, msk, T0, d2, ws, step, eps, damping = args[:9]
    dev = src.device
    carry = (T0, torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), device=dev), torch.zeros((), dtype=torch.int32, device=dev))

    def one():
        sums = kernels.ndt_direct7_accumulate_plain(
            vmap, se3.transform_points(T0, src), msk, d2, ws)
        return kernels.ndt_carry_update(sums, carry, step, eps, damping, False)

    return median_ms(one, calls=20)


def in_turns(label: str, stage: str, measure, this, parent, card: str) -> dict:
    """`measure(mods)` of this tree's modules `this`; with `parent` (the same modules of
    another tree) in turns, this, parent, parent, this, on the same inputs. Prints the
    parent's and this tree's means under `label` and returns this tree's, with the
    parent's under `parent_<key>`."""
    if parent is None:
        return measure(this)
    runs = {}
    for tree, mods in (("this", this), ("parent", parent), ("parent", parent),
                       ("this", this)):
        runs.setdefault(tree, []).append(measure(mods))
    mean = {tree: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
            for tree, rs in runs.items()}
    for tree, m in mean.items():
        say(label, stage=stage, tree=tree, turns=json.dumps(
            [round(r["working_launch_us"], 3) for r in runs[tree]]), **m,
            card=json.dumps(card))
    return {**mean["this"], **{f"parent_{k}": v for k, v in mean["parent"].items()}}


def timed_in_turns(stage: str, args, align, batched: bool, parent, card: str) -> dict:
    """`loop_timings` of this tree's loop kernel; with `parent` (another tree's
    (`ops.kernels`, `registration.ndt`) pair) in turns with it (`in_turns`)."""
    return in_turns("ndt-loop-turns", stage,
                    lambda mods: loop_timings(args, align, batched, *mods),
                    (kernels, ndt_module), parent, card)


def ndt_loop_phase(cfg: PipelineConfig, fine: NdtVoxelMap, coarse: NdtVoxelMap, last,
                   T_last: np.ndarray, card: str, parent: str | None = None) -> dict:
    """The ndt-loop phase: `ndt_iteration` (`ndt_align_loop`) and `ndt_iteration_batched`
    against the plain loop on the dense course's fixtures — the last ring scan (N =
    32,768 fine, 8,192 coarse) from a perturbed guess, and a fine loop cut at 3
    iterations (it reaches max_iterations) — and the batched loop at B = 4 (four guesses
    of the same scan, one at the true pose) row by row against single loops, bit for bit;
    the device us of a working and of an early-exit launch, the host us of an align stage
    and the bound; the kernel's registers, shared memory and blocks. With `parent` (the
    parent commit unpacked by `git archive`) the same timings of that tree's kernel, in
    turns with this tree's. Returns {"err", "timing", "records"}."""
    ndt_cfg = cfg.scan_matcher.ndt
    dev = last.points.device
    n_coarse = last.points[::ndt_cfg.coarse_subsample].shape[0]
    resources = dict(kernels.loop_kernel_attributes(dev),
                     blocks_fine=kernels.loop_grid(dev, last.points.shape[0]),
                     blocks_coarse=kernels.loop_grid(dev, n_coarse))
    say("ndt-loop-kernel", **resources)
    if parent:
        par_kernels = tree_kernels(parent)
        par = (par_kernels, tree_registration(parent, "ndt", par_kernels, "parent_ndt"))
    else:
        par = None
    init = torch.as_tensor(perturbed(T_last), device=dev)
    stages = {"fine": loop_args(fine, last.points, last.mask, init, ndt_cfg, False),
              "coarse": loop_args(coarse, last.points, last.mask, init, ndt_cfg, True)}
    recs = [compare_loop(f"{k}-perturbed", a) for k, a in stages.items()]
    recs.append(compare_loop("fine-max-iterations",
                             loop_args(fine, last.points, last.mask, init, ndt_cfg, False, 3)))
    if not (recs[-1]["iterations"] == 3 and not recs[-1]["done"]
            and all(r["done"] for r in recs[:2])):
        raise AssertionError(f"ndt loop fixtures: {recs}")
    err = max(r["T_max_abs_err"] for r in recs)

    timing = {}
    for k, a in stages.items():
        def align(ndt, a=a):
            return ndt.ndt_align(a[0], a[1], a[2], a[3], step_size=a[6],
                                 transform_epsilon=a[7], outlier_ratio=ndt_cfg.outlier_ratio,
                                 max_iterations=a[9], polish_iterations=a[10])
        t = timed_in_turns(k, a, align, False, par, card)
        t.update(loop_bound_us(a), plain_ms=plain_launch_ms(a), N=a[1].shape[0])
        t.update(device_us=t["working_launch_us"], host_us=t["stage_host_us"],
                 single_ms=t["stage_single_ms"],
                 share_of_bound=t["bound_us"] / t["working_launch_us"])
        say("ndt-loop-time", stage=k, **t, card=json.dumps(card))
        timing[f"loop_{k}"] = {"ndt_iteration": t}

    # Batched: four guesses of the same scan against four copies of the fine map.
    offsets = [np.eye(4, dtype=np.float32), perturbed(np.eye(4, dtype=np.float32))]
    for yaw, xy in ((-0.02, (-0.25, 0.3)), (0.015, (0.2, 0.35))):
        D = np.eye(4, dtype=np.float32)
        D[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        D[:2, 3] = xy
        offsets.append(D)
    T0s = torch.as_tensor(np.stack([T_last @ D for D in offsets]).astype(np.float32),
                          device=dev)
    B = T0s.shape[0]
    fa = stages["fine"]
    vmaps = kernels.stack_maps([fine] * B)
    src = fa[1].expand(B, -1, -1).contiguous()
    msk = fa[2].expand(B, -1).contiguous()
    d2, ws = fa[4].expand(B).contiguous(), fa[5].expand(B).contiguous()
    bargs = (vmaps, src, msk, T0s, d2, ws, *fa[6:])
    out = kernels.ndt_align_loop_batched(*bargs)
    ref = kernels.ndt_align_loop_batched_plain(*bargs)
    singles = [kernels.ndt_align_loop(fine, fa[1], fa[2], T0s[b], fa[4], fa[5], *fa[6:])
               for b in range(B)]
    torch.cuda.synchronize()
    berr = float((out[0] - ref[0]).abs().max())
    rows_equal = all(torch.equal(x[b], y) for b in range(B) for x, y in zip(out, singles[b]))
    iters = out[2].tolist()
    inl, inl_ref = out[4].double(), ref[4].double()
    fit_ok = bool(((out[3] - ref[3]).abs() <= LOOP_FITNESS_RTOL * ref[3].abs()).all())
    inl_ok = bool(((inl - inl_ref).abs() <= LOOP_INLIERS_RTOL * inl_ref).all())
    if not (rows_equal and berr <= LOOP_T_ATOL and iters == ref[2].tolist()
            and bool(out[1].all()) and bool(ref[1].all()) and fit_ok and inl_ok
            and iters[0] == min(iters) < max(iters)):
        raise AssertionError(
            f"batched ndt loop: rows equal to single {rows_equal}, T err {berr}, iterations "
            f"{iters} vs plain {ref[2].tolist()}, done {out[1].tolist()} vs "
            f"{ref[1].tolist()}, fitness {out[3].tolist()} vs {ref[3].tolist()}, inliers "
            f"{out[4].tolist()} vs {ref[4].tolist()}")
    say("ndt-loop-batched-check", B=B, N=src.shape[1], iterations=json.dumps(iters),
        T_max_abs_err=berr, inliers=json.dumps(out[4].tolist()),
        inliers_plain=json.dumps(ref[4].tolist()), fitness=json.dumps(out[3].tolist()),
        fitness_plain=json.dumps(ref[3].tolist()), rows_bit_equal_single=True)

    def balign(ndt):
        return ndt.ndt_align_batched(vmaps, src, msk, T0s, step_size=fa[6],
                                     transform_epsilon=fa[7],
                                     outlier_ratio=ndt_cfg.outlier_ratio,
                                     max_iterations=fa[9], polish_iterations=fa[10])

    t = timed_in_turns("fine-batched", bargs, balign, True, par, card)
    bounds = [loop_bound_us((fine, fa[1], fa[2], T0s[b], fa[4], fa[5])) for b in range(B)]
    nbytes, flops = sum(x["bytes"] for x in bounds), sum(x["flops"] for x in bounds)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    t.update(bound_us=1e6 * max(t_bytes, t_ops), bytes=nbytes, flops=flops,
             bound_by="bytes" if t_bytes >= t_ops else "operations", B=B, N=src.shape[1],
             plain_ms=B * timing["loop_fine"]["ndt_iteration"]["plain_ms"])
    t.update(device_us=t["working_launch_us"], host_us=t["stage_host_us"],
             single_ms=t["stage_single_ms"],
             share_of_bound=t["bound_us"] / t["working_launch_us"])
    say("ndt-loop-time", stage="fine-batched", **t, card=json.dumps(card))
    timing["loop_batch"] = {"ndt_iteration_batched": t}
    return dict(err=err, batched_err=berr, timing=timing, records=recs, resources=resources)


def fused_steps_sync_free(cfg: PipelineConfig, scans, gt, target, dev, first: int = 20,
                          frames: int = 5) -> dict:
    """The fused step (the config's matcher) on `frames` dense-course frames after
    `first`, against the target of the full ring of frames 0..first-1, from the state the
    ring's last frame
    leaves (its ground-truth pose, constant velocity): one warm-up step, then `frames`
    steps under `torch.cuda.set_sync_debug_mode("error")`, which raises at the first
    synchronous read. Their inputs are uploaded first, and their outputs read after."""
    init_state, step, _ = make_fused_frontend(cfg.scan_matcher, cfg.prefilter, cfg.capacity,
                                              device=dev)
    T = torch.as_tensor(gt, device=dev)
    state = dataclasses.replace(
        init_state(), pose=T[first - 1], last_motion=se3.inverse(T[first - 2]) @ T[first - 1],
        last_kf_pose=T[first - 1], n_keyframes=torch.full((), first, dtype=torch.int32,
                                                          device=dev))
    raws = []
    for s_ in scans[first - 1:first + frames]:
        raw = np.full((cfg.capacity.raw_points, 3), PAD_VALUE, np.float32)
        raw[:min(len(s_), cfg.capacity.raw_points)] = s_[:cfg.capacity.raw_points]
        raws.append(torch.as_tensor(raw, device=dev))
    eye3, eye4 = torch.eye(3, device=dev), torch.eye(4, device=dev)
    state, _ = step(state, raws[0], target, eye3, False, eye4, False)  # warm-up
    torch.cuda.synchronize()
    outs = []
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for raw in raws[1:]:
            state, out = step(state, raw, target, eye3, False, eye4, False)
            outs.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = 1000 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    total_ms = 1000 * (time.perf_counter() - t0)
    poses = np.stack([o.pose.cpu().numpy() for o in outs])
    err = np.linalg.norm(poses[:, :3, 3] - gt[first:first + frames, :3, 3], axis=1)
    conv = [bool(o.converged) for o in outs]
    if not (np.isfinite(poses).all() and all(conv)):
        raise AssertionError(f"fused steps: converged {conv}, pose errors {err}")
    return dict(frames=frames, sync_reads=0, converged=sum(conv),
                iterations=json.dumps([int(o.iterations) for o in outs]),
                pose_err_m=json.dumps([round(float(e), 5) for e in err]),
                enqueue_ms_per_frame=enqueue_ms / frames, wall_ms_per_frame=total_ms / frames)


# -- the GICP loop on the device (the gicp-loop phase) -------------------------------------

# The GICP loop kernel against its plain loop on the same card tensors, to the NDT loop's
# bounds (LOOP_T_ATOL, LOOP_INLIERS_RTOL, LOOP_FITNESS_RTOL: float32 sums in other orders,
# and the kernel's in-register transform against cuBLAS's `points @ R^T`); a loop cut at
# one iteration has exactly the plain loop's inliers (the query's d2 is the plain
# version's float32 arithmetic in its order, the first minimum as argmin takes it).
# Float operations of a working launch: per masked-in point the transform and its cell
# (TRANSFORM_FLOPS_PER_POINT + CELL_FLOPS_PER_POINT); per candidate whose key is its cell's,
# d2 and the comparison (9); per matched row R Cp R^T + Cq (99), the adjugate inverse (42),
# e = p - q (3), the accumulation (ACCUM_FLOPS_PER_HIT) and the fitness sums (2); the step.
CANDIDATE_FLOPS = 9
GICP_ROW_FLOPS = 99 + 42 + 3 + ACCUM_FLOPS_PER_HIT + 2
GICP_VARIANT = (7, 32, False)  # the path's query: 7 cells, 32-row buckets, no reciprocal
LOOP_TILE = 128  # source points a block of the loop kernels takes at once (kLoopThreads)


def gicp_loop_args(inputs, T0, g, max_iterations: int | None = None, source_grid=None):
    """`gicp_align_loop`'s arguments as `gicp_align` passes them for GICP config `g`."""
    target, points, mask, covs = inputs[:4]
    d = g.max_correspondence_distance
    return (target, points, mask, covs, T0, d * d, g.transform_epsilon,
            torch.full((), 1e-6, device=points.device),
            g.max_iterations if max_iterations is None else max_iterations, 32, 7,
            source_grid)


def compare_gicp_loop(label: str, args, exact_inliers: bool = False) -> dict:
    """The GICP kernel loop vs its plain loop on the same card tensors, plus a
    bit-identical rerun; returns the numbers of the comparison."""
    out = kernels.gicp_align_loop(*args)
    again = kernels.gicp_align_loop(*args)
    ref = kernels.gicp_align_loop_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{label}: two GICP kernel loops differ")
    rec = dict(case=label, N=args[1].shape[0], max_iterations=args[8],
               reciprocal=args[11] is not None, iterations=int(out[2]),
               iterations_plain=int(ref[2]), done=bool(out[1]), done_plain=bool(ref[1]),
               T_max_abs_err=float((out[0] - ref[0]).abs().max()), inliers=int(out[4]),
               inliers_plain=int(ref[4]), fitness=float(out[3]), fitness_plain=float(ref[3]),
               bit_identical=True)
    say("gicp-loop-check", **rec)
    inl_tol = 0 if exact_inliers else LOOP_INLIERS_RTOL * rec["inliers_plain"]
    if not (rec["T_max_abs_err"] <= LOOP_T_ATOL
            and rec["iterations"] == rec["iterations_plain"]
            and rec["done"] == rec["done_plain"]
            and abs(rec["inliers"] - rec["inliers_plain"]) <= inl_tol
            and rec["inliers_plain"] > 0
            and abs(rec["fitness"] - rec["fitness_plain"]) <= LOOP_FITNESS_RTOL
            * abs(rec["fitness_plain"])):
        raise AssertionError(f"{label}: GICP kernel loop vs plain {rec}")
    return rec


def nn_query_counts(grid, src, msk, T, bucket_cap: int, neighborhood: int) -> dict:
    """What one grid-NN query of the masked-in points of `src` moved by T reads, counted
    with torch ops on the card from this run's data: the points, the distinct in-table
    cells their neighbourhoods name (4 B of table each), the candidates whose key is their
    cell's and the distinct rows among them (16 B each)."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as nb

    q = se3.transform_points(T, src)[msk]
    offsets = nb._offsets_for(neighborhood, q.device)
    d2, cand = nb._candidate_scan(grid, q, offsets, bucket_cap)
    real = torch.isfinite(d2)
    nc = voxel_coords(q, grid.origin, 1.0 / grid.cell_size)[:, None, :] + offsets
    in_range = ((nc >= 0) & (nc < torch.tensor(TABLE_DIMS, device=q.device))).all(-1)
    _, dy, dz = TABLE_DIMS
    cells = torch.unique(((nc[..., 0] * dy + nc[..., 1]) * dz + nc[..., 2])[in_range]).numel()
    return dict(points=q.shape[0], candidates=int(real.sum()),
                candidate_rows=torch.unique(cand[real]).numel(), table_cells=cells)


def bound_of(nbytes: float, flops: float, **counts) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return dict(bound_us=1e6 * max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by="bytes" if t_bytes >= t_ops else "operations", **counts)


def gicp_loop_bound_us(args) -> dict:
    """The least time for one working launch of the GICP loop kernel on these inputs at
    T0, counted on the card from this run's data. Bytes: the mask (1 B a point), each
    masked-in point (12 B), the query's table cells (4 B) and candidate rows (16 B,
    `nn_query_counts`), each matched point's source covariance (36 B) and each distinct
    matched target row's covariance and flag (37 B), the carry and the damping.
    Operations: the per-point, per-candidate and per-row counts above, and the step."""
    target, src, msk, _covs, T0, corr2 = args[:6]
    bucket_cap, neighborhood = args[9], args[10]
    c = nn_query_counts(target.grid, src, msk, T0, bucket_cap, neighborhood)
    idx, _d2, matched = kernels.gicp_match(target, se3.transform_points(T0, src), msk, corr2,
                                           bucket_cap, neighborhood)
    n_match = int(matched.sum())
    trows = torch.unique(idx[matched]).numel()
    nbytes = (src.shape[0] + 12 * c["points"] + 4 * c["table_cells"]
              + 16 * c["candidate_rows"] + 36 * n_match + 37 * trows + CARRY_BYTES)
    flops = ((TRANSFORM_FLOPS_PER_POINT + CELL_FLOPS_PER_POINT) * c["points"]
             + CANDIDATE_FLOPS * c["candidates"] + GICP_ROW_FLOPS * n_match + STEP_FLOPS)
    return bound_of(nbytes, flops, candidates=c["candidates"],
                    candidate_rows=c["candidate_rows"], table_cells=c["table_cells"],
                    matched=n_match)


def stage_counts(args, stage_runs: int) -> dict:
    """What one working launch of the GICP loop kernel stages, tile by tile (128 source
    points, the kernel's), on these inputs at T0, counted with torch ops on the card: the
    distinct in-table cells the masked-in points' neighbourhoods name (`cells`, empty ones
    too), the distinct runs of B rows the stage copies (one a non-empty cell, from its
    table start: `runs`), the distinct candidate rows among them whose key is the cell's
    (`rows`); p50 and max over the tiles that hold a point, the bytes of the largest run
    set, and the runs past `stage_runs` (a tile's stage; they are read from global memory
    instead): their sum over the tiles and the tiles that have any."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as nb
    from lidar_graph_slam_tpu_torch.ops.voxel import _flat_table_index

    target, src, msk, _covs, T0 = args[:5]
    bucket_cap, neighborhood = args[9], args[10]
    grid = target.grid
    dev = src.device
    n, size = grid.packed.shape[0], grid.table.shape[0]
    p = se3.transform_points(T0, src)
    offsets = nb._offsets_for(neighborhood, dev)
    nc = voxel_coords(p, grid.origin, 1.0 / grid.cell_size)[:, None, :] + offsets
    flat, in_range = _flat_table_index(nc, TABLE_DIMS)
    start = torch.where(in_range & msk[:, None], grid.table[flat.clamp(max=size - 1).long()], -1)
    live, named = start >= 0, in_range & msk[:, None]
    tile = torch.arange(src.shape[0], device=dev) // LOOP_TILE
    tiles = int(tile[-1]) + 1
    tile_c = tile[:, None].expand_as(start)
    d2, cand = nb._candidate_scan(grid, p, offsets, bucket_cap)
    real = torch.isfinite(d2) & msk[:, None]

    def per_tile(t, key, stride):
        return torch.bincount(torch.unique(t * stride + key) // stride, minlength=tiles)

    counts = {
        "cells": per_tile(tile_c[named], flat[named].long(), size),
        "runs": per_tile(tile_c[live], start[live].long(), n),
        "rows": per_tile(tile[:, None].expand_as(cand)[real], cand[real], n),
    }
    held = torch.bincount(tile[msk], minlength=tiles) > 0
    out = {}
    for k, v in counts.items():
        v = v[held].float()
        out[f"{k}_p50"], out[f"{k}_max"] = float(v.median()), int(v.max())
    over = (counts["runs"] - stage_runs).clamp(min=0)
    out.update(tiles=int(held.sum()), run_bytes_max=out["runs_max"] * bucket_cap * 16,
               stage_runs=stage_runs, overflow_runs=int(over.sum()),
               overflow_tiles=int((over > 0).sum()))
    return out


def gicp_loop_timings(args, align, kern=kernels) -> dict:
    """Device us per working launch and per early-exit launch of the GICP loop kernel of
    the module `kern` (this tree's `ops.kernels`, or another tree's), and the host and
    device us of a whole align stage (`align()`), as `loop_timings` measures NDT's: a loop
    of 20 launches that all work (epsilon 0), one of 1 working launch, and one of 1
    working and 40 early-exit launches (epsilon 1e9)."""
    def loop(eps, its):
        return lambda: kern.gicp_align_loop(*args[:6], eps, args[7], its, *args[9:])

    work = split_times(loop(0.0, 20), calls=10, warmup=2)
    one = split_times(loop(1e9, 1), calls=40, warmup=2)
    dead = split_times(loop(1e9, 41), calls=5, warmup=2)
    stage = split_times(align, calls=3, warmup=2)
    return dict(working_launch_us=(work["device_us"] - one["device_us"]) / 19,
                early_exit_launch_us=(dead["device_us"] - one["device_us"]) / 40,
                loop_host_us_20=work["host_us"], stage_host_us=stage["host_us"],
                stage_device_us=stage["device_us"], stage_single_ms=stage["single_ms"])


def same_carry_as_parent(label: str, args, parent_kern) -> dict:
    """This tree's GICP loop kernel against `parent_kern`'s (another tree's `ops.kernels`)
    on the same card tensors: the whole loop and the loop cut at one iteration leave
    bit-identical carries (the same matches, rows and sums in the same order). Raises
    otherwise."""
    rec = {}
    for its in (args[8], 1):
        a = (*args[:8], its, *args[9:])
        out, ref = kernels.gicp_align_loop(*a), parent_kern.gicp_align_loop(*a)
        torch.cuda.synchronize()
        rec[f"bit_identical_{its}"] = all(torch.equal(x, y) for x, y in zip(out, ref))
    say("gicp-loop-vs-parent", case=label, **rec)
    if not all(rec.values()):
        raise AssertionError(f"{label}: the GICP kernel's carry differs from the parent's {rec}")
    return rec


def gicp_plain_launch_ms(args) -> float:
    """The plain version's time for one working launch's work on the card: the
    transform, match, rows and accumulation (`gicp_sums_plain`) and `gicp_carry_update`."""
    target, src, msk, covs, T0, corr2, eps, damping = args[:8]
    dev = src.device
    carry = (T0, torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), device=dev), torch.zeros((), dtype=torch.int32, device=dev))

    def one():
        sums = kernels.gicp_sums_plain(target, src, msk, covs, T0, corr2, *args[9:])
        return kernels.gicp_carry_update(sums, carry, eps, damping)

    return median_ms(one, calls=20)


def gicp_loop_phase(cfg: PipelineConfig, front_in, verify_in, T_last: np.ndarray, card: str,
                    parent: str | None = None) -> dict:
    """The gicp-loop phase: `gicp_iteration` (`gicp_align_loop`) against the plain loop on
    phase 14's fixtures — the front end's (the ring's target, the last ring scan, N =
    32,768) from a perturbed guess, the same cut at one iteration (inliers exact) and with
    the reciprocal test, and the verifier's (N = 16,384) from its pre-align's result; what
    a working launch stages at each fixture (`stage_counts`); the device us of a working
    and of an early-exit launch, the host and device us of an align stage, the bound and
    the plain version's ms; the kernel's registers, shared memory, blocks and warps an SM
    and the runs its stage holds. With `parent` (the parent commit unpacked by `git
    archive`) that tree's kernel on both fixtures: its carry bit-identical to this tree's,
    and its times in turns with this tree's. Returns {"err", "timing", "records",
    "resources"}."""
    g = cfg.scan_matcher.gicp
    dev = front_in[1].device
    resources = dict(kernels.loop_kernel_attributes(dev, GICP_VARIANT),
                     blocks_front=kernels.loop_grid(dev, front_in[1].shape[0], GICP_VARIANT),
                     blocks_verify=kernels.loop_grid(dev, verify_in[1].shape[0], GICP_VARIANT))
    resources["warps_per_sm"] = resources["blocks_per_sm"] * LOOP_TILE // 32
    say("gicp-loop-kernel", **resources)
    init = torch.as_tensor(perturbed(T_last), device=dev)
    vg = verify_in[5]
    stages = {"front": (gicp_loop_args(front_in, init, g), g),
              "verify": (gicp_loop_args(verify_in, verify_in[4], vg), vg)}
    recs = [compare_gicp_loop(f"{k}-perturbed", a) for k, (a, _) in stages.items()]
    recs.append(compare_gicp_loop("front-one-iteration", gicp_loop_args(front_in, init, g, 1),
                                  exact_inliers=True))
    grid = build_hash_grid(front_in[1], front_in[2], g.max_correspondence_distance)
    recip = gicp_loop_args(front_in, init, g, source_grid=grid)
    recs.append(compare_gicp_loop("front-reciprocal", recip))
    if not (recs[0]["done"] and recs[1]["done"] and recs[2]["iterations"] == 1):
        raise AssertionError(f"gicp loop fixtures: {recs}")
    err = max(r["T_max_abs_err"] for r in recs)

    par = None
    if parent:
        pk = tree_kernels(parent, "parent_kernels_gicp")
        par = (pk, tree_registration(parent, "gicp", pk, "parent_gicp"))
        for k, (a, _) in stages.items():
            same_carry_as_parent(k, a, pk)
        same_carry_as_parent("front-reciprocal", recip, pk)
    timing = {}
    for k, (a, gk) in stages.items():
        staged = stage_counts(a, resources["stage_runs"])
        say("gicp-loop-stage", stage=k, **staged)

        def align(mod, a=a, gk=gk):
            return mod.gicp_align(a[0], a[1], a[2], a[4], a[3],
                                  max_correspondence_distance=gk.max_correspondence_distance,
                                  transform_epsilon=gk.transform_epsilon,
                                  max_iterations=gk.max_iterations)
        t = in_turns("gicp-loop-turns", k,
                     lambda mods, a=a, align=align: gicp_loop_timings(
                         a, lambda: align(mods[1]), mods[0]),
                     (kernels, gicp), par, card)
        t.update(gicp_loop_bound_us(a), plain_ms=gicp_plain_launch_ms(a), N=a[1].shape[0],
                 stage_runs_p50=staged["runs_p50"], stage_runs_max=staged["runs_max"],
                 stage_overflow_runs=staged["overflow_runs"])
        t.update(device_us=t["working_launch_us"], host_us=t["stage_host_us"],
                 single_ms=t["stage_single_ms"],
                 share_of_bound=t["bound_us"] / t["working_launch_us"])
        say("gicp-loop-time", stage=k, **t, card=json.dumps(card))
        timing[f"gicp_loop_{k}"] = {"gicp_iteration": t}
    return dict(err=err, timing=timing, records=recs, resources=resources)


# -- the ICP loop on the device (the icp-loop phase) ---------------------------------------

# `icp_iteration` against its plain loop (the reference's body in torch ops, the carry
# frozen after done) on the same card tensors, to the NDT loop's bounds (LOOP_T_ATOL,
# LOOP_INLIERS_RTOL, LOOP_FITNESS_RTOL: float32 sums in other orders, the step from moments
# about an anchor and a one-sided Jacobi SVD against cuSOLVER's, the in-register transform
# against cuBLAS's `points @ R^T`); a loop cut at one iteration has exactly the plain loop's
# inliers (the same matches). `icp_fitness` against its plain version: the matched and
# valid counts exact, score and fraction to ICP_FITNESS_RTOL (sums in other orders).
ICP_FITNESS_RTOL = 1e-6
# Float operations of a working `icp_iteration` launch: per masked-in point the transform,
# its cell, the fitness term (a min and a sum) and the valid count (TRANSFORM_FLOPS_PER_POINT
# + CELL_FLOPS_PER_POINT + ICP_POINT_FLOPS); per candidate whose key is its cell's, d2 and
# the comparison (CANDIDATE_FLOPS); per matched point p - c and q - c (6), the nine products
# (9) and the 16 sums (ICP_MATCH_FLOPS); the step in one thread: six sweeps of three Jacobi
# rotations (~45 each), the rotation from the two pairs (~60), the means and the
# cross-covariance (~40), se3_log (~120) and the update (~40): ~1,100 (ICP_STEP_FLOPS). An
# `icp_fitness` launch: per point the transform, the cell, a min and three sums; per
# matched point a count and a sum. Bytes beyond the query's: the carry (CARRY_BYTES) and
# the anchor (12 B); the fitness launch's T (64 B) and outputs (8 B).
ICP_POINT_FLOPS = 3
ICP_MATCH_FLOPS = 31
ICP_STEP_FLOPS = 1100
ICP_FIT_POINT_FLOPS = 4
ICP_FIT_MATCH_FLOPS = 2
ICP_VERIFY_QUERY = (7, 16)  # the verifier's: 7 cells, 16-row buckets (graph/slam.py)
ICP_FRONT_QUERY = (7, 32)   # the ICP front end's (registration/icp.py:make_icp_matcher)


def icp_front_inputs(cfg: PipelineConfig, ring, last) -> dict:
    """The ICP front end's inputs on the dense course: the grid `make_icp_matcher` builds
    from the full ring (its cell the GICP config's correspondence distance, as
    `odometry/scan_matcher.py` passes it) and the last ring scan (N = 32,768), with the
    cloud the grid was built from."""
    g = cfg.scan_matcher.gicp
    points, mask = assemble_submap(ring, stride=cfg.scan_matcher.map_build_stride)
    build_target, _ = icp_module.make_icp_matcher(g, cell_size=g.max_correspondence_distance)
    return dict(grid=build_target(points, mask), cloud=(points, mask), points=last.points,
                mask=last.mask, cell=g.max_correspondence_distance)


def icp_front_args(cfg: PipelineConfig, inputs: dict, T0, max_iterations: int | None = None):
    """`icp_align_loop`'s arguments as the front end's `make_icp_matcher` align passes them."""
    g = cfg.scan_matcher.gicp
    d = min(g.max_correspondence_distance, inputs["cell"])
    return (inputs["grid"], inputs["points"], inputs["mask"], T0, d * d,
            max(g.transform_epsilon, 1e-7), 0.0,
            g.max_iterations if max_iterations is None else max_iterations, *ICP_FRONT_QUERY[::-1])


def icp_verify_inputs(back: GraphBasedSLAM, rec: dict) -> dict:
    """The ICP verifier's inputs for attempt `rec` of a back end (phase 12's): built by an
    ICP back end fed the same keyframes (the candidate's loop submap grid at 2 m cells and
    its pre-align map, the latest keyframe at 16,384 points) and the coarse pre-align's
    result, where the verifier's ICP loop starts."""
    cfg = dataclasses.replace(back.cfg, registration_method="ICP", async_backend=False)
    b = GraphBasedSLAM(cfg, back.capacity, device=back.device)
    for k in range(rec["latest"] + 1):
        cloud = back._cloud(k)
        b.add_keyframe({"pose": back.kf_front_poses[k], "cloud": cloud,
                        "cloud_mask": np.ones(cloud.shape[0], bool),
                        "accum_distance": back.kf_accum_dist[k]})
    inp = b._build_verify_inputs()
    grid, pre_map, _extra, _glob = inp["targets"][0]
    src_p, src_m, _ = inp["source"]
    pre = loop_pre_align(pre_map, src_p, src_m, torch.eye(4, device=src_p.device))
    mask = grid.keys != voxel.INVALID_KEY
    return dict(grid=grid, pre_map=pre_map, cloud=(grid.points, mask), points=src_p,
                mask=src_m, T_pre=pre.transform, cfg=cfg,
                cell=min(cfg.icp.max_correspondence_distance, 2.0))


def icp_verify_args(inputs: dict, max_iterations: int | None = None):
    """`icp_align_loop`'s arguments as `graph/slam.py:make_verify_one` passes them."""
    icp_cfg = inputs["cfg"].icp
    d = inputs["cell"]
    return (inputs["grid"], inputs["points"], inputs["mask"], inputs["T_pre"], d * d,
            max(icp_cfg.transform_epsilon, 1e-7), icp_cfg.euclidean_fitness_epsilon,
            icp_cfg.max_iterations if max_iterations is None else max_iterations,
            *ICP_VERIFY_QUERY[::-1])


def compare_icp_loop(label: str, args, exact_inliers: bool = False) -> dict:
    """The ICP kernel loop vs its plain loop on the same card tensors, plus a
    bit-identical rerun; returns the numbers of the comparison."""
    out = kernels.icp_align_loop(*args)
    again = kernels.icp_align_loop(*args)
    ref = kernels.icp_align_loop_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{label}: two ICP kernel loops differ")
    rec = dict(case=label, N=args[1].shape[0], max_iterations=args[7], iterations=int(out[2]),
               iterations_plain=int(ref[2]), done=bool(out[1]), done_plain=bool(ref[1]),
               T_max_abs_err=float((out[0] - ref[0]).abs().max()), inliers=int(out[4]),
               inliers_plain=int(ref[4]), fitness=float(out[3]), fitness_plain=float(ref[3]),
               bit_identical=True)
    say("icp-loop-check", **rec)
    inl_tol = 0 if exact_inliers else LOOP_INLIERS_RTOL * rec["inliers_plain"]
    if not (rec["T_max_abs_err"] <= LOOP_T_ATOL
            and rec["iterations"] == rec["iterations_plain"]
            and rec["done"] == rec["done_plain"]
            and abs(rec["inliers"] - rec["inliers_plain"]) <= inl_tol
            and rec["inliers_plain"] > 0
            and abs(rec["fitness"] - rec["fitness_plain"]) <= LOOP_FITNESS_RTOL
            * abs(rec["fitness_plain"])):
        raise AssertionError(f"{label}: ICP kernel loop vs plain {rec}")
    return rec


def icp_loop_bound_us(args) -> dict:
    """The least time for one working launch of `icp_iteration` on these inputs at T0:
    the mask (1 B a point), each masked-in point (12 B), the query's table cells and
    candidate rows (`nn_query_counts`), the carry and the anchor; the operations above."""
    grid, src, msk, T0, corr2 = args[:5]
    bucket_cap, neighborhood = args[8], args[9]
    c = nn_query_counts(grid, src, msk, T0, bucket_cap, neighborhood)
    matched = kernels.icp_match(grid, se3.transform_points(T0, src), msk, corr2, bucket_cap,
                                neighborhood)[3]
    n_match = int(matched.sum())
    nbytes = (src.shape[0] + 12 * c["points"] + 4 * c["table_cells"] + 16 * c["candidate_rows"]
              + CARRY_BYTES + 12)
    flops = ((TRANSFORM_FLOPS_PER_POINT + CELL_FLOPS_PER_POINT + ICP_POINT_FLOPS) * c["points"]
             + CANDIDATE_FLOPS * c["candidates"] + ICP_MATCH_FLOPS * n_match + ICP_STEP_FLOPS)
    return bound_of(nbytes, flops, matched=n_match, **c)


def icp_fitness_bound_us(grid, pts, msk, T, max_range: float, bucket_cap: int,
                         neighborhood: int) -> dict:
    """The least time for one `icp_fitness` launch on these inputs: the query's bytes as
    in `icp_loop_bound_us`, T and the two outputs; the operations above."""
    c = nn_query_counts(grid, pts, msk, T, bucket_cap, neighborhood)
    matched = kernels.icp_match(grid, se3.transform_points(T, pts), msk,
                                max_range * max_range, bucket_cap, neighborhood)[3]
    n_match = int(matched.sum())
    nbytes = (pts.shape[0] + 12 * c["points"] + 4 * c["table_cells"] + 16 * c["candidate_rows"]
              + 64 + 8)
    flops = ((TRANSFORM_FLOPS_PER_POINT + CELL_FLOPS_PER_POINT + ICP_FIT_POINT_FLOPS)
             * c["points"] + CANDIDATE_FLOPS * c["candidates"] + ICP_FIT_MATCH_FLOPS * n_match)
    return bound_of(nbytes, flops, matched=n_match, **c)


def icp_loop_timings(args, align) -> dict:
    """Device us per working launch and per early-exit launch of `icp_iteration`, and the
    host and device us of a whole align stage (`align()`), as `loop_timings` measures
    NDT's: a loop of 20 launches that all work (both epsilons 0), one of 1 working launch,
    and one of 1 working and 40 early-exit launches (epsilon 1e9)."""
    def loop(eps, its):
        return lambda: kernels.icp_align_loop(*args[:5], eps, 0.0, its, *args[8:])

    work = split_times(loop(0.0, 20), calls=10, warmup=2)
    one = split_times(loop(1e9, 1), calls=40, warmup=2)
    dead = split_times(loop(1e9, 41), calls=5, warmup=2)
    stage = split_times(align, calls=3, warmup=2)
    return dict(working_launch_us=(work["device_us"] - one["device_us"]) / 19,
                early_exit_launch_us=(dead["device_us"] - one["device_us"]) / 40,
                loop_host_us_20=work["host_us"], stage_host_us=stage["host_us"],
                stage_device_us=stage["device_us"], stage_single_ms=stage["single_ms"])


def icp_plain_launch_ms(args) -> float:
    """The plain version's time for one working launch's work on the card: one
    `icp_body_plain` (the transform, `nearest`, the SVD step with its host read, the
    fitness and the test) and the frozen carry's select."""
    grid, src, msk, T0, corr2, eps, fit_eps, _its, bucket_cap, neighborhood = args
    dev = src.device
    carry = (T0, torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.full((), torch.inf, device=dev), torch.zeros((), dtype=torch.int32, device=dev))

    def one():
        new = kernels.icp_body_plain(grid, src, msk, carry, corr2, eps, fit_eps, bucket_cap,
                                     neighborhood)
        return tuple(torch.where(carry[1], old, n) for old, n in zip(carry, new))

    return median_ms(one, calls=20)


def icp_fitness_check(label: str, grid, pts, msk, T, max_range: float, card: str) -> tuple:
    """`icp_fitness` against `icp_fitness_plain` at the verifier's query in both modes, on
    the same card tensors: the matched and valid counts exact (the fraction times the valid
    count), score and fraction to ICP_FITNESS_RTOL, a bit-identical rerun; device and host
    us a launch (`split_times`), the plain version's ms, the bound. Returns (max abs err,
    the "pcl" mode's timing record)."""
    nvalid = int(msk.sum())
    err, recs = 0.0, {}
    for mode in ("pcl", "penalized"):
        call = (grid, pts, msk, T, max_range, *ICP_VERIFY_QUERY[::-1], mode)
        out, again = kernels.icp_fitness(*call), kernels.icp_fitness(*call)
        ref = kernels.icp_fitness_plain(*call)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"{label}: two icp_fitness launches differ ({mode})")
        score, frac, rscore, rfrac = (float(x) for x in (*out, *ref))
        matched, rmatched = round(frac * nvalid), round(rfrac * nvalid)
        ok = (matched == rmatched and abs(frac - rfrac) <= ICP_FITNESS_RTOL * abs(rfrac)
              and (score == rscore or abs(score - rscore) <= ICP_FITNESS_RTOL * abs(rscore)))
        say("icp-fitness-check", case=label, mode=mode, valid=nvalid, matched=matched,
            matched_plain=rmatched, score=score, score_plain=rscore, frac=frac,
            frac_plain=rfrac, bit_identical=True)
        if not ok:
            raise AssertionError(f"{label}: icp_fitness vs plain ({mode}): {out} vs {ref}")
        if np.isfinite(rscore):
            err = max(err, abs(score - rscore), abs(frac - rfrac))
        t = split_times(kernels.icp_fitness, *call, calls=50, warmup=5)
        t.update(icp_fitness_bound_us(grid, pts, msk, T, max_range, *ICP_VERIFY_QUERY[::-1]),
                 plain_ms=median_ms(kernels.icp_fitness_plain, *call, calls=20), N=pts.shape[0],
                 mode=mode, library_ms=None)
        t.update(share_of_bound=t["bound_us"] / t["device_us"])
        say("icp-fitness-time", case=label, **t, card=json.dumps(card))
        recs[mode] = t
    return err, recs["pcl"]


def profile_icp_in_turns(label: str, inputs: dict, args, parent: str | None, card: str) -> dict:
    """One `icp_align` on a fixture under torch.profiler by `scripts/torch_profile_icp.py`
    in a subprocess: this tree's (one loop call, max_iterations launches, and the
    fitness's none), and with `parent` (the parent commit unpacked by `git archive`, whose
    ICP loop runs on the host) that tree's on the same input, in turns (this, parent,
    parent, this): wall and device ms, device launches, iterations and the transforms'
    largest difference. Returns the means by tree."""
    points, mask = inputs["cloud"]
    os.makedirs(os.path.join(REPO, ".chip_scratch"), exist_ok=True)
    path = os.path.join(REPO, ".chip_scratch", f"icp_profile_{label}.npz")
    np.savez(path, points=points.cpu().numpy(), mask=mask.cpu().numpy(), cell=inputs["cell"],
             source=args[1].cpu().numpy(), source_mask=args[2].cpu().numpy(),
             init=args[3].cpu().numpy(),
             settings=np.array([np.sqrt(args[4]), args[7], args[5], args[6], args[8], args[9]]))
    order = [("this", REPO)] if parent is None else [
        ("this", REPO), ("parent", parent), ("parent", parent), ("this", REPO)]
    out = {}
    try:
        for tree, root in order:
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "scripts", "torch_profile_icp.py"),
                 "--input", path, "--root", os.path.abspath(root)],
                cwd=os.path.abspath(root), capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"icp profile ({tree}) failed:\n{proc.stderr[-3000:]}")
            out.setdefault(tree, []).append(json.loads(proc.stdout.strip().splitlines()[-1]))
    finally:
        os.remove(path)
    summary = {tree: {k: float(np.mean([r[k] for r in runs])) for k in
                      ("wall_ms_per_align", "device_ms_per_align", "launches_per_align",
                       "idle_share", "iterations")}
               for tree, runs in out.items()}
    this = out["this"][0]
    extra = {}
    if "parent" in out:
        par = out["parent"][0]
        extra = dict(parent_iterations=par["iterations"], transform_max_diff_parent=float(
            np.abs(np.asarray(par["transform"]) - np.asarray(this["transform"])).max()))
    say("icp-profile", case=label, iterations=this["iterations"], **extra,
        mean=json.dumps(summary, separators=(",", ":")), card=json.dumps(card))
    if not all(r["converged"] for rs in out.values() for r in rs):
        raise AssertionError(f"icp profile {label}: {out}")
    return dict(summary, **extra)


def trajectories_in_turns(parent: str, courses) -> dict:
    """`scripts/torch_trajectories.py --courses ...` for this tree and `parent` (the parent
    commit unpacked by `git archive`) in turns (this, parent, parent, this), each in a
    subprocess, then `--compare`: per course and run (`0_this`, `1_parent`, `2_parent`,
    `3_this`) its bit-equality with the first run, its ATE, loops, stage p50s and verify
    p50 and max ms."""
    script = os.path.join(REPO, "scripts", "torch_trajectories.py")
    d = os.path.join(REPO, ".chip_scratch", "trajectories")
    os.makedirs(d, exist_ok=True)
    files = []
    for i, (tree, root) in enumerate((("this", REPO), ("parent", parent), ("parent", parent),
                                      ("this", REPO))):
        path = os.path.join(d, f"{i}_{tree}.npz")
        proc = subprocess.run([sys.executable, script, "--root", os.path.abspath(root), "--out",
                               path, "--courses", *courses], cwd=os.path.abspath(root),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"trajectories ({tree}) failed:\n{proc.stderr[-3000:]}")
        files.append(path)
    proc = subprocess.run([sys.executable, script, "--compare", *files], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"trajectories --compare failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def verification_sync_free(inputs: dict) -> dict:
    """One whole verification with the ICP verifier (`graph/slam.py:make_verify_one`: the
    coarse NDT pre-align, the ICP loop, the gate's fitness) on phase 12's inputs from the
    identity, after a warm-up one, under `torch.cuda.set_sync_debug_mode("error")`, which
    raises at the first synchronous read; its launches counted there."""
    from lidar_graph_slam_tpu_torch.graph.slam import make_verify_one

    verify = make_verify_one(inputs["cfg"], "ICP")
    call = (inputs["grid"], inputs["pre_map"], None,
            torch.eye(4, device=inputs["points"].device), inputs["points"], inputs["mask"])
    verify(*call)
    torch.cuda.synchronize()
    before = (kernels.icp_align_loop.launches, kernels.icp_fitness.launches)
    t0 = time.perf_counter()
    try:
        torch.cuda.set_sync_debug_mode("error")
        T, score, ok = verify(*call)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue_ms = 1000 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    total_ms = 1000 * (time.perf_counter() - t0)
    return dict(sync_reads=0, ok=bool(ok), fitness=float(score),
                icp_iteration_launches=kernels.icp_align_loop.launches - before[0],
                icp_fitness_launches=kernels.icp_fitness.launches - before[1],
                enqueue_ms=enqueue_ms, wall_ms=total_ms)


def icp_loop_phase(cfg: PipelineConfig, front: dict, verify: dict, T_last: np.ndarray,
                   card: str, parent: str | None = None) -> dict:
    """The icp-loop phase: `icp_iteration` (`icp_align_loop`) against the plain loop on the
    verifier's fixture (phase 12's loop submap grid and 16,384-point keyframe, from the
    pre-align's result) and the front end's (the full ring's grid and the last ring scan,
    N = 32,768, from a perturbed guess), and the front end's cut at one iteration (inliers
    exact); `icp_fitness` against its plain version at the verifier's result in both
    modes; per kernel the device us of a working (and an early-exit) launch, the host and
    device us of an align stage, the bound and the plain version's ms; the kernels'
    registers, shared memory and blocks; each fixture's align profiled, with `parent` in
    turns with the parent tree's host loop. Returns {"err", "fit_err", "timing",
    "records", "resources"}."""
    dev = front["points"].device
    resources = {
        name: dict(kernels.loop_kernel_attributes(dev, icp=(*q, fit)),
                   blocks=kernels.loop_grid(dev, n, icp=(*q, fit)))
        for name, q, fit, n in (
            ("icp_iteration_verify", ICP_VERIFY_QUERY, 0, verify["points"].shape[0]),
            ("icp_iteration_front", ICP_FRONT_QUERY, 0, front["points"].shape[0]),
            ("icp_fitness_verify", ICP_VERIFY_QUERY, 1, verify["points"].shape[0]))}
    for name, r in resources.items():
        say("icp-loop-kernel", kernel=name, **r)
    init = torch.as_tensor(perturbed(T_last), device=dev)
    stages = {"verify": icp_verify_args(verify), "front": icp_front_args(cfg, front, init)}
    recs = [compare_icp_loop(f"{k}-{'pre-align' if k == 'verify' else 'perturbed'}", a)
            for k, a in stages.items()]
    recs.append(compare_icp_loop("front-one-iteration", icp_front_args(cfg, front, init, 1),
                                 exact_inliers=True))
    if not (recs[0]["done"] and recs[1]["done"] and recs[2]["iterations"] == 1):
        raise AssertionError(f"icp loop fixtures: {recs}")
    err = max(r["T_max_abs_err"] for r in recs)
    out = kernels.icp_align_loop(*stages["verify"])
    fit_err, fit_t = icp_fitness_check("verify", verify["grid"], verify["points"],
                                       verify["mask"], out[0], verify["cell"], card)
    timing = {"icp_fitness_verify": {"icp_fitness": fit_t}}
    for k, a in stages.items():
        def align(a=a):
            return icp_module.icp_align(
                a[0], a[1], a[2], a[3], max_correspondence_distance=float(np.sqrt(a[4])),
                max_iterations=a[7], transform_epsilon=a[5], euclidean_fitness_epsilon=a[6],
                bucket_cap=a[8], neighborhood=a[9])
        t = icp_loop_timings(a, align)
        t.update(icp_loop_bound_us(a), plain_ms=icp_plain_launch_ms(a), N=a[1].shape[0],
                 library_ms=None)
        t.update(device_us=t["working_launch_us"], host_us=t["stage_host_us"],
                 single_ms=t["stage_single_ms"],
                 share_of_bound=t["bound_us"] / t["working_launch_us"])
        prof = profile_icp_in_turns(k, front if k == "front" else verify, a, parent, card)
        t.update(profile=prof)
        say("icp-loop-time", stage=k, **{x: (json.dumps(v, separators=(",", ":"))
                                            if isinstance(v, dict) else v)
                                         for x, v in t.items()}, card=json.dumps(card))
        timing[f"icp_loop_{k}"] = {"icp_iteration": t}
    return dict(err=err, fit_err=fit_err, timing=timing, records=recs, resources=resources)

def cli_command(out_dir: str, frames: int, loops: bool = False, sets=()) -> list:
    return [sys.executable, "-m", "lidar_graph_slam_tpu_torch.pipeline.cli", "--dataset",
            "synthetic", "--frames", str(frames), "--output", out_dir, "--progress-every", "0",
            *([] if loops else ["--no-loop-closure"]), *(a for v in sets for a in ("--set", v))]


def run_cli(out_dir: str, frames: int, loops: bool = False, sets=()) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(cli_command(out_dir, frames, loops, sets),
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
                ate_keyframes_m=summary["ate_keyframes_m"],
                frame_p50_ms=summary["frame_p50_ms"],
                ndt_loop_launches=summary["kernel_launches"]["ndt_align_loop"],
                ndt_loop_worked=summary["kernel_launches"]["ndt_iteration_worked"],
                gicp_loop_launches=summary["kernel_launches"]["gicp_align_loop"],
                gicp_loop_worked=summary["kernel_launches"]["gicp_iteration_worked"],
                icp_loop_launches=summary["kernel_launches"]["icp_align_loop"],
                icp_loop_worked=summary["kernel_launches"]["icp_iteration_worked"],
                icp_fitness_launches=summary["kernel_launches"]["icp_fitness"],
                ndt_accumulate_launches=summary["kernel_launches"]["ndt_accumulate"],
                finalize_launches=summary["kernel_launches"]["ndt_finalize"],
                eigh3x3_launches=summary["kernel_launches"]["eigh3x3"])


def global_register_check(dev, card: str) -> dict:
    """`global_register` at the default `GlobalRegConfig` on an 8,192-point scan and its
    copy moved by each of GLOBAL_OFFSETS, on the card and on the CPU: ok, and the
    recovered transform within GLOBAL_ROT_DEG / GLOBAL_TRANS_M of the truth. Times on the
    card: the whole call, and alone the SVDs it runs (one batch of 2,048 3x3 matrices and
    two single ones) and its [Q, M] feature product on its own features."""
    gr = GlobalRegConfig()
    rng = np.random.default_rng(0)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (8.0, -3.0, 1.5)
    tgt = simulate_scan(world, pose, rng, max_points=8192, noise=0.015)
    kw = dict(keypoint_leaf=gr.keypoint_leaf, normal_k=gr.normal_k, fpfh_k=gr.fpfh_k,
              hypotheses=gr.hypotheses, inlier_threshold=gr.inlier_threshold,
              min_occupancy=gr.min_occupancy, max_keypoints=gr.max_keypoints,
              tgt_viewpoint=np.zeros(3, np.float32))
    out = dict(points=len(tgt), keypoints=gr.max_keypoints, hypotheses=gr.hypotheses)
    for i, (yaw_deg, offset) in enumerate(GLOBAL_OFFSETS):
        a = np.deg2rad(yaw_deg)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     np.float32)
        t = np.asarray(offset, np.float32)
        src = ((tgt - t) @ R).astype(np.float32)
        sc = PointCloud.from_array(src, capacity=8192)
        tc = PointCloud.from_array(tgt, capacity=8192)
        for device in (dev, torch.device("cpu")):
            args = [x.to(device) for x in (sc.points, sc.mask, tc.points, tc.mask)]
            t0 = time.perf_counter()
            T, hits, ok, diag = features.global_register(*args, **kw, return_diag=True)
            T = T.cpu().numpy()
            seconds = time.perf_counter() - t0
            rot = float(np.rad2deg(np.arccos(np.clip(
                (np.trace(T[:3, :3].T @ R) - 1.0) / 2.0, -1.0, 1.0))))
            trans = float(np.linalg.norm(T[:3, 3] - t))
            if not (bool(ok) and rot < GLOBAL_ROT_DEG and trans < GLOBAL_TRANS_M):
                raise AssertionError(f"global_register on {device}, offset {i}: ok "
                                     f"{bool(ok)}, {rot} deg, {trans} m, {int(hits)} hits")
            tag = f"offset{i}_{device.type}"
            out.update({f"{tag}_rot_deg": rot, f"{tag}_trans_m": trans,
                        f"{tag}_hits": int(hits), f"{tag}_first_call_s": round(seconds, 3),
                        f"{tag}_families": json.dumps(
                            {k: int(v) for k, v in diag.items()}, separators=(",", ":"))})
        if i == 0:
            args = [x.to(dev) for x in (sc.points, sc.mask, tc.points, tc.mask)]
            out["call_ms"] = median_ms(lambda: features.global_register(*args, **kw),
                                       calls=10, warmup=2)
            S = torch.randn((gr.hypotheses, 3, 3), device=dev)

            def svds():
                torch.linalg.svd(S)
                torch.linalg.svd(S[0])
                torch.linalg.svd(S[1])

            out["svd_ms"] = median_ms(svds, calls=10, warmup=2)
            f_s = features.keypoint_features(args[0], args[1], gr.keypoint_leaf, gr.normal_k,
                                             gr.fpfh_k, gr.max_keypoints)[3]
            f_t = features.keypoint_features(args[2], args[3], gr.keypoint_leaf, gr.normal_k,
                                             gr.fpfh_k, gr.max_keypoints)[3]
            out["product_ms"] = median_ms(lambda: f_s @ f_t.T, calls=10, warmup=2)
            out["svd_share"] = out["svd_ms"] / out["call_ms"]
            out["product_share"] = out["product_ms"] / out["call_ms"]
    out["card"] = json.dumps(card)
    return out


def loop_fixture_keyframes(err_yaw: float = 0.4, err_xy=(4.0, -4.2), n_kf: int = 31):
    """The loop verifier fixture of the reference's tests: 31 keyframes of 4,096 points
    round a 20 m circle (1.02 laps), the last one reported with `err_yaw` / `err_xy` of
    drift. Returns (keyframe records, the last keyframe's true pose)."""
    rng = np.random.default_rng(7)
    world = make_world(rng, extent=40.0, density=2.0)
    traj = make_loop_trajectory(n_kf, radius=20.0, laps=1.02)
    err = np.eye(4, dtype=np.float32)
    err[:2, :2] = [[np.cos(err_yaw), -np.sin(err_yaw)], [np.sin(err_yaw), np.cos(err_yaw)]]
    err[0, 3], err[1, 3] = err_xy
    accum, prev, records = 0.0, traj[0], []
    for k in range(n_kf):
        true_pose = traj[k]
        accum += float(np.linalg.norm(true_pose[:3, 3] - prev[:3, 3])) if k else 0.0
        prev = true_pose
        scan = simulate_scan(world, true_pose, rng, max_points=4096, noise=0.01)
        last = k == n_kf - 1
        records.append({
            "pose": ((true_pose @ err) if last else true_pose).astype(np.float32),
            "cloud": scan, "cloud_mask": np.ones(scan.shape[0], bool),
            "accum_distance": accum + 110.0 if last else accum})
    return records, traj[-1]


def global_init_loop(device) -> dict:
    """One synchronous `try_close_loop` on the large-drift fixture, from the identity
    guess and from the FPFH+RANSAC guess, at the fixture's capacities and the default
    `GlobalRegConfig`. The loop kernel's launches on the global-init path (the pre-align
    from the global guess) are counted from 0 just before it and read just after, with
    how many of them did work; the verify thread launches those and the FPFH normals'
    `eigh3x3`, nothing else."""
    records, true_last = loop_fixture_keyframes()
    cap = CapacityConfig(max_keyframes=64, max_loop_factors=8, keyframe_points=4096,
                         loop_submap_points=65536, voxel_capacity=32768)
    backs = {}
    for use in (False, True):
        cfg = GraphSlamConfig(registration_method="ICP", accumulate_distance_threshold=100.0,
                              search_for_candidate_threshold=15.0,
                              icp=IcpConfig(max_iterations=40), use_global_init=use,
                              async_backend=False)
        b = GraphBasedSLAM(cfg, cap, device=device)
        for kf in records:
            b.add_keyframe(kf)
        backs[use] = b
    plain, glob = backs[False], backs[True]
    drifted = glob.optimized_poses()[-1]
    closed_plain = plain.try_close_loop()
    reset_counts()
    t0 = time.perf_counter()
    closed_glob = glob.try_close_loop()
    seconds = time.perf_counter() - t0
    counts = read_counts() if torch.device(device).type == "cuda" else dict.fromkeys(KERNELS, 0)
    rec = glob.loop_log[-1]
    err = float(np.linalg.norm((rec["transform"] @ drifted)[:3, 3] - true_last[:3, 3]))
    plain_fit = plain.loop_log[-1]["fitness"]
    if not (closed_glob and err < GLOBAL_LOOP_TRANS_M and "ransac_families" in rec
            and (not closed_plain or rec["fitness"] <= plain_fit)):
        raise AssertionError(f"global-init loop: closed {closed_glob}, corrected pose "
                             f"{err} m from truth, identity guess closed {closed_plain} "
                             f"({plain_fit}), log {glob.loop_log}")
    if torch.device(device).type == "cuda" and not (
            counts["ndt_align_loop"] > 0 and counts["ndt_accumulate"] == 0
            and counts["ndt_direct7_accumulate"] == 0
            and glob.verify_launches == counts["ndt_align_loop"] + counts["eigh3x3"]
            + counts["icp_align_loop"] + counts["icp_fitness"]
            and counts["eigh3x3"] > 0 and counts["icp_align_loop"] > 0
            and counts["icp_fitness"] == 1
            and 0 < counts["ndt_iteration_worked"] <= counts["ndt_align_loop"]):
        raise AssertionError(f"global-init loop: launches {counts}, verify thread "
                             f"{glob.verify_launches}")
    return dict(closed=closed_glob, corrected_pose_err_m=err, fitness=rec["fitness"],
                drift_m=float(np.linalg.norm(drifted[:3, 3] - true_last[:3, 3])),
                identity_closed=closed_plain, identity_fitness=plain_fit,
                ransac_families=json.dumps(rec["ransac_families"], separators=(",", ":")),
                kernel_launches=counts["ndt_align_loop"],
                kernel_launches_worked=counts["ndt_iteration_worked"],
                eigh3x3_launches=counts["eigh3x3"], attempt_ms=round(1000 * seconds, 3))


def resume_check(cfg: PipelineConfig, scans, cut: int, device, path: str) -> dict:
    """The course straight through, and cut at `cut`: saved, loaded onto `device`,
    continued. The resumed run must equal the uninterrupted one to RESUME_ATOL of its
    driver, with the same keyframe schedule."""
    whole = SlamPipeline(cfg, device=device)
    for s in scans:
        whole.process_scan(s)
    res_a = whole.result()
    first = SlamPipeline(cfg, device=device)
    for s in scans[:cut]:
        first.process_scan(s)
    t0 = time.perf_counter()
    checkpoint.save_pipeline(first, path)
    t1 = time.perf_counter()
    resumed = checkpoint.load_pipeline(path, device=device)
    t2 = time.perf_counter()
    for s in scans[cut:]:
        resumed.process_scan(s)
    res_c = resumed.result()
    atol = RESUME_ATOL[cfg.fused_frontend]
    diff = float(np.abs(res_c.odometry_poses - res_a.odometry_poses).max())
    kf_diff = float(np.abs(res_c.keyframe_poses - res_a.keyframe_poses).max()) \
        if res_c.keyframe_poses.shape == res_a.keyframe_poses.shape else float("inf")
    same = np.array_equal(res_c.keyframe_frame_indices, res_a.keyframe_frame_indices)
    if not (str(resumed.device) == str(whole.device) and same and diff <= atol
            and kf_diff <= atol):
        raise AssertionError(f"resume ({'fused' if cfg.fused_frontend else 'classic'}): "
                             f"odometry max diff {diff}, keyframes {kf_diff}, same "
                             f"schedule {same} (limit {atol})")
    return dict(driver="fused" if cfg.fused_frontend else "classic", frames=len(scans),
                cut=cut, keyframes=len(res_a.keyframe_frame_indices), device=str(resumed.device),
                odometry_max_diff=diff, keyframes_max_diff=kf_diff, limit=atol,
                file_mb=round(os.path.getsize(path) / 2**20, 3),
                save_ms=round(1000 * (t1 - t0), 3), load_ms=round(1000 * (t2 - t1), 3))


def write_kitti_layout(root: str, scans, gt) -> None:
    """`scans` and their poses in KITTI's odometry layout: velodyne/NNNNNN.bin (float32
    x, y, z, intensity), poses/00.txt (3x4 rows) and an identity `Tr` calib."""
    velo = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(velo)
    os.makedirs(os.path.join(root, "poses"))
    for i, scan in enumerate(scans):
        rec = np.zeros((scan.shape[0], 4), np.float32)
        rec[:, :3] = scan
        rec.tofile(os.path.join(velo, f"{i:06d}.bin"))
    np.savetxt(os.path.join(root, "poses", "00.txt"),
               np.stack([np.asarray(p, np.float64)[:3].reshape(-1) for p in gt]))
    with open(os.path.join(root, "sequences", "00", "calib.txt"), "w") as f:
        f.write("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")


def kitti_cli_run(scans, gt, out_dir: str) -> dict:
    """The KITTI path: the native library must be built (no numpy fallback), the
    read-ahead's scans equal `np.fromfile`'s, and the CLI reads the sequence in a
    subprocess with `--live-render`; its ATE comes from the poses file."""
    if not native.available():
        raise AssertionError("the native IO library did not build: g++ failed or is missing")
    root = os.path.join(REPO, ".chip_scratch", "kitti")
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_kitti_layout(root, scans, gt)
        cap = PipelineConfig().capacity.raw_points
        t0 = time.perf_counter()
        seq = KittiSequence(root, "00", max_points=cap)
        read = list(seq)  # through the native read-ahead
        read_s = time.perf_counter() - t0
        n_read = len(read)
        for i, ((scan, pose), f) in enumerate(zip(read, seq.files)):
            raw = np.fromfile(f, dtype=np.float32).reshape(-1, 4)[:cap, :3]
            if not (np.array_equal(scan, raw) and pose is not None):
                raise AssertionError(f"prefetcher: scan {i} differs from np.fromfile")
        del read
        if n_read != len(scans):
            raise AssertionError(f"prefetcher: {n_read} of {len(scans)} scans")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "lidar_graph_slam_tpu_torch.pipeline.cli", "--dataset",
             "kitti", "--kitti-root", root, "--sequence", "00", "--frames", str(len(scans)),
             "--output", out_dir, "--progress-every", "0", "--no-loop-closure",
             "--live-render", "20"], cwd=REPO, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if proc.returncode != 0:
        raise AssertionError(f"KITTI CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        m = json.load(f)
    travelled = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    bound = max(0.05 * travelled, 0.35)
    # The PNGs need matplotlib; without it the CLI says so once and carries on.
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    wanted = ["odometry_tum.txt", "odometry_kitti.txt", "keyframes_tum.txt", "map.pcd",
              "metrics.json"] + (["map.png", "live.png"] if have_mpl else [])
    missing = [f for f in wanted if not os.path.exists(os.path.join(out_dir, f))]
    if not (m["frames"] == len(scans) and m["device"] == "cuda" and m["keyframes"] >= 2
            and m["native_io"] is True and m["ate_keyframes_m"] < bound and not missing):
        raise AssertionError(f"KITTI CLI: {m}, missing {missing}, ATE bound {bound}")
    return dict(frames=m["frames"], keyframes=m["keyframes"], native_io=m["native_io"],
                native_built_here=native.build_info["built"],
                ate_keyframes_m=m["ate_keyframes_m"], ate_odometry_m=m["ate_odometry_m"],
                ate_bound_m=bound, files=len(wanted), matplotlib=have_mpl,
                prefetch_read_ms_per_scan=round(1000 * read_s / n_read, 3),
                mean_raw_points=int(np.mean([len(s) for s in scans])),
                seconds=round(seconds, 3))


def trace_frames(frames: int = 5) -> dict:
    """`utils.telemetry.trace("frame", profile_dir=...)` round a few frames, in a
    subprocess (`scripts/torch_trace_frames.py`): a profiler session can leave its
    process slower, and this process's frame times are read. The trace (tens of MB) is
    checked and removed."""
    out_dir = os.path.join(REPO, ".chip_scratch", "trace")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "torch_trace_frames.py"),
             "--frames", str(frames), "--profile-dir", out_dir],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"trace failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if not (rec["last_ms"] > 0 and os.path.exists(rec["trace_file"])
                and os.path.getsize(rec["trace_file"]) == rec["trace_bytes"] > 0
                and rec["device"] == "cuda" and rec["span_events"] >= 1):
            raise AssertionError(f"trace: {rec}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rec["trace_file"] = os.path.relpath(rec["trace_file"], REPO)
    return rec


def dense_courses(seeds, n_frames: int, max_points: int):
    """`dense_course` at each seed, in one spawned process a seed (a course takes ~0.75 s
    of CPU a frame to simulate)."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            len(seeds), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(dense_course, n_frames, max_points, s) for s in seeds]
        return [f.result() for f in futures]


def stack_course(courses, n: int):
    """Courses [(scans, gt)] as [B, F, n, 3] scans (padding PAD_VALUE), [B, F, n] masks and
    the ground truths."""
    B, F = len(courses), len(courses[0][0])
    scans = np.full((B, F, n, 3), PAD_VALUE, np.float32)
    masks = np.zeros((B, F, n), bool)
    for b, (sc, _) in enumerate(courses):
        for f, scan in enumerate(sc):
            k = min(len(scan), n)
            scans[b, f, :k], masks[b, f, :k] = scan[:k], True
    return scans, masks, [gt for _, gt in courses]


def batched_kernel_check(scans, masks, gts, card: str, dev=torch.device("cuda")) -> tuple:
    """The batched fused kernel at the multi-sequence odometry's shape: four sequences'
    fine maps (2 m, capacity 32,768) of a full 20-keyframe ring of their first frames at
    ground truth, each with its next frame (N = 32,768) at ground truth as the source.
    Against its plain version (REL/ABS, counts exact), row b against
    `ndt_direct7_accumulate` on sequence b bit for bit, two launches bit-identical; its
    device and host time beside four single launches', the plain version's, and the bound
    (the four sequences' bytes and operations, counted as `direct7_bound_us` does).
    Returns (max abs err, timing record); on the CPU (a rehearsal) no times."""
    cfg = PipelineConfig().scan_matcher
    W, B = cfg.max_scan_accumulate_num, scans.shape[0]
    maps, pts, msk = [], [], []
    for b in range(B):
        T = torch.as_tensor(gts[b][:W + 1], device=dev)
        ring = torch.as_tensor(scans[b, :W], device=dev)
        m = torch.as_tensor(masks[b, :W], device=dev)
        world = torch.where(m[..., None], ring @ T[:W, :3, :3].transpose(-1, -2)
                            + T[:W, None, :3, 3], ring)
        maps.append(build_ndt_map(world.reshape(-1, 3), m.reshape(-1), cfg.ndt.resolution,
                                  capacity=32768))
        src = torch.as_tensor(scans[b, W], device=dev)
        sm = torch.as_tensor(masks[b, W], device=dev)
        pts.append(torch.where(sm[:, None], src @ T[W, :3, :3].T + T[W, :3, 3], src))
        msk.append(sm)
    vmaps, p, m = kernels.stack_maps(maps), torch.stack(pts), torch.stack(msk)
    md1, md2 = magnusson_constants(vmaps.leaf, cfg.ndt.outlier_ratio)
    ws = -md1 * md2
    fn = kernels.ndt_direct7_accumulate_batched
    out, again = fn(vmaps, p, m, md2, ws), fn(vmaps, p, m, md2, ws)
    ref = kernels.ndt_direct7_accumulate_batched_plain(vmaps, p, m, md2, ws)
    err, rel = 0.0, 0.0
    for name, a, c, r in zip(DIRECT7_OUT, out, again, ref):
        if not torch.equal(a, c):
            raise AssertionError(f"batched kernel: {name} differs between two launches")
        for b in range(B):
            e = float((a[b] - r[b]).abs().max())
            exact = name in ("n_hit", "centre_count")
            bound = 0.0 if exact else REL * float(r[b].abs().max()) + ABS
            if not e <= bound:
                raise AssertionError(f"batched kernel, sequence {b}: {name} max err {e} > {bound}")
            err = max(err, e)
            rel = max(rel, e / max(float(r[b].abs().max()), 1e-30))
    singles = [kernels.ndt_direct7_accumulate(maps[b], p[b], m[b], md2[b], ws[b])
               for b in range(B)]
    for b in range(B):
        if not all(torch.equal(x[b], y) for x, y in zip(out, singles[b])):
            raise AssertionError(f"batched kernel: row {b} differs from the single launch")
    bounds = [direct7_bound_us(maps[b], p[b], m[b], float(out[3][b]), float(out[5][b]))
              for b in range(B)]
    nbytes, flops = sum(x["bytes"] for x in bounds), sum(x["flops"] for x in bounds)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    if dev.type != "cuda":
        return err, dict(B=B, n_hit=[int(x) for x in out[3]], bytes=nbytes, flops=flops)
    t = split_times(fn, vmaps, p, m, md2, ws)
    t_single = split_times(lambda: [kernels.ndt_direct7_accumulate(maps[b], p[b], m[b],
                                                                   md2[b], ws[b])
                                    for b in range(B)])
    rec = dict(kernel="ndt_direct7_accumulate_batched", shape="batch", B=B, N=p.shape[1],
               n_hit=[int(x) for x in out[3]], **t,
               plain_ms=median_ms(kernels.ndt_direct7_accumulate_batched_plain, vmaps, p, m,
                                  md2, ws, calls=10, warmup=2),
               bound_us=1e6 * max(t_bytes, t_ops), bytes=nbytes, flops=flops,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               singles_device_us=t_single["device_us"], singles_host_us=t_single["host_us"],
               max_rel_err=rel, rows_bit_equal_single=True, bit_identical=True)
    rec["share_of_bound"] = rec["bound_us"] / rec["device_us"]
    say("kernel-time", **{k: json.dumps(v) if isinstance(v, list) else v
                          for k, v in rec.items()}, card=json.dumps(card))
    return err, rec


def batch_odometry_check(scans, masks, gts, card: str) -> dict:
    """`batch_odometry` at full width: B sequences of F frames of N points under the default
    `ScanMatcherConfig` (20-keyframe ring, 2 m / 4 m), map capacity 32,768, counts set to 0
    just before and read just after (the batched loop kernel's). Every sequence's ATE
    within max(0.05 x travelled, 0.35) m, frame 0 a keyframe, >= 2 keyframes; the batch
    equals B runs of one bit for bit; the first 3 frames agree with the CPU's to 1e-4
    (`tests/test_torch_multi_sequence.py` against the reference). Frames per second over
    the batch, and the device's idle share from `scripts/torch_profile_batch.py` in a
    subprocess."""
    cfg = PipelineConfig().scan_matcher
    B, F = scans.shape[:2]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, outs = batch_odometry(scans, masks, cfg, map_capacity=32768, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if not (counts["ndt_align_loop_batched"] > 0 and counts["ndt_align_loop"] == 0
            and counts["ndt_direct7_accumulate_batched"] == 0
            and counts["ndt_direct7_accumulate"] == counts["ndt_accumulate"] == 0):
        raise AssertionError(f"batch odometry: launches {counts}")
    poses = outs["pose"].cpu().numpy()
    ates, bounds = [], []
    for b in range(B):
        travelled = float(np.sum(np.linalg.norm(np.diff(gts[b][:, :3, 3], axis=0), axis=1)))
        ates.append(ate_rmse(poses[b], gts[b], align=False))
        bounds.append(max(0.05 * travelled, 0.35))
    kf = outs["is_keyframe"].cpu().numpy()
    if not (all(a < bd for a, bd in zip(ates, bounds)) and kf[:, 0].all()
            and bool((final.kf_count >= 2).all()) and bool(outs["converged"][:, 1:].all())):
        raise AssertionError(f"batch odometry: ATE {ates} (bounds {bounds}), keyframes "
                             f"{kf.sum(axis=1)}, converged {outs['converged'].sum(dim=1)}")
    for b in range(B):
        _, one = batch_odometry(scans[b:b + 1], masks[b:b + 1], cfg, map_capacity=32768,
                                device="cuda")
        if not all(torch.equal(v[b], one[k][0]) for k, v in outs.items()):
            raise AssertionError(f"batch odometry: sequence {b} differs from its run alone")
    t0 = time.perf_counter()
    _, cpu = batch_odometry(scans[:, :3], masks[:, :3], cfg, map_capacity=32768, device="cpu")
    cpu_s = time.perf_counter() - t0
    dpose = float(np.abs(poses[:, :3] - cpu["pose"].numpy()).max())
    if not (dpose <= 1e-4 and np.array_equal(kf[:, :3], cpu["is_keyframe"].numpy())):
        raise AssertionError(f"batch odometry: card vs CPU first 3 frames {dpose}")
    path = os.path.join(REPO, ".chip_scratch", "batch_profile_input.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, scans=scans[:, :6], masks=masks[:, :6])
    try:
        proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                            "torch_profile_batch.py"),
                               "--input", path], cwd=REPO, capture_output=True, text=True,
                              timeout=600)
    finally:
        os.remove(path)
    if proc.returncode != 0:
        raise AssertionError(f"batch profile failed:\n{proc.stderr[-3000:]}")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    return dict(B=B, frames=F, points=scans.shape[2], ring_points=20 * scans.shape[2],
                ate_m=json.dumps([round(a, 5) for a in ates]),
                ate_bound_m=json.dumps([round(x, 3) for x in bounds]),
                keyframes=json.dumps(kf.sum(axis=1).tolist()),
                seconds=round(wall, 3), fps_over_batch=B * F / wall,
                frames_per_second_per_sequence=F / wall,
                launches=counts["ndt_align_loop_batched"],
                launches_worked=counts["ndt_iteration_worked"],
                card_vs_cpu_first3_max=dpose, cpu_first3_s=round(cpu_s, 3),
                batch_equals_single_runs=True, profile=json.dumps(prof, separators=(",", ":")))


def step_graph(kind: str, K: int, device):
    """The graph of the reference's test of each mesh step, at capacity K (the poses past
    its chain are inactive identity blocks of the K-block system): "schur"
    (`tests/test_schur.py`: 24 poses, 1 m steps with 0.01 rad of rotation noise, one loop
    (2, 23) at information 1e4) or "chain" (`tests/test_distributed.py`: 20 poses, one
    loop (0, 19))."""
    rng = np.random.default_rng(9 if kind == "schur" else 5)
    n, loop = (24, (2, 23)) if kind == "schur" else (20, (0, 19))
    g = gsolver.init_graph(K, 4, (1e-4,) * 6, device=device)
    T = torch.eye(4, device=device)
    g = gsolver.graph_add_keyframe(g, T, torch.eye(4, device=device))
    for _ in range(1, n):
        xi = np.concatenate([rng.normal(size=3) * 0.01,
                             [1.0, 0, 0.1] if kind == "schur" else [1.0, 0, 0]])
        meas = se3.se3_exp(torch.as_tensor(xi, dtype=torch.float32, device=device))
        T = T @ meas
        g = gsolver.graph_add_keyframe(g, T, meas)
    return gsolver.graph_add_loop(g, loop[0], loop[1], torch.eye(4, device=device),
                                  torch.full((6,), 1e4, device=device)), n


def drifted_line_graph(K: int, device, n: int = 128, n_loops: int = 8, seed: int = 0):
    """A drifted chain at capacity K: n poses 1 m apart (0.1 m of climb a step) whose
    odometry carries 3e-4 rad of rotation noise a step, and `n_loops` loop factors from
    poses along it back to pose 0, measured from the noise-free trajectory, at
    information 1e4. Returns (graph, the noise-free poses)."""
    rng = np.random.default_rng(seed)
    step = se3.se3_exp(torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.1])).numpy().astype(np.float64)
    truth, est, odo = [np.eye(4)], [np.eye(4)], [np.eye(4)]
    for _ in range(1, n):
        xi = torch.as_tensor(np.concatenate([rng.normal(size=3) * 3e-4, [0.0, 0.0, 0.0]]))
        meas = step @ se3.se3_exp(xi).numpy()
        truth.append(truth[-1] @ step)
        est.append(est[-1] @ meas)
        odo.append(meas)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    g = gsolver.init_graph(K, n_loops, (1e-4,) * 6, device=device)
    g = gsolver.graph_add_keyframes_batch(g, f32(est), f32(odo), n)
    for i in np.linspace(n // 8, n - 1, n_loops).astype(int):
        g = gsolver.graph_add_loop(g, int(i), 0, f32(np.linalg.inv(truth[i]) @ truth[0]),
                                   torch.full((6,), 1e4, device=device))
    return g, np.stack(truth)


def mesh_solve_check(device, slots: int = 4, K: int = 4096) -> dict:
    """The mesh solves at the capacity default K on a `slots`-slot mesh of one device
    (1,024 blocks a slot): one Schur step and one chain step on their reference tests'
    graphs (`step_graph`) against `solver._solve_step`, to those tests' tolerances (5e-3
    and 5e-4 on the poses); then `mesh_optimize` with each against `solver.optimize` on a
    drifted 128-pose chain (`drifted_line_graph`) to 1e-3, each below the start's cost.
    ms per step and per solve (the slots run one after another: no multi-card speed). A
    longer active chain is not compared: the float32 steps of the cyclic-reduction and
    blocked solves (the reference's algorithms, single-device and per slot alike) lose
    all digits there, which is why the back end solves in float64 on the host first."""
    dev = torch.device(device)
    mesh = Mesh((dev,) * slots, "pose")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    timed = dev.type == "cuda"
    damping = torch.tensor(1e-4, device=dev)
    out = dict(K=K, slots=slots, device=str(dev))
    for name, step, tol in (("schur", schur_graph_step, 5e-3),
                            ("chain", distributed_graph_step, 5e-4)):
        g, n = step_graph(name, K, dev)
        single = g.poses @ se3.se3_exp(gsolver._solve_step(g, g.poses, damping))
        poses = step(mesh, g, 1e-4)
        diff = float((poses[:n] - single[:n]).abs().max())
        if not (diff <= tol and float(gsolver.graph_cost(g, poses))
                < float(gsolver.graph_cost(g, g.poses))):
            raise AssertionError(f"mesh {name} step vs single: {diff} > {tol}")
        out[f"{name}_step_vs_single"] = diff
        out[f"{name}_step_ms"] = median_ms(step, mesh, g, 1e-4, calls=5, warmup=1) if timed else None
        out[f"single_step_ms_{name}_graph"] = median_ms(
            gsolver._solve_step, g, g.poses, damping, calls=5, warmup=1) if timed else None
    g, truth = drifted_line_graph(K, dev)
    sync()
    t0 = time.perf_counter()
    ref = gsolver.optimize(g, max_iterations=15)
    sync()
    out["optimize_ms"] = 1000 * (time.perf_counter() - t0)
    cost0 = float(gsolver.graph_cost(g, g.poses))
    for name in ("schur", "chain"):
        sync()
        t0 = time.perf_counter()
        res = mesh_optimize(mesh, g, max_iterations=15, solver=name)
        sync()
        diff = float((res.poses - ref.poses).abs().max())
        cost = float(gsolver.graph_cost(g, res.poses))
        if not (diff <= 1e-3 and cost < cost0):
            raise AssertionError(f"mesh_optimize {name}: {diff} from optimize, cost {cost} "
                                 f"(start {cost0})")
        out[f"mesh_optimize_{name}_vs_optimize"] = diff
        out[f"mesh_optimize_{name}_ms"] = 1000 * (time.perf_counter() - t0)
    n = truth.shape[0]
    out.update(cost_start=cost0, optimize_cost=float(gsolver.graph_cost(g, ref.poses)),
               drift_m=float(np.abs(g.poses[n - 1, :3, 3].cpu().numpy() - truth[-1, :3, 3]).max()),
               optimized_err_m=float(np.abs(ref.poses[:n, :3, 3].cpu().numpy()
                                            - truth[:, :3, 3]).max()))
    return out


def same_loops(ref, res, label: str) -> dict:
    """Two pipeline results hold the same attempts and decisions, fitness to 1e-4, and the
    same keyframes within 0.02 m (`tests/test_pipeline_mesh.py:140-149`)."""
    a = [(r["candidate"], r["accepted"]) for r in ref.loop_log]
    b = [(r["candidate"], r["accepted"]) for r in res.loop_log]
    dfit = max((abs(x["fitness"] - y["fitness"]) for x, y in zip(ref.loop_log, res.loop_log)
                if np.isfinite(x["fitness"])), default=0.0)
    dt = (float(np.linalg.norm(ref.keyframe_poses[:, :3, 3] - res.keyframe_poses[:, :3, 3],
                               axis=1).max())
          if ref.keyframe_poses.shape == res.keyframe_poses.shape else float("inf"))
    if not (a == b and ref.num_loop_closures == res.num_loop_closures and dfit <= 1e-4
            and dt <= 0.02):
        raise AssertionError(f"{label}: loops {res.num_loop_closures} vs "
                             f"{ref.num_loop_closures}, same decisions {a == b}, fitness "
                             f"{dfit}, keyframes {dt} m")
    return dict(loops_accepted=res.num_loop_closures, attempts=len(b),
                fitness_max_diff=dfit, keyframes_max_diff_m=dt)


def batch_slam_check(courses, n: int, card: str, dev=torch.device("cuda")) -> dict:
    """`batch_slam` on drift-course-like sequences on a 4-slot mesh of the card, loop
    attempts every 4 keyframes: >= 1 loop in all, and per sequence the optimized keyframe
    ATE <= 1.2 x the odometry's + 0.05 m (`tests/test_multi_sequence.py:97-99`)."""
    scans, masks, gts = stack_course(courses, n)
    reset_counts()
    t0 = time.perf_counter()
    results = batch_slam(scans, masks, PipelineConfig().scan_matcher, map_capacity=32768,
                         mesh=Mesh((dev,) * len(courses), "seq"), loop_every_keyframes=4)
    seconds = time.perf_counter() - t0
    counts = read_counts() if dev.type == "cuda" else {}
    loops, opt, odom = 0, [], []
    for b, res in enumerate(results):
        kf = res["keyframe_frame_indices"]
        opt.append(ate_rmse(res["keyframe_poses"], gts[b][kf], align=False))
        odom.append(ate_rmse(res["odometry_poses"][kf], gts[b][kf], align=False))
        loops += res["num_loop_closures"]
    if not (loops >= 1 and all(o <= 1.2 * d + 0.05 for o, d in zip(opt, odom))):
        raise AssertionError(f"batch_slam: {loops} loops, ATE {opt} vs odometry {odom}")
    return dict(B=len(results), frames=scans.shape[1], points=n, loops_accepted=loops,
                loops_per_sequence=json.dumps([r["num_loop_closures"] for r in results]),
                attempts=sum(len(r["loop_log"]) for r in results),
                ate_optimized_m=json.dumps([round(x, 5) for x in opt]),
                ate_odometry_m=json.dumps([round(x, 5) for x in odom]),
                seconds=round(seconds, 3),
                launches=json.dumps(counts, separators=(",", ":")), card=json.dumps(card))


MULTIHOST_PROCESSES = 2
# Two `--multihost` CLI runs against phase 13's: the reference's bound on the poses
# (`tests/multihost_worker.py:134`), metres and quaternion entries of the TUM rows.
MULTIHOST_POSE_ATOL = 1e-4


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multihost_env(port: int, rank: int) -> dict:
    """The `LGS_*` variables of process `rank` of a process group on localhost, and an
    equal share of the host's cores for its thread pools, as `torchrun` gives several
    processes on one host: two pools of every core each spin against each other (a
    12-frame CPU rehearsal took 57 s a process instead of 8 s alone)."""
    threads = max(1, (os.cpu_count() or 1) // MULTIHOST_PROCESSES)
    return {**os.environ, "LGS_COORDINATOR": f"127.0.0.1:{port}",
            "LGS_NUM_PROCESSES": str(MULTIHOST_PROCESSES), "LGS_PROCESS_ID": str(rank),
            "OMP_NUM_THREADS": str(threads)}


def run_processes(cmds, envs, logs, timeout: float) -> list:
    """Start every command at once (output to its log file), wait for all, and return
    each one's seconds from the common start. All are killed when one overruns its
    `timeout` or fails: the others would wait in a collective."""
    t0 = time.perf_counter()
    files = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for cmd, env, f in zip(cmds, envs, files)]
    seconds = [None] * len(procs)
    try:
        while None in seconds:
            for i, p in enumerate(procs):
                if seconds[i] is None and p.poll() is not None:
                    seconds[i] = time.perf_counter() - t0
                    if p.returncode != 0:
                        raise AssertionError(f"process {i} exited {p.returncode}: see {logs[i]}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"processes overran {timeout} s: see {logs}")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    return seconds


def read_tum(path: str) -> np.ndarray:
    """[N, 7]: tx ty tz qx qy qz qw of each TUM row (the stamp dropped)."""
    return np.loadtxt(path, ndmin=2)[:, 1:]


def multihost_cli(out_dir: str, frames: int, ref_dir: str, ref: dict, device: str = "cuda",
                  sets=()) -> dict:
    """Phase 13's CLI run again as two `--multihost` processes on `cuda:0` with `LGS_*`
    set: both exit 0; both trajectories equal; the keyframes and loops those of phase 13's
    run (`ref`, written to `ref_dir`) and the keyframe poses within MULTIHOST_POSE_ATOL
    of it. A multi-process run forces the synchronous back end, phase 13's is the
    asynchronous one. Each process's seconds, frame p50 and owned clouds."""
    port = free_port()
    outs = [out_dir] + [f"{out_dir}-p{r}" for r in range(1, MULTIHOST_PROCESSES)]
    cmd = cli_command(out_dir, frames, True, sets) + ["--multihost", "--device", device]
    seconds = run_processes(
        [cmd] * MULTIHOST_PROCESSES,
        [multihost_env(port, r) for r in range(MULTIHOST_PROCESSES)],
        [f"{o}.log" for o in outs], timeout=600)
    summaries = []
    for o in outs:
        with open(os.path.join(o, "metrics.json")) as f:
            summaries.append(json.load(f))
    texts = {name: [open(os.path.join(o, name)).read() for o in outs]
             for name in ("keyframes_tum.txt", "odometry_tum.txt", "odometry_kitti.txt")}
    ref_kf = read_tum(os.path.join(ref_dir, "keyframes_tum.txt"))
    kf = read_tum(os.path.join(out_dir, "keyframes_tum.txt"))
    pose_diff = float(np.abs(kf - ref_kf).max()) if kf.shape == ref_kf.shape else float("inf")
    s0 = summaries[0]
    owned = [s["keyframe_clouds_owned"] for s in summaries]
    if not (all(len(set(t)) == 1 for t in texts.values())
            and all(s["processes"] == MULTIHOST_PROCESSES and s["device"] == device
                    for s in summaries)
            and s0["keyframes"] == ref["keyframes"] and sum(owned) == s0["keyframes"]
            and s0["loop_closures"] == ref["loop_closures"] and 0 < owned[0] < s0["keyframes"]
            and all(s["kernel_launches"]["ndt_align_loop"] > 0 or device == "cpu"
                    for s in summaries)
            and pose_diff <= MULTIHOST_POSE_ATOL):
        raise AssertionError(f"multihost CLI: {summaries}, phase 13 {ref}, keyframe pose "
                             f"max diff {pose_diff}, equal files "
                             f"{ {k: len(set(t)) == 1 for k, t in texts.items()} }")
    out = dict(processes=MULTIHOST_PROCESSES, frames=frames, keyframes=s0["keyframes"],
               loop_closures=s0["loop_closures"],
               keyframe_pose_max_diff_vs_phase13=pose_diff,
               ate_keyframes_m=s0["ate_keyframes_m"],
               ate_keyframes_phase13_m=ref["ate_keyframes_m"],
               seconds_phase13=ref["seconds"], frame_p50_ms_phase13=ref["frame_p50_ms"],
               ndt_loop_launches_phase13=ref["ndt_loop_launches"],
               ndt_loop_worked_phase13=ref["ndt_loop_worked"])
    for r, (sec, s) in enumerate(zip(seconds, summaries)):
        out[f"seconds_p{r}"] = round(sec, 3)
        out[f"frame_p50_ms_p{r}"] = s["frame_p50_ms"]
        out[f"owned_clouds_p{r}"] = f"{s['keyframe_clouds_owned']}/{s['keyframes']}"
        out[f"ndt_loop_launches_p{r}"] = s["kernel_launches"]["ndt_align_loop"]
        out[f"ndt_loop_worked_p{r}"] = s["kernel_launches"]["ndt_iteration_worked"]
    return out


def mesh_step_worker(out_path: str, device: str = "cuda", K: int = 4096) -> int:
    """One process of phase 29 (b): join the process group from `LGS_*`, span a mesh of
    two slots of `cuda:0` a process, and run the Schur and chain steps at K on phase 26's
    graphs (`step_graph`); writes the poses and the ms of each step to `out_path`."""
    from lidar_graph_slam_tpu_torch.parallel import multihost
    from lidar_graph_slam_tpu_torch.parallel.distributed import span_processes

    if not multihost.initialize_from_env():
        raise RuntimeError("mesh worker: no process group configured in LGS_*")
    dev = torch.device(device)
    mesh = span_processes((dev, dev), "pose")
    out = {}
    for name, step in (("schur", schur_graph_step), ("chain", distributed_graph_step)):
        g, _ = step_graph(name, K, dev)
        out[name] = step(mesh, g, 1e-4).cpu().numpy()
        if dev.type == "cuda":
            out[f"{name}_ms"] = median_ms(step, mesh, g, 1e-4, calls=5, warmup=1)
    np.savez(out_path, **out)
    return 0


def multihost_mesh_steps(dev, K: int = 4096) -> dict:
    """Phase 29 (b): the chain and Schur steps at K on phase 26's graphs over two
    processes x two slots of `cuda:0` (`span_processes`, gloo collectives of host
    tensors) against the one-process 4-slot mesh of the card: the max difference of each
    process's poses (expected 0.0: the same sums in the same order) and the ms of a step
    in each process, beside the one-process mesh's."""
    dev = torch.device(dev)
    timed = dev.type == "cuda"
    ref, out = {}, dict(K=K, processes=MULTIHOST_PROCESSES, slots=4)
    mesh4 = Mesh((dev,) * 4, "pose")
    for name, step in (("schur", schur_graph_step), ("chain", distributed_graph_step)):
        g, _ = step_graph(name, K, dev)
        ref[name] = step(mesh4, g, 1e-4).cpu().numpy()
        out[f"{name}_step_ms_one_process"] = (
            median_ms(step, mesh4, g, 1e-4, calls=5, warmup=1) if timed else None)
    work = os.path.join(REPO, ".chip_scratch", "multihost_steps")
    os.makedirs(work, exist_ok=True)
    port = free_port()
    paths = [os.path.join(work, f"p{r}.npz") for r in range(MULTIHOST_PROCESSES)]
    seconds = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--mesh-worker", p, dev.type, str(K)]
         for p in paths],
        [multihost_env(port, r) for r in range(MULTIHOST_PROCESSES)],
        [p.replace(".npz", ".log") for p in paths], timeout=300)
    res = [dict(np.load(p)) for p in paths]
    for name in ("schur", "chain"):
        diff = max(float(np.abs(r[name] - ref[name]).max()) for r in res)
        if not (diff == 0.0 and np.array_equal(res[0][name], res[1][name])):
            raise AssertionError(f"cross-process {name} step: {diff} from the one-process "
                                 f"4-slot mesh")
        out[f"{name}_max_diff_vs_one_process"] = diff
        for r, rr in enumerate(res):
            out[f"{name}_step_ms_p{r}"] = float(rr[f"{name}_ms"]) if timed else None
    out["seconds"] = round(max(seconds), 3)
    return out


def parent_ms(t: dict):
    """The parent tree's working-launch ms of a phase 3b timing, or None without one."""
    us = t.get("parent_working_launch_us")
    return None if us is None else us / 1000


def kernel_record(name: str, timing: dict, max_err: float, shape: str = "fine",
                  source: str = "lidar_graph_slam_tpu_torch/csrc/ndt_accumulate.cu",
                  replaces: str = "lidar_graph_slam_tpu/ops/pallas_kernels.py:160",
                  replaces_commit: str | None = "4350000^", **launches) -> dict:
    """One kernel's entry of the JSON record: times at `shape`, its main path's (the
    others by shape), launches per path."""
    t = timing[shape][name]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "replaces_commit": replaces_commit,
        **launches,
        "max_abs_err": max_err,
        "ms": t["device_us"] / 1000,
        "host_ms": t["host_us"] / 1000,
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_us"] / 1000,
        "bound_by": t["bound_by"],
        "library_ms": t.get("library_ms"),
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
                    help="a tree of the parent commit (git archive): phases 3b, 7, 14b, 14c "
                         "and 16 time and profile it too, in turns")
    ap.add_argument("--mesh-worker", nargs=3, default=None, metavar=("OUT", "DEVICE", "K"),
                    help=argparse.SUPPRESS)  # one process of phase 29 (b)
    args = ap.parse_args(argv)
    if args.mesh_worker:
        out_path, device, K = args.mesh_worker
        return mesh_step_worker(out_path, device, int(K))
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sass = {"eigh3x3": sass_fast_path(library_sass(), "eigh3x3_kernel", 6)}
    say("sass", clock_max_sm_mhz=clock_mhz,
        **{f"eigh3x3_{k}": v for k, v in sass["eigh3x3"].items()})

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

    # -- 3b. ndt-loop: the loop kernels against the plain loop, the step without a read ---
    loop = ndt_loop_phase(cfg, fine, coarse, last, T_last, card, args.parent)
    max_err.update(ndt_iteration=loop["err"], ndt_iteration_batched=loop["batched_err"])
    timing.update(loop["timing"])
    say("ndt-loop-fused-steps", **fused_steps_sync_free(cfg, scans, gt, (coarse, fine), dev),
        card=json.dumps(card))

    # -- 4. the target rebuild on the full ring: bit-identical, its kernels vs plain -------
    rb = rebuild_phase(cfg, aux, ring, last, card, args.parent, sass, clock_mhz)
    timing.update(rb["timing"])
    say("map-build", **rb["numbers"], card=json.dumps(card))

    # -- 5. card vs the CPU plain path, first 3 frames -----------------------------------
    say("card-vs-cpu", **first_frames_agree(cfg, scans, ("cuda", "cpu")))

    # -- 6. the main path on the card; launches counted here only --------------------------
    reset_counts()
    stats = run_pipeline(cfg, scans, gt, "cuda")
    launches = read_counts()
    # The NDT loop kernel is the main path's; the accumulate kernels are not on it.
    per_frame = ndt_cfg.coarse_iterations + ndt_cfg.max_iterations + 2
    # Every target rebuild (the bootstrap frame's and each keyframe's) launches
    # `ndt_finalize` once a map; nothing on the NDT path launches `eigh3x3`.
    if not (launches["ndt_align_loop"] == per_frame * stats["frames"]
            and 0 < launches["ndt_iteration_worked"] < launches["ndt_align_loop"]
            and launches["ndt_direct7_accumulate"] == launches["ndt_accumulate"] == 0
            and launches["ndt_finalize"] == 2 * (stats["keyframes"] + 1)
            and launches["eigh3x3"] == 0):
        raise AssertionError(f"the main path's kernel launches: {launches}")
    say("pipeline", **stats, kernel_launches=launches["ndt_align_loop"],
        kernel_launches_worked=launches["ndt_iteration_worked"],
        kernel_launches_per_frame=per_frame, finalize_launches=launches["ndt_finalize"],
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
    # The odometry is NDT's: every ICP kernel launch of the course is the verify thread's.
    if not (on["loops_accepted"] >= 1 and launches_verify > 0
            and launches_course["ndt_accumulate"] == 0
            and launches_course["ndt_direct7_accumulate"] == 0
            and launches_course["icp_align_loop"] > 0 and launches_course["icp_fitness"] > 0
            and 0 < launches_course["icp_iteration_worked"] < launches_course["icp_align_loop"]
            and launches_verify >= launches_course["icp_align_loop"]
            + launches_course["icp_fitness"]
            and on["ate_keyframes_m"] < off["ate_keyframes_m"]):
        raise AssertionError(f"loop course: loops on {on}, off {off}, launches "
                             f"{launches_course}, verify {launches_verify}")
    odom_diff = float(np.abs(res_on.odometry_poses - res_off.odometry_poses).max())
    if not launches_course["ndt_finalize"] > 0:
        raise AssertionError(f"loop course: no ndt_finalize launch: {launches_course}")
    say("loop-course", p50_frame_ms=on["p50_frame_ms"], p50_frame_ms_loops_off=off["p50_frame_ms"],
        backend_p50_ms_on=on["stage_p50_ms"]["backend"],
        backend_p50_ms_off=off["stage_p50_ms"]["backend"],
        finalize_launches=launches_course["ndt_finalize"],
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
        ndt_launches_verify=launches_verify - launches_course["icp_align_loop"]
        - launches_course["icp_fitness"],
        icp_iteration_launches_verify=launches_course["icp_align_loop"],
        icp_iteration_launches_verify_worked=launches_course["icp_iteration_worked"],
        icp_fitness_launches_verify=launches_course["icp_fitness"],
        ndt_launches_total=launches_course["ndt_align_loop"],
        ndt_launches_worked=launches_course["ndt_iteration_worked"],
        odometry_on_vs_off_max_diff=odom_diff, card=json.dumps(card))

    # -- 10b. `ndt_finalize` on the drift course's last ring (~28% of its rows valid) -------
    drift_parent = None if args.parent is None else tree_kernels(args.parent,
                                                                 "parent_kernels_drift")
    timing.update(finalize_phase("drift", cfg_on, pipe_on._ring, card, drift_parent,
                                 sass["eigh3x3"]["instructions"], clock_mhz))
    drift_prof = profile_rebuild(cfg_on, pipe_on._ring, args.parent, card, tag="drift")

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
    front_in = gicp_front_inputs(cfg, ring, last)
    icp_front = icp_front_inputs(cfg, ring, last)
    verify_in = gicp_verify_inputs(back, first)
    for label, rows in (("gicp_front", gicp_front_rows(cfg, front_in, T_last)),
                        ("gicp_verify", gicp_verify_rows(verify_in))):
        err, timing[label] = gicp_rows_check(label, rows, card)
        max_err["ndt_accumulate"] = max(max_err["ndt_accumulate"], err)
    del ring

    # -- 14b. gicp-loop: the GICP loop kernel against the plain loop; the step without a read
    gloop = gicp_loop_phase(cfg, front_in, verify_in, T_last, card, args.parent)
    max_err["gicp_iteration"] = gloop["err"]
    timing.update(gloop["timing"])
    cfg_gicp = loops_off_config(["scan_matcher.registration_method=GICP"])
    say("gicp-loop-fused-steps", **fused_steps_sync_free(cfg_gicp, scans, gt, front_in[0], dev),
        card=json.dumps(card))
    del front_in, verify_in

    # -- 14c. icp-loop: the ICP loop kernel and the fitness against their plain versions;
    # a verification and the fused ICP step without a read ------------------------------
    icp_verify = icp_verify_inputs(back, first)
    iloop = icp_loop_phase(cfg, icp_front, icp_verify, T_last, card, args.parent)
    max_err.update(icp_iteration=iloop["err"], icp_fitness=iloop["fit_err"])
    timing.update(iloop["timing"])
    ver_sync = verification_sync_free(icp_verify)
    if not (ver_sync["ok"] and ver_sync["icp_fitness_launches"] == 1
            and ver_sync["icp_iteration_launches"] == icp_verify["cfg"].icp.max_iterations):
        raise AssertionError(f"icp verification without a read: {ver_sync}")
    say("icp-loop-verification", **ver_sync, card=json.dumps(card))
    cfg_icp = loops_off_config(["scan_matcher.registration_method=ICP"])
    say("icp-loop-fused-steps", **fused_steps_sync_free(cfg_icp, scans, gt, icp_front["grid"],
                                                        dev), card=json.dumps(card))
    del icp_front, icp_verify

    # -- 15. the GICP front end (fused driver, loops off); launches counted here only -----
    say("gicp-card-vs-cpu", **first_frames_agree(cfg_gicp, scans, ("cuda", "cpu")))
    reset_counts()
    # The JAX package holds phase 6's bound with GICP and with classic ICP on this
    # course (`scripts/jax_reference_dense.py`), so phases 15-16 assert it too.
    gicp_front = run_pipeline(cfg_gicp, scans, gt, "cuda")
    launches_gicp = read_counts()
    # The GICP loop kernel is this path's: max_iterations launches a frame (the
    # bootstrap frame's too, whose empty target matches nothing), none of the NDT kernels.
    g_its = cfg_gicp.scan_matcher.gicp.max_iterations
    # `eigh3x3` once a frame for the source's covariances and once a target rebuild.
    if not (launches_gicp["gicp_align_loop"] == g_its * gicp_front["frames"]
            and 0 < launches_gicp["gicp_iteration_worked"] < launches_gicp["gicp_align_loop"]
            and launches_gicp["ndt_accumulate"] == launches_gicp["ndt_direct7_accumulate"]
            == launches_gicp["ndt_align_loop"] == launches_gicp["ndt_finalize"] == 0
            and launches_gicp["eigh3x3"] >= gicp_front["frames"]):
        raise AssertionError(f"the GICP front end's kernel launches: {launches_gicp}")
    say("gicp-front-end", **gicp_front, kernel_launches=launches_gicp["gicp_align_loop"],
        kernel_launches_worked=launches_gicp["gicp_iteration_worked"],
        eigh3x3_launches=launches_gicp["eigh3x3"],
        prefilter_p50_ms=gicp_front["stage_p50_ms"]["prefilter"],
        card=json.dumps(card))

    # -- 16. the classic driver: NDT (phase 6's assertions), then ICP --------------------
    reset_counts()
    classic_ndt = run_pipeline(loops_off_config(["fused_frontend=False"]), scans, gt, "cuda")
    launches_classic = read_counts()
    reset_counts()
    classic_icp = run_pipeline(loops_off_config(["fused_frontend=False",
                                                 "scan_matcher.registration_method=ICP"]),
                               scans, gt, "cuda")
    launches_cicp = read_counts()
    if not (classic_ndt["driver"] == classic_icp["driver"] == "classic"
            and launches_classic["ndt_align_loop"] > 0
            and launches_classic["ndt_direct7_accumulate"] == 0
            and launches_cicp["icp_align_loop"] > 0
            and 0 < launches_cicp["icp_iteration_worked"] < launches_cicp["icp_align_loop"]
            and launches_cicp["gicp_align_loop"] == 0):
        raise AssertionError(f"classic driver: {classic_ndt}, {classic_icp}, launches "
                             f"{launches_classic}, {launches_cicp}")
    classic_icp.update(icp_iteration_launches=launches_cicp["icp_align_loop"],
                       icp_iteration_launches_worked=launches_cicp["icp_iteration_worked"])
    for name, st in (("ndt", classic_ndt), ("icp", classic_icp)):
        say("classic", method=name, **{k: json.dumps(v, separators=(",", ":"))
                                       if isinstance(v, dict) else v for k, v in st.items()},
            card=json.dumps(card))
    if args.parent:
        # Phase 10's verifications and phase 16's classic ICP against the parent tree's
        # (its ICP loop on the host), in turns.
        turns = trajectories_in_turns(args.parent, ("drift_icp", "dense_icp_classic"))
        for course, keys in (("drift_icp", ("verify_p50_ms", "verify_max_ms", "frame_p50_ms",
                                             "backend_p50_ms", "loops_accepted",
                                             "ate_keyframes_m", "bit_equal_first")),
                             ("dense_icp_classic", ("register_p50_ms", "frame_p50_ms",
                                                    "ate_keyframes_m", "bit_equal_first"))):
            say("icp-vs-parent", course=course, **{
                f"{k}_{run}": v[k] for run, v in turns[course].items() for k in keys},
                card=json.dumps(card))

    # -- 17. the GICP loop verifier on the drift course; launches counted here only --------
    reset_counts()
    pipe_g, res_g, gv = run_loop_course(
        apply_cli_overrides(PipelineConfig(), ["graph_slam.registration_method=GICP"]),
        dscans, dgt, "cuda")
    launches_gv = read_counts()
    # The odometry (NDT) launches only the NDT loop kernel: every GICP loop launch of this
    # run is the verify thread's, and nothing launches ndt_accumulate.
    if not (gv["loops_accepted"] >= 1 and gv["ate_keyframes_m"] < off["ate_keyframes_m"]
            and launches_gv["gicp_align_loop"] > 0 and launches_gv["gicp_iteration_worked"] > 0
            and launches_gv["ndt_accumulate"] == 0
            and pipe_g.back.verify_launches >= launches_gv["gicp_align_loop"]):
        raise AssertionError(f"GICP verifier: {gv}, loops off {off['ate_keyframes_m']}, "
                             f"launches {launches_gv}, verify {pipe_g.back.verify_launches}")
    say("gicp-verify", loops_accepted=gv["loops_accepted"],
        loops_attempted=gv["loops_attempted"], ate_keyframes_m=gv["ate_keyframes_m"],
        ate_keyframes_off_m=off["ate_keyframes_m"], ate_keyframes_icp_m=on["ate_keyframes_m"],
        p50_frame_ms=gv["p50_frame_ms"],
        stage_p50_ms=json.dumps(gv["stage_p50_ms"], separators=(",", ":")),
        verify_ms_p50=1000 * float(np.median(pipe_g.back.verify_seconds)),
        verify_ms_max=1000 * float(np.max(pipe_g.back.verify_seconds)),
        gicp_loop_launches_verify=launches_gv["gicp_align_loop"],
        gicp_loop_launches_verify_worked=launches_gv["gicp_iteration_worked"],
        ndt_accumulate_launches=launches_gv["ndt_accumulate"],
        verify_launches_all=pipe_g.back.verify_launches,
        odometry_vs_loops_off_max_diff=float(
            np.abs(res_g.odometry_poses - res_off.odometry_poses).max()),
        card=json.dumps(card))

    # -- 18. the CLI: classic driver, GICP front end --------------------------------------
    cli_g = run_cli(os.path.join(OUT_DIR, "cli_classic_gicp"), 60, loops=True,
                    sets=("fused_frontend=false", "scan_matcher.registration_method=GICP"))
    if not (cli_g["device"] == "cuda" and cli_g["fused_frontend"] is False
            and cli_g["registration_method"] == "GICP" and cli_g["gicp_loop_launches"] > 0
            and cli_g["gicp_loop_worked"] > 0 and cli_g["ndt_accumulate_launches"] == 0
            and cli_g["eigh3x3_launches"] > 0):
        raise AssertionError(f"CLI classic GICP: {cli_g}")
    say("cli-classic-gicp", **cli_g)

    # -- 19. FPFH + RANSAC global registration, card and CPU --------------------------------
    say("global-register", **global_register_check(dev, card))

    # -- 20. loop verification from the global guess; launches counted inside ---------------
    gl = global_init_loop("cuda")
    say("global-init-loop", **gl, card=json.dumps(card))
    reset_counts()
    pipe_gi, res_gi, gi = run_loop_course(
        apply_cli_overrides(PipelineConfig(), ["graph_slam.use_global_init=true"]),
        dscans, dgt, "cuda")
    launches_gi = read_counts()
    gi_log = [r for r in res_gi.loop_log if r["candidate"] >= 0]
    if not (gi["loops_accepted"] >= 1 and gi["ate_keyframes_m"] < off["ate_keyframes_m"]
            and pipe_gi.back.verify_launches > 0 and launches_gi["ndt_accumulate"] == 0
            and all("ransac_families" in r for r in gi_log)):
        raise AssertionError(f"global-init course: {gi}, loops off {off['ate_keyframes_m']}, "
                             f"launches {launches_gi}, verify {pipe_gi.back.verify_launches}")
    say("global-init-course", loops_accepted=gi["loops_accepted"],
        loops_attempted=gi["loops_attempted"], ate_keyframes_m=gi["ate_keyframes_m"],
        ate_keyframes_off_m=off["ate_keyframes_m"], ate_keyframes_identity_m=on["ate_keyframes_m"],
        p50_frame_ms=gi["p50_frame_ms"], p50_frame_ms_identity=on["p50_frame_ms"],
        stage_p50_ms=json.dumps(gi["stage_p50_ms"], separators=(",", ":")),
        verify_ms_p50=1000 * float(np.median(pipe_gi.back.verify_seconds)),
        verify_ms_max=1000 * float(np.max(pipe_gi.back.verify_seconds)),
        verify_ms_p50_identity=1000 * float(np.median(back.verify_seconds)),
        attempts_with_hypotheses=sum(r["ransac_families"]["n_3pt_valid"] + r["ransac_families"]["n_yaw_valid"]
                       > 0 for r in gi_log),
        best_is_yaw=sum(r["ransac_families"]["best_is_yaw"] for r in gi_log),
        ndt_launches_verify=pipe_gi.back.verify_launches - launches_gi["eigh3x3"]
        - launches_gi["icp_align_loop"] - launches_gi["icp_fitness"],
        icp_iteration_launches_verify=launches_gi["icp_align_loop"],
        eigh3x3_launches_verify=launches_gi["eigh3x3"],
        ndt_launches_total=launches_gi["ndt_align_loop"],
        ndt_launches_worked=launches_gi["ndt_iteration_worked"],
        odometry_vs_loops_off_max_diff=float(
            np.abs(res_gi.odometry_poses - res_off.odometry_poses).max()),
        card=json.dumps(card))
    # The verify thread's NDT loop launches: all of its launches but the FPFH normals'
    # `eigh3x3` and the ICP verifier's kernels (launched nowhere else on this NDT course).
    pipe_gi_verify_launches = (pipe_gi.back.verify_launches - launches_gi["eigh3x3"]
                               - launches_gi["icp_align_loop"] - launches_gi["icp_fitness"])
    del pipe_gi, res_gi

    # -- 21. checkpoint: cut at frame 20 of 40, saved, loaded onto the card, continued -------
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt_path = os.path.join(REPO, ".chip_scratch", "chip_smoke_state.npz")
    os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
    try:
        for overrides in (["fused_frontend=False"], []):
            say("checkpoint", **resume_check(loops_off_config(overrides), scans, 20, "cuda",
                                             ckpt_path), card=json.dumps(card))
    finally:
        if os.path.exists(ckpt_path):
            os.remove(ckpt_path)

    # -- 22. KITTI layout, native read-ahead, the CLI with --live-render ---------------------
    say("kitti-cli", **kitti_cli_run(scans, gt, os.path.join(OUT_DIR, "cli_kitti")),
        card=json.dumps(card))

    # -- 23. the profiler span, in a subprocess ----------------------------------------------
    say("trace", **trace_frames())

    # -- 24. the batched fused kernel at the multi-sequence shape ----------------------------
    t0 = time.perf_counter()
    bscans, bmasks, bgts = stack_course(dense_courses(BATCH_SEEDS, 40, 32768), 32768)
    say("batch-course", B=bscans.shape[0], frames=bscans.shape[1], points=bscans.shape[2],
        mean_points=float(bmasks.sum(axis=2).mean()), seconds=round(time.perf_counter() - t0, 3))
    err, rec = batched_kernel_check(bscans, bmasks, bgts, card)
    max_err["ndt_direct7_accumulate_batched"] = err
    timing["batch"] = {"ndt_direct7_accumulate_batched": rec}

    # -- 25. batch_odometry at full width; launches counted inside ---------------------------
    bo = batch_odometry_check(bscans, bmasks, bgts, card)
    say("batch-odometry", **bo, card=json.dumps(card))
    del bscans, bmasks

    # -- 26. the mesh solves on a 4-slot mesh of the card -----------------------------------
    say("mesh-solve", **mesh_solve_check("cuda"), card=json.dumps(card))

    # -- 27. the mesh pipeline on the drift course ------------------------------------------
    cfg_mesh = apply_cli_overrides(PipelineConfig(), ["parallel.use_mesh=true"])
    pipe_m1, res_m1, m1 = run_loop_course(cfg_mesh, dscans, dgt, "cuda")
    if pipe_m1.mesh.size != 1:
        raise AssertionError(f"mesh_devices=0 on one card: {pipe_m1.mesh}")
    say("mesh-pipeline", slots=1, loop_topk=1, **same_loops(res_on, res_m1, "mesh, 1 slot"),
        p50_frame_ms=m1["p50_frame_ms"], p50_frame_ms_phase10=on["p50_frame_ms"],
        card=json.dumps(card))
    del pipe_m1, res_m1
    topk = ["graph_slam.loop_topk=4"]
    cut = slice(0, TOPK_PAIR_FRAMES)
    _, res_k4, k4 = run_loop_course(apply_cli_overrides(PipelineConfig(), topk),
                                    dscans[cut], dgt[cut], "cuda")
    _, res_m4, m4 = run_loop_course(apply_cli_overrides(cfg_mesh, topk), dscans[cut],
                                    dgt[cut], "cuda", mesh=Mesh((dev,) * 4, "scan"))
    if k4["loops_accepted"] < 1:
        raise AssertionError(f"the top-4 pair's {TOPK_PAIR_FRAMES} frames closed no loop")
    say("mesh-pipeline", slots=4, loop_topk=4, frames=TOPK_PAIR_FRAMES,
        **same_loops(res_k4, res_m4, "mesh, 4 slots"), ate_keyframes_m=m4["ate_keyframes_m"],
        p50_frame_ms=m4["p50_frame_ms"], p50_frame_ms_unmeshed_topk4=k4["p50_frame_ms"],
        p50_frame_ms_phase10=on["p50_frame_ms"], card=json.dumps(card))
    del res_k4, res_m4

    # -- 28. batch_slam on drift-course-like sequences, a 4-slot mesh; launches inside -------
    bs = batch_slam_check([drift_course(130, 16384, seed=s_, laps=1.1) for s_ in SLAM_SEEDS],
                          16384, card)
    say("batch-slam", **bs)

    # -- 29. multi-host: two processes on the card (gloo process group) ----------------------
    mh_cli = multihost_cli(os.path.join(OUT_DIR, "cli_multihost"), 100,
                           os.path.join(OUT_DIR, "cli_loops"), cli_on)
    say("multihost-cli", **mh_cli, card=json.dumps(card))
    say("multihost-mesh-steps", **multihost_mesh_steps(dev), card=json.dumps(card))

    loop_src = "lidar_graph_slam_tpu_torch/csrc/ndt_loop.cu"
    finalize_src = "lidar_graph_slam_tpu_torch/csrc/voxel_finalize.cu"
    loop_fine = timing["loop_fine"]["ndt_iteration"]
    loop_batch = timing["loop_batch"]["ndt_iteration_batched"]
    print(json.dumps({"kernels": [
        kernel_record(
            "ndt_iteration", timing, max_err["ndt_iteration"], shape="loop_fine",
            source=loop_src, launches=launches["ndt_align_loop"],
            launches_worked=launches["ndt_iteration_worked"],
            path="every NDT iteration: fused and classic front ends, verify pre-align "
                 "(phase 6 counts the fused front end)",
            launches_verify=launches_verify,
            launches_loop_course=launches_course["ndt_align_loop"],
            launches_loop_course_worked=launches_course["ndt_iteration_worked"],
            launches_cli_loops=cli_on["ndt_loop_launches"],
            launches_cli_loops_worked=cli_on["ndt_loop_worked"],
            launches_multihost_cli_p0=mh_cli["ndt_loop_launches_p0"],
            launches_multihost_cli_p1=mh_cli["ndt_loop_launches_p1"],
            launches_global_init_loop=gl["kernel_launches"],
            launches_global_init_loop_worked=gl["kernel_launches_worked"],
            launches_global_init_course_verify=pipe_gi_verify_launches,
            loop_of="lidar_graph_slam_tpu/registration/ndt.py:135 (lax.while_loop)",
            fuses="lidar_graph_slam_tpu/ops/voxel.py:447 (lookup_direct7), the body's step "
                  "(registration/ndt.py:94-122)",
            early_exit_launch_ms=loop_fine["early_exit_launch_us"] / 1000,
            parent_ms=parent_ms(loop_fine),
            kernel_resources=loop["resources"],
            device_launches_per_align=prof["this"]["launches_per_align"],
            parent_device_launches_per_align=(prof["parent"]["launches_per_align"]
                                              if "parent" in prof else None)),
        kernel_record(
            "ndt_iteration_batched", timing, max_err["ndt_iteration_batched"],
            shape="loop_batch", source=loop_src, launches=bo["launches"],
            launches_worked=bo["launches_worked"], path="batch_odometry (phase 25)",
            launches_batch_slam=json.loads(bs["launches"])["ndt_align_loop_batched"],
            loop_of="lidar_graph_slam_tpu/registration/ndt.py:135 (lax.while_loop)",
            rows_bit_equal_single=True,
            early_exit_launch_ms=loop_batch["early_exit_launch_us"] / 1000,
            parent_ms=parent_ms(loop_batch)),
        kernel_record(
            "ndt_direct7_accumulate", timing, max_err["ndt_direct7_accumulate"],
            launches=launches["ndt_direct7_accumulate"],
            path="none since the NDT loop kernel (PR 8) runs its gather and accumulation; "
                 "measured in phases 3 and 12",
            launches_loop_course=launches_course["ndt_direct7_accumulate"],
            fuses="lidar_graph_slam_tpu/ops/voxel.py:447 (lookup_direct7)"),
        kernel_record(
            "gicp_iteration", timing, max_err["gicp_iteration"], shape="gicp_loop_front",
            source="lidar_graph_slam_tpu_torch/csrc/gicp_loop.cu",
            launches=launches_gicp["gicp_align_loop"],
            launches_worked=launches_gicp["gicp_iteration_worked"],
            path="every GICP iteration: the fused GICP front end (phase 15), the GICP "
                 "verifier (phase 17), the classic GICP CLI (phase 18)",
            launches_gicp_verify=launches_gv["gicp_align_loop"],
            launches_gicp_verify_worked=launches_gv["gicp_iteration_worked"],
            launches_cli_classic_gicp=cli_g["gicp_loop_launches"],
            launches_cli_classic_gicp_worked=cli_g["gicp_loop_worked"],
            loop_of="lidar_graph_slam_tpu/registration/gicp.py:191 (lax.while_loop)",
            fuses="lidar_graph_slam_tpu/ops/neighbors.py:103-177 (_candidate_scan, "
                  "nearest), the body's rows and step (registration/gicp.py:146-178)",
            early_exit_launch_ms=timing["gicp_loop_front"]["gicp_iteration"][
                "early_exit_launch_us"] / 1000,
            parent_ms=parent_ms(timing["gicp_loop_front"]["gicp_iteration"]),
            parent_ms_verify=parent_ms(timing["gicp_loop_verify"]["gicp_iteration"]),
            kernel_resources=gloop["resources"]),
        kernel_record(
            "icp_iteration", timing, max_err["icp_iteration"], shape="icp_loop_verify",
            source="lidar_graph_slam_tpu_torch/csrc/icp_loop.cu",
            replaces="lidar_graph_slam_tpu/registration/icp.py:47", replaces_commit=None,
            launches=launches_course["icp_align_loop"],
            launches_worked=launches_course["icp_iteration_worked"],
            path="every ICP iteration: the default loop verifier (phase 10 counts its verify "
                 "thread), the classic and fused ICP front ends (phases 16, 14c)",
            ports="the jitted lax.while_loop of icp_align (lidar_graph_slam_tpu/registration/"
                  "icp.py:114, body :73-101, _umeyama_step :30) around nearest "
                  "(ops/neighbors.py:103-177); no Pallas kernel",
            launches_classic_icp=launches_cicp["icp_align_loop"],
            launches_classic_icp_worked=launches_cicp["icp_iteration_worked"],
            launches_cli_loops=cli_on.get("icp_loop_launches"),
            early_exit_launch_ms=timing["icp_loop_verify"]["icp_iteration"][
                "early_exit_launch_us"] / 1000,
            kernel_resources=iloop["resources"]),
        kernel_record(
            "icp_fitness", timing, max_err["icp_fitness"], shape="icp_fitness_verify",
            source="lidar_graph_slam_tpu_torch/csrc/icp_loop.cu",
            replaces="lidar_graph_slam_tpu/registration/icp.py:155", replaces_commit=None,
            launches=launches_course["icp_fitness"],
            path="every loop verification's gate, whatever the verifier (phase 10 counts the "
                 "drift course's)",
            ports="fitness_and_match_fraction inside the jitted verification "
                  "(lidar_graph_slam_tpu/graph/slam.py:152-155); no Pallas kernel",
            launches_gicp_verify=launches_gv["icp_fitness"],
            launches_cli_loops=cli_on.get("icp_fitness_launches")),
        kernel_record(
            "ndt_accumulate", timing, max_err["ndt_accumulate"], shape="gicp_front",
            launches=ls["launches"],
            path="the NDT line search (phase 8); GICP no longer launches it (phases 15, "
                 "17, 18 count 0); measured on GICP's rows in phase 14",
            launches_gicp_front_end=launches_gicp["ndt_accumulate"],
            launches_gicp_verify=launches_gv["ndt_accumulate"],
            launches_cli_classic_gicp=cli_g["ndt_accumulate_launches"],
            launches_line_search=ls["launches"],
            launches_ndt_main_path=launches["ndt_accumulate"],
            launches_icp_loop_course=launches_course["ndt_accumulate"]),
        kernel_record(
            "ndt_finalize", timing, max_err["ndt_finalize"], shape="finalize_fine",
            source=finalize_src, replaces="lidar_graph_slam_tpu/ops/voxel.py:300",
            replaces_commit=None, launches=launches["ndt_finalize"],
            path="every NDT target build: the front ends' rebuilds, each loop attempt's "
                 "maps, batch_odometry (phase 6 counts the fused front end)",
            ports="the jitted programs build_ndt_map / build_ndt_pyramid "
                  "(lidar_graph_slam_tpu/ops/voxel.py:341,360): the moments of "
                  "_sorted_voxel_stats :257 and the coarse merge :360-436, _finalize_ndt "
                  ":300 with regularize_covariance :246 and _eigh3x3 :182; no Pallas kernel",
            launches_loop_course=launches_course["ndt_finalize"],
            launches_cli_loops=cli_on["finalize_launches"],
            bit_equal_plain=True, **{k: rb["numbers"][k] for k in (
                "wrapper_launches_per_rebuild", "launches_per_rebuild",
                "plain_launches_per_rebuild", "rebuild_wall_ms", "rebuild_device_ms",
                "plain_rebuild_wall_ms", "parent_rebuild_wall_ms",
                "parent_rebuild_device_ms")},
            drift_rebuild_device_ms=drift_prof["kernel"]["device_ms"],
            drift_parent_rebuild_device_ms=drift_prof.get("parent", {}).get("device_ms"),
            drift_launches_per_rebuild=drift_prof["kernel"]["launches"]),
        kernel_record(
            "eigh3x3", timing, max_err["eigh3x3"], shape="eigh_target", source=finalize_src,
            replaces="lidar_graph_slam_tpu/ops/voxel.py:182", replaces_commit=None,
            launches=launches_gicp["eigh3x3"],
            path="GICP's covariances (each frame's source, each target build) and the FPFH "
                 "normals (phase 15 counts the fused GICP front end)",
            ports="_eigh3x3 (lidar_graph_slam_tpu/ops/voxel.py:182) inside the jitted "
                  "estimate_covariances (registration/gicp.py:61) and the FPFH normals "
                  "(registration/features.py:58); no Pallas kernel",
            launches_global_init_loop=gl["eigh3x3_launches"],
            launches_cli_classic_gicp=cli_g["eigh3x3_launches"], bit_equal_plain=True),
        kernel_record(
            "ndt_direct7_accumulate_batched", timing, max_err["ndt_direct7_accumulate_batched"],
            shape="batch", launches=0,
            path="none since the batched NDT loop kernel (PR 8); measured in phase 24",
            launches_batch_slam=json.loads(bs["launches"])["ndt_direct7_accumulate_batched"],
            max_rel_err=rec["max_rel_err"], rows_bit_equal_single=True,
            singles_device_ms=rec["singles_device_us"] / 1000,
            singles_host_ms=rec["singles_host_us"] / 1000),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
