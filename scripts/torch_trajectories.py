"""Trajectories of one tree of the port on a CUDA card, and their comparison with another's.

    python3 scripts/torch_trajectories.py --root DIR --out FILE.npz [--courses NAME ...]
    python3 scripts/torch_trajectories.py --compare A.npz B.npz [C.npz ...]

With `--root`, the package and `chip_smoke.py` under DIR (this checkout, or a parent
commit unpacked with `git archive`) run four of `chip_smoke.py`'s courses on the card at
the default config: the 40-frame dense course through the fused front end with loops
off, NDT (phase 6) and GICP (phase 15), and the 360-frame drift course with loops on,
with the ICP verifier (phase 10) and with the GICP verifier (phase 17); `--courses` runs
those named instead, among them `dense_icp_classic` and `dense_ndt_classic`, the dense
course through the classic driver with ICP and with NDT (phase 16), and `cli_gicp_classic`, the CLI's 60-frame synthetic course
(seed 0) through the classic driver with GICP and loops on, as phase 18 runs the CLI, and
`drift_global`, the drift course with `graph_slam.use_global_init=true` (phase 20), and
`drift_topk4`, the drift course's first 130 frames with `graph_slam.loop_topk=4` (phase
27's unmeshed run). It
writes each run's odometry and keyframe poses, its loop
attempts (candidate, accepted, fitness), its keyframe ATE, the loop kernels' launches
that did work, the p50 ms of the frame and of the pipeline's stages (`prefilter`: the
host's enqueue of the fused step; `register`: the classic driver's align; `backend`: the
ring insert and target rebuild of a keyframe and the loop back end), and the p50 and max
ms of the loop verifications (`GraphBasedSLAM.verify_seconds`), the p50 and max of the
`backend` stage at the tick frames that start an attempt (`tick_backend`), and the programs the
front end captured (`SlamPipeline.programs`, or on an older tree the fused front end's
`FusedFrontEnd.captures`: 0 on a tree that dispatches its operators one by one). With
`--compare`, per course and file: whether its poses and loop attempts equal the first
file's bit for bit, the poses' largest difference from them, the first frame whose
odometry pose differs from theirs and the first whose position is 5 cm or more away, and
its numbers; one JSON line. Trees in turns (this, parent, parent, this) give the stage
times a pairing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

COURSES = ("dense", "dense_gicp", "drift_icp", "drift_gicp")
TOPK_FRAMES = 130  # `chip_smoke.py`'s TOPK_PAIR_FRAMES
EXTRA = ("dense_icp_classic", "dense_ndt_classic", "cli_gicp_classic", "drift_global",
         "drift_topk4")
NUMBERS = ("ate_keyframes_m", "loops_accepted", "ndt_worked", "gicp_worked", "captures")
STAGES = ("frame", "prefilter", "register", "backend")


def captures(pipe) -> int:
    """The programs `pipe`'s front end captured (a tree before `SlamPipeline.programs`:
    its fused front end's, or none)."""
    if hasattr(pipe, "programs"):
        return sum(p.captured for p in pipe.programs.values())
    return getattr(getattr(pipe, "fused_front", None), "captures", 0)


def run_tree(root: str, out: str, courses=COURSES) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides
    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dense = chip_smoke.dense_course(40)
    drift = (chip_smoke.drift_course() if any(c.startswith("drift") for c in courses)
             else None)
    cli = None
    if "cli_gicp_classic" in courses:
        from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence

        # `pipeline/cli.py --dataset synthetic --frames 60`'s sequence.
        seq = SyntheticSequence(n_frames=60, seed=0, laps=min(1.08, 1.08 * 60 / 100.0))
        T0_inv = np.linalg.inv(seq.poses[0])
        cli = ([scan for scan, _ in seq],
               np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses]))
    runs = {"dense": (chip_smoke.loops_off_config(), dense),
            "dense_icp_classic": (chip_smoke.loops_off_config(
                ["fused_frontend=False", "scan_matcher.registration_method=ICP"]), dense),
            "dense_ndt_classic": (chip_smoke.loops_off_config(["fused_frontend=False"]), dense),
            "dense_gicp": (chip_smoke.loops_off_config(
                ["scan_matcher.registration_method=GICP"]), dense),
            "drift_icp": (PipelineConfig(), drift),
            "drift_gicp": (apply_cli_overrides(PipelineConfig(),
                                               ["graph_slam.registration_method=GICP"]),
                           drift),
            "cli_gicp_classic": (apply_cli_overrides(PipelineConfig(), [
                "fused_frontend=False", "scan_matcher.registration_method=GICP"]), cli),
            "drift_global": (apply_cli_overrides(PipelineConfig(),
                                                 ["graph_slam.use_global_init=true"]), drift),
            "drift_topk4": (apply_cli_overrides(PipelineConfig(), ["graph_slam.loop_topk=4"]),
                            drift and (drift[0][:TOPK_FRAMES], drift[1][:TOPK_FRAMES]))}
    arrays = {}
    for name in courses:
        cfg, (scans, gt) = runs[name]
        kernels.load_library()
        kernels.worked_launches(reset=True)
        pipe = SlamPipeline(cfg, device="cuda")
        ticks, begin = [], pipe.back.begin_loop_attempt

        def recorded(backend=pipe.timings["backend"], begin=begin, ticks=ticks):
            pending = begin()
            if pending is not None:
                ticks.append(len(backend))  # the index of this frame's backend time
            return pending

        pipe.back.begin_loop_attempt = recorded
        walls = []
        for scan in scans:
            t0 = time.perf_counter()
            pipe.process_scan(scan)
            walls.append(time.perf_counter() - t0)
        res = pipe.result()
        del pipe.back.begin_loop_attempt
        torch.cuda.synchronize()
        ver = 1000 * np.asarray(pipe.back.verify_seconds, np.float64)
        tick = 1000 * np.asarray([pipe.timings["backend"][i] for i in ticks], np.float64)
        kf = np.asarray(res.keyframe_frame_indices)
        loops = np.array([(r["candidate"], r["accepted"], r["fitness"]) for r in res.loop_log
                          if r["candidate"] >= 0], np.float64).reshape(-1, 3)
        arrays.update({
            f"{name}_odometry": res.odometry_poses, f"{name}_keyframes": res.keyframe_poses,
            f"{name}_loops": loops,
            f"{name}_numbers": np.array([
                ate_rmse(res.keyframe_poses, gt[kf], align=False), res.num_loop_closures,
                kernels.worked_launches(kernel="ndt_iteration"),
                kernels.worked_launches(kernel="gicp_iteration"),
                captures(pipe)], np.float64),
            f"{name}_ms": np.array([1000 * np.median(walls[1:])] + [
                res.metrics[k]["p50_ms"] if k in res.metrics else np.nan
                for k in STAGES[1:]], np.float64),
            f"{name}_verify_ms": np.array([np.median(ver), ver.max(), ver.size] if ver.size
                                          else [np.nan, np.nan, 0], np.float64),
            f"{name}_tick_backend_ms": np.array([np.median(tick), tick.max(), tick.size]
                                                if tick.size else [np.nan, np.nan, 0],
                                                np.float64)})
    np.savez(out, **arrays)
    return 0


def compare(paths) -> int:
    import numpy as np

    files = [np.load(p) for p in paths]
    labels = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    out = {}
    for name in [c for c in COURSES + EXTRA if f"{c}_odometry" in files[0]]:
        first = files[0]
        rows = {}
        for label, f in zip(labels, files):
            same = all(f[f"{name}_{k}"].shape == first[f"{name}_{k}"].shape
                       and np.array_equal(f[f"{name}_{k}"], first[f"{name}_{k}"])
                       for k in ("odometry", "keyframes", "loops"))
            a, b = f[f"{name}_odometry"], first[f"{name}_odometry"]
            parts, far = [], []
            if a.shape == b.shape:
                parts = np.flatnonzero((a != b).reshape(len(a), -1).any(axis=1))
                far = np.flatnonzero(np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1) >= 0.05)
            rows[label] = {
                "bit_equal_first": bool(same),
                "odometry_max_diff_first": (float(np.abs(a - b).max())
                                            if a.shape == b.shape else None),
                "first_frame_parting": int(parts[0]) if len(parts) else None,
                "first_frame_5cm_apart": int(far[0]) if len(far) else None,
                **{k: float(v) for k, v in zip(NUMBERS, f[f"{name}_numbers"])},
                **{f"{k}_p50_ms": round(float(v), 3) for k, v in zip(STAGES, f[f"{name}_ms"])},
                **({f"verify_{k}_ms": round(float(v), 3) for k, v in zip(
                    ("p50", "max"), f[f"{name}_verify_ms"])} if f"{name}_verify_ms" in f else {}),
                **({f"tick_backend_{k}_ms": round(float(v), 3) for k, v in zip(
                    ("p50", "max"), f[f"{name}_tick_backend_ms"])}
                   if f"{name}_tick_backend_ms" in f else {})}
        out[name] = rows
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs="+", metavar="NPZ")
    ap.add_argument("--courses", nargs="+", choices=COURSES + EXTRA, default=list(COURSES))
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    if not (args.root and args.out):
        ap.error("--root and --out, or --compare NPZ ...")
    return run_tree(args.root, args.out, tuple(args.courses))


if __name__ == "__main__":
    sys.exit(main())
