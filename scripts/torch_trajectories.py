"""Trajectories of one tree of the port on a CUDA card, and their comparison with another's.

    python3 scripts/torch_trajectories.py --root DIR --out FILE.npz [--courses NAME ...]
    python3 scripts/torch_trajectories.py --compare A.npz B.npz [C.npz ...]

With `--root`, the package and `chip_smoke.py` under DIR (this checkout, or a parent
commit unpacked with `git archive`) run four of `chip_smoke.py`'s courses on the card at
the default config: the 40-frame dense course through the fused front end with loops
off, NDT (phase 6) and GICP (phase 15), and the 360-frame drift course with loops on,
with the ICP verifier (phase 10) and with the GICP verifier (phase 17); `--courses` runs
those named instead, among them `dense_icp_classic`, the dense course through the classic
driver with ICP (phase 16). It writes each run's odometry and keyframe poses, its loop
attempts (candidate, accepted, fitness), its keyframe ATE, the loop kernels' launches
that did work, the p50 ms of the frame and of the pipeline's stages (`prefilter`: the
host's enqueue of the fused step; `register`: the classic driver's align; `backend`: the
ring insert and target rebuild of a keyframe and the loop back end), and the p50 and max
ms of the loop verifications (`GraphBasedSLAM.verify_seconds`). With
`--compare`, per course and file: whether its poses and loop attempts equal the first
file's bit for bit, the poses' largest difference from them, and its numbers; one JSON
line. Trees in turns (this, parent, parent, this) give the stage times a pairing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

COURSES = ("dense", "dense_gicp", "drift_icp", "drift_gicp")
EXTRA = ("dense_icp_classic",)
NUMBERS = ("ate_keyframes_m", "loops_accepted", "ndt_worked", "gicp_worked")
STAGES = ("frame", "prefilter", "register", "backend")


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
    runs = {"dense": (chip_smoke.loops_off_config(), dense),
            "dense_icp_classic": (chip_smoke.loops_off_config(
                ["fused_frontend=False", "scan_matcher.registration_method=ICP"]), dense),
            "dense_gicp": (chip_smoke.loops_off_config(
                ["scan_matcher.registration_method=GICP"]), dense),
            "drift_icp": (PipelineConfig(), drift),
            "drift_gicp": (apply_cli_overrides(PipelineConfig(),
                                               ["graph_slam.registration_method=GICP"]),
                           drift)}
    arrays = {}
    for name in courses:
        cfg, (scans, gt) = runs[name]
        kernels.load_library()
        kernels.worked_launches(reset=True)
        pipe = SlamPipeline(cfg, device="cuda")
        walls = []
        for scan in scans:
            t0 = time.perf_counter()
            pipe.process_scan(scan)
            walls.append(time.perf_counter() - t0)
        res = pipe.result()
        torch.cuda.synchronize()
        ver = 1000 * np.asarray(pipe.back.verify_seconds, np.float64)
        kf = np.asarray(res.keyframe_frame_indices)
        loops = np.array([(r["candidate"], r["accepted"], r["fitness"]) for r in res.loop_log
                          if r["candidate"] >= 0], np.float64).reshape(-1, 3)
        arrays.update({
            f"{name}_odometry": res.odometry_poses, f"{name}_keyframes": res.keyframe_poses,
            f"{name}_loops": loops,
            f"{name}_numbers": np.array([
                ate_rmse(res.keyframe_poses, gt[kf], align=False), res.num_loop_closures,
                kernels.worked_launches(kernel="ndt_iteration"),
                kernels.worked_launches(kernel="gicp_iteration")], np.float64),
            f"{name}_ms": np.array([1000 * np.median(walls[1:])] + [
                res.metrics[k]["p50_ms"] if k in res.metrics else np.nan
                for k in STAGES[1:]], np.float64),
            f"{name}_verify_ms": np.array([np.median(ver), ver.max(), ver.size] if ver.size
                                          else [np.nan, np.nan, 0], np.float64)})
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
            rows[label] = {
                "bit_equal_first": bool(same),
                "odometry_max_diff_first": (float(np.abs(a - b).max())
                                            if a.shape == b.shape else None),
                **{k: float(v) for k, v in zip(NUMBERS, f[f"{name}_numbers"])},
                **{f"{k}_p50_ms": round(float(v), 3) for k, v in zip(STAGES, f[f"{name}_ms"])},
                **({f"verify_{k}_ms": round(float(v), 3) for k, v in zip(
                    ("p50", "max"), f[f"{name}_verify_ms"])} if f"{name}_verify_ms" in f else {})}
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
