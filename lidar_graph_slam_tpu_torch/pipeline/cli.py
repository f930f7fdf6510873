"""Command-line entry point: `python -m lidar_graph_slam_tpu_torch.pipeline.cli`.

Port of `lidar_graph_slam_tpu/pipeline/cli.py`: one command producing trajectory files
(TUM + KITTI), the map PCD, a bird's-eye PNG (when matplotlib is installed) and a metrics
JSON. Loop closure is on by default, as in the reference; `--no-loop-closure` switches it
off. It runs on the CUDA card; `--device cpu` runs it on the CPU (the counterpart of the
reference's platform choice). The KITTI reader, `--multihost` and `--live-render` are not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="slam-torch",
                                 description="LiDAR graph SLAM on PyTorch (CUDA or CPU)")
    ap.add_argument("--dataset", choices=["synthetic"], default="synthetic")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--config", default=None, help="YAML config file")
    ap.add_argument("--set", action="append", default=[], metavar="a.b.c=v",
                    help="config overrides, e.g. --set capacity.raw_points=65536")
    ap.add_argument("--output", default="out", help="output directory")
    ap.add_argument("--map-resolution", type=float, default=0.5)
    ap.add_argument("--no-loop-closure", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the pipeline runs (default: the CUDA card; no fallback)")
    ap.add_argument("--progress-every", type=int, default=20)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write per-frame structured metrics to this JSONL file")
    args = ap.parse_args(argv)

    from lidar_graph_slam_tpu_torch.core.config import apply_cli_overrides, load_config
    from lidar_graph_slam_tpu_torch.io.pcd import write_kitti_trajectory, write_tum_trajectory
    from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse, rpe

    cfg = load_config(args.config)
    if args.no_loop_closure:
        cfg = apply_cli_overrides(cfg, ["enable_loop_closure=False"])
    if args.set:
        cfg = apply_cli_overrides(cfg, args.set)

    # Keep per-frame motion (~2.4 m) constant regardless of --frames so short runs stay
    # within the matchers' convergence basin; a full lap needs ~100 frames.
    seq = SyntheticSequence(n_frames=args.frames, seed=0,
                            laps=min(1.08, 1.08 * args.frames / 100.0))
    gt_all = seq.poses

    pipe = SlamPipeline(cfg, metrics_path=args.metrics_jsonl, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    result = pipe.run(seq, progress_every=args.progress_every)
    write_tum_trajectory(os.path.join(args.output, "odometry_tum.txt"), result.odometry_poses)
    write_kitti_trajectory(os.path.join(args.output, "odometry_kitti.txt"), result.odometry_poses)
    write_tum_trajectory(os.path.join(args.output, "keyframes_tum.txt"), result.keyframe_poses)
    pipe.save_map(os.path.join(args.output, "map.pcd"), args.map_resolution)

    n = result.odometry_poses.shape[0]
    T0_inv = np.linalg.inv(gt_all[0])
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in gt_all[:n]])
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[slam-torch] matplotlib is not installed: map.png not written")
    else:
        from lidar_graph_slam_tpu_torch.utils.viz import render_run

        log = result.loop_log
        render_run(
            os.path.join(args.output, "map.png"),
            pipe.back.assemble_map(max(args.map_resolution, 0.3)),
            result.odometry_poses, result.keyframe_poses,
            loop_pairs=[(rec["latest"], rec["candidate"]) for rec in log if rec["accepted"]],
            rejected_pairs=[
                (rec["latest"], rec["candidate"]) for rec in log
                if not rec["accepted"] and not rec.get("overflow") and rec["candidate"] >= 0
            ],
            gt_poses=gt,
        )

    summary = {
        "frames": int(n),
        "keyframes": int(result.keyframe_poses.shape[0]),
        "loop_closures": result.num_loop_closures,
        "device": str(pipe.device),
        "stage_timings": result.metrics,
    }
    summary["ate_odometry_m"] = ate_rmse(result.odometry_poses, gt, align=False)
    kf_gt = gt[result.keyframe_frame_indices]
    summary["ate_keyframes_m"] = ate_rmse(result.keyframe_poses, kf_gt, align=False)
    t_rpe, r_rpe = rpe(result.odometry_poses, gt)
    summary["rpe_trans_m"] = t_rpe
    summary["rpe_rot_rad"] = r_rpe
    with open(os.path.join(args.output, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
