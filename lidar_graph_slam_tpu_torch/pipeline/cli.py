"""Command-line entry point: `python -m lidar_graph_slam_tpu_torch.pipeline.cli`.

Port of `lidar_graph_slam_tpu/pipeline/cli.py`: one command producing trajectory files
(TUM + KITTI), the map PCD, a bird's-eye PNG (when matplotlib is installed) and a metrics
JSON. Loop closure is on by default, as in the reference; `--no-loop-closure` switches it
off. It runs on the CUDA card; `--device cpu` runs it on the CPU (the counterpart of the
reference's platform choice). The front-end driver and the registration methods come from
the config, as in the reference: `--set fused_frontend=false` runs the classic
stage-by-stage driver, `--set scan_matcher.registration_method=GICP` (or ICP) the front
end's matcher, `--set graph_slam.registration_method=GICP` (or NDT) the loop verifier; the
summary names all three. `--dataset kitti --kitti-root DIR --sequence NN` reads a KITTI
odometry sequence through the native read-ahead (`io/kitti.py`, `native/`);
`--live-render N` re-renders `<output>/live.png` every N frames. `--multihost` is not
ported: it waits for the port of the reference's `parallel/` package.
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
    ap.add_argument("--dataset", choices=["synthetic", "kitti"], default="synthetic")
    ap.add_argument("--kitti-root", default=os.environ.get("KITTI_ROOT", "/data/kitti"))
    ap.add_argument("--sequence", default="00")
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
    ap.add_argument("--live-render", type=int, default=0, metavar="N",
                    help="re-render <output>/live.png every N frames during the run (map, "
                         "trajectories, accepted AND rejected loop candidates); 0 disables")
    args = ap.parse_args(argv)

    from lidar_graph_slam_tpu_torch.core.config import apply_cli_overrides, load_config
    from lidar_graph_slam_tpu_torch.io.pcd import write_kitti_trajectory, write_tum_trajectory
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse, rpe

    cfg = load_config(args.config)
    if args.no_loop_closure:
        cfg = apply_cli_overrides(cfg, ["enable_loop_closure=False"])
    if args.set:
        cfg = apply_cli_overrides(cfg, args.set)

    if args.dataset == "synthetic":
        from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence

        # Keep per-frame motion (~2.4 m) constant regardless of --frames so short runs
        # stay within the matchers' convergence basin; a full lap needs ~100 frames.
        seq = SyntheticSequence(n_frames=args.frames, seed=0,
                                laps=min(1.08, 1.08 * args.frames / 100.0))
        gt_all = seq.poses
    else:
        from lidar_graph_slam_tpu_torch.io.kitti import KittiSequence

        seq = KittiSequence(args.kitti_root, args.sequence, max_frames=args.frames,
                            max_points=cfg.capacity.raw_points)
        gt_all = seq.gt_poses  # None without a poses file

    try:
        import matplotlib  # noqa: F401

        from lidar_graph_slam_tpu_torch.utils.viz import render_run
    except ImportError:
        render_run = None
        print("[slam-torch] matplotlib is not installed: map.png"
              + (" and live.png" if args.live_render > 0 else "") + " not written")

    def loop_pairs(log):
        return dict(
            loop_pairs=[(rec["latest"], rec["candidate"]) for rec in log if rec["accepted"]],
            rejected_pairs=[
                (rec["latest"], rec["candidate"]) for rec in log
                if not rec["accepted"] and not rec.get("overflow") and rec["candidate"] >= 0
            ])

    pipe = SlamPipeline(cfg, metrics_path=args.metrics_jsonl, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    if args.live_render > 0:
        live_path = os.path.join(args.output, "live.png")
        for i, item in enumerate(seq):
            scan = item[0] if isinstance(item, tuple) else item
            pipe.process_scan(np.asarray(scan))
            if render_run is not None and (i + 1) % args.live_render == 0 \
                    and pipe.odometry_poses:
                render_run(
                    live_path,
                    pipe.back.assemble_map(max(args.map_resolution, 0.3)),
                    np.stack(pipe.odometry_poses),
                    pipe.back.optimized_poses(),
                    **loop_pairs(pipe.back.loop_log),
                )
            if args.progress_every and (i + 1) % args.progress_every == 0:
                print(f"[slam-torch] frame {i + 1}, keyframes={pipe.back.n_keyframes}, "
                      f"loops={sum(1 for rec in pipe.back.loop_log if rec['accepted'])}")
        result = pipe.result()
    else:
        result = pipe.run(seq, progress_every=args.progress_every)
    write_tum_trajectory(os.path.join(args.output, "odometry_tum.txt"), result.odometry_poses)
    write_kitti_trajectory(os.path.join(args.output, "odometry_kitti.txt"), result.odometry_poses)
    write_tum_trajectory(os.path.join(args.output, "keyframes_tum.txt"), result.keyframe_poses)
    pipe.save_map(os.path.join(args.output, "map.pcd"), args.map_resolution)

    n = result.odometry_poses.shape[0]
    gt = None  # ground truth relative to the first pose, when the dataset has it
    if gt_all is not None:
        T0_inv = np.linalg.inv(gt_all[0])
        gt = np.stack([(T0_inv @ p).astype(np.float32) for p in gt_all[:n]])
    if render_run is not None:
        render_run(
            os.path.join(args.output, "map.png"),
            pipe.back.assemble_map(max(args.map_resolution, 0.3)),
            result.odometry_poses, result.keyframe_poses,
            **loop_pairs(result.loop_log), gt_poses=gt,
        )

    summary = {
        "frames": int(n),
        "keyframes": int(result.keyframe_poses.shape[0]),
        "loop_closures": result.num_loop_closures,
        "device": str(pipe.device),
        "fused_frontend": pipe.fused,
        "registration_method": cfg.scan_matcher.registration_method,
        "loop_verifier": cfg.graph_slam.registration_method,
        "stage_timings": result.metrics,
    }
    if args.dataset == "kitti":
        from lidar_graph_slam_tpu_torch import native

        # False: no C++ toolchain, the scans came through the numpy fallback.
        summary["native_io"] = native.available()
    if gt is not None:
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
