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
`--live-render N` re-renders `<output>/live.png` every N frames. `--multihost` joins the
process group named by `LGS_COORDINATOR` (host:port of process 0), `LGS_NUM_PROCESSES` and
`LGS_PROCESS_ID` (`parallel/multihost.py`) and runs the pipeline SPMD: every process reads
the same scans, keyframe clouds shard over the processes, process 0 writes `<output>` and
process r writes `<output>-p<r>`. Without those variables it runs single-process, as the
reference does; a configured group that cannot form is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

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
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group of LGS_COORDINATOR / LGS_NUM_PROCESSES / "
                         "LGS_PROCESS_ID and run the pipeline SPMD across processes with the "
                         "keyframe-cloud store sharded per process. Every process must "
                         "receive the same scan stream; process 0 writes --output, process "
                         "r writes <output>-p<r>.")
    args = ap.parse_args(argv)

    from lidar_graph_slam_tpu_torch.parallel.distributed import process_count, process_index

    if args.multihost:
        from lidar_graph_slam_tpu_torch.parallel.multihost import initialize_from_env

        if not initialize_from_env():
            print("[slam-torch] --multihost: no LGS_* coordinator env, running single-process")
        else:
            rank = process_index()
            print(f"[slam-torch] multihost: process {rank}/{process_count()}")
            if rank != 0:
                # Every process runs the whole SPMD pipeline (map assembly is a collective);
                # the others write their (identical) outputs beside process 0's.
                args.output = f"{args.output}-p{rank}"

    from lidar_graph_slam_tpu_torch.core.config import apply_cli_overrides, load_config
    from lidar_graph_slam_tpu_torch.io.pcd import write_kitti_trajectory, write_tum_trajectory
    from lidar_graph_slam_tpu_torch.ops import kernels
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
    live_path = os.path.join(args.output, "live.png")
    frame_s = []  # host wall time of each process_scan
    for i, item in enumerate(seq):
        scan = item[0] if isinstance(item, tuple) else item
        t0 = time.perf_counter()
        pipe.process_scan(np.asarray(scan))
        frame_s.append(time.perf_counter() - t0)
        if render_run is not None and args.live_render > 0 \
                and (i + 1) % args.live_render == 0 and pipe.odometry_poses:
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
        # Every frame but the bootstrap frame 0 (`PERF.md` section 2).
        "frame_p50_ms": 1000 * float(np.median(frame_s[1:])) if len(frame_s) > 1 else 0.0,
        "kernel_launches": {name: getattr(kernels, name).launches for name in (
            "ndt_direct7_accumulate", "ndt_accumulate", "ndt_direct7_accumulate_batched",
            "ndt_align_loop", "ndt_align_loop_batched", "gicp_align_loop", "icp_align_loop",
            "icp_fitness", "ndt_finalize", "eigh3x3")},
        "processes": process_count(),
    }
    # How many of each loop kernel's launches did work (a device count; 0 without a loop).
    looped = {"ndt_iteration": kernels.ndt_align_loop.launches
              + kernels.ndt_align_loop_batched.launches,
              "gicp_iteration": kernels.gicp_align_loop.launches,
              "icp_iteration": kernels.icp_align_loop.launches}
    for name, n in looped.items():
        summary["kernel_launches"][f"{name}_worked"] = (
            kernels.worked_launches(kernel=name) if pipe.device.type == "cuda" and n else 0)
    store = pipe.back.cloud_store
    if store is not None:
        summary["keyframe_clouds_owned"] = len(store.local_ids())
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
