"""The JAX package's front end on the dense course, on the CPU: the reference numbers the
PyTorch port's `chip_smoke.py` phases 15-16 are read against.

    python scripts/jax_reference_dense.py --set scan_matcher.registration_method=GICP
    python scripts/jax_reference_dense.py --max-points 12000 \
        --set fused_frontend=False --set scan_matcher.registration_method=ICP

The course is `bench.py:bench_e2e_dense`'s (seed 2, 40 frames; `--max-points` cuts the
scans, 12000 being the CPU rehearsal size), the config the default with loop closure off
plus the `--set` overrides (Python literals, as the JAX CLI parses them). Prints one JSON
line: converged frames, keyframes, keyframe ATE against ground truth (no alignment), the
bound max(0.05 x travelled, 0.35) m, mean iterations and seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--max-points", type=int, default=131072)
    ap.add_argument("--set", action="append", default=[], metavar="a.b.c=v")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    from lidar_graph_slam_tpu.core.config import PipelineConfig, apply_cli_overrides
    from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence, make_world, simulate_scan
    from lidar_graph_slam_tpu.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu.utils.evaluation import ate_rmse

    n, mp = 40, args.max_points
    rng = np.random.default_rng(2)
    world = make_world(rng, extent=60.0, density=60.0, wall_height=12.0,
                       box_height=(6.0, 25.0), n_boxes=60)
    seq = SyntheticSequence(n_frames=n, seed=2, radius=35.0, laps=0.25, max_points=mp,
                            n_azimuth=2048, n_elevation=64)
    scans = [simulate_scan(world, seq.poses[i], rng, max_points=mp, n_azimuth=2048,
                           n_elevation=64) for i in range(n)]
    T0_inv = np.linalg.inv(seq.poses[0])
    gt = np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses])

    cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *args.set])
    t0 = time.perf_counter()
    pipe = SlamPipeline(cfg)
    for s in scans:
        pipe.process_scan(s)
    res = pipe.result()
    frames = [r for r in pipe.metrics_writer.records if "frame" in r and "event" not in r]
    kf = res.keyframe_frame_indices
    travelled = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    print(json.dumps(dict(
        sets=args.set, max_points=mp, fused_frontend=bool(cfg.fused_frontend is True),
        frames=len(frames), converged=sum(bool(r["converged"]) for r in frames),
        keyframes=len(kf), ate_keyframes_m=ate_rmse(res.keyframe_poses, gt[kf], align=False),
        ate_bound_m=max(0.05 * travelled, 0.35),
        iterations_mean=float(np.mean([r["iterations"] for r in frames])),
        seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
