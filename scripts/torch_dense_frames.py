"""The dense course's frame times through the fused driver, for one tree of the package.

    python3 scripts/torch_dense_frames.py --write-input NPZ
    python3 scripts/torch_dense_frames.py --input NPZ [--root DIR]

`--write-input` writes `chip_smoke.py`'s 40-frame dense course (`bench.py:bench_e2e_dense`,
seed 2, ~73k points a frame) and its ground truth to NPZ. `--input` runs those scans
through `SlamPipeline` on the CUDA card with the default config and loop closure off
(the default capacities), using the package under `--root` (default: this checkout), in
a process of its own. Prints one JSON line: the frame p50 in ms (host clock around
`process_scan`, every frame but the bootstrap frame 0), the stage timers' p50s, the mean
iterations, the keyframe ATE and the tree's kernel wrappers' launches. Run two trees in
turns (this, parent, parent, this) in one call to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write-input", default=None)
    ap.add_argument("--input", default=None)
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args(argv)
    import numpy as np

    if args.write_input:
        sys.path.insert(0, REPO)
        import chip_smoke

        scans, gt = chip_smoke.dense_course(40)
        np.savez(args.write_input, gt=gt, **{f"scan{i}": s for i, s in enumerate(scans)})
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides
    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
    from lidar_graph_slam_tpu_torch.utils.evaluation import ate_rmse

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    data = np.load(args.input)
    gt = data["gt"]
    scans = [data[f"scan{i}"] for i in range(gt.shape[0])]
    cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False"])
    names = [n for n in ("ndt_direct7_accumulate", "ndt_accumulate", "ndt_align_loop")
             if hasattr(kernels, n)]
    before = {n: getattr(kernels, n).launches for n in names}
    pipe = SlamPipeline(cfg)
    walls = []
    for s in scans:
        t0 = time.perf_counter()
        pipe.process_scan(s)
        walls.append(time.perf_counter() - t0)
    res = pipe.result()
    frames = [r for r in pipe.metrics_writer.records if "frame" in r and "event" not in r]
    kf = res.keyframe_frame_indices
    print(json.dumps(dict(
        root=os.path.abspath(args.root), frames=len(scans),
        frame_p50_ms=1000 * float(np.median(walls[1:])),
        frame_mean_ms=1000 * float(np.mean(walls[1:])),
        stage_p50_ms={k: v["p50_ms"] for k, v in res.metrics.items()},
        iterations_mean=float(np.mean([r["iterations"] for r in frames])),
        converged=sum(bool(r["converged"]) for r in frames),
        ate_keyframes_m=ate_rmse(res.keyframe_poses, gt[kf], align=False),
        launches={n: getattr(kernels, n).launches - before[n] for n in names},
        card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
