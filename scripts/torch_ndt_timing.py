"""Time per call of the NDT kernels on one CUDA card, split into device and host time,
at the main path's shapes.

    python3 scripts/torch_ndt_timing.py [--root DIR] [--rounds 3] [--json PATH]

Builds the dense course's full submap ring (the first 20 scans of
`chip_smoke.dense_course` at their ground-truth poses, default capacities) and its
4 m / 2 m target, and takes the last ring scan in the map frame as the source, as the
NDT iterations see it near convergence. Three shapes of the path:
  fine    all 32,768 filtered points against the 2 m map (K = 229,376 correspondences);
  coarse  every 4th point against the 4 m map (K = 57,344);
  verify  every 2nd point against the 4 m map: the loop verification's pre-align shape
          (16,384 keyframe points x 7 = K 114,688 against a 4 m map).
For each kernel wrapper of `ops/kernels.py` and each shape it prints one JSON line, the
record of `chip_smoke.kernel_timings` (the measurement `chip_smoke.py` makes, with the
median of `--rounds` rounds): device_us, host_us, single_ms, the plain version's
single-call ms, the bound and the share of the bound (bound_us / device_us). The card's
name and power limit come first. `--root` times the package of another tree (such as the
parent commit unpacked by `git archive`) with the same inputs and the same measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = (("fine", 1, 1), ("coarse", 0, 4), ("verify", 0, 2))  # (name, map, stride)


def path_inputs(chip_smoke, torch, dev):
    """[(shape name, map, source points, source mask)] on `dev`."""
    cfg = chip_smoke.loops_off_config()
    scans, gt = chip_smoke.dense_course(20)
    aux, ring, last = chip_smoke.full_ring(cfg, scans, gt, dev)
    maps = aux["rebuild"](ring)  # (coarse, fine)
    T = torch.as_tensor(gt[aux["window"] - 1], device=dev)
    pts = torch.where(last.mask[:, None], last.points @ T[:3, :3].T + T[:3, 3], last.points)
    return [(name, maps[m], pts[::stride].contiguous(), last.mask[::stride].contiguous())
            for name, m, stride in SHAPES]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="the package tree to time")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))  # the package of that tree
    import importlib.util

    import torch

    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.registration.ndt import magnusson_constants

    # This checkout's chip_smoke.py (another tree has its own), on that tree's package.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    kernels.load_library()
    tree = os.path.relpath(os.path.abspath(args.root), REPO)
    outlier_ratio = chip_smoke.loops_off_config().scan_matcher.ndt.outlier_ratio
    lines = []
    for name, vmap, src, msk in path_inputs(chip_smoke, torch, dev):
        d1, d2 = magnusson_constants(vmap.leaf, outlier_ratio)
        timing = chip_smoke.kernel_timings(kernels, name, vmap, src, msk, d2, -d1 * d2,
                                           rounds=args.rounds)
        for line in timing.values():
            lines.append(dict(line, tree=tree, card=card))
            print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
