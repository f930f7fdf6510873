"""Profile one ICP alignment of the PyTorch port on a CUDA card.

    python3 scripts/torch_profile_icp.py --input NPZ [--root DIR] [--repeats 5]

`--input` holds one ICP problem as `chip_smoke.py`'s icp-loop phase writes it: a target
cloud (`points`, `mask`) whose `HashGrid` the package under `--root` (default: this
checkout) builds at `cell` metres, a source (`source`, `source_mask`), an initial guess
(`init`) and the align's settings (`settings`: max correspondence distance, max
iterations, transform epsilon, fitness epsilon, bucket_cap, neighborhood). One
`registration.icp.icp_align` runs once to warm up, `--repeats` times unprofiled (wall
time between synchronizes), then under `torch.profiler` (the second of two sessions: a
process's first can miss events). Prints one JSON line: iterations, converged, inliers,
the device's kernel launches (copies and memsets not counted), device ms and wall ms per
align, the device's idle share, the kernels launched most and the transform. `--root` points the same measurement at another tree of the
package, such as the parent commit unpacked with `git archive`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid
    from lidar_graph_slam_tpu_torch.registration.icp import icp_align

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = np.load(args.input)
    grid = build_hash_grid(torch.as_tensor(data["points"], device=dev),
                           torch.as_tensor(data["mask"], device=dev), float(data["cell"]))
    src, msk, init = (torch.as_tensor(data[k], device=dev)
                      for k in ("source", "source_mask", "init"))
    corr, its, eps, fit_eps, bucket_cap, neighborhood = data["settings"].tolist()

    def align():
        return icp_align(grid, src, msk, init, max_correspondence_distance=corr,
                         max_iterations=int(its), transform_epsilon=eps,
                         euclidean_fitness_epsilon=fit_eps, bucket_cap=int(bucket_cap),
                         neighborhood=int(neighborhood))

    res = align()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        align()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            align()
            torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and not e.key.startswith(("Memcpy", "Memset"))]
    launches = sum(e.count for e in ka)
    device_ms = sum(e.self_device_time_total for e in ka) / 1000
    wall_ms = 1000 * float(np.median(walls))
    print(json.dumps(dict(
        root=os.path.abspath(args.root), iterations=int(res.iterations),
        converged=bool(res.converged), inliers=int(res.num_inliers),
        launches_per_align=launches, device_ms_per_align=device_ms, wall_ms_per_align=wall_ms,
        idle_share=1.0 - device_ms / wall_ms,
        top=[[e.key[:60], e.count] for e in sorted(ka, key=lambda e: -e.count)[:6]],
        transform=res.transform.cpu().numpy().tolist())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
