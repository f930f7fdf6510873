"""Profile one fine-stage `ndt_align` of the PyTorch port on a CUDA card.

    python3 scripts/torch_profile_ndt.py --input NPZ [--root DIR] [--repeats 5]

`--input` holds one NDT problem as `chip_smoke.py` writes it from the dense course: an
assembled submap (`points`, `mask`), a source scan (`source`, `source_mask`) and an
initial guess (`init`). The package under `--root` (default: this checkout) builds the
default config's target from the submap, and one `ndt_align` runs against its fine map
at the fine stage's settings: once to warm up, `--repeats` times unprofiled (wall time
between synchronizes), then once under `torch.profiler`. Prints one JSON line: NDT bodies
(iterations + 2 polish), device kernel launches per align and per body (the profiler's
kernel events; copies and memsets are not counted), device ms and wall ms per align and
per body, the device's idle share, each kernel wrapper's launches per align (a loop
wrapper counts every launch it enqueues, the early-exit ones included), the kernels
launched most (per body), the iterations and the transform. `--root` points the same
measurement at another tree of the package, such as the parent commit unpacked with
`git archive`.
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

    from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, NdtConfig
    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.registration.ndt import make_ndt_matcher, ndt_align

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = np.load(args.input)
    cfg = NdtConfig()
    build_target, _ = make_ndt_matcher(cfg, CapacityConfig().voxel_capacity)
    _coarse, fine = build_target(torch.as_tensor(data["points"], device=dev),
                                 torch.as_tensor(data["mask"], device=dev))
    src, msk, init = (torch.as_tensor(data[k], device=dev)
                      for k in ("source", "source_mask", "init"))
    kernels.load_library()

    def align():
        return ndt_align(fine, src, msk, init, step_size=cfg.step_size,
                         transform_epsilon=cfg.transform_epsilon,
                         outlier_ratio=cfg.outlier_ratio, max_iterations=cfg.max_iterations)

    res = align()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        align()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wrappers = [w for w in (getattr(kernels, n, None) for n in
                            ("ndt_accumulate", "ndt_direct7_accumulate", "ndt_align_loop"))
                if w is not None]
    before = {w.__name__: w.launches for w in wrappers}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        align()
        torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and not e.key.startswith(("Memcpy", "Memset"))]
    bodies = int(res.iterations) + 2
    launches = sum(e.count for e in ka)
    device_ms = sum(e.self_device_time_total for e in ka) / 1000
    wall_ms = 1000 * float(np.median(walls))
    top = sorted(ka, key=lambda e: -e.count)[:8]
    print(json.dumps(dict(
        root=os.path.abspath(args.root), bodies=bodies, iterations=int(res.iterations),
        converged=bool(res.converged), launches=launches, launches_per_align=launches,
        device_ms_per_align=device_ms, wall_ms_per_align=wall_ms,
        launches_per_body=launches / bodies, device_ms_per_body=device_ms / bodies,
        wall_ms_per_body=wall_ms / bodies, idle_share=1.0 - device_ms / wall_ms,
        wrapper_launches_per_align={w.__name__: w.launches - before[w.__name__]
                                    for w in wrappers},
        top=[[e.key[:60], e.count / bodies] for e in top],
        transform=res.transform.cpu().numpy().tolist())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
