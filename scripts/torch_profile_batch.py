"""Profile the port's batched multi-sequence odometry on a CUDA card.

    python3 scripts/torch_profile_batch.py --input NPZ [--frames 6]

`--input` holds a batch of sequences as `chip_smoke.py` writes it: `scans` [B, F, N, 3]
and `masks` [B, F, N]. `parallel/multi_sequence.py:batch_odometry` runs on their first
`--frames` frames under the default `ScanMatcherConfig` (map capacity 32,768): once to
warm up, once timed
(wall between synchronizes), then once under `torch.profiler`. Prints one JSON line: the
wall ms, the device kernel time (the profiler's kernel events; copies and memsets not
counted), the device's idle share (1 - device / wall of the unprofiled run), kernel
launches per frame, the batched NDT kernel's launches and its device time per launch.
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
    ap.add_argument("--frames", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.core.config import ScanMatcherConfig
    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.parallel.multi_sequence import batch_odometry

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    data = np.load(args.input)
    scans, masks = data["scans"][:, :args.frames], data["masks"][:, :args.frames]
    cfg = ScanMatcherConfig()

    def run():
        batch_odometry(scans, masks, cfg, map_capacity=32768, device="cuda")
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = 1000 * (time.perf_counter() - t0)
    before = kernels.ndt_align_loop_batched.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    batched = kernels.ndt_align_loop_batched.launches - before
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and not e.key.startswith(("Memcpy", "Memset"))]
    device_ms = sum(e.self_device_time_total for e in ka) / 1000
    ndt = [e for e in ka if "ndt_iteration" in e.key]
    ndt_us = sum(e.self_device_time_total for e in ndt) / max(sum(e.count for e in ndt), 1)
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
    print(json.dumps(dict(
        batch=scans.shape[0], frames=scans.shape[1], points=scans.shape[2], wall_ms=wall_ms,
        device_ms=device_ms, idle_share=1.0 - device_ms / wall_ms,
        launches_per_frame=sum(e.count for e in ka) / scans.shape[1],
        batched_kernel_launches=batched, batched_kernel_device_us=ndt_us,
        top_device_ms=[[e.key[:50], e.self_device_time_total / 1000] for e in top])),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
