"""Profile one loop verification of the PyTorch port on a CUDA card.

    python3 scripts/torch_profile_verify.py [--frames 200] [--trace PATH]

Runs the first `--frames` frames of the drift course of `bench.py:bench_e2e` (the
course of `chip_smoke.py` phase 8) with loops off to collect keyframes, then builds a
back end with the default config from those keyframes and verifies the latest one
inline: twice unprofiled (input build and verification wall ms), then once under
`torch.profiler`. Prints the profiled wall, the device's busy time and idle share, the
count of kernel launches and the 25 kernels with the most device time, and writes the
Chrome trace to `--trace` (default `out/profile_verify/verify_trace.json` in the checkout).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from lidar_graph_slam_tpu_torch.core.config import PipelineConfig  # noqa: E402
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM  # noqa: E402


def backend_from(src: GraphBasedSLAM, cfg: PipelineConfig, latest: int) -> GraphBasedSLAM:
    """A synchronous back end on the card holding `src`'s keyframes 0..latest."""
    b = GraphBasedSLAM(dataclasses.replace(cfg.graph_slam, async_backend=False),
                       cfg.capacity, device="cuda")
    for k in range(latest + 1):
        c = src._cloud(k)
        b.add_keyframe({"pose": src.kf_front_poses[k], "cloud": c,
                        "cloud_mask": np.ones(c.shape[0], bool),
                        "accum_distance": src.kf_accum_dist[k]})
    return b


def timed_verify(b: GraphBasedSLAM):
    """(input build ms, verification ms, verification results), synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inp = b._build_verify_inputs()
    if inp is None:
        raise SystemExit(f"keyframe {b.n_keyframes - 1} has no loop candidate: use more "
                         f"--frames")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = b._verify(inp)
    torch.cuda.synchronize()
    return 1000 * (t1 - t0), 1000 * (time.perf_counter() - t1), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--trace", default=os.path.join(REPO, "out", "profile_verify",
                                                    "verify_trace.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    scans, gt = chip_smoke.drift_course(360)
    cfg = PipelineConfig()
    pipe, _res, _ = chip_smoke.run_loop_course(chip_smoke.loops_off_config(),
                                               scans[: args.frames], gt[: args.frames], "cuda")
    src = pipe.back
    latest = src.n_keyframes - 1
    print(f"keyframes {src.n_keyframes}, verifying keyframe {latest}", flush=True)
    for rep in range(2):
        build_ms, verify_ms, out = timed_verify(backend_from(src, cfg, latest))
        print(f"rep {rep}: inputs {build_ms:.3f} ms, verify {verify_ms:.3f} ms, "
              f"ndt_accumulate launches {out['launches']}, fitness {out['scores']}", flush=True)

    b = backend_from(src, cfg, latest)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        build_ms, verify_ms, _ = timed_verify(b)
    wall_ms = build_ms + verify_ms
    ka = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in ka) / 1000
    print(f"profiled wall {wall_ms:.3f} ms (inputs {build_ms:.3f}, verify {verify_ms:.3f}); "
          f"device busy {device_ms:.3f} ms; idle share {1 - device_ms / wall_ms:.4f}")
    print("cudaLaunchKernel calls", sum(e.count for e in ka if e.key == "cudaLaunchKernel"))
    top = sorted((e for e in ka if e.device_time_total > 0), key=lambda e: -e.device_time_total)
    for e in top[:25]:
        print(f"{e.device_time_total / 1000:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
