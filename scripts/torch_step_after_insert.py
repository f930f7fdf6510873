"""Device ms of one tree's captured fused step replay after an insert replay, after an
insert and a spin that keeps the card busy, and with no insert, on a CUDA card.

    python3 scripts/torch_step_after_insert.py --root DIR [--method GICP] [--frames 40]
        [--spin-ms 2.9]

Builds `FusedFrontEnd` of the tree under DIR (this checkout, or a parent commit unpacked
with `git archive`, with its own package and `chip_smoke.py`) for the dense course's
first `--frames` frames with that matcher, captures its programs on frame 0, then replays
frames 1.. three ways, each timed between CUDA events around the step's dispatch:

  insert       each step followed by the keyframe's insert replay, as a dense course runs;
  insert_spin  the same, and after each insert `torch.cuda._sleep` holds the stream for
               `--spin-ms` (by default about as long as an insert that builds the grid with
               `torch.cummax` and a scatter took: ~3.3 ms on the dense course);
  no_insert    steps alone, back to back.

While each way runs, `nvidia-smi` samples the SM clock every 20 ms. Prints one JSON line:
the tree, the card's name and power limit, and per way the step's device ms p50 and the
SM clock's median. If the step reads slower after a short insert and the spin restores
it, the step waits on the card's clock, not on its own work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--method", default="GICP", choices=("NDT", "GICP", "ICP"))
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--spin-ms", type=float, default=2.9)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from lidar_graph_slam_tpu_torch.odometry.fused import FusedFrontEnd

    if not torch.cuda.is_available():
        print("torch_step_after_insert: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    scans, _gt = chip_smoke.dense_course(args.frames)
    cfg = chip_smoke.loops_off_config([f"scan_matcher.registration_method={args.method}"])
    raws = [chip_smoke.raw_bucket(s, cfg.capacity.raw_points) for s in scans]
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=dev)
    front.dispatch(raws[0], None, None, 0)  # the captures
    front.insert_and_rebuild(0)
    torch.cuda.synchronize()
    spin_cycles = int(args.spin_ms * 1000 * clock_mhz)
    out = {}
    for way in ("insert", "insert_spin", "no_insert", "insert"):
        sampler = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader,nounits", "-lms", "20"],
                                   stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                   text=True)
        events = []
        try:
            for t in range(1, len(raws)):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                front.dispatch(raws[t], None, None, t % 2)
                e1.record()
                events.append((e0, e1))
                if way != "no_insert":
                    front.insert_and_rebuild(t % 2)
                if way == "insert_spin":
                    torch.cuda._sleep(spin_cycles)
            torch.cuda.synchronize()
        finally:
            sampler.terminate()
            clocks = [float(x) for x in sampler.communicate()[0].split() if x.strip()]
        ms = [e0.elapsed_time(e1) for e0, e1 in events]
        key = way if way not in out else f"{way}_again"
        out[key] = dict(step_device_ms_p50=float(np.median(ms)),
                        sm_clock_mhz_median=float(np.median(clocks)) if clocks else None,
                        clock_samples=len(clocks))
    print(json.dumps(dict(root=root, card=card, method=args.method, frames=args.frames,
                          spin_ms=args.spin_ms, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
