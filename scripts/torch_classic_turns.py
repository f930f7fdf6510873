"""The classic driver of this tree against another tree's, in turns, on a CUDA card.

    python3 scripts/torch_classic_turns.py --parent DIR [--methods NDT ICP] [--frames 5]
        [--courses dense_ndt_classic dense_icp_classic cli_gicp_classic]

Two measurements, each in turns (this, parent, parent, this), each run in a process of its
own: `chip_smoke.py`'s classic courses through `scripts/torch_trajectories.py`
(`chip_smoke.trajectories_in_turns`: every pose's bits against the first run's, the
keyframe ATE, the p50 ms of the frame and of the `prefilter`, `register` and `backend`
stages, the programs captured), and for each method frames 3-7 of the 40-frame dense
course through the classic driver under the profiler (`scripts/torch_trace_frames.py
--course dense --warmup 3 --set fused_frontend=false`, `chip_smoke.run_trace`): the ms
a frame, the device's busy and span ms a frame and its idle share, the CUDA runtime
calls a frame by name (graph launches against kernel launch calls), each classic part's
host ms, and on a tree with the classic programs their first calls' parts and the same
frames with the bodies called directly. DIR is a tree of the parent commit unpacked with
`git archive`. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def trace_summary(rec: dict, frames: int) -> dict:
    """A classic trace's numbers (`scripts/torch_trace_frames.py`'s record)."""
    calls = rec["runtime_calls_per_frame"]
    out = {"ms_per_frame": rec["ms_per_frame"],
           "device_busy_ms_per_frame": rec["device_busy_ms"] / frames,
           "device_span_ms_per_frame": rec["device_span_ms"] / frames,
           "device_idle_share": rec["device_idle_share"],
           "window_keyframes": rec["window_keyframes"],
           "graph_launches_per_frame": calls.get("cudaGraphLaunch", 0.0),
           "kernel_launch_calls_per_frame": sum(v for k, v in calls.items()
                                                if "LaunchKernel" in k),
           "runtime_calls_per_frame": calls, "stage_p50_ms": rec["stage_p50_ms"],
           "parts_host_ms_per_frame": {k: v["host_ms_per_frame"]
                                       for k, v in rec["stages"].items() if v["calls"]}}
    if "programs" in rec:
        out["first_call_ms"] = {k: v["first_call_ms"] for k, v in rec["programs"].items()}
        out["pool_bytes"] = {k: v["pool_bytes"] for k, v in rec["programs"].items()}
        out["body_ms_per_frame"] = rec["body_ms_per_frame"]
        out["body_device_busy_ms_per_frame"] = rec["body_window"]["device_busy_ms"] / frames
        out["body_device_idle_share"] = rec["body_window"]["device_idle_share"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--methods", nargs="+", default=["NDT", "ICP"])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--courses", nargs="+",
                    default=["dense_ndt_classic", "dense_icp_classic", "cli_gicp_classic"])
    args = ap.parse_args()

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    parent = os.path.abspath(args.parent)
    out = {"card": torch.cuda.get_device_name(0),
           "trajectories": chip_smoke.trajectories_in_turns(parent, tuple(args.courses)),
           "traces": {}}
    turns = (("this", REPO), ("parent", parent), ("parent", parent), ("this", REPO))
    for method in args.methods:
        row = out["traces"][method] = {}
        for i, (tree, root) in enumerate(turns):
            rec = chip_smoke.run_trace(args.frames, (
                "--root", root, "--course", "dense", "--warmup", "3", "--set",
                "fused_frontend=false", "--set", f"scan_matcher.registration_method={method}"))
            row[f"{i}_{tree}"] = trace_summary(rec, args.frames)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
