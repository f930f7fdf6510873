"""A few frames of the PyTorch port's pipeline under `utils.telemetry.trace`.

    python scripts/torch_trace_frames.py --frames 5 --profile-dir DIR [--device cpu]

Runs `--warmup` frames of the synthetic course at the default capacities, then `--frames`
more inside `trace("frame", profile_dir=DIR)`, which writes `DIR/frame.trace.json` (a
Chrome trace of the CPU and CUDA activity). Prints one JSON line: the span's wall ms
(`trace.last_ms`), ms per frame, the trace file, its size, the number of events named
after the span, and the number of CUDA kernel events. Run it in a process of its own: a
profiler session can leave the process slower afterwards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides  # noqa: E402
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline  # noqa: E402
from lidar_graph_slam_tpu_torch.utils.telemetry import trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile-dir", required=True)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--set", action="append", default=[], metavar="a.b.c=v")
    args = ap.parse_args(argv)

    cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *args.set])
    n = args.warmup + args.frames
    scans = [s for s, _ in SyntheticSequence(n_frames=n, seed=0, laps=1.08 * n / 100.0)]
    pipe = SlamPipeline(cfg, device=args.device)
    for s in scans[: args.warmup]:
        pipe.process_scan(s)
    with trace("frame", profile_dir=args.profile_dir):
        for s in scans[args.warmup:]:
            pipe.process_scan(s)
        pipe.flush()
    path = os.path.join(args.profile_dir, "frame.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    print(json.dumps({
        "frames": args.frames, "device": str(pipe.device), "last_ms": trace.last_ms,
        "ms_per_frame": trace.last_ms / args.frames, "trace_file": os.path.abspath(path),
        "trace_bytes": os.path.getsize(path),
        "span_events": sum(e.get("name") == "frame" for e in events),
        "kernel_events": sum(e.get("cat") == "kernel" for e in events),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
