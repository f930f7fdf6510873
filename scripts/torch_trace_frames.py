"""A few frames of the PyTorch port's pipeline under `utils.telemetry.trace`.

    python scripts/torch_trace_frames.py --frames 5 --profile-dir DIR [--device cpu]
        [--course cli|drift] [--warmup N] [--set a.b.c=v ...]

Runs `--warmup` frames of a synthetic course at the default capacities, then `--frames`
more inside `trace("frame", profile_dir=DIR)`, which writes `DIR/frame.trace.json` (a
Chrome trace of the CPU and CUDA activity). `--course cli` (the default) is the CLI's
synthetic course with loop closure off; `--course drift` is `chip_smoke.py`'s 360-frame
drift course (`bench.py:bench_e2e`, every frame a keyframe) with the default config, loop
closure on. Prints one JSON line: the span's wall ms (`trace.last_ms`), ms per frame,
the trace file, its size, the number of events named after the span, the number of CUDA
kernel events, and `stages`: the fused driver's back-end stage split into its parts —
the ring insert and target rebuild, the keyframe hand-over (`add_keyframe`), the loop
tick (`on_frame`) and the rest — each part's host ms a frame (marked in the trace with
`record_function`), the device ms of the work it enqueued and its kernels' own ms (the
kernels that take most named), the CUDA runtime calls it made (the host's synchronous
waits on the device among them: synchronizes, copies, frees and allocations, each wait
also by the chain of CPU operators that made it) and its CPU operators, beside the stage timers'
p50s over the traced frames. Run it in a process of its own: a profiler session can
leave the process slower afterwards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides  # noqa: E402
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline  # noqa: E402
from lidar_graph_slam_tpu_torch.utils.telemetry import trace  # noqa: E402

# The back-end stage's parts, as the fused driver calls them in `_consume_fused`.
STAGE_PARTS = {"insert_and_rebuild": "_insert_and_rebuild", "add_keyframe": "add_keyframe",
               "on_frame": "on_frame", "drain_lazy_clouds": "drain_lazy_clouds",
               "emit_loop_attempts": "_emit_loop_attempts"}
# CUDA runtime calls in which the host waits for the device (cudaFree and cudaMalloc
# can too).
WAITS = ("Synchronize", "cudaMemcpy", "cudaFree", "cudaMalloc")


def annotate(pipe: SlamPipeline) -> None:
    """Wrap each back-end part of `pipe` (an instance attribute over the method) in a
    `record_function` named `stage.<part>`, so the trace marks it."""
    for part, attr in STAGE_PARTS.items():
        owner = pipe if hasattr(pipe, attr) and attr.startswith("_") else pipe.back
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=f"stage.{part}", **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        setattr(owner, attr, wrapped)


def stage_breakdown(events: list, frames: int) -> dict:
    """Per part, a frame: the host ms of its `record_function` spans, the device ms of the
    work they enqueued (the profiler's GPU-side spans of the same name, first kernel to
    last, gaps included) and the kernels' own ms inside those spans with the kernels that
    take most, the ms of the CUDA runtime calls made inside the host spans by name (the
    synchronous waits among them summed apart, and by the chain of CPU operators that
    made them), and the number of CPU operators they ran."""
    def inside(e, spans, same_thread=True):
        return any((not same_thread or s["tid"] == e["tid"])
                   and s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in spans)

    def per_frame(evs):
        return sum(e["dur"] for e in evs) / 1000 / frames

    def top(evs, key, n=6):
        acc = {}
        for e in evs:
            acc[key(e)] = acc.get(key(e), 0.0) + e["dur"] / 1000 / frames
        return {k: round(v, 3) for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]}

    def op_chain(e):
        """The CPU operators enclosing runtime call `e`, outermost first."""
        holders = [o for o in ops if o["tid"] == e["tid"]
                   and o["ts"] <= e["ts"] <= o["ts"] + o["dur"]]
        return " > ".join(o["name"] for o in sorted(holders, key=lambda o: -o["dur"])) or "(none)"

    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    runtime = [e for e in timed if e.get("cat") == "cuda_runtime"]
    ops = [e for e in timed if e.get("cat") == "cpu_op"]
    kernels = [e for e in timed if e.get("cat") == "kernel"]
    out = {}
    for part in STAGE_PARTS:
        name = f"stage.{part}"
        host = [e for e in timed if e["name"] == name and e.get("cat") == "user_annotation"]
        dev = [e for e in timed if e["name"] == name and e.get("cat") == "gpu_user_annotation"]
        calls = [e for e in runtime if inside(e, host)]
        waits = [e for e in calls if any(w in e["name"] for w in WAITS)]
        ran = [e for e in kernels if inside(e, dev, same_thread=False)]
        out[part] = {
            "calls": len(host), "host_ms_per_frame": per_frame(host),
            "device_ms_per_frame": per_frame(dev),
            "kernel_ms_per_frame": per_frame(ran),
            "top_kernels_ms_per_frame": top(ran, lambda e: e["name"][:60], 4),
            "wait_ms_per_frame": per_frame(waits),
            "waits_by_op_ms_per_frame": top(waits, op_chain, 4),
            "runtime_ms_per_frame": top(calls, lambda e: e["name"]),
            "cpu_ops_per_frame": sum(inside(e, host) for e in ops) / frames}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile-dir", required=True)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--course", choices=("cli", "drift"), default="cli")
    ap.add_argument("--set", action="append", default=[], metavar="a.b.c=v")
    args = ap.parse_args(argv)

    n = args.warmup + args.frames
    if args.course == "drift":
        import chip_smoke

        cfg = apply_cli_overrides(PipelineConfig(), args.set)
        scans = chip_smoke.drift_course()[0][:n]  # the 360-frame course's first frames
    else:
        cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *args.set])
        scans = [s for s, _ in SyntheticSequence(n_frames=n, seed=0, laps=1.08 * n / 100.0)]
    pipe = SlamPipeline(cfg, device=args.device)
    annotate(pipe)
    for s in scans[: args.warmup]:
        pipe.process_scan(s)
    stage_before = {k: len(v) for k, v in pipe.timings.items()}
    with trace("frame", profile_dir=args.profile_dir):
        for s in scans[args.warmup:]:
            pipe.process_scan(s)
        pipe.flush()
    path = os.path.join(args.profile_dir, "frame.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    print(json.dumps({
        "course": args.course, "frames": args.frames, "device": str(pipe.device),
        "last_ms": trace.last_ms, "ms_per_frame": trace.last_ms / args.frames,
        "trace_file": os.path.abspath(path), "trace_bytes": os.path.getsize(path),
        "span_events": sum(e.get("name") == "frame" for e in events),
        "kernel_events": sum(e.get("cat") == "kernel" for e in events),
        "keyframes": len(pipe.kf_frame_indices),
        "stage_p50_ms": {k: 1000 * float(np.median(v[stage_before[k]:]))
                         for k, v in pipe.timings.items() if len(v) > stage_before[k]},
        "stages": stage_breakdown(events, args.frames),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
