"""A few frames of the PyTorch port's pipeline under `utils.telemetry.trace`.

    python scripts/torch_trace_frames.py --frames 5 --profile-dir DIR [--device cpu]
        [--course cli|drift|dense] [--warmup N] [--root DIR] [--set a.b.c=v ...]

Runs `--warmup` frames of a synthetic course at the default capacities, then `--frames`
more inside `trace("frame", profile_dir=DIR)`, which writes `DIR/frame.trace.json` (a
Chrome trace of the CPU and CUDA activity). `--course cli` (the default) is the CLI's
synthetic course with loop closure off; `--course drift` is `chip_smoke.py`'s 360-frame
drift course (`bench.py:bench_e2e`, every frame a keyframe) with the default config, loop
closure on; `--course dense` is `chip_smoke.py`'s 40-frame dense course
(`bench.py:bench_e2e_dense`, ~73k points a frame) with loop closure off. `--root DIR`
runs the package and `chip_smoke.py` of another tree (a parent commit unpacked with
`git archive`), so that two trees can be traced in turns. Prints one JSON line: the
span's wall ms (`trace.last_ms`), ms per frame, the trace file, its size, the number of
events named after the span, the number of CUDA kernel events, and `stages`: each part
of the fused driver's frame — the fused step (`step`) and its parts, the prefilter, the
registration and the health gate with the state update (`step.prefilter`,
`step.register`, `step.gate`: the step's functions wrapped by this script before the
pipeline is built, so the program carries no marks of its own), and the back-end
stage's parts: the ring insert and target rebuild, the keyframe hand-over
(`add_keyframe`), the loop tick (`on_frame`) and the rest — each part's host ms a frame
(marked in the trace with `record_function`), the kernels it launched (their number, own
ms and the device ms from the first to the last; the kernels that take most named), how
far its last kernel ends after the host's span (`device_behind_ms`: > 0 when the device
runs behind the host's enqueue), the CUDA runtime calls it made (the host's synchronous
waits on the device among them: synchronizes, copies, frees and allocations, each wait
also by the chain of CPU operators that made it) and its CPU operators, beside the stage
timers' p50s over the traced frames. Run it in a process of its own: a profiler session
can leave the process slower afterwards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tree whose package runs: this checkout, or `--root DIR` (read before the imports).
ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]) if "--root" in sys.argv else REPO
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides  # noqa: E402
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from lidar_graph_slam_tpu_torch.odometry import fused  # noqa: E402
from lidar_graph_slam_tpu_torch.pipeline import runner  # noqa: E402
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline  # noqa: E402
from lidar_graph_slam_tpu_torch.utils.telemetry import trace  # noqa: E402

# The fused step's parts: the step itself, its prefilter and registration, and the health
# gate with the state update (from the registration's return to the step's).
STEP_PARTS = ("step", "step.prefilter", "step.register", "step.gate")
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


def annotate_step() -> None:
    """Wrap the fused step's functions before a pipeline is built: `make_prefilter`'s and
    `make_register`'s results in `record_function` spans `step.prefilter` and
    `step.register`, and the step `make_fused_frontend` returns in `step`; `step.gate`
    opens when the registration returns and closes when the step does."""
    open_gate = []

    def marked(make, name, then=None):
        def make_marked(*a, **k):
            fn = make(*a, **k)

            def run(*args, **kw):
                with torch.profiler.record_function(name):
                    out = fn(*args, **kw)
                if then is not None:
                    then()
                return out

            return run

        return make_marked

    def gate_opens():
        span = torch.profiler.record_function("step.gate")
        span.__enter__()
        open_gate.append(span)

    def make_frontend(*a, **k):
        init_state, step, aux = make_fused(*a, **k)

        def run(*args, **kw):
            with torch.profiler.record_function("step"):
                try:
                    return step(*args, **kw)
                finally:
                    while open_gate:
                        open_gate.pop().__exit__(None, None, None)

        return init_state, run, aux

    make_fused = fused.make_fused_frontend
    fused.make_prefilter = marked(fused.make_prefilter, "step.prefilter")
    fused.make_register = marked(fused.make_register, "step.register", then=gate_opens)
    runner.make_fused_frontend = make_frontend


def stage_breakdown(events: list, frames: int) -> dict:
    """Per part, a frame: the host ms of its `record_function` spans; the kernels launched
    inside them (each kernel tied to the runtime call that launched it by the profiler's
    correlation id): their number, their own ms, the kernels that take most, and the
    device ms from each span's first kernel to its last, gaps included; how far the last
    of a span's kernels ends after the span (the mean over spans, `device_behind_ms`: > 0
    when the device runs behind the host's enqueue); the ms of the CUDA runtime calls made
    inside the host spans by name (the synchronous waits among them summed apart, and by
    the chain of CPU operators that made them), and the number of CPU operators they ran."""
    def inside(e, spans):
        return any(s["tid"] == e["tid"] and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]
                   for s in spans)

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
    by_correlation = {e["args"]["correlation"]: e for e in timed
                      if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}

    def launched(calls):
        return [by_correlation[c["args"]["correlation"]] for c in calls
                if c.get("args", {}).get("correlation") in by_correlation]

    out = {}
    for part, name in [(p, p) for p in STEP_PARTS] + [(p, f"stage.{p}") for p in STAGE_PARTS]:
        host = [e for e in timed if e["name"] == name and e.get("cat") == "user_annotation"]
        calls = [e for e in runtime if inside(e, host)]
        waits = [e for e in calls if any(w in e["name"] for w in WAITS)]
        ran, spans, behind = [], 0.0, []
        for h in host:
            ks = launched([c for c in calls if inside(c, [h])])
            ran += ks
            if ks:
                end = max(k["ts"] + k["dur"] for k in ks)
                spans += end - min(k["ts"] for k in ks)
                behind.append(end - (h["ts"] + h["dur"]))
        out[part] = {
            "calls": len(host), "host_ms_per_frame": per_frame(host),
            "device_ms_per_frame": spans / 1000 / frames,
            "launches_per_frame": len(ran) / frames,
            "kernel_ms_per_frame": per_frame(ran),
            "device_behind_ms": sum(behind) / len(behind) / 1000 if behind else None,
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
    ap.add_argument("--course", choices=("cli", "drift", "dense"), default="cli")
    ap.add_argument("--root", default=None, help="another tree's package (read at import)")
    ap.add_argument("--set", action="append", default=[], metavar="a.b.c=v")
    args = ap.parse_args(argv)

    n = args.warmup + args.frames
    if args.course == "drift":
        import chip_smoke

        cfg = apply_cli_overrides(PipelineConfig(), args.set)
        scans = chip_smoke.drift_course()[0][:n]  # the 360-frame course's first frames
    elif args.course == "dense":
        import chip_smoke

        cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *args.set])
        scans = chip_smoke.dense_course(40)[0][:n]  # the 40-frame course's first frames
    else:
        cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *args.set])
        scans = [s for s, _ in SyntheticSequence(n_frames=n, seed=0, laps=1.08 * n / 100.0)]
    annotate_step()
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
        "course": args.course, "root": ROOT, "frames": args.frames,
        "device": str(pipe.device),
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
