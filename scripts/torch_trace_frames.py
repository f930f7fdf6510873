"""A few frames of the PyTorch port's pipeline under `utils.telemetry.trace`.

    python scripts/torch_trace_frames.py --frames 5 --profile-dir DIR [--device cpu]
        [--course cli|drift|dense] [--warmup N] [--root DIR] [--set a.b.c=v ...]

Runs `--warmup` frames of a synthetic course at the default capacities, then `--frames`
more inside `trace("frame", profile_dir=DIR)`, which writes `DIR/frame.trace.json` (a
Chrome trace of the CPU and CUDA activity). On a tree whose fused front end runs as
captured programs (`odometry/fused.py:FusedFrontEnd`), a replayed program has no parts:
`--frames` more frames then run with the programs' bodies called directly (the same work
on the same buffers, not captured) inside `trace("body", ...)` (`DIR/body.trace.json`),
and their parts are `body_stages`. `--course cli` (the default) is the CLI's
synthetic course with loop closure off; `--course drift` is `chip_smoke.py`'s 360-frame
drift course (`bench.py:bench_e2e`, every frame a keyframe) with the default config, loop
closure on; `--course dense` is `chip_smoke.py`'s 40-frame dense course
(`bench.py:bench_e2e_dense`, ~73k points a frame) with loop closure off. `--root DIR`
runs the package and `chip_smoke.py` of another tree (a parent commit unpacked with
`git archive`), so that two trees can be traced in turns. Prints one JSON line: the
span's wall ms (`trace.last_ms`), ms per frame, the trace file, its size, the number of
events named after the span, the number of CUDA kernel events, `runtime_calls_per_frame`
(the CUDA runtime calls of the traced frames by name, a frame: `cudaGraphLaunch` against
`cudaLaunchKernel` / `cudaLaunchKernelExC`), `device_idle_share` (the share of the
traced frames' device span, first kernel to last, in which no kernel ran), and `stages`:
each part of the fused driver's frame — the fused step (`step`: its dispatch, one replay
on a tree with captured programs) and its parts, the prefilter, the registration and the
health gate with the state update (`step.prefilter`, `step.register`, `step.gate`: the
step's functions wrapped by this script before the pipeline is built, so the program
carries no marks of its own; on a tree with captured programs they are in
`body_stages`), and the back-end stage's parts: the ring insert and target rebuild, the
keyframe hand-over
(`add_keyframe`), the loop tick (`on_frame`) and the rest. With `--set
fused_frontend=false` the parts are the classic driver's (`classic.*`): the prefilter
stage's program, the matcher's `process` and inside it the register program and the
keyframe (`keyframe`: the payload's copy and wait, and the insert program, `insert`), the
keyframe hand-over and the rest; on a tree whose classic driver runs its operators one by
one, its prefilter, `_register`, `_add_keyframe` and `_rebuild_target` take those parts'
places, and on a tree with the classic programs their bodies are called directly for
`body_stages` as the fused ones are. Each part's host ms a frame
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
# The classic driver's parts: (part, owner, attribute on a tree with the classic programs,
# attribute on a tree without them); the owner is the pipeline, its matcher or its back end.
CLASSIC_PARTS = (("prefilter", "pipe", "prefilter_program", "prefilter"),
                 ("process", "front", "process", "process"),
                 ("register", "front", "register_program", "_register"),
                 ("keyframe", "front", "_add_keyframe", "_add_keyframe"),
                 ("insert", "front", "insert_program", "_rebuild_target"),
                 ("add_keyframe", "back", "add_keyframe", "add_keyframe"),
                 ("emit_loop_attempts", "pipe", "_emit_loop_attempts", "_emit_loop_attempts"))
CLASSIC_PROGRAMS = ("prefilter_program", "register_program", "insert_program")
# CUDA runtime calls in which the host waits for the device (cudaFree and cudaMalloc
# can too).
WAITS = ("Synchronize", "cudaMemcpy", "cudaFree", "cudaMalloc")


class Eager:
    """A captured program's body called directly, not replayed (for the body's parts;
    measurement only)."""

    def __init__(self, program):
        self.body, self.captured = program.body, program.captured

    def __call__(self):
        self.body()


def run_bodies(front) -> None:
    """From now on `front`'s programs (a `FusedFrontEnd`) run their bodies directly."""
    front.programs = {rows: Eager(p) for rows, p in front.programs.items()}
    front.insert_program = Eager(front.insert_program)


def mark(owner, attr: str, name: str) -> None:
    """Wrap `owner.attr` (an instance attribute over the method or program) in a
    `record_function` named `name`."""
    fn = getattr(owner, attr)

    def wrapped(*a, _fn=fn, **k):
        with torch.profiler.record_function(name):
            return _fn(*a, **k)

    setattr(owner, attr, wrapped)


def annotate_classic(pipe: SlamPipeline, originals: dict | None = None,
                     bodies: bool = False) -> dict:
    """Mark each of the classic driver's parts (`CLASSIC_PARTS`) as `classic.<part>`; with
    `bodies`, the programs give way to their bodies, called directly. Returns what it
    replaced by (owner, attribute); given back as `originals`, the marks are made anew
    over those."""
    programs = hasattr(pipe, "prefilter_program")
    owners = {"pipe": pipe, "front": pipe.front, "back": pipe.back}
    originals = {} if originals is None else originals
    for part, owner, attr, old_attr in CLASSIC_PARTS:
        attr = attr if programs else old_attr
        fn = originals.setdefault((owner, attr), getattr(owners[owner], attr))
        setattr(owners[owner], attr, Eager(fn) if bodies and attr in CLASSIC_PROGRAMS else fn)
        mark(owners[owner], attr, f"classic.{part}")
    return originals


def unmark_classic(pipe: SlamPipeline, originals: dict) -> None:
    """Put back what `annotate_classic` replaced."""
    owners = {"pipe": pipe, "front": pipe.front, "back": pipe.back}
    for (owner, attr), fn in originals.items():
        setattr(owners[owner], attr, fn)


def annotate(pipe: SlamPipeline, close_gate) -> None:
    """Wrap each back-end part of `pipe` (an instance attribute over the method) in a
    `record_function` named `stage.<part>`, so the trace marks it; with captured programs
    (`pipe.fused_front`), the insert program's call is `stage.insert_and_rebuild` and the
    step's dispatch is `step` (which then closes `step.gate`)."""
    front = getattr(pipe, "fused_front", None)
    for part, attr in STAGE_PARTS.items():
        if part == "insert_and_rebuild" and front is not None:
            owner, attr = front, "insert_and_rebuild"
        else:
            owner = pipe if hasattr(pipe, attr) and attr.startswith("_") else pipe.back
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=f"stage.{part}", **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        setattr(owner, attr, wrapped)
    if front is not None:
        dispatch = front.dispatch

        def step(*a, **k):
            with torch.profiler.record_function("step"):
                try:
                    return dispatch(*a, **k)
                finally:
                    close_gate()

        front.dispatch = step


def annotate_step():
    """Wrap the fused step's functions before a pipeline is built: `make_prefilter`'s and
    `make_register`'s results in `record_function` spans `step.prefilter` and
    `step.register`, and (on a tree without captured programs) the step
    `make_fused_frontend` returns in `step`; `step.gate` opens when the registration
    returns and closes when the step does. Returns the function that closes it."""
    open_gate = []

    def close_gate():
        while open_gate:
            open_gate.pop().__exit__(None, None, None)

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
                    close_gate()

        return init_state, run, aux

    make_fused = fused.make_fused_frontend
    fused.make_prefilter = marked(fused.make_prefilter, "step.prefilter")
    fused.make_register = marked(fused.make_register, "step.register", then=gate_opens)
    if not hasattr(fused, "FusedFrontEnd"):
        runner.make_fused_frontend = make_frontend
    return close_gate


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
    # A graph launch's kernels all carry its runtime call's correlation id.
    by_correlation: dict = {}
    for e in timed:
        if e.get("cat") == "kernel" and "correlation" in e.get("args", {}):
            by_correlation.setdefault(e["args"]["correlation"], []).append(e)

    def launched(calls):
        return [k for c in calls for k in by_correlation.get(
            c.get("args", {}).get("correlation"), ())]

    out = {}
    names = ([(p, p) for p in STEP_PARTS] + [(p, f"stage.{p}") for p in STAGE_PARTS]
             + [(f"classic.{p[0]}", f"classic.{p[0]}") for p in CLASSIC_PARTS])
    for part, name in names:
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
            "runtime_calls_per_frame": calls_by_name(calls, frames),
            "cpu_ops_per_frame": sum(inside(e, host) for e in ops) / frames}
    return out


def calls_by_name(calls: list, frames: int) -> dict:
    """The number of runtime calls a frame, by name."""
    out: dict = {}
    for e in calls:
        out[e["name"]] = out.get(e["name"], 0) + 1
    return {k: v / frames for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def window_numbers(events: list, frames: int) -> dict:
    """The traced frames' CUDA runtime calls by name, a frame, and the device's idle
    share: the part of the span from the first kernel's start to the last one's end in
    which no kernel ran (the union of the kernels' intervals against that span)."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in timed if e.get("cat") == "kernel")
    busy, end = 0.0, None
    for a, b in kernels:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = kernels[-1][1] - kernels[0][0] if kernels else 0.0
    return {"runtime_calls_per_frame": calls_by_name(
                [e for e in timed if e.get("cat") == "cuda_runtime"], frames),
            "device_span_ms": span / 1000, "device_busy_ms": busy / 1000,
            "device_idle_share": 1.0 - busy / span if span else None}


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
        # The 40-frame course's first frames (bodies: those after the warm-up again).
        try:
            scans = chip_smoke.dense_course(40, first=n)[0]
        except TypeError:  # a tree whose `dense_course` simulates every frame
            scans = chip_smoke.dense_course(40)[0][:n]
    else:
        cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=False", *args.set])
        scans = [s for s, _ in SyntheticSequence(n_frames=n, seed=0, laps=1.08 * n / 100.0)]
    close_gate = annotate_step()
    pipe = SlamPipeline(cfg, device=args.device)
    front = getattr(pipe, "fused_front", None)
    classic_programs = not pipe.fused and hasattr(pipe, "prefilter_program")
    if pipe.fused:
        annotate(pipe, close_gate)
    else:
        originals = annotate_classic(pipe)
    for s in scans[: args.warmup]:
        pipe.process_scan(s)
    stage_before = {k: len(v) for k, v in pipe.timings.items()}
    kf_before = len(pipe.kf_frame_indices)
    with trace("frame", profile_dir=args.profile_dir):
        for s in scans[args.warmup:args.warmup + args.frames]:
            pipe.process_scan(s)
        pipe.flush()
    window_keyframes = len(pipe.kf_frame_indices) - kf_before
    path = os.path.join(args.profile_dir, "frame.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    frame_ms, body = trace.last_ms, {}
    if front is not None or classic_programs:
        # Each program's pool, then the same parts with the programs' bodies called
        # directly on the same buffers, over the same frames once more.
        if classic_programs:
            unmark_classic(pipe, originals)
            log = pipe.program_log()
            pools = {name: rec["pool_bytes"] for name, rec in log.items()}
            captures = sum(rec["captures"] for rec in log.values())
            body = {"programs": log}
            annotate_classic(pipe, originals, bodies=True)
        else:
            pools = {str(rows): p.pool_bytes() for rows, p in front.programs.items()}
            pools["insert"] = front.insert_program.pool_bytes()
            captures = front.captures
            run_bodies(front)
        scans = scans + scans[args.warmup:]
        with trace("body", profile_dir=args.profile_dir):
            for s in scans[args.warmup + args.frames:]:
                pipe.process_scan(s)
            pipe.flush()
        with open(os.path.join(args.profile_dir, "body.trace.json")) as f:
            body_events = json.load(f)["traceEvents"]
        body = {**body, "body_ms_per_frame": trace.last_ms / args.frames,
                "body_window": window_numbers(body_events, args.frames),
                "body_stages": stage_breakdown(body_events, args.frames),
                "captures": captures, "pool_bytes": pools}
        del body_events
    print(json.dumps({
        "course": args.course, "root": ROOT, "frames": args.frames,
        "device": str(pipe.device),
        "last_ms": frame_ms, "ms_per_frame": frame_ms / args.frames,
        "trace_file": os.path.abspath(path), "trace_bytes": os.path.getsize(path),
        "span_events": sum(e.get("name") == "frame" for e in events),
        "kernel_events": sum(e.get("cat") == "kernel" for e in events),
        "keyframes": len(pipe.kf_frame_indices), "window_keyframes": window_keyframes,
        "stage_p50_ms": {k: 1000 * float(np.median(v[stage_before[k]:]))
                         for k, v in pipe.timings.items() if len(v) > stage_before[k]},
        **window_numbers(events, args.frames),
        "stages": stage_breakdown(events, args.frames),
        **body,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
