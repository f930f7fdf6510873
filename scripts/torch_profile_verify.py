"""Time and profile loop attempts of the PyTorch port on a CUDA card, and compare two trees.

    python3 scripts/torch_profile_verify.py --write-input F.npz [--frames 200]
    python3 scripts/torch_profile_verify.py --input F.npz [--root DIR] [--attempts 6]
        [--set graph_slam.registration_method=GICP ...] [--trace PATH]
    python3 scripts/torch_profile_verify.py --input F.npz --parent DIR [--attempts 6]

`--write-input` runs the first `--frames` frames of `chip_smoke.py`'s drift course
(`bench.py:bench_e2e`) with loops off and writes the back end's keyframes (front-end
poses, clouds, accumulated distances) to F; `chip_smoke.py` phase 10 writes the same file
from its own course, up to its first attempt's latest keyframe. `--input` feeds them to a
back end at the default config (with `--set` overrides) on the card, with the
asynchronous back end, and makes `--attempts` loop attempts for the latest keyframe, each
as a tick makes it (`begin_loop_attempt` on this thread, the verification in the verify
worker) and joined at once (`_consume_verify`). The first attempt captures the programs
on a tree that runs them (`graph/slam.py:LoopPrograms`). Then one more attempt, its start
and its worker's whole verification, runs under `torch.profiler`.

Prints one JSON line: the tree; per attempt the frame thread's ms in
`begin_loop_attempt` (`stage_ms`) and the worker's verification ms (`verify_ms`, from
`GraphBasedSLAM.verify_seconds`), the p50 and max of both after the first attempt, and the
p50 of the frame thread's submap assembly and cloud reads inside `begin_loop_attempt`
(`stage_parts_p50_ms`; the assembly includes the reads it makes); the
programs' log (captures, replays, pool bytes, first call's parts) where the tree has
them; and of the profiled attempt: its wall ms, the CUDA runtime calls by thread (`frame`,
`worker`) and name, the device's busy ms (kernels, copies and fills, their union), the
span from the first to the last of them and the share of that span in which the device
was idle, and the 10 kernels with the most device time. A profiled attempt's wall is
slower than an unprofiled one (CUPTI), so take times from the attempts before it.
`--parent DIR` runs this tree and DIR (a parent commit unpacked with `git archive`) in
turns (this, parent, parent, this), each in a process of its own, and prints one JSON
line with the four runs. `--trace` writes the profiled attempt's Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tree whose package runs: this checkout, or `--root DIR` (read before the imports).
ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]) if "--root" in sys.argv else REPO
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Runtime calls that launch kernels one by one (a graph replay is `cudaGraphLaunch`).
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def write_input(path: str, frames: int) -> int:
    import chip_smoke

    scans, gt = chip_smoke.drift_course(360)
    pipe, _res, _ = chip_smoke.run_loop_course(chip_smoke.loops_off_config(),
                                               scans[:frames], gt[:frames], "cuda")
    save_keyframes(path, pipe.back, pipe.back.n_keyframes - 1)
    return 0


def save_keyframes(path: str, back, latest: int) -> None:
    """Keyframes 0..latest of `back` (front-end poses, clouds, accumulated distances)."""
    clouds = [back._cloud(k) for k in range(latest + 1)]
    np.savez(path, poses=np.stack(back.kf_front_poses[:latest + 1]),
             accum=np.asarray(back.kf_accum_dist[:latest + 1], np.float64),
             points=np.concatenate(clouds), sizes=np.array([len(c) for c in clouds]))


def load_backend(path: str, sets):
    from lidar_graph_slam_tpu_torch.core.config import PipelineConfig, apply_cli_overrides
    from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM

    cfg = apply_cli_overrides(PipelineConfig(), list(sets))
    back = GraphBasedSLAM(cfg.graph_slam, cfg.capacity, device="cuda")
    z = np.load(path)
    ends = np.cumsum(z["sizes"])
    for k, (a, b) in enumerate(zip(ends - z["sizes"], ends)):
        cloud = z["points"][a:b]
        back.add_keyframe({"pose": z["poses"][k], "cloud": cloud,
                           "cloud_mask": np.ones(len(cloud), bool),
                           "accum_distance": float(z["accum"][k])})
    return back


def timed_parts(back):
    """Wraps the back end's `_assemble_submap` and `_cloud` (instance attributes) to sum
    their ms into the returned dict; `parts.clear()` starts a new sum."""
    parts: dict = {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[name] = parts.get(name, 0.0) + 1000 * (time.perf_counter() - t0)
        return call

    back._assemble_submap = timed("assemble_submap", back._assemble_submap)
    back._cloud = timed("cloud", back._cloud)
    return parts


def attempt(back, parts: dict) -> tuple:
    """One attempt as a tick makes it, joined at once: the frame thread's ms in
    `begin_loop_attempt`, and the ms of its parts (`timed_parts`; the submap's assembly
    includes its clouds' reads)."""
    parts.clear()
    t0 = time.perf_counter()
    pending = back.begin_loop_attempt()
    t1 = time.perf_counter()
    if pending is None:
        raise SystemExit(f"keyframe {back.n_keyframes - 1} has no loop candidate")
    split = dict(parts)
    back._consume_verify(pending)
    return 1000 * (t1 - t0), split


def device_numbers(events: list) -> dict:
    """The union of the device's kernels, copies and fills: busy ms, the span from the
    first to the last, and the share of that span in which none ran."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"device_busy_ms": busy / 1000, "device_span_ms": span / 1000,
            "device_idle_share": 1.0 - busy / span if span else None}


def profile_attempt(back, trace: str | None) -> dict:
    """One attempt's start and its worker's whole verification under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    tids = {"frame": threading.get_native_id()}
    verify = back._verify

    def spy(*a, **k):
        tids["worker"] = threading.get_native_id()
        return verify(*a, **k)

    back._verify = spy
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pending = back.begin_loop_attempt()
            pending["thread"].join()
            wall = 1000 * (time.perf_counter() - t0)
    finally:
        del back._verify
    back._consume_verify(pending)
    path = trace or os.path.join(REPO, ".chip_scratch", "profile_verify", "attempt.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    # The trace names the main thread by its native id; the worker's id in it may differ
    # from `threading.get_native_id`, so a sole other thread making runtime calls is it.
    callers = {e.get("tid") for e in events if e.get("cat") == "cuda_runtime"}
    names = {tids["frame"]: "frame"}
    others = callers - {tids["frame"]}
    if tids.get("worker") in callers:
        names[tids["worker"]] = "worker"
    elif len(others) == 1:
        names[others.pop()] = "worker"
    calls: dict = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            who = calls.setdefault(names.get(e.get("tid"), f"tid_{e.get('tid')}"), {})
            who[e["name"]] = who.get(e["name"], 0) + 1
    kernels_ms: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels_ms[e["name"][:70]] = kernels_ms.get(e["name"][:70], 0.0) + e["dur"] / 1000
    top = dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:10])
    return {"wall_ms": wall, "runtime_calls": calls,
            "graph_launches": {k: v.get("cudaGraphLaunch", 0) for k, v in calls.items()},
            "kernel_launch_calls": {k: sum(v.get(n, 0) for n in KERNEL_LAUNCHES)
                                    for k, v in calls.items()},
            **device_numbers(events), "kernels": sum(e.get("cat") == "kernel" for e in events),
            "top_kernels_ms": {k: round(v, 4) for k, v in top.items()}, "trace": path}


def run_tree(path: str, attempts: int, sets, trace: str | None) -> dict:
    from lidar_graph_slam_tpu_torch.ops import kernels

    kernels.load_library()
    back = load_backend(path, sets)
    parts = timed_parts(back)
    runs = [attempt(back, parts) for _ in range(attempts)]
    del back._assemble_submap, back._cloud
    stage = [ms for ms, _ in runs]
    verify = [1000 * s for s in back.verify_seconds]
    torch.cuda.synchronize()
    out = {"root": ROOT, "latest": back.n_keyframes - 1, "attempts": attempts,
           "stage_ms": [round(v, 3) for v in stage], "verify_ms": [round(v, 3) for v in verify],
           "stage_p50_ms": float(np.median(stage[1:])), "stage_max_ms": max(stage[1:]),
           "stage_parts_p50_ms": {k: float(np.median([p.get(k, 0.0) for _, p in runs[1:]]))
                                  for k in ("assemble_submap", "cloud")},
           "verify_p50_ms": float(np.median(verify[1:])), "verify_max_ms": max(verify[1:]),
           "first_verify_ms": verify[0]}
    if hasattr(back, "loop_programs"):
        out["programs"] = back.loop_programs.log()
    out["profiled"] = profile_attempt(back, trace)
    return out


def in_turns(path: str, parent: str, attempts: int, sets) -> dict:
    runs = {}
    for i, (tree, root) in enumerate((("this", ROOT), ("parent", parent), ("parent", parent),
                                      ("this", ROOT))):
        cmd = [sys.executable, os.path.abspath(__file__), "--input", os.path.abspath(path),
               "--root", os.path.abspath(root), "--attempts", str(attempts),
               "--trace", os.path.join(REPO, ".chip_scratch", "profile_verify", f"{i}_{tree}.json")]
        for s in sets:
            cmd += ["--set", s]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.abspath(root))
        if proc.returncode != 0:
            raise SystemExit(f"{tree} failed:\n{proc.stderr[-3000:]}")
        runs[f"{i}_{tree}"] = json.loads(proc.stdout.strip().splitlines()[-1])
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write-input")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--input")
    ap.add_argument("--root")
    ap.add_argument("--parent")
    ap.add_argument("--attempts", type=int, default=6)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.write_input:
        return write_input(args.write_input, args.frames)
    if not args.input:
        ap.error("--write-input F, or --input F")
    if args.attempts < 2:
        ap.error("--attempts: at least 2 (the first captures)")
    if args.parent:
        out = in_turns(args.input, args.parent, args.attempts, args.set)
    else:
        out = run_tree(args.input, args.attempts, args.set, args.trace)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
