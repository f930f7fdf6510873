"""Profile the port's batched multi-sequence odometry on a CUDA card, a batch frame at a
time, for one tree or for this tree and a parent tree in turns.

    python3 scripts/torch_profile_batch.py --input NPZ [--frames 12] [--root DIR]
    python3 scripts/torch_profile_batch.py --input NPZ --parent DIR

`--input` holds a batch of sequences as `chip_smoke.py` writes it: `scans` [B, F, N, 3]
and `masks` [B, F, N]. `parallel/multi_sequence.py:batch_odometry` of the tree under
`--root` (this checkout by default) runs under the default `ScanMatcherConfig` (map
capacity 32,768):

  1. on every frame of the input, to warm up and to take a digest of its outputs and
     final state (a trees' runs compare by it);
  2. on the first `--frames` frames, timed: each batch frame marked on entry (host clock
     and a CUDA event on the current stream: this tree's frame program call, or the
     parent's op-by-op `_step`), the run ended by a synchronize;
  3. on the same frames under `torch.profiler` (CPU and CUDA activities), from the entry
     of frame 1 to the synchronize.

Prints one JSON line. Over batch frames 1..F-1 (frame 0 warms up and, in this tree,
captures the CUDA graph), a batch frame's: wall ms (run 2, host clock from frame 1's
entry to the synchronize), host ms inside its call, device span ms (run 2, CUDA events
from frame 1's entry to the synchronize), device busy ms (run 3, the profiler's kernel
events, copies and memsets not counted), the idle share (1 - busy / wall), graph launches
(`cudaGraphLaunch` calls), host kernel launches (the runtime's `*LaunchKernel*` calls) and
the other runtime calls by name (run 3); the batched NDT kernel's launches (the wrapper's
count, replays counted from their capture's tally); frame 0's wall ms and the whole call's;
the frame programs' captures, replays and pool bytes (`program_log`, where the tree has
it); the largest device operations. With `--parent`, it runs itself on this tree and on
the parent in turns (this, parent, parent, this), each in a subprocess, prints each run's
line and then one line with the means per tree and whether every run's digest is the
same.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEANS = ("wall_ms_per_frame", "host_ms_per_frame", "device_span_ms_per_frame",
         "device_busy_ms_per_frame", "idle_share", "graph_launches_per_frame",
         "host_launches_per_frame", "first_frame_ms", "call_ms")


def digest(final, outs) -> str:
    """A hex digest of a run's outputs and final state (`batch_odometry`'s return), by
    name: equal digests, equal bits."""
    h = hashlib.sha1()
    for k in sorted(outs):
        h.update(outs[k].contiguous().cpu().numpy().tobytes())
    for name in sorted(vars(final)):
        h.update(getattr(final, name).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def runtime_call(key: str) -> bool:
    """Whether a profiler event's name is a CUDA runtime or driver call."""
    return key.startswith("cuda") or (key.startswith("cu") and key[2:3].isupper())


def in_turns(args) -> int:
    """This script on this tree and the parent in turns, each in a subprocess."""
    runs = []
    for tree, root in (("this", REPO), ("parent", args.parent), ("parent", args.parent),
                       ("this", REPO)):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--input",
                               os.path.abspath(args.input), "--frames", str(args.frames),
                               "--root", root], cwd=root, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode or 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"] = tree
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {f"{tree}_{k}": sum(r[k] for r in runs if r["tree"] == tree) / 2
               for tree in ("this", "parent") for k in MEANS}
    summary["turns"] = [r["tree"] for r in runs]
    summary["card"] = runs[0]["card"]
    summary["digest"] = runs[0]["digest"]
    summary["bit_equal_parent"] = len({r["digest"] for r in runs}) == 1
    print(json.dumps(summary), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if args.parent:
        return in_turns(args)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.core.config import ScanMatcherConfig
    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.parallel import multi_sequence as ms
    from lidar_graph_slam_tpu_torch.utils import capture

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    data = np.load(args.input)
    all_scans = torch.as_tensor(data["scans"], device="cuda")
    all_masks = torch.as_tensor(data["masks"], device="cuda")
    cfg = ScanMatcherConfig()
    logged = "program_log" in inspect.signature(ms.batch_odometry).parameters

    marks: list = []  # (host seconds on entry, seconds on return, CUDA event) a frame
    hooks = {"profiler": None}

    def entering():
        if len(marks) == 1 and hooks["profiler"] is not None:
            hooks["profiler"].start()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append([time.perf_counter(), None, ev])

    def marked(fn):
        def call(*a, **k):
            entering()
            out = fn(*a, **k)
            marks[-1][1] = time.perf_counter()
            return out
        return call

    if hasattr(ms, "_frame_body"):  # a frame is one call of the frame program
        capture.Program.__call__ = marked(capture.Program.__call__)
    else:  # the op-by-op driver: a frame is one `_step`
        ms._step = marked(ms._step)

    def run(frames: int, log=None):
        marks.clear()
        kw = {"program_log": log} if logged else {}
        t0 = time.perf_counter()
        final, outs = ms.batch_odometry(all_scans[:, :frames], all_masks[:, :frames], cfg,
                                        map_capacity=32768, device="cuda", **kw)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        return final, outs, t0, time.perf_counter(), end

    final, outs, *_ = run(all_scans.shape[1])
    run_digest = digest(final, outs)

    F = args.frames
    log: list = []
    before = kernels.ndt_align_loop_batched.launches
    _, _, t0, t_end, end = run(F, log)
    batched = kernels.ndt_align_loop_batched.launches - before
    steady = F - 1
    wall_ms = 1000 * (t_end - marks[1][0]) / steady
    host_ms = 1000 * sum(m[1] - m[0] for m in marks[1:]) / steady
    span_ms = marks[1][2].elapsed_time(end) / steady
    first_ms, call_ms = 1000 * (marks[1][0] - t0), 1000 * (t_end - t0)

    hooks["profiler"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run(F)
    hooks["profiler"].stop()
    ka = hooks["profiler"].key_averages()
    dev_events = [e for e in ka if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1000 / steady
    runtime = {e.key: e.count / steady for e in ka
               if e.device_type == DeviceType.CPU and runtime_call(e.key)}
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps(dict(
        root=os.path.abspath(args.root), card=card, batch=all_scans.shape[0], frames=F,
        points=all_scans.shape[2], digest_frames=all_scans.shape[1], digest=run_digest,
        wall_ms_per_frame=wall_ms, host_ms_per_frame=host_ms,
        device_span_ms_per_frame=span_ms, device_busy_ms_per_frame=busy_ms,
        device_busy_from="the profiler's kernel events (run 3)",
        device_span_from="CUDA events from frame 1's entry to the end (run 2)",
        idle_share=1.0 - busy_ms / wall_ms,
        graph_launches_per_frame=sum(v for k, v in runtime.items() if "GraphLaunch" in k),
        host_launches_per_frame=sum(v for k, v in runtime.items() if "LaunchKernel" in k),
        runtime_calls_per_frame=dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:8]),
        batched_kernel_launches=batched, first_frame_ms=first_ms, call_ms=call_ms,
        programs=log,
        top_device_ms_per_frame=[[e.key[:60], e.self_device_time_total / 1000 / steady]
                                 for e in top])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
