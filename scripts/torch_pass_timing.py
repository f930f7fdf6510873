"""Time the prefilter passes `cell_keys` and `sorted_runs` of one or more trees of the
PyTorch port on a CUDA card, at every shape the main path gives them, in turns.

    python3 scripts/torch_pass_timing.py --root . [--root DIR ...]

Each `--root` is a tree of the package (the first is this checkout, the others loaded
beside it, such as a parent commit unpacked by `git archive`).

The fixtures are made once, with this checkout's plain versions on the card:

  prefilter_dense, prefilter_drift   the default prefilter's keys (with the distance
        filter) and runs (C = 65,536) on the dense course's first frame (its 131,072-row
        bucket) and the drift course's frame 100 (8,192 rows), as `chip_smoke.py` phase
        10c makes them (`prefilter_kernel_inputs`), and the SOR's keys and gather
        (`_sor`);
  ring_dense, ring_drift   a target build's fine level on a full ring (20 scans at their
        true poses: the dense course's first 20, the drift course's first 20): the keys
        at the NDT resolution (N = 655,360) and the runs with the gather (C = 65,536);
  coarse_dense, coarse_drift   the coarse level's runs over the fine level's 65,536
        merged rows (C = 32,768, no gather), as `ops/voxel.py:_coarse_runs` sorts them.

Every tree's outputs equal the plain version's bit for bit (a rerun too). Per fixture,
kernel and tree: device us a call (`chip_smoke.split_times`, a spin-held event pair over
200 calls), host us, launches a call (the wrapper's count), in turns (the trees in order,
then in reverse), the bound (`chip_smoke.pass_bound`). Prints one JSON line a fixture and
kernel, then a summary line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence  # noqa: E402
from lidar_graph_slam_tpu_torch.ops import kernels  # noqa: E402

KERNELS = ("cell_keys", "sorted_runs")
RING_SCANS = 20


def drift_scans(n: int):
    """The first `n` scans of `chip_smoke.drift_course` and their true poses (the same
    course, its other frames not simulated)."""
    seq = SyntheticSequence(n_frames=360, seed=1, extent=60.0, radius=35.0,
                            max_points=131072, noise=0.02, laps=3.05, n_azimuth=2048,
                            n_elevation=64)
    scans = [scan for scan, _ in itertools.islice(seq, n)]
    T0_inv = np.linalg.inv(seq.poses[0])
    return scans, np.stack([(T0_inv @ p).astype(np.float32) for p in seq.poses[:n]])


def ring_fixtures(cfg, scans, gt, dev) -> dict:
    """The target build's key passes on a full ring of `scans` at poses `gt`
    (`chip_smoke.ring_pass_inputs`) and the ring's valid rows."""
    _, ring, _ = cs.full_ring(cfg, scans, gt, dev)
    out = cs.ring_pass_inputs(cfg, ring)
    out["valid_rows"] = int(ring.masks.sum())
    return out


def fixtures(dev) -> dict:
    """{label: {kernel: args}} for every shape of the module docstring."""
    cfg = cs.loops_off_config()
    out = {}
    dense, dense_gt = cs.dense_course(40, first=RING_SCANS)
    drift, drift_gt = drift_scans(max(RING_SCANS, cs.PREFILTER_DRIFT_FRAME + 1))
    for tag, scans, gt, frame in (("dense", dense, dense_gt, 0),
                                  ("drift", drift, drift_gt, cs.PREFILTER_DRIFT_FRAME)):
        raw = torch.as_tensor(cs.raw_bucket(scans[frame], cfg.capacity.raw_points), device=dev)
        inputs = cs.prefilter_kernel_inputs(cfg, raw)
        out[f"prefilter_{tag}"] = {k: inputs["voxel"][k] for k in KERNELS}
        out[f"prefilter_{tag}_sor"] = {k: inputs["sor"][k] for k in KERNELS}
        ring = ring_fixtures(cfg, scans[:RING_SCANS], gt[:RING_SCANS], dev)
        out[f"ring_{tag}"] = ring["ring"]
        out[f"coarse_{tag}"] = ring["coarse"]
        print(json.dumps({"fixture": f"ring_{tag}", "rows": ring["ring"]["cell_keys"][0]
                          .shape[0], "valid_rows": ring["valid_rows"]}), flush=True)
    return out


def tree_runs(roots) -> list:
    """[(label, kernels module)]: this checkout's, then each other root's."""
    return [("this", kernels)] + [(f"root{i}", cs.tree_kernels(r, f"timing_kernels_{i}"))
                                  for i, r in enumerate(roots[1:], 1)]


def call(mod, name, args):
    """One call of `mod.<name>` on `args` as that tree takes them
    (`chip_smoke.parent_pass_args`)."""
    return getattr(mod, name)(*cs.parent_pass_args(name, args, mod))


def time_fixture(label, name, args, runs, clock_mhz) -> dict:
    ref = cs.flat_pass(cs.PASS_PLAIN[name](*args))
    rec = dict(fixture=label, kernel=name, **cs.pass_bound(name, args, clock_mhz))
    for run, mod in runs:
        before = getattr(mod, name).launches
        out = cs.flat_pass(call(mod, name, args))
        torch.cuda.synchronize()
        launches = getattr(mod, name).launches - before
        again = cs.flat_pass(call(mod, name, args))
        cs.same_bits(f"{name} {label} {run}", [f"out{i}" for i in range(len(ref))], out,
                     again, ref)
        rec[f"{run}_launches"] = launches
    times = {run: [] for run, _ in runs}
    for run, mod in runs + runs[::-1]:
        times[run].append(cs.split_times(lambda: call(mod, name, args)))
    for run, ts in times.items():
        rec[f"{run}_device_us"] = float(np.mean([t["device_us"] for t in ts]))
        rec[f"{run}_host_us"] = float(np.mean([t["host_us"] for t in ts]))
        rec[f"{run}_turns_us"] = [round(t["device_us"], 3) for t in ts]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a tree of the package; the first is this checkout")
    ap.add_argument("--only", nargs="*", default=None, help="fixtures to time (all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_pass_timing: needs a CUDA card", file=sys.stderr)
        return 2
    roots = args.root or ["."]
    if os.path.abspath(roots[0]) != REPO:
        raise SystemExit("the first --root must be this checkout")
    dev = torch.device("cuda")
    card = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    kernels.load_library()
    runs = tree_runs(roots)
    for _, mod in runs:
        mod.load_library()
    fx = fixtures(dev)
    summary = {}
    for label, per in fx.items():
        if args.only and label not in args.only:
            continue
        for name, fargs in per.items():
            rec = time_fixture(label, name, fargs, runs, clock_mhz)
            rec["card"] = card
            print(json.dumps(rec), flush=True)
            summary[f"{label}/{name}"] = {run: round(rec[f"{run}_device_us"], 3)
                                          for run, _ in runs}
    print(json.dumps({"card": card, "runs": [r for r, _ in runs],
                      "device_us": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
