"""Split one working launch of the NDT loop kernel (`ndt_iteration`, `csrc/ndt_loop.cu`)
into its parts on one CUDA card, by timing variants of the kernel that stop earlier.

    python3 scripts/torch_ndt_loop_split.py [--json PATH]

For each variant the script copies this checkout's `csrc/` and `ops/kernels.py` into
`.chip_scratch/ndt_loop_split/<variant>/`, edits the copies of `ndt_loop.cu` and of
`loop_common.cuh` (the reduction and the step it shares with the GICP loop kernel) there
(the package itself is never changed), builds it with the package's own nvcc flags and
loads it beside the others:

  full       the kernel as it is;
  no_step    the last block writes one total instead of taking the step;
  no_tail    each block writes its partial row and exits: no ticket, no last block;
  no_reduce  each thread folds its sums into one register and exits: no block reduction;
  exit       every launch returns after the `done` test: the launch floor.

Each variant runs the phase 3b fine fixture of `chip_smoke.py` (the dense course's last
ring scan, N = 32,768, from a perturbed guess against the full ring's 2 m map; the
coarse one too, N = 8,192 against the 4 m map): `split_times` of a loop of 20 launches
with epsilon 0 (every launch works) less a loop of 1, over 19, in ROUNDS rounds that take
the variants in turn. The parts of a working launch are the differences of neighbouring
variants: step = full - no_step, ticket and last-block sum = no_step - no_tail, block
reduction = no_tail - no_reduce, transform + gather + accumulation = no_reduce - exit.
A variant that skips the step leaves T at the guess, so its gathers see the guess's
hits on every launch; the full kernel's see the converging T's (within a few percent).
Launches are programmatic dependents of each other, so a launch's start overlaps its
predecessor's tail, and each difference also holds what that overlap hides or shows in
the variant: read a small or negative part as "within the overlap".

Prints the card's name and power limit, ptxas's registers per variant, one JSON line per
variant and stage, then one JSON line of the split.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lidar_graph_slam_tpu_torch"

ROUNDS = 3

# (anchor, replacement) edits per variant, each made in the one of EDITED that holds the
# anchor.
EDITED = ("ndt_loop.cu", "loop_common.cuh")
_EXIT = "  if (!polish && *done) return;  // the loop's cond: this sequence is finished\n"
_STEP_CALL = ("  gn_step_warp<kCap, kMinInliers>(tot, Ts, damping, done0, iters0, T, done, "
              "carry.iters + b,\n                                  carry.fitness + b, "
              "carry.inliers + b, st, polish);")
_TICKET = "  if (t == 0) last = ticket(counter + b) == gridDim.x - 1;"
_SCATTER = "  red[warp][lane] = warp_reduce_scatter(acc);"
_NO_REDUCE = """  {
    float s_ = 0.f;
    for (int q = 0; q < kRow; ++q) s_ += acc[q];
    if (s_ == 1.2345e-30f) partials[blockIdx.x] = s_;  // keeps the sums alive
    return;
  }"""

VARIANTS = {
    "full": [],
    "no_step": [(_STEP_CALL, "  if (lane == 0) carry.fitness[b] = tot + damping;")],
    "no_tail": [(_TICKET, "  return;")],
    "no_reduce": [(_SCATTER, _NO_REDUCE)],
    "exit": [(_EXIT, _EXIT + "  return;\n")],
}
ORDER = ("full", "no_step", "no_tail", "no_reduce", "exit")


def make_variant(out: str, edits) -> str:
    """Copies this checkout's csrc/ and ops/kernels.py under out/ with `edits` applied to
    the files of EDITED; returns out."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG, "csrc"), os.path.join(out, PKG, "csrc"))
    os.makedirs(os.path.join(out, PKG, "ops"))
    shutil.copy(os.path.join(REPO, PKG, "ops", "kernels.py"), os.path.join(out, PKG, "ops"))
    paths = [os.path.join(out, PKG, "csrc", name) for name in EDITED]
    srcs = {}
    for path in paths:
        with open(path) as f:
            srcs[path] = f.read()
    for anchor, new in edits:
        holders = [p for p in paths if srcs[p].count(anchor) == 1]
        if len(holders) != 1 or sum(srcs[p].count(anchor) for p in paths) != 1:
            raise SystemExit(f"torch_ndt_loop_split: anchor not found once: {anchor!r}")
        srcs[holders[0]] = srcs[holders[0]].replace(anchor, new)
    for path, src in srcs.items():
        with open(path, "w") as f:
            f.write(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ndt_loop_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    base = os.path.join(REPO, ".chip_scratch", "ndt_loop_split")
    mods = {v: chip_smoke.tree_kernels(make_variant(os.path.join(base, v), VARIANTS[v]),
                                       f"ndt_loop_split_{v}") for v in ORDER}
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per variant, all at once
        list(pool.map(lambda m: m.load_library(), mods.values()))
    for v, m in mods.items():
        regs = [ln.strip() for ln in m.build_info["log"].splitlines()
                if "registers" in ln]
        print(f"[{v}] nvcc_seconds={m.build_info['seconds']:.2f}", flush=True)
        for ln in regs:
            print(f"  ptxas: {ln}", flush=True)

    dev = torch.device("cuda")
    cfg = chip_smoke.loops_off_config()
    ndt_cfg = cfg.scan_matcher.ndt
    scans, gt = chip_smoke.dense_course(40)
    aux, ring, last = chip_smoke.full_ring(cfg, scans, gt, dev)
    coarse, fine = aux["rebuild"](ring)
    init = torch.as_tensor(chip_smoke.perturbed(gt[aux["window"] - 1]), device=dev)
    stages = {"fine": chip_smoke.loop_args(fine, last.points, last.mask, init, ndt_cfg, False),
              "coarse": chip_smoke.loop_args(coarse, last.points, last.mask, init, ndt_cfg,
                                             True)}
    times = {(s, v): [] for s in stages for v in ORDER}
    for _ in range(ROUNDS):
        for s, a in stages.items():
            for v, m in mods.items():
                def loop(its, m=m, a=a):
                    return lambda: m.ndt_align_loop(*a[:7], 0.0, a[8], its, 0)
                work = chip_smoke.split_times(loop(20), calls=10, warmup=2)
                one = chip_smoke.split_times(loop(1), calls=40, warmup=2)
                times[(s, v)].append((work["device_us"] - one["device_us"]) / 19)
    lines = []
    for (s, v), ts in times.items():
        lines.append(dict(stage=s, variant=v, working_launch_us=float(
            np.median(ts)), rounds=[round(t, 3) for t in ts], card=card))
        print(json.dumps(lines[-1]), flush=True)
    split = {}
    for s in stages:
        t = {v: float(np.median(times[(s, v)])) for v in ORDER}
        split[s] = dict(working_launch_us=t["full"], step_us=t["full"] - t["no_step"],
                        ticket_and_last_block_us=t["no_step"] - t["no_tail"],
                        block_reduction_us=t["no_tail"] - t["no_reduce"],
                        gather_and_accumulation_us=t["no_reduce"] - t["exit"],
                        launch_floor_us=t["exit"])
    lines.append(dict(split=split, card=card))
    print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
