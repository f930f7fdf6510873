"""Split one working launch of the GICP loop kernel (`gicp_iteration`, `csrc/gicp_loop.cu`)
into its parts on one CUDA card, by timing variants of the kernel that skip a part.

    python3 scripts/torch_gicp_loop_split.py [--json PATH]

For each variant the script copies this checkout's `csrc/` and `ops/kernels.py` into
`.chip_scratch/gicp_loop_split/<variant>/`, edits the copy of `gicp_loop.cu` there (the
package itself is never changed), builds it with the package's own nvcc flags (one nvcc
per variant, all at once) and loads it beside the others:

  full     the kernel as it is;
  one_row  every lane of a query reads its cell's first candidate row instead of its own
           slots: the same loads and arithmetic, 1/32 of the distinct candidate bytes (the
           results are wrong; the times say what the candidates' bytes cost);
  no_rows  the scan runs, no matched row is formed or accumulated;
  no_scan  no query at all: the tile, the transform, the reduction and the step;
  exit     every launch returns after the `done` test: the launch floor.

Each variant runs the front-end fixture of `chip_smoke.py`'s gicp-loop phase (the dense
course's last ring scan, N = 32,768, from a perturbed guess against the GICP target of
the full 20-scan ring, 655,360 rows): `split_times` of a loop of 20 launches with epsilon
0 (every launch works) less a loop of 1, over 19, in ROUNDS rounds that take the variants
in turn. The parts: scan = no_rows - no_scan, rows = full - no_rows, tail (tile,
transform, reduction, step) = no_scan - exit; full - one_row is what the candidate rows'
bytes add to the scan's latency. Variants that match nothing leave T at the guess.

Prints the card's name and power limit, ptxas's registers per variant, one JSON line per
variant, then one JSON line of the split.
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

# (anchor, replacement) edits of gicp_loop.cu per variant.
_LOAD = "__ldg(g.packed + s[k] + lane16 + kSegment * t);"
_SCAN = ("    const float d2 =\n        warp_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, x, y, "
         "z, mine, sm, row);")
_GATE = "    bool cand = d2 < a.corr2;  // found, masked in, within the gate\n"
_EXIT = "  if (*a.carry.done) return;  // the loop's cond: the alignment is finished\n"

VARIANTS = {
    "full": [],
    "one_row": [(_LOAD, _LOAD.replace(" + lane16 + kSegment * t", ""))],
    "no_rows": [(_GATE, _GATE + "    if (d2 == -1.f) acc[0] += (float)row;  // keeps the scan\n"
                 "    cand = false;\n")],
    "no_scan": [(_SCAN, "    const float d2 = INFINITY;")],
    "exit": [(_EXIT, _EXIT + "  return;\n")],
}
ORDER = ("full", "one_row", "no_rows", "no_scan", "exit")


def make_variant(out: str, edits) -> str:
    """Copies this checkout's csrc/ and ops/kernels.py under out/ with `edits` applied to
    gicp_loop.cu; returns out."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG, "csrc"), os.path.join(out, PKG, "csrc"))
    os.makedirs(os.path.join(out, PKG, "ops"))
    shutil.copy(os.path.join(REPO, PKG, "ops", "kernels.py"), os.path.join(out, PKG, "ops"))
    path = os.path.join(out, PKG, "csrc", "gicp_loop.cu")
    with open(path) as f:
        src = f.read()
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_gicp_loop_split: anchor not found once: {anchor!r}")
        src = src.replace(anchor, new)
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
        print("torch_gicp_loop_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    base = os.path.join(REPO, ".chip_scratch", "gicp_loop_split")
    mods = {v: chip_smoke.tree_kernels(make_variant(os.path.join(base, v), VARIANTS[v]),
                                       f"gicp_loop_split_{v}") for v in ORDER}
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per variant, all at once
        list(pool.map(lambda m: m.load_library(), mods.values()))
    dev = torch.device("cuda")
    for v, m in mods.items():
        res = m.loop_kernel_attributes(dev, chip_smoke.GICP_VARIANT)
        print(f"[{v}] nvcc_seconds={m.build_info['seconds']:.2f} registers={res['registers']} "
              f"blocks_per_sm={res['blocks_per_sm']}", flush=True)

    cfg = chip_smoke.loops_off_config()
    scans, gt = chip_smoke.dense_course(40)
    aux, ring, last = chip_smoke.full_ring(cfg, scans, gt, dev)
    inputs = chip_smoke.gicp_front_inputs(cfg, ring, last)
    init = torch.as_tensor(chip_smoke.perturbed(gt[aux["window"] - 1]), device=dev)
    a = chip_smoke.gicp_loop_args(inputs, init, cfg.scan_matcher.gicp)
    times = {v: [] for v in ORDER}
    for _ in range(ROUNDS):
        for v, m in mods.items():
            def loop(its, m=m):
                return lambda: m.gicp_align_loop(*a[:6], 0.0, a[7], its, *a[9:])
            work = chip_smoke.split_times(loop(20), calls=10, warmup=2)
            one = chip_smoke.split_times(loop(1), calls=40, warmup=2)
            times[v].append((work["device_us"] - one["device_us"]) / 19)
    lines = []
    for v, ts in times.items():
        lines.append(dict(stage="front", variant=v, working_launch_us=float(np.median(ts)),
                          rounds=[round(t, 3) for t in ts], card=card))
        print(json.dumps(lines[-1]), flush=True)
    t = {v: float(np.median(times[v])) for v in ORDER}
    split = dict(working_launch_us=t["full"], candidate_bytes_us=t["full"] - t["one_row"],
                 rows_us=t["full"] - t["no_rows"], scan_us=t["no_rows"] - t["no_scan"],
                 tail_us=t["no_scan"] - t["exit"], launch_floor_us=t["exit"])
    lines.append(dict(split={"front": split}, card=card))
    print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
