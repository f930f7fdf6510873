"""Split one working launch of the GICP loop kernel (`gicp_iteration`, `csrc/gicp_loop.cu`)
into its parts on one CUDA card, by timing variants of the kernel that skip a part.

    python3 scripts/torch_gicp_loop_split.py [--root DIR] [--json PATH]

For each variant the script copies the `csrc/` and `ops/kernels.py` of a tree (this
checkout, or with `--root` another one, such as the parent commit unpacked by `git
archive`) into `.chip_scratch/gicp_loop_split/<variant>/`, edits the copies of
`gicp_loop.cu` and `nn_stage.cuh` (the grid-NN query it shares with ICP's kernels) there
(the tree itself is never changed), builds it with that tree's nvcc
flags (one nvcc per variant, all at once) and loads it beside the others. The edits are
anchored on the kernel's text; the script knows two kernels and takes the one whose
anchors the tree's `gicp_loop.cu` holds.

The staged scan (a block stages its tile's distinct cell runs in shared memory, then
every point scans its own cell there, and the block the neighbour cells that can still
hold a point's nearest row):

  full      the kernel as it is;
  own_only  no neighbour cell is scanned (the results are wrong);
  no_rows   the scan runs, no matched row is formed or accumulated;
  no_scan   the table starts are read and de-duplicated and the runs copied, no cell is
            scanned;
  no_copy   as no_scan, and the runs are not copied into the stage;
  no_match  no query at all: the tile, the transform, the reduction and the step;
  exit      every launch returns after the `done` test: the launch floor.

  parts: rows = full - no_rows, scan = no_rows - no_scan, of which the neighbour cells =
  full - own_only, copy = no_scan - no_copy, table starts and hash = no_copy - no_match,
  tail (tile, transform, reduction, step) = no_match - exit.

The earlier half-warp scan (a warp walks its 32 queries in 16 rounds, half a warp a
query, the candidates read from global memory):

  full      the kernel as it is;
  one_row   every lane of a query reads its cell's first candidate row instead of its own
            slots: the same loads and arithmetic, 1/32 of the distinct candidate bytes;
  no_rows   the scan runs, no matched row is formed or accumulated;
  no_loads  as no_rows, with each candidate load replaced by a value made in registers
            (no key matches: nothing is found);
  one_round as no_rows, with one round a warp instead of up to 16;
  no_scan   no query at all: the tile, the transform, the reduction and the step;
  exit      every launch returns after the `done` test: the launch floor.

  parts: candidate bytes = full - one_row, rows = full - no_rows, scan = no_rows -
  no_scan, of which the candidate loads = no_rows - no_loads and the rounds after a
  warp's first = no_rows - one_round; tail = no_scan - exit.

Each variant runs the front-end fixture of `chip_smoke.py`'s gicp-loop phase (the dense
course's last ring scan, N = 32,768, from a perturbed guess against the GICP target of
the full 20-scan ring, 655,360 rows): `split_times` of a loop of 20 launches with epsilon
0 (every launch works) less a loop of 1, over 19, in ROUNDS rounds that take the variants
in turn. Variants that match nothing leave T at the guess.

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

# The sources the edits are made in: the kernel, and the grid-NN query's header (a tree
# before that header held the query in gicp_loop.cu).
EDITED = ("gicp_loop.cu", "nn_stage.cuh")

# (anchor, replacement) edits of EDITED per variant, for each kernel the script
# knows: its name, a line only that kernel's text holds, its variants in order, and its
# parts as differences of variants.
_EXIT = "  if (*a.carry.done) return;  // the loop's cond: the alignment is finished\n"

# The staged scan.
_S_GATE = "    bool cand = d2 < a.corr2;  // found, masked in, within the gate\n"
_S_OWN = "  const unsigned long long own = scan_cell<C, B>(sm, g, t, kOwn, start[kOwn] >= 0);\n"
_S_WANT = "    if (c != kOwn && start[c] >= 0 && !(bound > best)) wanted |= 1u << c;\n"
_S_COPY = "  copy_runs<B>(sm, g.packed, g.n, min(total, S::kRuns));\n"
_S_QUERY = ("    float d2 = stage_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, x, y, z, mine, "
            "sm, row);\n")
_S_NO_ROWS = (_S_GATE, _S_GATE + "    if (d2 == -1.f) acc[0] += (float)row;  // keeps the scan\n"
              "    cand = false;\n")
_S_NO_SCAN = [(_S_OWN, "  const unsigned long long own = pack_best(INFINITY, 0);\n"), (_S_WANT, "")]
STAGED = dict(
    name="staged scan",
    marker="stage_nearest<C, B>(",
    variants={
        "full": [],
        "own_only": [(_S_WANT, "")],
        "no_rows": [_S_NO_ROWS],
        "no_scan": _S_NO_SCAN,
        "no_copy": _S_NO_SCAN + [(_S_COPY, "")],
        "no_match": [(_S_QUERY, "    float d2 = INFINITY;\n")],
        "exit": [(_EXIT, _EXIT + "  return;\n")],
    },
    parts=dict(rows_us=("full", "no_rows"), scan_us=("no_rows", "no_scan"),
               neighbour_cells_us=("full", "own_only"), copy_us=("no_scan", "no_copy"),
               starts_and_hash_us=("no_copy", "no_match"), tail_us=("no_match", "exit")),
)

# The earlier half-warp scan.
_H_LOAD = "__ldg(g.packed + s[k] + lane16 + kSegment * t);"
_H_SCAN = ("    const float d2 =\n        warp_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, "
           "x, y, z, mine, sm, row);")
_H_ROUND = "    int r = __ffs(todo) - 1, ch = 0;\n    todo &= todo - 1;\n"
_H_NO_ROWS = (_S_GATE, _S_NO_ROWS[1])
HALF_WARP = dict(
    name="half-warp scan",
    marker="warp_nearest<C, B>(",
    variants={
        "full": [],
        "one_row": [(_H_LOAD, _H_LOAD.replace(" + lane16 + kSegment * t", ""))],
        "no_rows": [_H_NO_ROWS],
        "no_loads": [_H_NO_ROWS, (_H_LOAD, "make_float4((float)(s[k] + lane16 + kSegment * t), "
                                  "0.f, 0.f, __int_as_float(s[k] | 1 << 30));")],
        "one_round": [_H_NO_ROWS, (_H_ROUND, "    int r = __ffs(todo) - 1, ch = 0;\n"
                                   "    todo = 0;\n")],
        "no_scan": [(_H_SCAN, "    const float d2 = INFINITY;")],
        "exit": [(_EXIT, _EXIT + "  return;\n")],
    },
    parts=dict(candidate_bytes_us=("full", "one_row"), rows_us=("full", "no_rows"),
               scan_us=("no_rows", "no_scan"), candidate_loads_us=("no_rows", "no_loads"),
               later_rounds_us=("no_rows", "one_round"), tail_us=("no_scan", "exit")),
)
KNOWN = (STAGED, HALF_WARP)


def kernel_of(root: str) -> dict:
    """The known kernel whose text the tree at `root` holds."""
    with open(os.path.join(root, PKG, "csrc", "gicp_loop.cu")) as f:
        src = f.read()
    for k in KNOWN:
        if k["marker"] in src:
            return k
    raise SystemExit(f"torch_gicp_loop_split: {root}'s gicp_loop.cu is none of "
                     f"{[k['name'] for k in KNOWN]}")


def make_variant(root: str, out: str, edits) -> str:
    """Copies the csrc/ and ops/kernels.py of the tree at `root` under out/ with `edits`
    applied, each to the one of EDITED that holds its anchor; returns out."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, PKG, "csrc"), os.path.join(out, PKG, "csrc"))
    os.makedirs(os.path.join(out, PKG, "ops"))
    shutil.copy(os.path.join(root, PKG, "ops", "kernels.py"), os.path.join(out, PKG, "ops"))
    paths = [os.path.join(out, PKG, "csrc", name) for name in EDITED]
    srcs = {p: open(p).read() for p in paths if os.path.exists(p)}
    for anchor, new in edits:
        holders = [p for p, src in srcs.items() if src.count(anchor) == 1]
        if len(holders) != 1 or sum(src.count(anchor) for src in srcs.values()) != 1:
            raise SystemExit(f"torch_gicp_loop_split: anchor not found once: {anchor!r}")
        srcs[holders[0]] = srcs[holders[0]].replace(anchor, new)
    for path, src in srcs.items():
        with open(path, "w") as f:
            f.write(src)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="the tree whose kernel is split")
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
    root = os.path.abspath(args.root)
    kern = kernel_of(root)
    print(f"{root}: {kern['name']}", flush=True)
    base = os.path.join(REPO, ".chip_scratch", "gicp_loop_split")
    mods = {v: chip_smoke.tree_kernels(make_variant(root, os.path.join(base, v), edits),
                                       f"gicp_loop_split_{v}")
            for v, edits in kern["variants"].items()}
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
    times = {v: [] for v in mods}
    for _ in range(ROUNDS):
        for v, m in mods.items():
            def loop(its, m=m):
                return lambda: m.gicp_align_loop(*a[:6], 0.0, a[7], its, *a[9:])
            work = chip_smoke.split_times(loop(20), calls=10, warmup=2)
            one = chip_smoke.split_times(loop(1), calls=40, warmup=2)
            times[v].append((work["device_us"] - one["device_us"]) / 19)
    lines = []
    for v, ts in times.items():
        lines.append(dict(stage="front", kernel=kern["name"], variant=v,
                          working_launch_us=float(np.median(ts)),
                          rounds=[round(t, 3) for t in ts], card=card))
        print(json.dumps(lines[-1]), flush=True)
    t = {v: float(np.median(ts)) for v, ts in times.items()}
    split = dict(working_launch_us=t["full"], launch_floor_us=t["exit"],
                 **{part: t[a] - t[b] for part, (a, b) in kern["parts"].items()})
    lines.append(dict(split={"front": split}, kernel=kern["name"], card=card))
    print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
