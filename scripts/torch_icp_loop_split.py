"""Split one working launch of the ICP loop kernel (`icp_iteration`, `csrc/icp_loop.cu`)
and one launch of the loop gate's `icp_fitness` into their parts on one CUDA card, by
timing variants of the kernels that skip a part.

    python3 scripts/torch_icp_loop_split.py [--root DIR ...] [--json PATH]

For each tree (this checkout, or each `--root`, such as the parent commit unpacked by
`git archive`) and variant the script copies the tree's `csrc/` and `ops/kernels.py` into
`.chip_scratch/icp_loop_split/<tree>/<variant>/`, edits the copies of `icp_loop.cu` and
`nn_stage.cuh` (the grid-NN query it shares with GICP's kernel) there (the trees
themselves are never changed), builds every copy with its tree's nvcc flags (all at once)
and loads them beside each other. The edits are anchored on the kernels' text; the script
knows two designs and takes the one whose anchors a tree's `icp_loop.cu` holds.

Variants (each edits both kernels where the part exists in both):

  full           the kernels as they are;
  identity_step  the last block writes the carry with dT = I: no SVD and no se3_log (the
                 stop test reads epsilon alone, so that a loop with a huge epsilon still
                 stops after one launch); every variant below keeps it, so that the
                 query's parts are timed apart from the step, whose cost depends on the
                 sums it is given;
  no_row         a matched point's row q is not read (q := the point itself);
  no_rows        the scan runs, no matched sums are formed;
  no_scan        the table starts are read and de-duplicated and the runs copied, no cell
                 is scanned;
  no_copy        as no_scan, and the runs are not copied into the stage;
  no_match       no query at all: the tile, the transform and the reduction;
  exit           `icp_iteration` returns after the `done` test, `icp_fitness` at once: the
                 launch floor;
  wait_first     (the redesign only) the programmatic wait first, as in PR 14: the first
                 tile's loads no longer run while the launch before ends;
  constants_first  (the redesign only) the anchor and the grid's constants read before
                 the wait too, as an earlier form of the redesign did.

  parts: step = full - identity_step, row = identity_step - no_row, sums = no_row -
  no_rows, scan = no_rows - no_scan, copy = no_scan - no_copy, table starts and hash =
  no_copy - no_match, tail (tile, transform, reduction, ticket) = no_match - exit.
  `icp_fitness` (which has no step): its scan (identity_step - no_scan), copy, starts and
  hash, and tail likewise; its floor holds the wrapper's torch operations, if any. The
  prologue = wait_first - full; constants first = full - constants_first (compare the
  two variants' early exits too).

Fixtures, those of `chip_smoke.py`'s icp-loop phase (14c): the verifier's (the drift
course's first loop attempt: the loop submap's grid, 2 m cells, 7 cells, bucket 16, and
its 16,384-point keyframe from the coarse pre-align's result) and the front end's (the
dense course's full ring, the last ring scan, N = 32,768, bucket 32, from a perturbed
guess). Per variant, fixture and round: `split_times` of a loop of 20 launches with both
epsilons 0 (every launch works) less a loop of 1, over 19 (the working launch); of 1
working and 40 early-exit launches less that, over 40 (the early exit); and at the
verifier one `icp_fitness` call ("pcl", at the first tree's full kernel loop's result, the
same T for every variant), device time of the call. ROUNDS rounds
take the trees in turns (this, parent, parent, this, ...) and each tree's variants in
order.

Prints the card's name and power limit, ptxas's registers per variant, one JSON line per
tree, variant and fixture (the medians and each round's times), then one JSON line of the
split per tree.
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

ROUNDS = 4

# The sources the edits are made in: the kernels, and the grid-NN query's header.
EDITED = ("icp_loop.cu", "nn_stage.cuh")

# The staged query's anchors (nn_stage.cuh), the same in both designs.
_OWN = "  const unsigned long long own = scan_cell<C, B>(sm, g, t, kOwn, start[kOwn] >= 0);\n"
_WANT = "    if (c != kOwn && start[c] >= 0 && !(bound > best)) wanted |= 1u << c;\n"
_COPY = "  copy_runs<B>(sm, g.packed, g.n, min(total, S::kRuns));\n"
_EXIT = "  if (*a.carry.done) return;  // the loop's cond: the alignment is finished\n"
_FIT_HEAD = "icp_fitness_kernel(const FitArgs a) {\n"
_MATCHED = "    if (mine && d2 < a.corr2) {  // matched: found, masked in, within the gate\n"
_NO_ROWS = (_MATCHED, "    if (d2 == -1.f) acc[kRow - 1] += (float)row;  // keeps the scan\n"
            "    if (false) {\n")
_ITER_THEN = "    if (mine) {\n      acc[kFit] +="
_FIT_THEN = "    if (mine) {\n      acc[1] += 1.f;"
_QUERY = ("    const float d2 =\n        stage_nearest<C, B>(a.tgt, tinv, tox, toy, toz, a.dims, "
          "x, y, z, mine, sm, row);\n")


def design(name: str, marker: str, done_line: str, row_line: str) -> dict:
    """A design's variants from its own anchors: the stop test's line `done_line` (bool
    name = se3_log_norm(R, t) < a.epsilon;) and the matched row's line `row_line`. Every
    variant past identity_step keeps the identity step, so that the query's parts are
    timed without the step, whose cost depends on the sums it is given."""
    done_name = done_line.split("=")[0]
    identity = [
        ("  float R[3][3], t[3];\n  rotation_of(S, R);\n",
         "  float R[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}}, t[3];\n"),
        ("  for (int i = 0; i < 3; ++i) t[i] = (c[i] + mq[i]) - dot3(R[i], mu_s);\n",
         "  for (int i = 0; i < 3; ++i) t[i] = 0.f * mu_s[i];\n"),
        (done_line, done_name + "= a.epsilon > 1.0f;\n")]
    no_row = identity + [(row_line, "      const float4 qr = make_float4(x, y, z + 0.0f * row, "
                                    "0.f);\n")]
    no_scan = identity + [(_OWN, "  const unsigned long long own = pack_best(INFINITY, 0);\n"),
                          (_WANT, "")]
    return dict(
        name=name, marker=marker,
        variants={
            "full": [],
            "identity_step": identity,
            "no_row": no_row,
            "no_rows": identity + [_NO_ROWS],
            "no_scan": no_scan,
            "no_copy": no_scan + [(_COPY, "")],
            "no_match": identity + [
                (_QUERY + _ITER_THEN, "    const float d2 = INFINITY;\n" + _ITER_THEN),
                (_QUERY + _FIT_THEN, "    const float d2 = INFINITY;\n" + _FIT_THEN)],
            "exit": [(_EXIT, _EXIT + "  return;\n"), (_FIT_HEAD, _FIT_HEAD + "  return;\n")],
        })


# The PR 14 design: the step in lane 0 of the last block, six fixed Jacobi sweeps, the
# matched row read again from global memory, the wait first; `icp_fitness` a plain launch
# after a torch op (the grid's 1 / cell), with the loop kernels' 32-wide reduction.
SERIAL = design("one-thread step", "    icp_step(q, Ts, cs, fit0, iters0, a);\n",
                "  bool newly_done = se3_log_norm(R, t) < a.epsilon;\n",
                "      const float4 qr = __ldg(a.tgt.packed + row);\n")
# The redesign: the step in warp 0 (the Jacobi sweeps stop at convergence), the row from
# the stage, the carry-free prologue before the wait; `icp_fitness` a programmatic
# dependent with its own 4-wide reduction.
WARP = design("warp step", "  icp_step_warp(tot, Ts, cs, fit0, iters0, a);\n",
              "  bool done = se3_log_norm(R, t) < a.epsilon;\n",
              "      const float4 qr = matched_row<C, B>(sm, a.tgt, t, row);\n")
# Its first tile's loads before the programmatic wait, as a lever: `wait_first` waits
# first (PR 14's order); `constants_first` also reads the anchor and the grid's constants
# before the wait (an earlier form of the redesign).
_W_WAIT = ("  // A programmatic dependent of the previous launch on the stream "
           "(as gicp_iteration).\n"
           "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
           "  asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n")
_W_FIT_WAIT = ("  // A programmatic dependent of the launch before it: T is its result.\n"
               "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n")
_W_TOP = "  const int t = threadIdx.x, lane = t & 31;\n  // Before the wait"
_W_FIT_TOP = "  const int t = threadIdx.x;\n  // Before the wait"
_W_ITER_CONSTS = ("  const float tinv = __frcp_rn(*a.cell);\n"
                  "  const float tox = a.tgt.origin[0], toy = a.tgt.origin[1], "
                  "toz = a.tgt.origin[2];\n")
_W_ANCHOR = "  if (t >= 16 && t < 19) cs[t - 16] = a.anchor[t - 16];\n"
_W_TILES = "  // dearer (`scripts/torch_icp_loop_split.py`).\n  const long long tiles"
_W_FIT_TILES = ("  // launch do not write the source), as in `icp_iteration`.\n"
                "  const long long tiles")
WARP["variants"]["constants_first"] = [
    ("  if (t == 20) fit0 = *a.carry.fitness;\n" + _W_ITER_CONSTS,
     "  if (t == 20) fit0 = *a.carry.fitness;\n"),
    (_W_ANCHOR, "  if (t >= 16 && t < 19) cs[t - 16] = anchor;\n"),
    (_W_TILES, _W_TILES.replace("  const long long", _W_ITER_CONSTS
                                + "  const float anchor = t >= 16 && t < 19 ? a.anchor[t - 16] "
                                  ": 0.f;\n  const long long")),
    ("  if (t < 16) Ts[t] = a.T[t];\n" + _W_ITER_CONSTS, "  if (t < 16) Ts[t] = a.T[t];\n"),
    (_W_FIT_TILES, _W_FIT_TILES.replace("  const long long", _W_ITER_CONSTS + "  const long long"))]
WARP["variants"]["wait_first"] = [
    (_W_WAIT, ""), (_W_TOP, _W_TOP.replace("  // Before", _W_WAIT + "  // Before")),
    (_W_FIT_WAIT, ""),
    (_W_FIT_TOP, _W_FIT_TOP.replace("  // Before", _W_FIT_WAIT + "  // Before"))]
KNOWN = (SERIAL, WARP)

# Each part as (slower variant, faster variant).
ITERATION_PARTS = dict(prologue_us=("wait_first", "full"),
                       constants_first_us=("full", "constants_first"),
                       step_us=("full", "identity_step"), row_us=("identity_step", "no_row"),
                       sums_us=("no_row", "no_rows"), scan_us=("no_rows", "no_scan"),
                       copy_us=("no_scan", "no_copy"),
                       starts_and_hash_us=("no_copy", "no_match"), tail_us=("no_match", "exit"))
FITNESS_PARTS = dict(prologue_us=("wait_first", "full"), scan_us=("identity_step", "no_scan"),
                     copy_us=("no_scan", "no_copy"), starts_and_hash_us=("no_copy", "no_match"),
                     tail_us=("no_match", "exit"))


def kernel_of(root: str) -> dict:
    """The known design whose text the tree at `root` holds."""
    with open(os.path.join(root, PKG, "csrc", "icp_loop.cu")) as f:
        src = f.read()
    for k in KNOWN:
        if k["marker"] in src:
            return k
    raise SystemExit(f"torch_icp_loop_split: {root}'s icp_loop.cu is none of "
                     f"{[k['name'] for k in KNOWN]}")


def make_variant(root: str, out: str, edits) -> str:
    """Copies the csrc/ and ops/kernels.py of the tree at `root` under out/ with `edits`
    applied, each to the one of EDITED that holds its anchor once; returns out."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, PKG, "csrc"), os.path.join(out, PKG, "csrc"))
    os.makedirs(os.path.join(out, PKG, "ops"))
    shutil.copy(os.path.join(root, PKG, "ops", "kernels.py"), os.path.join(out, PKG, "ops"))
    paths = [os.path.join(out, PKG, "csrc", name) for name in EDITED]
    srcs = {p: open(p).read() for p in paths}
    for anchor, new in edits:
        holders = [p for p, src in srcs.items() if src.count(anchor) == 1]
        if len(holders) != 1 or sum(src.count(anchor) for src in srcs.values()) != 1:
            raise SystemExit(f"torch_icp_loop_split: anchor not found once: {anchor!r}")
        srcs[holders[0]] = srcs[holders[0]].replace(anchor, new)
    for path, src in srcs.items():
        with open(path, "w") as f:
            f.write(src)
    return out


def fixtures(chip_smoke, dev) -> dict:
    """The icp-loop phase's two fixtures as `icp_align_loop` argument lists, and the
    verifier's fitness inputs but for T."""
    import torch

    cfg = chip_smoke.loops_off_config()
    scans, gt = chip_smoke.dense_course(40)
    aux, ring, last = chip_smoke.full_ring(cfg, scans, gt, dev)
    front = chip_smoke.icp_front_inputs(cfg, ring, last)
    init = torch.as_tensor(chip_smoke.perturbed(gt[aux["window"] - 1]), device=dev)
    dscans, dgt = chip_smoke.drift_course()
    pipe, _res, _numbers = chip_smoke.run_loop_course(chip_smoke.PipelineConfig(), dscans, dgt,
                                                      "cuda")
    first = next(r for r in pipe.back.loop_log if r["candidate"] >= 0)
    verify = chip_smoke.icp_verify_inputs(pipe.back, first)
    return dict(args={"verify": chip_smoke.icp_verify_args(verify),
                      "front": chip_smoke.icp_front_args(cfg, front, init)},
                fitness=(verify["grid"], verify["points"], verify["mask"], verify["cell"]))


def times(chip_smoke, m, fx) -> dict:
    """One round of a variant's module `m`: per fixture the working and early-exit launch
    us, and the verifier's fitness call us at fx["T"]."""
    out = {}
    for stage, a in fx["args"].items():
        def loop(eps, its, a=a):
            return lambda: m.icp_align_loop(*a[:5], eps, 0.0, its, *a[8:])

        work = chip_smoke.split_times(loop(0.0, 20), calls=10, warmup=2)
        one = chip_smoke.split_times(loop(1e9, 1), calls=40, warmup=2)
        dead = chip_smoke.split_times(loop(1e9, 41), calls=5, warmup=2)
        out[f"{stage}_working_us"] = (work["device_us"] - one["device_us"]) / 19
        out[f"{stage}_early_exit_us"] = (dead["device_us"] - one["device_us"]) / 40
    grid, pts, msk, cell = fx["fitness"]
    T = fx["T"]
    out["fitness_us"] = chip_smoke.split_times(m.icp_fitness, grid, pts, msk, T, cell, 16, 7,
                                               "pcl", calls=50, warmup=5)["device_us"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a tree whose kernels are split (repeatable; default: this checkout)")
    ap.add_argument("--variants", nargs="+", default=None,
                    help="time only these variants (default: all a design has)")
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_icp_loop_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    roots = [os.path.abspath(r) for r in (args.root or [REPO])]
    names = ["this" if r == REPO else f"{i}_{os.path.basename(r)}" for i, r in enumerate(roots)]
    base = os.path.join(REPO, ".chip_scratch", "icp_loop_split")
    kern, mods = {}, {}
    for name, root in zip(names, roots):
        kern[name] = kernel_of(root)
        print(f"{name}: {root}: {kern[name]['name']}", flush=True)
        for v, edits in kern[name]["variants"].items():
            if args.variants and v not in args.variants:
                continue
            mods[name, v] = chip_smoke.tree_kernels(
                make_variant(root, os.path.join(base, name, v), edits),
                f"icp_loop_split_{name}_{v}")
    with ThreadPoolExecutor(len(mods)) as pool:  # every variant's nvcc at once
        list(pool.map(lambda m: m.load_library(), mods.values()))
    dev = torch.device("cuda")
    for (name, v), m in mods.items():
        res = {k: m.loop_kernel_attributes(dev, icp=q) for k, q in (
            ("verify", (7, 16, 0)), ("front", (7, 32, 0)), ("fitness", (7, 16, 1)))}
        print(f"[{name} {v}] nvcc_seconds={m.build_info['seconds']:.2f} " + " ".join(
            f"registers_{k}={r['registers']} blocks_per_sm_{k}={r['blocks_per_sm']}"
            for k, r in res.items()), flush=True)

    fx = fixtures(chip_smoke, dev)
    fx["T"] = mods[names[0], "full"].icp_align_loop(*fx["args"]["verify"])[0]
    runs = {key: [] for key in mods}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for v in kern[name]["variants"]:
                if (name, v) in mods:
                    runs[name, v].append(times(chip_smoke, mods[name, v], fx))
    lines = []
    med = {}
    for (name, v), rs in runs.items():
        med[name, v] = {k: float(np.median([x[k] for x in rs])) for k in rs[0]}
        lines.append(dict(tree=name, kernel=kern[name]["name"], variant=v, **med[name, v],
                          rounds={k: [round(x[k], 3) for x in rs] for k in rs[0]}, card=card))
        print(json.dumps(lines[-1]), flush=True)
    for name in names:
        t = {v: med[name, v] for v in kern[name]["variants"] if (name, v) in med}

        def parts(key, pairs):
            """Each part a variant pair's difference, where both ran; the floor `exit`."""
            out = {p: t[a][key] - t[b][key] for p, (a, b) in pairs.items()
                   if a in t and b in t}
            return dict(out, launch_floor_us=t["exit"][key]) if "exit" in t else out
        split = {stage: dict(working_launch_us=t["full"][f"{stage}_working_us"],
                             early_exit_us=t["full"][f"{stage}_early_exit_us"],
                             **parts(f"{stage}_working_us", ITERATION_PARTS))
                 for stage in ("verify", "front")} if "full" in t else {}
        split["fitness"] = parts("fitness_us", FITNESS_PARTS)
        lines.append(dict(tree=name, kernel=kern[name]["name"], split=split, card=card))
        print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
