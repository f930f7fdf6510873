"""Split a launch of GICP's covariance kernel (`gicp_covariances`, `csrc/covariances.cu`)
into its parts on one CUDA card, by timing builds of it cut after each part.

    python3 scripts/torch_covariances_split.py [--input NPZ] [--parent DIR] [--json PATH]

The kernel's source has one compile-time switch, `LGS_COV_STEPS` (`CovStep` there). The
script builds `csrc/covariances.cu` once for each value into a shared library of its own
under `.chip_scratch/covariances_split/` (all at once, with the library's nvcc flags; the
file has a plain C interface) and calls each library's C entry point through ctypes (its
grid is the library's: a warp for each tile of 32 rows). Variants, each adding one part
to the one above it (so each part is the difference of two neighbours):

  floor     the launch returns at once: the floor of a launch over the grid;
  stage     each warp stages its tile of 32 sorted rows with their 16 rows on each side
            (key, xyz, xyz in float64) and writes what it staged at the sorted row;
  sums      the window sums and the covariance, every column through the float64
            route, a tile with no valid row skipped, written at the sorted row;
  solve     the eigensolve and V diag(1e-3, 1, 1) V^T of the rows of 5 or more points
            (written at the sorted row);
  full      the store at each row's original index with the caller's mask: the kernel.

    parts: stage = stage - floor, sums = sums - stage, solve = solve - sums, scatter
    store = full - solve.

Also: the kernel's launch on each shape's first 32 rows (one tile, one block) less the
floor of that launch, the latency of one tile's chain. With `--parent DIR` (the parent
commit unpacked by `git archive`), that tree's `gicp_covariances` (its `ops/kernels.py`,
building its own `csrc/`) on the same inputs, in the same rounds.

Fixtures: with `--input`, the kernel's arguments as `chip_smoke.py`'s phase 14d writes
them (`<shape>__<i>` arrays: keys, points, order, mask); without it, built here as that
phase builds them: the dense course's full ring (the target build's 655,360 grid rows)
and last ring scan (32,768, a frame's source), and the GICP verifier's 16,384-row cloud
from the drift course's first loop attempt. The full variant is checked bit for bit
against `gicp_covariances_plain` at every shape. Per variant, shape and round,
`chip_smoke.split_times` (device us); ROUNDS rounds, the variants in order, then in
reverse.

Prints the card's name and power limit, ptxas's registers per variant, one JSON line per
variant and shape (the median and each round's time), then one JSON line of the split.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lidar_graph_slam_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "covariances.cu")

ROUNDS = 4
STEPS = ("floor", "stage", "sums", "solve", "full")  # LGS_COV_STEPS 0..4

PARTS = dict(stage_us=("stage", "floor"), sums_us=("sums", "stage"),
             solve_us=("solve", "sums"), scatter_store_us=("full", "solve"))
TILE = 32


def build(variant: str, out: str) -> tuple:
    """nvcc covariances.cu with LGS_COV_STEPS at the variant into out/ with the kernel
    library's flags; returns (the loaded library, ptxas's register lines)."""
    from lidar_graph_slam_tpu_torch.ops import kernels

    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"libcov_{variant}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS,
                           f"-DLGS_COV_STEPS={STEPS.index(variant)}", f"-I{CSRC}", "-shared",
                           "-o", so, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgs_gicp_covariances.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp]
    lib.lgs_gicp_covariances.restype = ctypes.c_int
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return lib, regs


def launcher(lib, args):
    """A no-argument launch of `lib`'s kernel on (keys, points, order, mask), into outputs
    made once; raises on a launch error."""
    import torch

    keys, pts, order, mask = args
    n = keys.shape[0]
    covs = torch.empty((n, 3, 3), dtype=torch.float32, device=pts.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pts.device)
    call = (keys.data_ptr(), pts.data_ptr(), order.data_ptr(), mask.data_ptr(), n,
            covs.data_ptr(), ok.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def go(_args=args):  # holds the inputs as long as the launch is timed
        err = lib.lgs_gicp_covariances(*call)
        if err:
            raise RuntimeError(f"gicp_covariances variant: launch error {err}")
        return covs, ok
    return go


def first_tile(args):
    """The first 32 rows of a shape as a cloud of its own: keys, points, the identity order
    (a tile's own original indices reach past its 32 rows of output) and those rows'
    mask (every row valid or not as it was)."""
    import torch

    keys, pts, order, mask = args
    return (keys[:TILE].contiguous(), pts[:TILE].contiguous(),
            torch.arange(TILE, device=keys.device), mask[order[:TILE]].contiguous())


def load_fixtures(path: str, dev) -> dict:
    """{shape: (keys, points, order, mask)} from an NPZ of `<shape>__<i>` arrays."""
    import numpy as np
    import torch

    data = np.load(path)
    out: dict = {}
    for key in sorted(data.files, key=lambda k: (k.rsplit("__", 1)[0], int(k.rsplit("__", 1)[1]))):
        shape, _ = key.rsplit("__", 1)
        out.setdefault(shape, []).append(torch.as_tensor(data[key], device=dev))
    return {s: tuple(v) for s, v in out.items()}


def build_fixtures(chip_smoke, dev) -> dict:
    """Phase 14d's three shapes, made as that phase makes them."""
    cfg = chip_smoke.loops_off_config()
    scans, gt = chip_smoke.dense_course(40)
    _aux, ring, last = chip_smoke.full_ring(cfg, scans, gt, dev)
    dscans, dgt = chip_smoke.drift_course()
    pipe, _res, _numbers = chip_smoke.run_loop_course(chip_smoke.PipelineConfig(), dscans, dgt,
                                                      "cuda")
    first = next(r for r in pipe.back.loop_log if r["candidate"] >= 0)
    verify_in = chip_smoke.gicp_verify_inputs(pipe.back, first)
    return chip_smoke.covariance_inputs(cfg, ring, last, verify_in)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default=None,
                    help="the kernel's arguments as chip_smoke.py's phase 14d writes them")
    ap.add_argument("--parent", default=None,
                    help="a tree whose gicp_covariances is timed too")
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_covariances_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lidar_graph_slam_tpu_torch.ops.neighbors import gicp_covariances_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    base = os.path.join(REPO, ".chip_scratch", "covariances_split")
    shutil.rmtree(base, ignore_errors=True)
    with ThreadPoolExecutor(len(STEPS)) as pool:  # every variant's nvcc at once
        built = dict(zip(STEPS, pool.map(lambda v: build(v, base), STEPS)))
    for v, (_lib, regs) in built.items():
        print(f"[{v}] " + " | ".join(regs), flush=True)

    dev = torch.device("cuda")
    fixtures = (load_fixtures(args.input, dev) if args.input
                else build_fixtures(chip_smoke, dev))
    parent = chip_smoke.tree_kernels(args.parent) if args.parent else None
    calls, meta = {}, {}
    for shape, a in fixtures.items():
        meta[shape] = dict(rows=a[0].shape[0], valid_rows=int((a[0] != 0x7FFFFFFF).sum()))
        got = launcher(built["full"][0], a)()
        want = gicp_covariances_plain(*a)
        torch.cuda.synchronize()
        if not all(torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
                   for x, y in zip(got, want)):
            raise AssertionError(f"torch_covariances_split: {shape}: the kernel is not "
                                 "bit-equal to gicp_covariances_plain")
        for v, (lib, _regs) in built.items():
            calls[v, shape] = launcher(lib, a)
        tile = first_tile(a)
        calls["tile_full", shape] = launcher(built["full"][0], tile)
        calls["tile_floor", shape] = launcher(built["floor"][0], tile)
        if parent is not None:
            calls["parent", shape] = (lambda a=a: parent.gicp_covariances(*a))
    names = list(dict.fromkeys(k[0] for k in calls))
    runs = {key: [] for key in calls}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for (v, shape), go in calls.items():
                if v == name:
                    runs[v, shape].append(chip_smoke.split_times(go, calls=100,
                                                                 warmup=5)["device_us"])
    torch.cuda.synchronize()
    lines, med = [], {}
    for (v, shape), ts in runs.items():
        med[v, shape] = float(np.median(ts))
        lines.append(dict(variant=v, shape=shape, device_us=med[v, shape],
                          rounds=[round(t, 3) for t in ts], card=card))
        print(json.dumps(lines[-1]), flush=True)
    split = {}
    for shape in fixtures:
        row = dict(meta[shape], full_us=med["full", shape], floor_us=med["floor", shape],
                   **{p: med[a, shape] - med[b, shape] for p, (a, b) in PARTS.items()},
                   one_tile_chain_us=med["tile_full", shape] - med["tile_floor", shape])
        if ("parent", shape) in med:
            row["parent_us"] = med["parent", shape]
        split[shape] = row
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
