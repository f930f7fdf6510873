"""Split a launch of each prefilter kernel (`voxel_centroids` and `sor_window_stats`,
`csrc/prefilter.cu`) into its parts on one CUDA card, by timing variants of the kernels
that stop after a part.

    python3 scripts/torch_prefilter_split.py [--root DIR ...] [--input NPZ] [--json PATH]

For each tree (this checkout, or each `--root`, such as the parent commit unpacked by
`git archive`) and variant the script copies the tree's `csrc/prefilter.cu` into
`.chip_scratch/prefilter_split/<tree>/<variant>/`, edits the copy there (the trees
themselves are never changed), builds every copy with the library's nvcc flags into a
shared library of its own (all at once; the file has a plain C interface and no header of
the repo) and calls its two C entry points through ctypes, on this checkout's inputs. The
edits are anchored on the kernels' text; the script knows two designs and takes the one
whose anchors a tree's `prefilter.cu` holds.

Variants, each keeping the edits of those above it (so each part is the difference of
two neighbours):

  `voxel_centroids`
    full        the kernel as it is;
    no_points   a run's points are not read (a value made from the row index is added
                in their place, so the sums and their chain stay);
    no_sums     no run is summed (count := length, sums 0);
    no_index    a row's start and key are not read (so neither is anything that waits
                for them); the lengths are read and the outputs written;
    exit        the kernel returns at once: the launch floor.
    parts: points = full - no_points, sums = no_points - no_sums, index (starts and
    keys) = no_sums - no_index, lengths and writes = no_index - exit.

  `sor_window_stats`
    full        the kernel as it is;
    no_scatter  the outputs written at the sorted row, not at `order[i]`;
    no_roots    the found distances are added as they are, without the square root;
    no_select   no sort or selection of the distances (the first k finite in slot
                order are added);
    no_d2       a same-cell neighbour's d^2 is not formed (1.0 in its place); the key
                tests (the old design) or searches (the redesign) stay;
    staged      the block stages its rows and window, then each row writes its key and
                stops;
    exit        the kernel returns at once: the launch floor.
    parts: scatter, roots, select, d2 as the differences down to no_d2; key tests and
    the sum = no_d2 - staged; staging = staged - exit.

Fixtures: with `--input`, the kernels' arguments as `chip_smoke.py`'s phase 10c writes
them (`<shape>__<kernel>__<i>` arrays); without it, built here as that phase builds them:
the dense course's first frame and drift frame 100 (each kernel), and the drift course's
first loop attempt's submap (`voxel_centroids`, C = 131,072). Per tree, variant, shape and
round, `chip_smoke.split_times` of the variant's launch (device us). ROUNDS rounds take
the trees in turns (this, parent, parent, this, ...) and each tree's variants in order.

Prints the card's name and power limit, ptxas's registers per variant, one JSON line per
tree, variant and shape (the median and each round's time), then one JSON line of the
split per tree.
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
PKG = "lidar_graph_slam_tpu_torch"
SOURCE = "prefilter.cu"

ROUNDS = 4
KERNELS = ("voxel_centroids", "sor_window_stats")


def _cumulative(steps):
    """[(variant, edits)] -> {variant: the edits of it and of every variant before it}."""
    out, acc = {"full": []}, []
    for name, edits in steps:
        acc = acc + edits
        out[name] = list(acc)
    return out


# -- the first design: a thread a voxel row reading its run from device memory; the SOR's
# 48 same-cell d^2 of every valid row through a 64-wide bitonic network -------------------
_N_CENTROID_EXIT = ("  if (r >= C) return;\n", "  return;\n")
_N_SOR_EXIT = ("  const long long i0 = static_cast<long long>(blockIdx.x) * kSorThreads;\n",
               "  return;\n  const long long i0 = 0;\n")
NETWORK = dict(
    name="64-wide network",
    marker="  // Bitonic sort, ascending: every index is a compile-time constant after unrolling.\n",
    variants={
        "voxel_centroids": _cumulative([
            ("no_points", [("__fsub_rn(pts[3 * i + d], corner[d])",
                            "__fsub_rn(__ll2float_rn(i + d), corner[d])")]),
            ("no_sums", [("    for (long long i = s; i < s + len; ++i) {\n"
                          "      count = __fadd_rn(count, 1.0f);\n",
                          "    count = __ll2float_rn(len);\n"
                          "    for (long long i = s; i < s; ++i) {\n")]),
            ("no_index", [("    const long long s = starts[r];\n    const int key = keys[s];\n",
                           "    const long long s = 0;\n"
                           "    const int key = static_cast<int>(r);\n")]),
            ("exit", [_N_CENTROID_EXIT]),
        ]),
        "sor_window_stats": _cumulative([
            ("no_scatter", [("  const long long row = order[i];\n",
                             "  const long long row = i;\n")]),
            ("no_roots", [("acc = __fadd_rn(acc, __fsqrt_rn(d2[q]));",
                           "acc = __fadd_rn(acc, d2[q]);")]),
            ("no_select", [("  for (int size = 2; size <= kSortWidth; size <<= 1) {\n",
                            "  for (int size = 2; size <= 0; size <<= 1) {\n")]),
            ("no_d2", [("        const float dx = __fsub_rn(sp[0][j], x), "
                        "dy = __fsub_rn(sp[1][j], y),\n"
                        "                    dz = __fsub_rn(sp[2][j], z);\n"
                        "        v = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), "
                        "__fmul_rn(dy, dy)), __fmul_rn(dz, dz));\n",
                        "        v = 1.0f;\n")]),
            ("staged", [("  __syncthreads();\n  const long long i = i0 + threadIdx.x;\n"
                         "  if (i >= n) return;\n",
                         "  __syncthreads();\n  const long long i = i0 + threadIdx.x;\n"
                         "  if (i >= n) return;\n"
                         "  mean_d[i] = __int2float_rn(skey[threadIdx.x + kWindow]);\n"
                         "  n_found[i] = 0;\n  return;\n")]),
            ("exit", [_N_SOR_EXIT]),
        ]),
    })
# -- the redesign: a block's span of sorted points staged in rounds, a thread a run
# from shared memory; the SOR's same-cell range by two key searches, only its d^2 formed,
# an odd-even merge network 16, 32, 40 or 48 wide by the warp's largest count -----------
MERGE = dict(
    name="odd-even merge by the warp's count",
    marker="// Sorts v[0, W) ascending with Batcher's odd-even merge network",
    variants={
        "voxel_centroids": _cumulative([
            ("no_points", [
                ("__fsub_rn(pts[3 * i + d], corner[d])",
                 "__fsub_rn(__ll2float_rn(i + d), corner[d])"),
                ("      for (int t = threadIdx.x; t < 3 * m; t += kCentroidRows) "
                 "stage[t] = src[t];\n", ""),
                ("__fsub_rn(stage[3 * o + d], corner[d])",
                 "__fsub_rn(__int2float_rn(o + d), corner[d])")]),
            ("no_sums", [
                ("    for (long long i = s; i < s + len; ++i) {\n"
                 "      count = __fadd_rn(count, 1.0f);\n",
                 "    count = __ll2float_rn(len);\n"
                 "    for (long long i = s; i < s; ++i) {\n"),
                ("      for (int o = a; o < b; ++o) {\n"
                 "        count = __fadd_rn(count, 1.0f);\n",
                 "      count = __fadd_rn(count, __int2float_rn(b - a));\n"
                 "      for (int o = a; o < a; ++o) {\n")]),
            ("no_index", [("  const long long s = row ? starts[r] : 0;\n",
                           "  const long long s = row ? r : 0;\n"),
                          ("  if (len > 0) key = keys[s];\n",
                           "  if (len > 0) key = static_cast<int>(r);\n")]),
            ("exit", [("  const long long r0 = static_cast<long long>(blockIdx.x) * "
                       "kCentroidRows;\n",
                       "  return;\n  const long long r0 = 0;\n")]),
        ]),
        "sor_window_stats": _cumulative([
            ("no_scatter", [("  const long long row = mine ? order[i] : 0;\n",
                             "  const long long row = mine ? i : 0;\n")]),
            ("no_roots", [("const float root = Fast ? sqrt_rn_fast(x) : __fsqrt_rn(x);",
                           "const float root = x;")]),
            ("no_select", [("  if (fw == 0) {", "  if (fw >= 0) {")]),
            ("no_d2", [("__device__ __forceinline__ float d2_of(const float4 q, "
                        "const float4 p) {\n",
                        "__device__ __forceinline__ float d2_of(const float4 q, "
                        "const float4 p) {\n  return 1.0f;\n")]),
            ("staged", [("  const long long i = i0 + threadIdx.x;\n  const bool mine = i < n;\n",
                         "  const long long i = i0 + threadIdx.x;\n"
                         "  if (i < n) {\n"
                         "    mean_d[i] = __int2float_rn(skey[threadIdx.x + kWindow]);\n"
                         "    n_found[i] = 0;\n  }\n  return;\n"
                         "  const bool mine = i < n;\n")]),
            ("exit", [_N_SOR_EXIT]),
        ]),
    })
KNOWN = (NETWORK, MERGE)

CENTROID_PARTS = dict(points_us=("full", "no_points"), sums_us=("no_points", "no_sums"),
                      index_us=("no_sums", "no_index"), lengths_and_writes_us=("no_index", "exit"))
SOR_PARTS = dict(scatter_us=("full", "no_scatter"), roots_us=("no_scatter", "no_roots"),
                 select_us=("no_roots", "no_select"), d2_us=("no_select", "no_d2"),
                 key_tests_and_sum_us=("no_d2", "staged"), staging_us=("staged", "exit"))
PARTS = {"voxel_centroids": CENTROID_PARTS, "sor_window_stats": SOR_PARTS}


def design_of(root: str) -> dict:
    """The known design whose text the tree at `root` holds."""
    with open(os.path.join(root, PKG, "csrc", SOURCE)) as f:
        src = f.read()
    for d in KNOWN:
        if d["marker"] in src:
            return d
    raise SystemExit(f"torch_prefilter_split: {root}'s {SOURCE} is none of "
                     f"{[d['name'] for d in KNOWN]}")


def make_variant(root: str, out: str, edits) -> str:
    """The tree's prefilter.cu copied to out/ with `edits` applied, each anchor found
    exactly once; returns the copy's path."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with open(os.path.join(root, PKG, "csrc", SOURCE)) as f:
        src = f.read()
    for anchor, new in edits:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_prefilter_split: anchor not found once: {anchor!r}")
        src = src.replace(anchor, new)
    path = os.path.join(out, SOURCE)
    with open(path, "w") as f:
        f.write(src)
    return path


def build(src: str) -> tuple:
    """nvcc src into a shared library beside it with the kernel library's flags; returns
    (the loaded library, ptxas's register lines)."""
    from lidar_graph_slam_tpu_torch.ops import kernels

    so = src[:-3] + ".so"
    proc = subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lgs_voxel_centroids.argtypes = [vp, vp, vp, vp, i64, vp, vp, i32, i32, i32, i32, vp,
                                        vp, vp]
    lib.lgs_sor_window_stats.argtypes = [vp, vp, vp, i64, i32, vp, vp, vp]
    lib.lgs_voxel_centroids.restype = lib.lgs_sor_window_stats.restype = ctypes.c_int
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return lib, regs


def launcher(lib, name: str, args):
    """A no-argument call of `name` in `lib` on the kernel's arguments `args` (as
    `ops/kernels.py`'s wrapper passes them), into outputs made once; raises on a
    launch error."""
    import torch
    from lidar_graph_slam_tpu_torch.ops import kernels

    stream = torch.cuda.current_stream().cuda_stream
    if name == "voxel_centroids":
        keys, pts, starts, lengths, origin, leaf = args
        C = starts.shape[0] - 1
        out = torch.empty((C, 3), dtype=torch.float32, device=pts.device)
        mask = torch.empty((C,), dtype=torch.bool, device=pts.device)
        call = (keys.data_ptr(), pts.data_ptr(), starts.data_ptr(), lengths.data_ptr(), C,
                origin.data_ptr(), leaf.data_ptr(), kernels._BITS_Y + kernels._BITS_Z,
                kernels._BITS_Z, kernels.COORD_MAX[1], kernels.COORD_MAX[2], out.data_ptr(),
                mask.data_ptr(), stream)
        fn = lib.lgs_voxel_centroids
    else:
        keys, pts, order, k = args
        n = keys.shape[0]
        mean_d = torch.empty((n,), dtype=torch.float32, device=pts.device)
        found = torch.empty((n,), dtype=torch.int64, device=pts.device)
        call = (keys.data_ptr(), pts.data_ptr(), order.data_ptr(), n,
                min(int(k), 2 * kernels.SOR_WINDOW), mean_d.data_ptr(), found.data_ptr(),
                stream)
        fn = lib.lgs_sor_window_stats

    def go():
        err = fn(*call)
        if err:
            raise RuntimeError(f"{name}: launch error {err}")
    return go


def load_fixtures(path: str, dev) -> dict:
    """{shape: {kernel: args}} from an NPZ of `<shape>__<kernel>__<i>` arrays (a 0-d
    array for the SOR's k)."""
    import numpy as np
    import torch

    data = np.load(path)
    out: dict = {}
    for key in sorted(data.files, key=lambda k: (k.rsplit("__", 1)[0], int(k.rsplit("__", 1)[1]))):
        shape, name, _ = key.split("__")
        a = data[key]
        out.setdefault(shape, {}).setdefault(name, []).append(
            int(a) if a.ndim == 0 and a.dtype.kind == "i" else torch.as_tensor(a, device=dev))
    return {s: {k: tuple(v) for k, v in d.items()} for s, d in out.items()}


def build_fixtures(chip_smoke, dev) -> dict:
    """Phase 10c's shapes, made as that phase makes them."""
    import torch

    cfg = chip_smoke.loops_off_config()
    scans, _ = chip_smoke.dense_course(1)
    dscans, dgt = chip_smoke.drift_course()
    out = {}
    for label, scan in (("prefilter_dense", scans[0]),
                        ("prefilter_drift", dscans[chip_smoke.PREFILTER_DRIFT_FRAME])):
        raw = torch.as_tensor(chip_smoke.raw_bucket(scan, cfg.capacity.raw_points), device=dev)
        inputs = chip_smoke.prefilter_kernel_inputs(cfg, raw)
        out[label] = {"voxel_centroids": inputs["voxel"]["voxel_centroids"],
                      "sor_window_stats": inputs["sor"]["sor_window_stats"]}
    cfg_on = chip_smoke.PipelineConfig()
    pipe, _res, _numbers = chip_smoke.run_loop_course(cfg_on, dscans, dgt, "cuda")
    first = next(r for r in pipe.back.loop_log if r["candidate"] >= 0)
    loop = chip_smoke.loop_centroid_inputs(cfg_on, pipe.back, first)
    out["loop_submap"] = {"voxel_centroids": loop["loop_submap"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a tree whose kernels are split (repeatable; default: this checkout)")
    ap.add_argument("--input", default=None,
                    help="the kernels' arguments as chip_smoke.py's phase 10c writes them")
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_prefilter_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    roots = [os.path.abspath(r) for r in (args.root or [REPO])]
    names = ["this" if r == REPO else f"{i}_{os.path.basename(r)}" for i, r in enumerate(roots)]
    base = os.path.join(REPO, ".chip_scratch", "prefilter_split")
    designs, srcs = {}, {}
    for name, root in zip(names, roots):
        designs[name] = design_of(root)
        print(f"{name}: {root}: {designs[name]['name']}", flush=True)
        for kernel in KERNELS:
            for v, edits in designs[name]["variants"][kernel].items():
                srcs[name, kernel, v] = make_variant(
                    root, os.path.join(base, name, kernel, v), edits)
    with ThreadPoolExecutor(min(16, len(srcs))) as pool:  # every variant's nvcc at once
        built = dict(zip(srcs, pool.map(build, srcs.values())))
    for key, (_lib, regs) in built.items():
        print(f"[{' '.join(key)}] " + " | ".join(r for r in regs if key[1] in r or "spill" in r
                                                 or "registers" in r), flush=True)

    dev = torch.device("cuda")
    fixtures = (load_fixtures(args.input, dev) if args.input
                else build_fixtures(chip_smoke, dev))
    calls = {key: {shape: launcher(lib, key[1], per[key[1]])
                   for shape, per in fixtures.items() if key[1] in per}
             for key, (lib, _regs) in built.items()}
    runs = {key: {shape: [] for shape in c} for key, c in calls.items()}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for key, per in calls.items():
                if key[0] != name:
                    continue
                for shape, go in per.items():
                    runs[key][shape].append(chip_smoke.split_times(go, calls=100,
                                                                   warmup=5)["device_us"])
    torch.cuda.synchronize()
    lines, med = [], {}
    for (name, kernel, v), per in runs.items():
        for shape, ts in per.items():
            med[name, kernel, v, shape] = float(np.median(ts))
            lines.append(dict(tree=name, design=designs[name]["name"], kernel=kernel,
                              variant=v, shape=shape, device_us=med[name, kernel, v, shape],
                              rounds=[round(t, 3) for t in ts], card=card))
            print(json.dumps(lines[-1]), flush=True)
    for name in names:
        split = {}
        for kernel in KERNELS:
            for shape in fixtures:
                if (name, kernel, "full", shape) not in med:
                    continue
                t = {v: med[name, kernel, v, shape] for v in designs[name]["variants"][kernel]}
                split[f"{kernel}@{shape}"] = dict(
                    full_us=t["full"], launch_floor_us=t["exit"],
                    **{p: t[a] - t[b] for p, (a, b) in PARTS[kernel].items()})
        lines.append(dict(tree=name, design=designs[name]["name"], split=split, card=card))
        print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
