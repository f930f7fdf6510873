"""The fine level of `ndt_finalize` built with other block and stage shapes, timed in turns
on the dense course's full ring, on a CUDA card.

    python3 scripts/torch_finalize_variants.py

Fills the dense course's full ring (20 x 32,768 points, `chip_smoke.full_ring`), takes
the fine level's sorted points as a rebuild makes them, and prints how its runs fall into
blocks: the longest run, and for blocks of 8, 16 and 32 rows the blocks that hold any
point and the most points one holds. Then it builds `csrc/voxel_finalize.cu` once for
each shape of VARIANTS (rows and threads a block, points a round, stage slots: rounds in
flight + 1), every nvcc at once, holds each build's moments and rows bit for bit against
`ndt_finalize_plain`, and times each (`chip_smoke.split_times`, device and host us) in
turns: the shapes in order, then in reverse. One `finalize-variant` line a shape, with
its registers and shared memory from ptxas; ~2 min. The builds go to
`lidar_graph_slam_tpu_torch/build/finalize_variants/`.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lidar_graph_slam_tpu_torch", "csrc")
OUT = os.path.join(REPO, "lidar_graph_slam_tpu_torch", "build", "finalize_variants")

# name: (rows a block, threads a block, points a round, stage slots)
VARIANTS = {
    "r32-t512-c64-s2": (32, 512, 64, 2),
    "r32-t512-c128-s2": (32, 512, 128, 2),
    "r32-t256-c128-s2": (32, 256, 128, 2),
    "r16-t256-c64-s2": (16, 256, 64, 2),
    "r16-t256-c128-s2": (16, 256, 128, 2),
    "r16-t256-c128-s4": (16, 256, 128, 4),
    "r8-t128-c128-s2": (8, 128, 128, 2),
    "r8-t128-c128-s4": (8, 128, 128, 4),
}
CONSTANTS = ("kPointRows", "kPointThreads", "kChunk", "kStages")


def variant_source(shape) -> str:
    """voxel_finalize.cu with the points mode's four constants set to `shape`."""
    with open(os.path.join(CSRC, "voxel_finalize.cu")) as f:
        src = f.read()
    for name, value in zip(CONSTANTS, shape):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise AssertionError(f"voxel_finalize.cu: {n} definitions of {name}")
    return src


def build_all(nvcc: str, flags) -> dict:
    """One nvcc a shape, all started together. Returns {name: (library path, ptxas line
    of the points-mode kernel)}."""
    procs = {}
    for name, shape in VARIANTS.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "voxel_finalize.cu"), "w") as f:
            f.write(variant_source(shape))
        shutil.copy(os.path.join(CSRC, "eigh3x3.cuh"), d)
        so = os.path.join(d, "libfinalize.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *flags, "-o", so, os.path.join(d, "voxel_finalize.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        entry = next(i for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and "ndt_finalize_kernelILb0" in ln)
        usage = next(ln for ln in lines[entry:] if "registers" in ln)
        out[name] = (so, usage.split("info    :")[-1].strip())
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from lidar_graph_slam_tpu_torch.ops import kernels, voxel

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.load_library()
    libs = build_all(kernels._nvcc(), [*kernels._NVCC_FLAGS, "-shared"])
    cfg = cs.loops_off_config()
    scans, gt = cs.dense_course(40)
    _, ring, _ = cs.full_ring(cfg, scans, gt, dev)
    (runs, origin, res), kw = cs.ring_finalize_inputs(cfg, ring)["fine"]
    C = runs[2].shape[0] - 1
    lengths = runs[2][:C].cpu().numpy()
    blocks = {R: lengths[: C // R * R].reshape(-1, R).sum(1) for R in (8, 16, 32)}
    cs.say("finalize-runs", rows=C, points=int(lengths.sum()), occupied=int((lengths > 0).sum()),
           max_run=int(lengths.max()),
           **{f"busy_blocks_r{R}": int((b > 0).sum()) for R, b in blocks.items()},
           **{f"max_block_points_r{R}": int(b.max()) for R, b in blocks.items()},
           card=card)

    def call():
        return kernels.ndt_finalize(runs, origin, res, cs.MIN_POINTS, **kw)

    ref = cs.flat(voxel.ndt_finalize_plain(runs, origin, res, cs.MIN_POINTS, **kw))
    main_lib, vp, i32, i64, f32 = (kernels._lib, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_float)
    loaded = {}
    for name, (so, _) in libs.items():
        lib = ctypes.CDLL(so)
        lib.lgs_ndt_finalize.argtypes = [vp, vp, vp, i64, vp, vp, vp, vp, vp, i32, vp, vp, f32,
                                         i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.lgs_ndt_finalize.restype = ctypes.c_int
        loaded[name] = lib
    times = {name: [] for name in VARIANTS}
    try:
        for name in VARIANTS:
            kernels._lib = loaded[name]
            cs.same_bits(f"variant {name}", cs.FINALIZE_OUT, cs.flat(call()), cs.flat(call()),
                         ref)
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            kernels._lib = loaded[name]
            times[name].append(cs.split_times(call, calls=50, warmup=3))
    finally:
        kernels._lib = main_lib
    for name, shape in VARIANTS.items():
        rows_, threads, chunk, slots = shape
        cs.say("finalize-variant", name=name, rows=rows_, threads=threads, chunk=chunk,
               stages=slots, stage_bytes=threads // 32 * (slots * 3 + 4) * chunk * 4,
               device_us=float(np.mean([t["device_us"] for t in times[name]])),
               device_us_turns=",".join(f"{t['device_us']:.3f}" for t in times[name]),
               host_us=float(np.mean([t["host_us"] for t in times[name]])),
               bit_equal=True, ptxas=f"'{libs[name][1]}'", card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
