"""Time and profile the NDT target build of the PyTorch port on a CUDA card.

    python3 scripts/torch_profile_rebuild.py --input NPZ [--parent DIR] [--repeats 10]

`--input` holds an assembled submap (`points`, `mask`) as `chip_smoke.py` writes it from
a course's ring (the dense course's full ring, the drift course's last). The default
config's target (`make_ndt_matcher`'s `build_target`: `build_ndt_pyramid`, a 2 m fine map
of 65,536 voxels and a 4 m coarse one of 32,768) is built on three paths:

  kernel  this checkout: `ndt_finalize` launched once a map, from the sorted rows;
  plain   this checkout with `ops.kernels.ndt_finalize` and `ops.kernels.dense_table`
          replaced by their plain versions (`ops/voxel.py:ndt_finalize_plain`: the run
          sums by `torch.segment_reduce`, then ~1,050 ATen operations a map;
          `build_dense_table_plain`: the scatter-min);
  parent  with `--parent DIR`, that tree's `ops/voxel.py:build_ndt_pyramid` and
          `ops/kernels.py` (a parent commit unpacked with `git archive`), loaded beside
          this checkout's; the parent's target build calls its own kernels.

Wall ms a build (host clock between synchronizes, the median of `--repeats`), in turns
(kernel, plain, parent, parent, plain, kernel); then one build of each under
`torch.profiler` (after a session thrown away): device kernel launches (the profiler's kernel events; copies and
memsets not counted), device ms, the device's idle share, the kernel wrappers' launches
(`thread_launches`), the launches and device ms of `segment_reduce`, the scatters'
launches (the plain dense table's `scatter_reduce_`), and the kernels
launched most and those that took most device time. The kernel path's maps must equal the
plain path's, and the parent's, bit for bit. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, NdtConfig
    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.ops import voxel
    from lidar_graph_slam_tpu_torch.registration.ndt import make_ndt_matcher

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = np.load(args.input)
    points = torch.as_tensor(data["points"], device=dev)
    mask = torch.as_tensor(data["mask"], device=dev)
    cfg, capacity = NdtConfig(), CapacityConfig().voxel_capacity
    build_target, _ = make_ndt_matcher(cfg, capacity)
    factor = round(cfg.coarse_resolution / cfg.resolution)
    kernel_finalize, kernel_table = kernels.ndt_finalize, kernels.dense_table

    builds = {"kernel": lambda: build_target(points, mask),
              "plain": lambda: build_target(points, mask)}
    ops_pkg = sys.modules["lidar_graph_slam_tpu_torch.ops"]
    if args.parent:
        def tree_module(name, rel):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(args.parent, "lidar_graph_slam_tpu_torch", "ops", rel))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod

        parent = tree_module("parent_voxel", "voxel.py")
        parent_kernels = tree_module("parent_kernels", "kernels.py")
        builds["parent"] = lambda: parent.build_ndt_pyramid(
            points, mask, cfg.resolution, factor, capacity=capacity,
            coarse_capacity=capacity // 2)

    def on_path(name):
        # The parent's map builders import `ops.kernels` when they run: the package's
        # attribute names the parent tree's module while the parent builds.
        ops_pkg.kernels = parent_kernels if name == "parent" else kernels
        kernels.ndt_finalize = voxel.ndt_finalize_plain if name == "plain" else kernel_finalize
        kernels.dense_table = (voxel.build_dense_table_plain if name == "plain"
                               else kernel_table)

    def run(name):
        on_path(name)
        try:
            return builds[name]()
        finally:
            on_path("kernel")

    maps = {name: run(name) for name in builds}  # warm-up: builds the library
    torch.cuda.synchronize()
    for other in [name for name in builds if name != "kernel"]:
        for a, b in zip(maps["kernel"], maps[other]):
            for field in voxel.NdtVoxelMap.__dataclass_fields__:
                if not torch.equal(getattr(a, field), getattr(b, field)):
                    raise AssertionError(f"kernel and {other} maps differ: {field}")
    order = ["kernel", "plain"] + (["parent", "parent"] if args.parent else []) + ["plain",
                                                                                  "kernel"]
    walls = {name: [] for name in builds}
    for name in order:
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(name)
            torch.cuda.synchronize()
            walls[name].append(1000 * (time.perf_counter() - t0))
    out = {}
    for name in builds:
        on_path(name)
        try:
            # Twice, the first session thrown away: a process's first session can miss
            # kernel events (a dense-ring build once showed 74 of its 158 launches).
            for _ in range(2):
                before = kernels.thread_launches()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    builds[name]()
                    torch.cuda.synchronize()
                wrapper = kernels.thread_launches() - before
        finally:
            on_path("kernel")
        ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not e.key.startswith(("Memcpy", "Memset"))]
        device_ms = sum(e.self_device_time_total for e in ka) / 1000
        wall = float(np.median(walls[name]))
        segment = [e for e in ka if "segment_reduce" in e.key]
        scatter = [e for e in ka if "scatter" in e.key.lower()]
        out[name] = dict(wall_ms=wall, wall_ms_turns=[round(w, 3) for w in walls[name]],
                         launches=sum(e.count for e in ka), device_ms=device_ms,
                         idle_share=1.0 - device_ms / wall, wrapper_launches=wrapper,
                         segment_reduce_launches=sum(e.count for e in segment),
                         segment_reduce_device_ms=sum(e.self_device_time_total
                                                      for e in segment) / 1000,
                         scatter_launches=sum(e.count for e in scatter),
                         top=[[e.key[:60], e.count] for e in sorted(ka, key=lambda e: -e.count)[:6]],
                         top_device_ms=[[e.key[:60], e.self_device_time_total / 1000]
                                        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:4]])
    print(json.dumps(dict(fine_voxels=int(maps["kernel"][1].num_voxels),
                          coarse_voxels=int(maps["kernel"][0].num_voxels),
                          bit_equal_kernel_plain=True,
                          bit_equal_kernel_parent="parent" in builds, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
