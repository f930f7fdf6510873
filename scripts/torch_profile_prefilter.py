"""Time and profile the prefilter of the PyTorch port on a CUDA card.

    python3 scripts/torch_profile_prefilter.py --input NPZ [--parent DIR] [--repeats 20]

`--input` holds raw scans padded to their bucket with PAD_VALUE (`raw_<label>` arrays,
as `chip_smoke.py` writes them from the dense course's first frame and a drift frame).
The default config's prefilter (`filters/prefilter.py:make_prefilter`: the distance
filter, the 0.1 m voxel downsample into C = 65,536 rows, the outlier filter at k = 30,
the compaction to 32,768 rows) runs on each scan on three paths:

  kernel  this checkout: `voxel_centroids` and `sor_window_stats` launched once a call;
  plain   this checkout with `ops.kernels.voxel_centroids` and `sor_window_stats` replaced
          by their plain versions (`torch.segment_reduce`, the [N, 48] window distances,
          their row sort and the scatters);
  parent  with `--parent DIR`, that tree's `filters/prefilter.py`, `ops/voxel.py` and
          `ops/neighbors.py` (a parent commit unpacked with `git archive`), loaded beside
          this checkout's.

Per scan and path: wall ms a call (host clock between synchronizes, the median of
`--repeats`) and the host's enqueue ms (the call's return, no synchronize), in turns
(kernel, plain, parent, parent, plain, kernel); then one call of each under
`torch.profiler` (after a session thrown away): device kernel launches (copies and
memsets not counted), device ms, the device's idle share over the wall ms, the kernel
wrappers' launches (`thread_launches`), `segment_reduce`'s launches and device ms, the
`aten::sort` calls by input shape (the SOR's row sort is the one of [N, 48]), and the
kernels launched most and those that took most device time. The kernel path's result
must equal the plain path's bit for bit; the parent's is compared (masks equal, largest
point difference) and not required to match: the plain SOR adds its k roots in another
order than the parent's `torch.sum`. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parent_make_prefilter(root: str):
    """`make_prefilter` of the tree at `root`, its `ops/voxel.py` and `ops/neighbors.py`
    loaded beside this checkout's (their other imports are this checkout's modules, which
    the prefilter's sorts and grids share unchanged)."""
    import lidar_graph_slam_tpu_torch.ops as ops_pkg

    def load(name, *rel):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "lidar_graph_slam_tpu_torch", *rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    saved = (ops_pkg.voxel, ops_pkg.neighbors)
    try:
        # `from lidar_graph_slam_tpu_torch.ops import neighbors, voxel` in the parent's
        # prefilter reads these attributes of the package.
        ops_pkg.voxel = load("parent_voxel", "ops", "voxel.py")
        ops_pkg.neighbors = load("parent_neighbors", "ops", "neighbors.py")
        return load("parent_prefilter", "filters", "prefilter.py").make_prefilter
    finally:
        ops_pkg.voxel, ops_pkg.neighbors = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.core.config import CapacityConfig, PrefilterConfig
    from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
    from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
    from lidar_graph_slam_tpu_torch.ops import kernels, neighbors, voxel

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = np.load(args.input)
    cap = CapacityConfig()
    sizes = dict(capacity_out=cap.filtered_points,
                 voxel_capacity=min(cap.raw_points, 2 * cap.filtered_points))
    makers = {"kernel": make_prefilter, "plain": make_prefilter}
    if args.parent:
        makers["parent"] = parent_make_prefilter(os.path.abspath(args.parent))
    prefilters = {name: make(PrefilterConfig(), **sizes) for name, make in makers.items()}
    kernel_fns = (kernels.voxel_centroids, kernels.sor_window_stats)

    def on_path(name):
        kernels.voxel_centroids, kernels.sor_window_stats = (
            (voxel.voxel_centroids_plain, neighbors.sor_window_stats_plain)
            if name == "plain" else kernel_fns)

    def run(name, raw, mask):
        on_path(name)
        try:
            return prefilters[name](raw, mask)
        finally:
            on_path("kernel")

    order = ["kernel", "plain"] + (["parent", "parent"] if args.parent else []) + [
        "plain", "kernel"]
    out = {}
    for label in sorted(k[4:] for k in data.files if k.startswith("raw_")):
        raw = torch.as_tensor(data[f"raw_{label}"], device=dev)
        mask = raw[:, 0] < 0.5 * PAD_VALUE
        results = {name: run(name, raw, mask) for name in prefilters}  # warm-up
        torch.cuda.synchronize()
        ref = results["kernel"]
        if not (torch.equal(ref.points, results["plain"].points)
                and torch.equal(ref.mask, results["plain"].mask)):
            raise AssertionError(f"{label}: the kernel and plain prefilters differ")
        walls = {name: [] for name in prefilters}
        enqueues = {name: [] for name in prefilters}
        for name in order:
            for _ in range(args.repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(name, raw, mask)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                walls[name].append(1000 * (time.perf_counter() - t0))
                enqueues[name].append(1000 * (t1 - t0))
        rows = {}
        for name in prefilters:
            on_path(name)
            try:
                # Twice, the first session thrown away (a process's first session can
                # miss kernel events).
                for _ in range(2):
                    before = kernels.thread_launches()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                 record_shapes=True) as prof:
                        prefilters[name](raw, mask)
                        torch.cuda.synchronize()
                    wrapper = kernels.thread_launches() - before
            finally:
                on_path("kernel")
            ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset"))]
            device_ms = sum(e.self_device_time_total for e in ka) / 1000
            wall = float(np.median(walls[name]))
            segment = [e for e in ka if "segment_reduce" in e.key]
            sorts = {str(e.input_shapes[0]) if e.input_shapes else "?": e.count
                     for e in prof.key_averages(group_by_input_shape=True)
                     if e.key == "aten::sort"}
            res = results[name]
            rows[name] = dict(
                wall_ms=wall, wall_ms_turns=[round(w, 3) for w in walls[name]],
                enqueue_ms=float(np.median(enqueues[name])),
                launches=sum(e.count for e in ka), device_ms=device_ms,
                idle_share=1.0 - device_ms / wall, wrapper_launches=wrapper,
                segment_reduce_launches=sum(e.count for e in segment),
                segment_reduce_device_ms=sum(e.self_device_time_total for e in segment) / 1000,
                sorts=sorts,
                row_sorts=sum(n for shape, n in sorts.items() if shape.endswith(", 48]")),
                masks_equal_kernel=bool(torch.equal(res.mask, ref.mask)),
                points_max_diff_kernel=float((res.points - ref.points).abs().max()),
                top=[[e.key[:60], e.count] for e in sorted(ka, key=lambda e: -e.count)[:6]],
                top_device_ms=[[e.key[:60], e.self_device_time_total / 1000]
                               for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:4]])
        out[label] = dict(raw_rows=int(raw.shape[0]), raw_points=int(mask.sum()),
                          filtered_points=int(ref.mask.sum()),
                          bit_equal_kernel_plain=True, **rows)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
