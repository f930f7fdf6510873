"""Time and profile the prefilter of the PyTorch port on a CUDA card.

    python3 scripts/torch_profile_prefilter.py --write-input NPZ
    python3 scripts/torch_profile_prefilter.py --input NPZ [--parent DIR] [--repeats 20]

`--write-input` writes the raw scans the profile reads (~20 s on a CPU): the dense
course's first frame and the drift course's frame 100, each padded to its bucket with
PAD_VALUE (`raw_<label>` arrays, as `chip_smoke.py` phase 10c also writes them, with
the loop submap's cloud as `sub_<label>` and `sub_mask_<label>`).

The default config's prefilter (`filters/prefilter.py:make_prefilter`: the distance
filter, the 0.1 m voxel downsample into C = 65,536 rows, the outlier filter at k = 30,
the compaction to 32,768 rows) runs on each raw scan, and the loop attempt's
`voxel_downsample` (`graph/slam.py:candidate_targets`: `loop_submap_leaf`, C = 131,072)
on each submap, on three paths:

  kernel  this checkout: its hand-written kernels launched;
  plain   this checkout with every kernel wrapper the prefilter calls replaced by its
          plain version;
  parent  with `--parent DIR`, that tree's `filters/prefilter.py`, `ops/voxel.py`,
          `ops/neighbors.py`, `core/pointcloud.py` and `ops/kernels.py` (a parent commit
          unpacked with `git archive`), loaded beside this checkout's; while a parent
          call runs, its modules' kernel wrappers are that tree's `ops/kernels.py`
          (which builds that tree's `csrc/`).

Per input and path: wall ms a call (host clock between synchronizes, the median of
`--repeats`) and the host's enqueue ms (the call's return, no synchronize), in turns
(kernel, plain, parent, parent, plain, kernel); the call captured into a CUDA graph and
its replay's device us (CUDA events around 50 replays, in the same turns), and the device
kernels of one replay under `torch.profiler`; then one eager call under `torch.profiler`
(after a session thrown away): device kernel launches (copies and memsets not counted),
device ms, the device's idle share over the wall ms, the kernel wrappers' launches
(`thread_launches`), `segment_reduce`'s, `cumsum`'s, `searchsorted`'s and the argsort's
launches, the `aten::sort` calls by input shape (the SOR's row sort is the one of [N,
48]); and `split`, from a third call under the profiler with each function of `GROUPS`
wrapped in a `record_function` range of its group: the call's device kernels under the
innermost group of the operator that launched them (a kernel a wrapper launches through
the C library has no operator and is grouped by its own name), launches and device us a
group. The kernel path's result must equal the plain path's bit for bit;
the parent's is compared (masks equal, largest point difference), and not required to
match. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The kernel wrappers a prefilter or a downsample calls, by the module that holds each
# one's plain version and that version's name (a tree lacking a wrapper skips it).
WRAPPERS = {"voxel_centroids": ("voxel", "voxel_centroids_plain"),
            "sor_window_stats": ("neighbors", "sor_window_stats_plain"),
            "cell_keys": ("voxel", "cell_keys_plain"),
            "sorted_runs": ("voxel", "sorted_runs_plain"),
            "sor_threshold": ("neighbors", "sor_threshold_plain"),
            "compact_rows": ("pointcloud", "compact_rows_plain")}
REPLAYS = 50
# The profile's groups: each a list of (module, function) whose device kernels it takes
# (the innermost group wins; "torch" is the torch module, the others the tree's).
GROUPS = {
    "distance filter": [("prefilter", "distance_filter"), ("prefilter", "crop_filter")],
    "pad": [("prefilter", "pad_points")],
    "corner and keys": [("voxel", "min_corner"), ("voxel", "voxel_coords"),
                        ("voxel", "pack_key"), ("neighbors", "min_corner"),
                        ("neighbors", "voxel_coords"), ("neighbors", "pack_key"),
                        ("kernels", "cell_keys")],
    "sort": [("torch", "sort")],
    "runs": [("voxel", "_sorted_runs"), ("kernels", "sorted_runs")],
    "downsample (gather, where)": [("voxel", "voxel_downsample")],
    "voxel_centroids": [("kernels", "voxel_centroids")],
    "SOR cells (gather, pad)": [("neighbors", "sort_by_cell")],
    "sor_window_stats": [("kernels", "sor_window_stats")],
    "threshold": [("prefilter", "statistical_outlier_mask"), ("kernels", "sor_threshold")],
    "compact": [("prefilter", "compact"), ("kernels", "compact_rows")],
    "argsort": [("torch", "argsort")],
}


class Ranged:
    """`fn` called inside a `record_function` range of its profile group; its attributes
    (a kernel wrapper's `launches`) are `fn`'s."""

    def __init__(self, fn, group: str):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_group", f"group::{group}")

    def __call__(self, *args, **kwargs):
        import torch

        with torch.profiler.record_function(self._group):
            return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def write_input(path: str) -> None:
    """The dense course's first frame and the drift course's frame 100, each padded to its
    raw bucket (`chip_smoke.raw_bucket`)."""
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke
    from lidar_graph_slam_tpu_torch.core.config import CapacityConfig

    raw_points = CapacityConfig().raw_points
    dense, _ = chip_smoke.dense_course(40, first=1)
    drift, _ = chip_smoke.drift_course()
    np.savez(path, raw_dense=chip_smoke.raw_bucket(dense[0], raw_points),
             raw_drift=chip_smoke.raw_bucket(drift[chip_smoke.PREFILTER_DRIFT_FRAME],
                                             raw_points))


def tree_modules(root: str) -> dict:
    """The tree at `root`'s `core/pointcloud.py`, `ops/voxel.py`, `ops/neighbors.py` and
    `filters/prefilter.py`, each loaded with the ones before it standing in for this
    checkout's while it imports (their other imports are this checkout's modules)."""
    import lidar_graph_slam_tpu_torch.filters.prefilter  # noqa: F401 (this tree's, first)
    import lidar_graph_slam_tpu_torch.ops as ops_pkg

    names = {"pointcloud": ("core", "pointcloud.py"), "voxel": ("ops", "voxel.py"),
             "neighbors": ("ops", "neighbors.py"), "prefilter": ("filters", "prefilter.py")}
    mods, saved = {}, {}
    saved_attrs = (ops_pkg.voxel, ops_pkg.neighbors)
    try:
        spec = importlib.util.spec_from_file_location(
            "parent_kernels", os.path.join(root, "lidar_graph_slam_tpu_torch", "ops",
                                           "kernels.py"))
        mods["kernels"] = importlib.util.module_from_spec(spec)
        sys.modules["parent_kernels"] = mods["kernels"]
        spec.loader.exec_module(mods["kernels"])
        for name, rel in names.items():
            spec = importlib.util.spec_from_file_location(
                f"parent_{name}", os.path.join(root, "lidar_graph_slam_tpu_torch", *rel))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
            full = f"lidar_graph_slam_tpu_torch.{rel[0]}.{name}"
            saved.setdefault(full, sys.modules[full])
            sys.modules[full] = mod
            if rel[0] == "ops":  # `from lidar_graph_slam_tpu_torch.ops import voxel`
                setattr(ops_pkg, name, mod)
    finally:
        sys.modules.update(saved)
        ops_pkg.voxel, ops_pkg.neighbors = saved_attrs
    mods["prefilter"].kernels = mods["kernels"]
    return mods


@contextlib.contextmanager
def kernels_of(mods: dict):
    """Inside, `from lidar_graph_slam_tpu_torch.ops import kernels` gives the tree's own
    kernel module (`mods["kernels"]`, for a tree of `tree_modules`); this checkout's
    outside."""
    import lidar_graph_slam_tpu_torch.ops as ops_pkg

    if "kernels" not in mods:
        yield
        return
    full = "lidar_graph_slam_tpu_torch.ops.kernels"
    saved = (ops_pkg.kernels, sys.modules[full])
    ops_pkg.kernels = sys.modules[full] = mods["kernels"]
    try:
        yield
    finally:
        ops_pkg.kernels, sys.modules[full] = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input")
    ap.add_argument("--write-input")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if args.write_input:
        write_input(args.write_input)
        return 0
    sys.path.insert(0, REPO)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.core import pointcloud
    from lidar_graph_slam_tpu_torch.core.config import (
        CapacityConfig,
        GraphSlamConfig,
        PrefilterConfig,
    )
    from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
    from lidar_graph_slam_tpu_torch.filters import prefilter as prefilter_mod
    from lidar_graph_slam_tpu_torch.ops import kernels, neighbors, voxel

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = np.load(args.input)
    cap, gs = CapacityConfig(), GraphSlamConfig()
    sizes = dict(capacity_out=cap.filtered_points,
                 voxel_capacity=min(cap.raw_points, 2 * cap.filtered_points))
    this = {"prefilter": prefilter_mod, "voxel": voxel, "neighbors": neighbors,
            "pointcloud": pointcloud}
    trees = {"kernel": this, "plain": this}
    if args.parent:
        trees["parent"] = tree_modules(os.path.abspath(args.parent))
    homes = {"voxel": voxel, "neighbors": neighbors, "pointcloud": pointcloud}
    wrappers = {name: getattr(kernels, name) for name in WRAPPERS if hasattr(kernels, name)}
    plains = {name: getattr(homes[mod], plain) for name, (mod, plain) in WRAPPERS.items()
              if name in wrappers}

    def on_path(name):
        for w, fn in (plains if name == "plain" else wrappers).items():
            setattr(kernels, w, fn)

    calls = {}  # (label, path) -> fn() of the prefilter or downsample on the input
    labels = []
    for key in sorted(data.files):
        if key.startswith("raw_"):
            label = key[4:]
            raw = torch.as_tensor(data[key], device=dev)
            mask = raw[:, 0] < 0.5 * PAD_VALUE
            for path, mods in trees.items():
                fn = mods["prefilter"].make_prefilter(PrefilterConfig(), **sizes)
                calls[label, path] = (lambda fn=fn, raw=raw, mask=mask: fn(raw, mask))
        elif key.startswith("sub_") and not key.startswith("sub_mask_"):
            label = key
            pts = torch.as_tensor(data[key], device=dev)
            mask = torch.as_tensor(data[f"sub_mask_{key[4:]}"], device=dev)
            for path, mods in trees.items():
                calls[label, path] = (
                    lambda v=mods["voxel"], pts=pts, mask=mask: v.voxel_downsample(
                        pts, mask, gs.loop_submap_leaf, capacity=cap.loop_submap_points))
        else:
            continue
        labels.append(label)

    def run(label, name):
        on_path(name)
        try:
            with kernels_of(trees[name]):
                return calls[label, name]()
        finally:
            on_path("kernel")

    def flat(res):
        return [res.points, res.mask] + ([res.num_voxels] if hasattr(res, "num_voxels")
                                         else [])

    def capture(label, name):
        """The call captured into a CUDA graph after a warm-up on the capture stream: (the
        graph, its outputs)."""
        s = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            run(label, name)
        torch.cuda.current_stream(dev).wait_stream(s)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        on_path(name)
        try:
            with kernels_of(trees[name]), torch.cuda.graph(graph, stream=s):
                out = calls[label, name]()
        finally:
            on_path("kernel")
        return graph, out

    def replay_us(graph) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return 1000 * start.elapsed_time(end) / REPLAYS

    def device_events(prof):
        # (A group's range also shows as a device-side span named "group::...".)
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset", "group::"))]

    def annotated(name):
        """Each function of GROUPS the `name` path calls, wrapped in a `record_function`
        range of its group, until the context ends."""
        mods = {"kernels": kernels, **trees[name], "torch": torch}
        saved = []
        for group, targets in GROUPS.items():
            for mod, attr in targets:
                obj = mods.get(mod)
                if obj is None or not hasattr(obj, attr):
                    continue
                fn = getattr(obj, attr)
                saved.append((obj, attr, fn))
                setattr(obj, attr, Ranged(fn, group))
        return saved

    def split(prof) -> dict:
        """Device kernels grouped under the innermost group range (`annotated`) of the
        operator that launched them; the kernels no operator claims (those a wrapper
        launches through the C library) by their own names."""
        groups: dict = {}
        claimed: dict = {}

        def add(label, us):
            g = groups.setdefault(label, [0, 0.0])
            g[0] += 1
            g[1] += us

        for op in prof.events():
            if op.device_type != DeviceType.CPU or not op.kernels:
                continue
            top = op
            while top is not None and not top.name.startswith("group::"):
                top = top.cpu_parent
            label = top.name[7:] if top is not None else f"op {op.name}"
            for k in op.kernels:
                if k.name.startswith(("Memcpy", "Memset")):
                    continue
                claimed[k.name] = claimed.get(k.name, 0) + 1
                add(label, k.duration)
        for k in device_events(prof):
            if claimed.get(k.name, 0) > 0:
                claimed[k.name] -= 1
            else:
                add(f"kernel {k.name[:48]}", k.time_range.end - k.time_range.start)
        return {k: [n, round(us, 3)] for k, (n, us) in
                sorted(groups.items(), key=lambda kv: -kv[1][1])}

    out = {}
    order = ["kernel", "plain"] + (["parent", "parent"] if args.parent else []) + [
        "plain", "kernel"]
    for label in labels:
        results = {name: run(label, name) for name in trees}  # warm-up
        torch.cuda.synchronize()
        ref = flat(results["kernel"])
        if not all(torch.equal(a, b) for a, b in zip(ref, flat(results["plain"]))):
            raise AssertionError(f"{label}: the kernel and plain paths differ")
        graphs = {name: capture(label, name) for name in trees}
        for name, (graph, gout) in graphs.items():
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(flat(gout), flat(results[name]))):
                raise AssertionError(f"{label}: the {name} path's replay differs from its "
                                     "eager call")
        walls = {name: [] for name in trees}
        enqueues = {name: [] for name in trees}
        replays = {name: [] for name in trees}
        for name in order:
            for _ in range(args.repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(label, name)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                walls[name].append(1000 * (time.perf_counter() - t0))
                enqueues[name].append(1000 * (t1 - t0))
            replays[name].append(replay_us(graphs[name][0]))
        rows = {}
        for name in trees:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graphs[name][0].replay()
                torch.cuda.synchronize()
            replay_kernels = len(device_events(prof))
            on_path(name)
            kern = trees[name].get("kernels", kernels)
            try:
                with kernels_of(trees[name]):
                    # Twice, the first session thrown away (a process's first session can
                    # miss kernel events).
                    for _ in range(2):
                        before = kern.thread_launches()
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA],
                                     record_shapes=True) as prof:
                            calls[label, name]()
                            torch.cuda.synchronize()
                        wrapper = kern.thread_launches() - before
                    saved = annotated(name)
                    try:
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as grouped:
                            calls[label, name]()
                            torch.cuda.synchronize()
                    finally:
                        for obj, attr, fn in reversed(saved):
                            setattr(obj, attr, fn)
            finally:
                on_path("kernel")
            ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset"))]
            device_ms = sum(e.self_device_time_total for e in ka) / 1000
            wall = float(np.median(walls[name]))

            def launches_of(*words):
                return sum(e.count for e in ka if any(w in e.key.lower() for w in words))

            sorts = {str(e.input_shapes[0]) if e.input_shapes else "?": e.count
                     for e in prof.key_averages(group_by_input_shape=True)
                     if e.key == "aten::sort"}
            res = flat(results[name])
            rows[name] = dict(
                wall_ms=wall, wall_ms_turns=[round(w, 3) for w in walls[name]],
                enqueue_ms=float(np.median(enqueues[name])),
                replay_device_us=float(np.mean(replays[name])),
                replay_device_us_turns=[round(x, 3) for x in replays[name]],
                replay_launches=replay_kernels,
                launches=sum(e.count for e in ka), device_ms=device_ms,
                idle_share=1.0 - device_ms / wall, wrapper_launches=wrapper,
                segment_reduce_launches=launches_of("segment_reduce"),
                cumsum_launches=launches_of("cumsum", "scan"),
                searchsorted_launches=launches_of("searchsorted"),
                argsort_calls=sum(e.count for e in prof.key_averages()
                                  if e.key == "aten::argsort"),
                sort_calls=sum(sorts.values()), sorts=sorts,
                row_sorts=sum(n for shape, n in sorts.items() if shape.endswith(", 48]")),
                masks_equal_kernel=bool(torch.equal(res[1], ref[1])),
                points_max_diff_kernel=float((res[0] - ref[0]).abs().max()),
                split=split(grouped),
                top=[[e.key[:60], e.count] for e in sorted(ka, key=lambda e: -e.count)[:6]],
                top_device_ms=[[e.key[:60], e.self_device_time_total / 1000]
                               for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:4]])
        first = results["kernel"]
        out[label] = dict(rows=int(first.points.shape[0]), valid_out=int(first.mask.sum()),
                          bit_equal_kernel_plain=True, **rows)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
