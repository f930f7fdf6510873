"""Time and profile GICP's covariances of the PyTorch port on a CUDA card: the target build
and a source scan's covariances.

    python3 scripts/torch_profile_gicp_build.py --input NPZ [--parent DIR] [--repeats 10]

`--input` holds an assembled submap (`points`, `mask`) and a source scan (`src_points`,
`src_mask`), as `chip_smoke.py` writes them from the dense course's full ring and its
last ring scan. Two calls, each on three paths:

  target  `registration/gicp.py:build_gicp_target` of the submap (2 m cells, as
          `make_gicp_matcher` builds it): the grid, the window sums and the
          regularization;
  source  `estimate_covariances` of the source scan (the fused step's, every frame);

  kernel  this checkout: `gicp_covariances` launched once a call
          (`csrc/covariances.cu`), and the target's grid by `grid_rows`
          (`csrc/grid.cu`);
  plain   this checkout with those wrappers (and `dense_table`) replaced by their
          plain versions (`ops/neighbors.py:gicp_covariances_plain`: the window sums'
          ~800 ATen operations a cloud, then `plane_covariances_plain`;
          `grid_rows_plain`: the cummax, the packed rows and the scatter-min table);
  parent  with `--parent DIR`, that tree's `registration/gicp.py` (a parent commit
          unpacked with `git archive`), loaded beside this checkout's and bound to that
          tree's `ops/kernels.py` (which builds that tree's `csrc/`) and to that tree's
          grid build (`ops/neighbors.py:build_hash_grid` with its `ops/voxel.py`):
          its own covariances and grid, whatever they call.

Wall ms a call (host clock between synchronizes, the median of `--repeats`), in turns
(kernel, plain, parent, parent, plain, kernel); then one call of each under
`torch.profiler` (after a session thrown away): device kernel launches (copies and
memsets not counted), device ms, the kernel wrappers' launches (`thread_launches`), the
launches of `torch.cummax`'s scan and of scatters, and the kernels that took most device
time. The kernel path must equal the plain path bit for
bit; against the parent it reports the valid rows' agreement and how many covariance
entries differ (a tree whose product V diag V^T summed in cuBLAS's order parts in the last
bits). Prints one JSON line.
"""

from __future__ import annotations

import argparse
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

    from lidar_graph_slam_tpu_torch.ops import kernels
    from lidar_graph_slam_tpu_torch.ops import neighbors
    from lidar_graph_slam_tpu_torch.ops import voxel
    from lidar_graph_slam_tpu_torch.registration import gicp

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    data = np.load(args.input)
    tgt = [torch.as_tensor(data[k], device=dev) for k in ("points", "mask")]
    src = [torch.as_tensor(data[k], device=dev) for k in ("src_points", "src_mask")]
    cell = 2.0
    modules = {"kernel": gicp, "plain": gicp}
    if args.parent:
        import chip_smoke

        parent_kern = chip_smoke.tree_kernels(args.parent)
        modules["parent"] = chip_smoke.tree_registration(args.parent, "gicp", parent_kern,
                                                         "parent_gicp")
        modules["parent"].build_hash_grid = chip_smoke.tree_grid_builder(args.parent,
                                                                         parent_kern)
    kernel_path = (kernels.gicp_covariances, kernels.grid_rows, kernels.dense_table)
    plain_path = (neighbors.gicp_covariances_plain, neighbors.grid_rows_plain,
                  voxel.build_dense_table_plain)

    def on_path(name):
        kernels.gicp_covariances, kernels.grid_rows, kernels.dense_table = (
            plain_path if name == "plain" else kernel_path)

    calls = {"target": lambda mod: mod.build_gicp_target(*tgt, cell),
             "source": lambda mod: mod.estimate_covariances(*src, cell)}

    def run(name, call):
        on_path(name)
        try:
            return calls[call](modules[name])
        finally:
            on_path("kernel")

    def outputs(call, out):
        return (out.covs, out.valid) if call == "target" else out

    out = {}
    for call in calls:
        res = {name: outputs(call, run(name, call)) for name in modules}  # the warm-up
        torch.cuda.synchronize()
        for a, b in zip(res["kernel"], res["plain"]):
            if not torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)):
                raise AssertionError(f"{call}: the kernel and plain paths differ")
        rec = {"rows": int(tgt[0].shape[0] if call == "target" else src[0].shape[0]),
               "valid_rows": int(res["kernel"][1].sum()), "bit_equal_kernel_plain": True}
        if "parent" in res:
            (kc, kv), (pc, pv) = res["kernel"], res["parent"]
            both = kv & pv
            scale = pc[both].abs().amax(dim=(1, 2)).clamp(min=1e-30)
            rec.update(parent_valid_equal=bool(torch.equal(kv, pv)),
                       parent_entries_differ=int((kc != pc).sum()),
                       parent_rows_differ=int((kc != pc).any(dim=(1, 2)).sum()),
                       parent_max_rel_diff=float(((kc[both] - pc[both]).abs().amax(dim=(1, 2))
                                                  / scale).max()) if bool(both.any()) else 0.0)
        order = ["kernel", "plain"] + (["parent", "parent"] if "parent" in modules else [])
        order += ["plain", "kernel"]
        walls = {name: [] for name in modules}
        for name in order:
            for _ in range(args.repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(name, call)
                torch.cuda.synchronize()
                walls[name].append(1000 * (time.perf_counter() - t0))
        for name in modules:
            # Twice, the first session thrown away: a process's first session can miss
            # kernel events.
            for _ in range(2):
                before = modules[name].kernels.thread_launches()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run(name, call)
                    torch.cuda.synchronize()
                wrapper = modules[name].kernels.thread_launches() - before
            ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset"))]
            device_ms = sum(e.self_device_time_total for e in ka) / 1000
            wall = float(np.median(walls[name]))
            rec[name] = dict(
                wall_ms=wall, wall_ms_turns=[round(w, 3) for w in walls[name]],
                launches=sum(e.count for e in ka), device_ms=device_ms,
                idle_share=1.0 - device_ms / wall, wrapper_launches=wrapper,
                cummax_launches=sum(e.count for e in ka if "cummax" in e.key
                                    or "dim_with_indices" in e.key),
                scatter_launches=sum(e.count for e in ka if "scatter" in e.key.lower()),
                top_device_ms=[[e.key[:60], round(e.self_device_time_total / 1000, 4), e.count]
                               for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:5]])
        out[call] = rec
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
