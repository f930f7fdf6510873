"""The floor of a launch on a CUDA card: empty kernels launched plainly and as
thread-block clusters, with and without cluster barriers, timed as `chip_smoke.py` times a
kernel (a spin-held event pair over 200 back-to-back launches).

    python3 scripts/torch_cluster_floor.py

It writes a small CUDA source into `lidar_graph_slam_tpu_torch/build/`, builds it with
nvcc for sm_90a and binds it with ctypes. Each kernel reads nothing; a cluster kernel's
barrier variants: none, one `cluster.sync()` with a read of a peer's shared memory, and a
second `cluster.sync()` after it (the shape of `csrc/prefilter_pass.cu`'s one-launch
kernels). Prints one JSON line a configuration (grid, block, cluster, barriers, device
and host us a launch) and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void plain_kernel(int* out) {
  if (threadIdx.x == 0 && blockIdx.x == 0xffffff) out[0] = 1;
}

template <int kBarriers>
__global__ void cluster_kernel(int* out) {
  __shared__ int part;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) part = static_cast<int>(blockIdx.x);
  int v = 0;
  if (kBarriers > 0) {
    cluster.sync();
    if (threadIdx.x == 0)
      v = *cluster.map_shared_rank(&part, (cluster.block_rank() + 1) % cluster.num_blocks());
  }
  if (kBarriers > 1) cluster.sync();
  if (threadIdx.x == 0 && v < 0) out[0] = v;
}

extern "C" int floor_launch(int barriers, int cluster, int grid, int threads, void* stream,
                            int* out) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  cudaError_t err;
  if (cluster == 0) {
    err = cudaLaunchKernelEx(&cfg, plain_kernel, out);
  } else {
    void (*fns[3])(int*) = {cluster_kernel<0>, cluster_kernel<1>, cluster_kernel<2>};
    if (cluster > 8)
      cudaFuncSetAttribute(fns[barriers], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    err = cudaLaunchKernelEx(&cfg, fns[barriers], out);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""

# (label, barriers, blocks a cluster (0: a plain launch), grid, threads a block)
CONFIGS = [
    ("plain 8 x 256", 0, 0, 8, 256),
    ("plain 128 x 256", 0, 0, 128, 256),
    ("plain 640 x 256", 0, 0, 640, 256),
    ("plain 16 x 1024", 0, 0, 16, 1024),
    ("cluster 16 x 1024, no barrier", 0, 16, 16, 1024),
    ("cluster 16 x 1024, one barrier", 1, 16, 16, 1024),
    ("cluster 16 x 1024, two barriers", 2, 16, 16, 1024),
    ("cluster 16 x 256, two barriers", 2, 16, 16, 256),
    ("cluster 8 x 1024, two barriers", 2, 8, 8, 1024),
    ("7 clusters 16 x 1024, two barriers", 2, 16, 112, 1024),
    ("7 clusters 16 x 256, two barriers", 2, 16, 112, 256),
]


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_cluster_floor: needs a CUDA card", file=sys.stderr)
        return 2
    build = os.path.join(REPO, "lidar_graph_slam_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    src, lib_path = os.path.join(build, "cluster_floor.cu"), os.path.join(build,
                                                                          "libcluster_floor.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    from lidar_graph_slam_tpu_torch.ops import kernels

    subprocess.run([kernels._nvcc(), *kernels._ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.floor_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.floor_launch.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for label, barriers, cluster, grid, threads in CONFIGS:
        def launch():
            err = lib.floor_launch(barriers, cluster, grid, threads,
                                   torch.cuda.current_stream().cuda_stream, out.data_ptr())
            if err:
                raise RuntimeError(f"{label}: launch failed ({err})")

        t = cs.split_times(launch)
        print(json.dumps(dict(config=label, barriers=barriers, cluster=cluster, grid=grid,
                              threads=threads, device_us=t["device_us"], host_us=t["host_us"],
                              card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
