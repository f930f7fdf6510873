"""The summation order of cuBLAS's batched 3x3 product on a CUDA card, against the fixed
order the `ndt_finalize` kernel takes.

    python3 scripts/torch_product_order.py [--rows 65536 32768] [--seed 0] [--device cpu]

`regularize_covariance` once formed V diag(1/w) V^T with a batched `@`, which runs in
cuBLAS on the card. For random covariances of a 2 m voxel's scale (near-planar and
near-linear ones among them, so the eigenvalue floor is active), their eigenpairs by
`_eigh3x3` and the floored reciprocals, this compares that `@` with
`ops/voxel.py:_scaled_gram` (mul-then-add, k = 0, 1, 2: the kernel's order) and with an
FMA chain k = 0, 1, 2 evaluated in float64 and rounded to float32 at each step. Prints one
JSON line: for each row count, the entries and how many of them differ from cuBLAS's.
`--device cpu` asks the same of the CPU's batched `@`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[65536, 32768])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch

    from lidar_graph_slam_tpu_torch.ops.voxel import _eigh3x3, _scaled_gram

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    out = {"device": (torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
           "torch": torch.__version__}
    for rows in args.rows:
        A = rng.normal(size=(rows, 3, 3)).astype(np.float32) * 0.3
        A[rows // 4: rows // 2, 2] *= 1e-3   # near-planar
        A[rows // 2: 3 * rows // 4, 1:] *= 1e-3  # near-linear
        cov = torch.as_tensor(A @ np.swapaxes(A, 1, 2), device=dev)
        w, V = _eigh3x3(cov)
        inv_w = 1.0 / torch.maximum(w, 1e-2 * torch.clamp(w[..., 2:3], min=1e-9))
        M = V * inv_w[..., None, :]
        library = M @ V.transpose(-1, -2)
        ordered = _scaled_gram(V, inv_w)
        M64, V64 = M.double(), V.double()
        fma = (M64[..., :, 0, None] * V64[..., None, :, 0]).float()
        for k in (1, 2):
            fma = (M64[..., :, k, None] * V64[..., None, :, k] + fma.double()).float()
        out[str(rows)] = dict(
            entries=library.numel(),
            mul_add_differs=int((ordered != library).sum()),
            fma_chain_differs=int((fma != library).sum()),
            mul_add_max_rel=float(((ordered - library).abs().amax((1, 2))
                                   / library.abs().amax((1, 2))).max()))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
