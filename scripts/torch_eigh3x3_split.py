"""Split a launch of the batched 3x3 eigensolve (`eigh3x3`: `eigh3x3_kernel` in
`csrc/voxel_finalize.cu`, the rotations of `csrc/eigh3x3.cuh`) into its parts on one CUDA
card, by timing builds of it cut after each part, and count the rotations that take each
of the header's shortcuts.

    python3 scripts/torch_eigh3x3_split.py [--input NPZ] [--parent DIR] [--json PATH]

The kernel's source has two compile-time switches: `LGS_EIGH_STEPS` (-1: the launch
returns at once, the floor; 0: each thread loads its matrix and stores the diagonal and
the identity; 1-6: that many Jacobi sweeps, 6 being the kernel) and `LGS_EIGH_THREADS`
(threads a block). The script builds `csrc/voxel_finalize.cu` once for each pair of
STEPS x THREADS into a shared library of its own under `.chip_scratch/eigh3x3_split/`
(all at once, with the library's nvcc flags; the file has a plain C interface) and calls
each library's `lgs_eigh3x3` through ctypes. Parts at each thread count: load_store =
load/store - floor, sweep k = (k sweeps) - (k - 1 sweeps).

Also, at each thread count: the kernel on 32 of the input's solved matrices (those that
are not the identity: one warp's chain) less the floor of that launch. With `--parent
DIR` (the parent commit unpacked by `git archive`), that tree's `eigh3x3` (its
`ops/kernels.py`, building its own `csrc/`) on the same inputs, in the same rounds.
Every build's SASS (`cuobjdump -sass`): the instructions of `eigh3x3_kernel` and the
`CALL`s in it (the IEEE divide's, square root's and reciprocal's slow paths), and so for
the parent's library; ptxas's registers and spills of each build.

The routes: `shortcut_eigh3x3`, a float32 model of the kernel's rotation in torch (any
device), classifies each of the 6 x 3 rotations of each matrix as one of ROUTES: `zero`
(|a_pq| > 0 false), `no_divide` (|a_qq - a_pp| >= 2^64 |2 a_pq|), `large_tau` (tau^2 >=
2^25: one reciprocal, no root), `unit_c` (1 + t^2 rounds to 1: no root or reciprocal for
c) and `general`. A warp runs every branch one of its lanes takes, so the script also
counts the warps of 32 consecutive rows by their costliest lane's route.

Fixtures: with `--input`, the normals' inputs as `chip_smoke.py`'s phase 20 writes them
(`eigh_normals__<k>` arrays, [Q, 3, 3] float32); without it, recorded here as that phase
records them: the drift course with `graph_slam.use_global_init=true`
(`chip_smoke.recording_eigh3x3`). Every build of the whole kernel and the parent's are
held bit-equal to `_eigh3x3` on every input; the times are taken on the first. Per
variant and round, `chip_smoke.split_times` (device us); ROUNDS rounds, the variants in
order, then in reverse.

Prints the card's name and power limit, each build's ptxas and SASS numbers, the routes
(one JSON line), one JSON line per variant (the median and each round's time), then one
JSON line of the split.
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

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "lidar_graph_slam_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "voxel_finalize.cu")

ROUNDS = 4
STEPS = (-1, 0, 1, 2, 3, 4, 5, 6)
THREADS = (32, 64, 256)
WARP = 32
ROUTES = ("zero", "no_divide", "large_tau", "unit_c", "general")  # by cost


def _signed_zero(x: torch.Tensor) -> torch.Tensor:
    """+0.0 where x's sign bit is clear, -0.0 where it is set (float32)."""
    return (x.view(torch.int32) & torch.iinfo(torch.int32).min).view(torch.float32)


def shortcut_eigh3x3(A: torch.Tensor):
    """The kernel's eigensolve (`csrc/eigh3x3.cuh`) as float32 torch arithmetic: each
    rotation's t and c from its route's formula, then the plain version's updates.
    Returns (w [..., 3], V [..., 3, 3], routes [6, 3, ...] uint8, indices into ROUTES),
    bit-equal to `ops/voxel.py:_eigh3x3` where the header's shortcuts are exact."""
    a = {(0, 0): A[..., 0, 0], (1, 1): A[..., 1, 1], (2, 2): A[..., 2, 2],
         (0, 1): A[..., 0, 1], (0, 2): A[..., 0, 2], (1, 2): A[..., 1, 2]}
    one = torch.ones_like(a[(0, 0)])
    zero = torch.zeros_like(one)
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    routes = []
    for _ in range(6):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
            num, den = aqq - app, 2.0 * apq
            nz = torch.abs(apq) > 0
            no_divide = nz & (torch.abs(den) * 2.0 ** 64 <= torch.abs(num)) & (
                torch.abs(den) < float("inf"))
            divide = nz & ~no_divide
            # The divide's lanes as the plain version computes them, the root of a large
            # tau taken as |tau|.
            tau = num / (2.0 * torch.where(nz, apq, one))
            tt = tau * tau
            large = divide & (tt >= 2.0 ** 25)
            sgn = torch.where(tau >= 0, one, -one)
            root = torch.where(tt >= 2.0 ** 25, torch.abs(tau), torch.sqrt(1.0 + tt))
            t_div = sgn / (torch.abs(tau) + root)
            u = 1.0 + t_div * t_div
            unit = divide & ~large & (u == 1.0)
            t_none = _signed_zero((num.view(torch.int32) ^ den.view(torch.int32)).view(torch.float32))
            t = torch.where(divide, t_div, torch.where(no_divide, t_none, zero))
            c = torch.where(divide & ~large & ~unit, 1.0 / torch.sqrt(1.0 + t * t), one)
            s = t * c
            routes.append(torch.where(~nz, 0, torch.where(no_divide, 1, torch.where(
                large, 2, torch.where(unit, 3, 4)))).to(torch.uint8))
            apr, aqr = a[(min(p, r), max(p, r))], a[(min(q, r), max(q, r))]
            a[(p, p)] = app - t * apq
            a[(q, q)] = aqq + t * apq
            a[(p, q)] = zero
            a[(min(p, r), max(p, r))] = c * apr - s * aqr
            a[(min(q, r), max(q, r))] = s * apr + c * aqr
            vp, vq = v[p], v[q]
            v[p] = [c * vp[i] - s * vq[i] for i in range(3)]
            v[q] = [s * vp[i] + c * vq[i] for i in range(3)]
    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]
    for (i, j) in ((0, 1), (1, 2), (0, 1)):
        swap = w[i] > w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        vi, vj = v[i], v[j]
        v[i] = [torch.where(swap, vj[k], vi[k]) for k in range(3)]
        v[j] = [torch.where(swap, vi[k], vj[k]) for k in range(3)]
    W = torch.stack(w, dim=-1)
    V = torch.stack([torch.stack(col, dim=-1) for col in v], dim=-1)
    return W, V, torch.stack(routes).reshape(6, 3, *A.shape[:-2])


def route_counts(routes: torch.Tensor) -> dict:
    """routes [6, 3, M] -> {"lanes": [sweep][rotation] {route: matrices}, "warps":
    [sweep][rotation] {route: warps of 32 consecutive rows whose costliest lane takes
    it}} (a last, shorter warp counts as one)."""
    M = routes.shape[-1]
    pad = (-M) % WARP
    warps = torch.nn.functional.pad(routes.to(torch.int16), (0, pad)).reshape(
        6, 3, -1, WARP).amax(dim=-1)
    out = {}
    for name, x in (("lanes", routes.to(torch.int16)), ("warps", warps)):
        n = torch.stack([(x == k).sum(dim=-1) for k in range(len(ROUTES))], dim=-1).cpu()
        out[name] = [[dict(zip(ROUTES, map(int, n[s, r]))) for r in range(3)]
                     for s in range(6)]
    return out


def build(steps: int, threads: int, out: str) -> tuple:
    """nvcc voxel_finalize.cu with the switches into out/ with the kernel library's flags;
    returns (the library's path, ptxas's log)."""
    from lidar_graph_slam_tpu_torch.ops import kernels

    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"libeigh_{steps}_{threads}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS,
                           f"-DLGS_EIGH_STEPS={steps}", f"-DLGS_EIGH_THREADS={threads}",
                           f"-I{CSRC}", "-shared", "-o", so, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {steps}/{threads}:\n{proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def launcher(lib, A):
    """A no-argument launch of `lib`'s `lgs_eigh3x3` on A, into outputs made once."""
    M = A.shape[0]
    w = torch.empty((M, 3), dtype=torch.float32, device=A.device)
    V = torch.empty((M, 3, 3), dtype=torch.float32, device=A.device)
    call = (A.data_ptr(), M, w.data_ptr(), V.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def go(_A=A):  # holds the input as long as the launch is timed
        err = lib.lgs_eigh3x3(*call)
        if err:
            raise RuntimeError(f"eigh3x3 variant: launch error {err}")
        return w, V
    return go


def load_inputs(path: str, dev) -> list:
    import numpy as np

    data = np.load(path)
    keys = sorted(data.files, key=lambda k: int(k.rsplit("__", 1)[1]))
    return [torch.as_tensor(data[k], device=dev) for k in keys]


def record_inputs(chip_smoke) -> list:
    """Phase 20's normals inputs: the drift course with use_global_init on the card."""
    dscans, dgt = chip_smoke.drift_course()
    inputs: list = []
    with chip_smoke.recording_eigh3x3(inputs):
        chip_smoke.reset_counts()  # the counts now live on the recording wrapper
        chip_smoke.run_loop_course(chip_smoke.apply_cli_overrides(
            chip_smoke.PipelineConfig(), ["graph_slam.use_global_init=true"]),
            dscans, dgt, "cuda")
    return inputs


def bit_equal(got, want) -> bool:
    return all(torch.equal(x.reshape(-1).view(torch.int32), y.reshape(-1).view(torch.int32))
               for x, y in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default=None,
                    help="the normals' inputs as chip_smoke.py's phase 20 writes them")
    ap.add_argument("--parent", default=None, help="a tree whose eigh3x3 is timed too")
    ap.add_argument("--json", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    import numpy as np

    if not torch.cuda.is_available():
        print("torch_eigh3x3_split: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from lidar_graph_slam_tpu_torch.ops.voxel import _eigh3x3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    base = os.path.join(REPO, ".chip_scratch", "eigh3x3_split")
    shutil.rmtree(base, ignore_errors=True)
    pairs = [(s, t) for t in THREADS for s in STEPS]
    with ThreadPoolExecutor(len(pairs)) as pool:  # every variant's nvcc at once
        built = dict(zip(pairs, pool.map(lambda p: build(*p, base), pairs)))
    lines, libs = [], {}
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    for (s, t), (so, log) in built.items():
        lib = ctypes.CDLL(so)
        lib.lgs_eigh3x3.argtypes = [vp, i64, vp, vp, vp]
        lib.lgs_eigh3x3.restype = ctypes.c_int
        libs[s, t] = lib
        if s == 6:
            lines.append(dict(build=f"steps6_threads{t}",
                              ptxas=chip_smoke.ptxas_usage(log, "eigh3x3_kernel"),
                              sass=chip_smoke.sass_counts(chip_smoke.library_sass(so),
                                                          "eigh3x3_kernel"),
                              card=card))
            print(json.dumps(lines[-1]), flush=True)

    dev = torch.device("cuda")
    inputs = load_inputs(args.input, dev) if args.input else record_inputs(chip_smoke)
    if not inputs:
        raise AssertionError("torch_eigh3x3_split: no normals input")
    parent = chip_smoke.tree_kernels(args.parent) if args.parent else None
    routes_all = []
    for k, A in enumerate(inputs):
        want = _eigh3x3(A)
        w, V, routes = shortcut_eigh3x3(A)
        routes_all.append(routes)
        checks = {"model": (w, V)}
        checks.update({f"threads{t}": launcher(libs[6, t], A)() for t in THREADS})
        if parent is not None:
            checks["parent"] = parent.eigh3x3(A)
        torch.cuda.synchronize()
        for name, got in checks.items():
            if not bit_equal(got, want):
                raise AssertionError(f"torch_eigh3x3_split: input {k}: {name} is not "
                                     "bit-equal to _eigh3x3")
    if parent is not None:
        parent.load_library()
        lines.append(dict(build="parent", sass=chip_smoke.sass_counts(
            chip_smoke.library_sass(parent.build_info["path"]), "eigh3x3_kernel"),
            card=card))
        print(json.dumps(lines[-1]), flush=True)
    A = inputs[0]
    eye = torch.eye(3, dtype=A.dtype, device=dev)
    solved = (A != eye).any(dim=2).any(dim=1)
    lines.append(dict(routes_first=route_counts(routes_all[0]),
                      routes_all=route_counts(torch.cat(routes_all, dim=-1)),
                      inputs=len(inputs), rows=A.shape[0], solved_rows=int(solved.sum()),
                      solved_warps=int(torch.nn.functional.pad(
                          solved, (0, (-A.shape[0]) % WARP)).reshape(-1, WARP).any(1).sum()),
                      card=card))
    print(json.dumps(lines[-1]), flush=True)
    warp = A[solved][:WARP].contiguous()
    calls = {}
    for (s, t), lib in libs.items():
        calls[f"steps{s}_threads{t}"] = launcher(lib, A)
    for t in THREADS:
        calls[f"warp_full_threads{t}"] = launcher(libs[6, t], warp)
        calls[f"warp_floor_threads{t}"] = launcher(libs[-1, t], warp)
    if parent is not None:
        calls["parent"] = lambda: parent.eigh3x3(A)
        calls["parent_warp"] = lambda: parent.eigh3x3(warp)
    names = list(calls)
    runs = {n: [] for n in names}
    for r in range(ROUNDS):
        for n in (names if r % 2 == 0 else names[::-1]):
            runs[n].append(chip_smoke.split_times(calls[n], calls=100, warmup=5)["device_us"])
    torch.cuda.synchronize()
    med = {}
    for n, ts in runs.items():
        med[n] = float(np.median(ts))
        lines.append(dict(variant=n, device_us=med[n], rounds=[round(x, 3) for x in ts],
                          card=card))
        print(json.dumps(lines[-1]), flush=True)
    split = {}
    for t in THREADS:
        row = dict(full_us=med[f"steps6_threads{t}"], floor_us=med[f"steps-1_threads{t}"],
                   load_store_us=med[f"steps0_threads{t}"] - med[f"steps-1_threads{t}"],
                   **{f"sweep{k}_us": med[f"steps{k}_threads{t}"]
                      - med[f"steps{k - 1}_threads{t}"] for k in range(1, 7)},
                   one_warp_chain_us=med[f"warp_full_threads{t}"]
                   - med[f"warp_floor_threads{t}"])
        split[f"threads{t}"] = row
    if parent is not None:
        split["parent"] = dict(full_us=med["parent"], one_warp_us=med["parent_warp"])
    lines.append(dict(split=split, rows=A.shape[0], card=card))
    print(json.dumps(lines[-1]), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
