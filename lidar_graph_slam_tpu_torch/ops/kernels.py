"""NDT/GICP normal-equation accumulation — the registration hot loop's reduction.

Both wrappers port the TPU kernel `ndt_accumulate` of
`lidar_graph_slam_tpu/ops/pallas_kernels.py` (deleted in commit 4350000; live reference
`ndt_accumulate_xla`, same file) as hand-written CUDA kernels for Hopper in one source,
`csrc/ndt_accumulate.cu` (its header says what bounds them and how they are built for
that), compiled with nvcc at first use into `build/` and bound with ctypes:

* `ndt_direct7_accumulate(vmap, p, source_mask, d2, w_scale)`: one NDT iteration's
  reduction in one launch — the DIRECT7 gather of `ops/voxel.py:lookup_direct7`, the
  accumulation, and the centre-residual sums of NDT's fitness. `ndt_align` calls it.
* `ndt_direct7_accumulate_batched(vmaps, p, source_mask, d2, w_scale)`: the same
  reduction for B sequences in one launch, each against its own map (the maps' tensors
  stacked on a leading batch axis, `stack_maps`), one output row per sequence — the
  multi-sequence odometry's (`parallel/multi_sequence.py`). Row b equals
  `ndt_direct7_accumulate` on sequence b alone bit for bit (the same kernel, the same
  number of blocks per sequence).
* `ndt_accumulate(e, icovs, p, hit, d2, w_scale)`: the reference's interface over gathered
  rows, for NDT's line search (which needs the gathered means) and GICP.

Beside each, its plain PyTorch version: `ndt_accumulate_plain` is the port of
`ndt_accumulate_xla` with `point_jacobian_blocks` and `accumulate_normal_equations`
(`lidar_graph_slam_tpu/registration/base.py:38-64`); `ndt_direct7_accumulate_plain` is
`lookup_direct7` followed by it (`direct7_gathered`); `ndt_direct7_accumulate_batched_plain`
loops that over the batch. A wrapper takes its plain version
for CPU tensors only; on a CUDA tensor it launches its kernel or raises.

Launch counts: `<wrapper>.launches` counts a kernel's launches in the process (odometry
on the main thread and loop verification in its worker thread both launch), and
`thread_launches()` the calling thread's, so a caller can tell the two paths apart.
Scratch: a kernel's last block sums the per-block partials, through a partials buffer and
a ticket counter (one per sequence of a batch); there is one such pair per CUDA stream,
made at the stream's first launch (and grown for a larger batch), because the odometry
and the verification thread launch at once on two streams.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from lidar_graph_slam_tpu_torch.ops.voxel import (
    COORD_MAX,
    TABLE_DIMS,
    NdtVoxelMap,
    lookup_direct7,
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "ndt_accumulate.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_BLOCKS = 1024
_TABLE_SIZE = TABLE_DIMS[0] * TABLE_DIMS[1] * TABLE_DIMS[2]

_lib = None  # the loaded shared library (built at first use)
_lib_lock = threading.Lock()
build_info: dict = {}  # {"path", "seconds", "log"} of this process's build or load
_consts: dict = {}     # the library's threads per block, accumulators and outputs
_scratch: dict = {}    # (device index, stream handle) -> (partials f32, counters i32)
_count_lock = threading.Lock()
_thread_counts = threading.local()


def thread_launches() -> int:
    """Kernel launches (of both kernels) made by the calling thread since it started."""
    return getattr(_thread_counts, "launches", 0)


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1
    _thread_counts.launches = thread_launches() + 1


# -- plain versions ----------------------------------------------------------------------

def point_jacobian_blocks(p_transformed: torch.Tensor) -> torch.Tensor:
    """J = [ -hat(p), I ] (3x6) for residual e = (T p) - q under left perturbation."""
    n = p_transformed.shape[:-1]
    J = torch.zeros(n + (3, 6), dtype=p_transformed.dtype, device=p_transformed.device)
    x, y, z = p_transformed[..., 0], p_transformed[..., 1], p_transformed[..., 2]
    J[..., 0, 1] = z
    J[..., 0, 2] = -y
    J[..., 1, 0] = -z
    J[..., 1, 2] = x
    J[..., 2, 0] = y
    J[..., 2, 1] = -x
    J[..., 0, 3] = 1.0
    J[..., 1, 4] = 1.0
    J[..., 2, 5] = 1.0
    return J


def accumulate_normal_equations(J: torch.Tensor, W: torch.Tensor, e: torch.Tensor,
                                weight: torch.Tensor):
    """H = sum w J^T W J and g = sum w J^T W e over the leading axes.

    J: [..., 3, 6], W: [..., 3, 3], e: [..., 3], weight: [...].
    """
    WJ = torch.einsum("...ij,...jk->...ik", W, J)
    H = torch.einsum("...ji,...jk,...->ik", J, WJ, weight)
    g = torch.einsum("...ji,...jk,...k,...->i", J, W, e, weight)
    return H, g


def ndt_accumulate_plain(e, icovs, p, hit, d2, w_scale):
    """Plain PyTorch version: (H [6,6], g [6], sum_w, n_hit) — see `ndt_accumulate`."""
    md2 = torch.einsum("ki,kij,kj->k", e, icovs, e)
    w = torch.where(hit, w_scale * torch.exp(-0.5 * d2 * md2), 0.0)
    J = point_jacobian_blocks(p)
    H, g = accumulate_normal_equations(J, icovs, e, w)
    return H, g, torch.sum(w), torch.sum(hit.to(torch.float32))


def direct7_gathered(vmap, p, source_mask, d2, w_scale, accumulate):
    """One NDT iteration's reduction over gathered correspondences: `lookup_direct7`, the
    source mask, e = p - mean, then `accumulate` (`ndt_accumulate` or its plain version)
    over the N x 7 rows and the centre residuals' sums.

    Returns ((H, g, sum_w, n_hit, centre_d2_sum, centre_count), (means, icovs, valid)):
    the line search reuses the gathered rows."""
    means, icovs, hit = lookup_direct7(vmap, p)                  # [N, 7, ...]
    valid = hit & source_mask[:, None]
    e = p[:, None, :] - means                                    # [N, 7, 3]
    n = p.shape[0]
    K = n * 7
    p_rep = p[:, None, :].expand(n, 7, 3).reshape(K, 3)
    H, g, sum_w, n_hit = accumulate(e.reshape(K, 3), icovs.reshape(K, 3, 3).contiguous(),
                                    p_rep.contiguous(), valid.reshape(K), d2, w_scale)
    centre_valid = valid[:, 0]
    centre_d2 = torch.sum(torch.where(centre_valid, torch.sum(e[:, 0, :] ** 2, dim=-1), 0.0))
    centre_count = torch.sum(centre_valid.to(torch.float32))
    return (H, g, sum_w, n_hit, centre_d2, centre_count), (means, icovs, valid)


def ndt_direct7_accumulate_plain(vmap, p, source_mask, d2, w_scale):
    """Plain PyTorch version of `ndt_direct7_accumulate`."""
    return direct7_gathered(vmap, p, source_mask, d2, w_scale, ndt_accumulate_plain)[0]


_MAP_FIELDS = ("keys", "means", "inv_covs", "valid", "origin", "leaf", "num_voxels", "table",
               "packed")


def stack_maps(vmaps) -> NdtVoxelMap:
    """B voxel maps of one capacity as one `NdtVoxelMap` whose tensors carry a leading
    batch axis (`inv_leaf` [B] included) — the batched kernel's map argument."""
    return NdtVoxelMap(**{f: torch.stack([getattr(v, f) for v in vmaps]) for f in _MAP_FIELDS})


def map_at(vmaps: NdtVoxelMap, b: int) -> NdtVoxelMap:
    """Sequence b's map of a `stack_maps` batch."""
    return NdtVoxelMap(**{f: getattr(vmaps, f)[b] for f in _MAP_FIELDS})


def _scalar_at(x, b: int):
    return x[b] if isinstance(x, torch.Tensor) and x.dim() == 1 else x


def ndt_direct7_accumulate_batched_plain(vmaps, p, source_mask, d2, w_scale):
    """Plain PyTorch version of `ndt_direct7_accumulate_batched`: the plain
    single-sequence version on each sequence, stacked."""
    rows = [ndt_direct7_accumulate_plain(map_at(vmaps, b), p[b], source_mask[b],
                                         _scalar_at(d2, b), _scalar_at(w_scale, b))
            for b in range(p.shape[0])]
    return tuple(torch.stack(x) for x in zip(*rows))


# -- the library -------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "csrc/ndt_accumulate.cu")


def load_library():
    """Build (once per source version) and load the kernel library; returns it.

    The library is named by a hash of the source, so an edited source is rebuilt and a
    stale build is never loaded. `build_info` records the path, the build seconds (0.0
    when an existing build was loaded) and the compiler's output.
    """
    if _lib is not None:
        return _lib
    with _lib_lock:
        return _load_library_locked()


def _load_library_locked():
    global _lib
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libndt_accumulate-{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    vp, f32, i32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    lib.lgs_ndt_accumulate.argtypes = [vp, vp, vp, vp, vp, f32, vp, f32, i64, vp, vp, i32,
                                       vp, vp]
    lib.lgs_ndt_direct7_accumulate.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                               i32, i32, vp, f32, vp, f32, i64, vp, vp, i32,
                                               vp, vp]
    lib.lgs_ndt_direct7_accumulate_batched.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i64, i32, vp, f32, vp, f32, i64,
        i32, vp, vp, i32, vp, vp]
    for fn in (lib.lgs_ndt_accumulate, lib.lgs_ndt_direct7_accumulate,
               lib.lgs_ndt_direct7_accumulate_batched):
        fn.restype = ctypes.c_int
    for name in ("threads", "quantities", "outputs"):
        fn = getattr(lib, f"lgs_ndt_{name}")
        fn.argtypes, fn.restype = [], ctypes.c_int
        _consts[name] = fn()
    lib.lgs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lgs_cuda_error_string.restype = ctypes.c_char_p
    build_info.update(path=so_path, seconds=seconds, log=log)
    _lib = lib
    return lib


# -- wrappers ----------------------------------------------------------------------------

def _check(wrapper: str, device, **tensors) -> None:
    """Each keyword is (tensor, shape, dtype): on `device`, of that shape and dtype, and
    contiguous; raises ValueError otherwise."""
    for name, (t, shape, dtype) in tensors.items():
        if t.device != device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{wrapper}: {name} must be {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{wrapper}: {name} must be contiguous")


def _scalar_arg(x, device):
    """(device pointer, host value) for a scalar given as a 0-d f32 tensor or a number."""
    if isinstance(x, torch.Tensor):
        if x.device != device or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"scalar tensor must be one float32 on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x.data_ptr(), 0.0
    return None, float(x)


def _launch_args(device, rows: int, batch: int | None = None):
    """(stream handle, partials pointer, counters pointer, blocks, fresh output) for one
    launch over `rows` work items (per sequence of `batch`, whose output then has a
    leading batch axis) on the current stream of `device`. The block count depends on
    `rows` only, so a sequence of a batch is reduced in the same order as alone."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    scratch = _scratch.get(key)
    need = batch or 1
    if scratch is None or scratch[1].numel() < need:
        with _lib_lock:
            scratch = _scratch.get(key)
            if scratch is None or scratch[1].numel() < need:
                # Zeroed on this stream, before its first launch that uses them; a smaller
                # pair it replaces is freed in this stream's order.
                scratch = _scratch[key] = (
                    torch.empty(_consts["quantities"] * _MAX_BLOCKS * need,
                                dtype=torch.float32, device=device),
                    torch.zeros(need, dtype=torch.int32, device=device))
    threads = _consts["threads"]
    nblocks = min(max(-(-rows // threads), 1), _MAX_BLOCKS)
    shape = (_consts["outputs"],) if batch is None else (batch, _consts["outputs"])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return stream, scratch[0].data_ptr(), scratch[1].data_ptr(), nblocks, out


def _raise_on(err: int, wrapper: str) -> None:
    if err != 0:
        raise RuntimeError(f"{wrapper} launch failed: "
                           f"{_lib.lgs_cuda_error_string(err).decode()} ({err})")


def ndt_accumulate(e, icovs, p, hit, d2, w_scale):
    """Weighted 6x6 normal-equation accumulation over gathered correspondences.

    e:     [K, 3] f32 residuals (p - mean) per correspondence
    icovs: [K, 3, 3] f32
    p:     [K, 3] f32 transformed points (Jacobian anchor)
    hit:   [K] bool
    d2, w_scale: 0-d f32 tensors on the same device, or numbers.
    Returns (H [6,6], g [6], sum_w, n_hit), all f32 on the inputs' device.

    CPU tensors take `ndt_accumulate_plain`; CUDA tensors launch the kernel (counted in
    `ndt_accumulate.launches`) or raise.
    """
    if e.device.type == "cpu":
        return ndt_accumulate_plain(e, icovs, p, hit, d2, w_scale)
    if e.device.type != "cuda":
        raise ValueError(f"ndt_accumulate: unsupported device {e.device}")
    K = e.shape[0]
    _check("ndt_accumulate", e.device, e=(e, (K, 3), torch.float32),
           icovs=(icovs, (K, 3, 3), torch.float32), p=(p, (K, 3), torch.float32),
           hit=(hit, (K,), torch.bool))
    d2_ptr, d2_val = _scalar_arg(d2, e.device)
    ws_ptr, ws_val = _scalar_arg(w_scale, e.device)
    lib = load_library()
    stream, partials, counter, nblocks, out = _launch_args(e.device, K)
    _raise_on(lib.lgs_ndt_accumulate(
        e.data_ptr(), icovs.data_ptr(), p.data_ptr(), hit.data_ptr(), d2_ptr, d2_val,
        ws_ptr, ws_val, K, partials, counter, nblocks, out.data_ptr(), stream),
        "ndt_accumulate")
    _count(ndt_accumulate)
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


def ndt_direct7_accumulate(vmap, p, source_mask, d2, w_scale):
    """One NDT iteration's reduction against a voxel map, gather included.

    vmap:        `ops.voxel.NdtVoxelMap` (its dense table, packed rows, origin and
                 `inv_leaf`, the float32 `lookup_direct7` uses)
    p:           [N, 3] f32 transformed source points
    source_mask: [N] bool
    d2, w_scale: 0-d f32 tensors on the same device, or numbers
    Returns (H [6,6], g [6], sum_w, n_hit, centre_d2_sum, centre_count), f32 on the
    device: the accumulation over the N x 7 DIRECT7 correspondences (hit = neighbour
    cell in the table, occupied, valid voxel, source row masked in) and, over the hits
    at offset 0, the sum of |p - mean|^2 and their count (NDT's fitness is their ratio).

    CPU tensors take `ndt_direct7_accumulate_plain`; CUDA tensors launch the kernel
    (counted in `ndt_direct7_accumulate.launches`) or raise.
    """
    if p.device.type == "cpu":
        return ndt_direct7_accumulate_plain(vmap, p, source_mask, d2, w_scale)
    if p.device.type != "cuda":
        raise ValueError(f"ndt_direct7_accumulate: unsupported device {p.device}")
    dev, n = p.device, p.shape[0]
    _check("ndt_direct7_accumulate", dev, p=(p, (n, 3), torch.float32),
           source_mask=(source_mask, (n,), torch.bool),
           table=(vmap.table, (_TABLE_SIZE,), torch.int32),
           packed=(vmap.packed, (vmap.packed.shape[0], 16), torch.float32),
           origin=(vmap.origin, (3,), torch.float32),
           inv_leaf=(vmap.inv_leaf, (), torch.float32))
    if vmap.packed.data_ptr() % 16:
        raise ValueError("ndt_direct7_accumulate: packed rows must be 16-byte aligned")
    d2_ptr, d2_val = _scalar_arg(d2, dev)
    ws_ptr, ws_val = _scalar_arg(w_scale, dev)
    lib = load_library()
    stream, partials, counter, nblocks, out = _launch_args(dev, 7 * n)
    _raise_on(lib.lgs_ndt_direct7_accumulate(
        p.data_ptr(), source_mask.data_ptr(), vmap.table.data_ptr(), vmap.packed.data_ptr(),
        vmap.origin.data_ptr(), vmap.inv_leaf.data_ptr(), *TABLE_DIMS, *COORD_MAX, d2_ptr, d2_val, ws_ptr,
        ws_val, n, partials, counter, nblocks, out.data_ptr(), stream),
        "ndt_direct7_accumulate")
    _count(ndt_direct7_accumulate)
    return out[:36].view(6, 6), out[36:42], out[42], out[43], out[44], out[45]


def _batched_scalar_arg(x, device, batch: int):
    """(device pointer, host value, one value per sequence) for d2 / w_scale of the batched
    kernel: a number, a 0-d f32 tensor, or a [batch] f32 tensor."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        _check("ndt_direct7_accumulate_batched", device, scalars=(x, (batch,), torch.float32))
        return x.data_ptr(), 0.0, 1
    ptr, val = _scalar_arg(x, device)
    return ptr, val, 0


def ndt_direct7_accumulate_batched(vmaps, p, source_mask, d2, w_scale):
    """`ndt_direct7_accumulate` for B sequences in one launch.

    vmaps:       B maps of one capacity C stacked by `stack_maps` (table [B, 4,194,304]
                 i32, packed [B, C, 16] f32, origin [B, 3] f32, inv_leaf [B] f32)
    p:           [B, N, 3] f32 transformed source points
    source_mask: [B, N] bool
    d2, w_scale: numbers, 0-d f32 tensors, or [B] f32 tensors (one per sequence)
    Returns (H [B,6,6], g [B,6], sum_w [B], n_hit [B], centre_d2_sum [B], centre_count
    [B]), f32 on the device: row b is `ndt_direct7_accumulate(map b, p[b], mask[b], ...)`,
    bit for bit on the card.

    CPU tensors take `ndt_direct7_accumulate_batched_plain`; CUDA tensors launch the kernel
    (counted in `ndt_direct7_accumulate_batched.launches`) or raise.
    """
    if p.device.type == "cpu":
        return ndt_direct7_accumulate_batched_plain(vmaps, p, source_mask, d2, w_scale)
    if p.device.type != "cuda":
        raise ValueError(f"ndt_direct7_accumulate_batched: unsupported device {p.device}")
    dev, (B, n) = p.device, p.shape[:2]
    C = vmaps.packed.shape[1]
    _check("ndt_direct7_accumulate_batched", dev, p=(p, (B, n, 3), torch.float32),
           source_mask=(source_mask, (B, n), torch.bool),
           table=(vmaps.table, (B, _TABLE_SIZE), torch.int32),
           packed=(vmaps.packed, (B, C, 16), torch.float32),
           origin=(vmaps.origin, (B, 3), torch.float32),
           inv_leaf=(vmaps.inv_leaf, (B,), torch.float32))
    if vmaps.packed.data_ptr() % 16:
        raise ValueError("ndt_direct7_accumulate_batched: packed rows must be 16-byte aligned")
    d2_ptr, d2_val, per_seq = _batched_scalar_arg(d2, dev, B)
    ws_ptr, ws_val, per_seq_ws = _batched_scalar_arg(w_scale, dev, B)
    if d2_ptr is not None and ws_ptr is not None and per_seq != per_seq_ws:
        raise ValueError("ndt_direct7_accumulate_batched: d2 and w_scale must both be "
                         "per-sequence tensors or both shared")
    lib = load_library()
    stream, partials, counters, nblocks, out = _launch_args(dev, 7 * n, B)
    _raise_on(lib.lgs_ndt_direct7_accumulate_batched(
        p.data_ptr(), source_mask.data_ptr(), vmaps.table.data_ptr(), vmaps.packed.data_ptr(),
        vmaps.origin.data_ptr(), vmaps.inv_leaf.data_ptr(), *TABLE_DIMS, *COORD_MAX, C, B,
        d2_ptr, d2_val, ws_ptr, ws_val, n, max(per_seq, per_seq_ws), partials, counters,
        nblocks, out.data_ptr(), stream),
        "ndt_direct7_accumulate_batched")
    _count(ndt_direct7_accumulate_batched)
    return (out[:, :36].view(B, 6, 6), out[:, 36:42], out[:, 42], out[:, 43], out[:, 44],
            out[:, 45])


ndt_accumulate.launches = 0
ndt_direct7_accumulate.launches = 0
ndt_direct7_accumulate_batched.launches = 0
