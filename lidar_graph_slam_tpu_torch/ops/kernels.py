"""NDT/GICP normal-equation accumulation — the registration hot loop's reduction.

`ndt_accumulate` is the port of the TPU kernel `ndt_accumulate` of
`lidar_graph_slam_tpu/ops/pallas_kernels.py` (deleted in commit 4350000; live reference
`ndt_accumulate_xla`, same file): a hand-written CUDA kernel for Hopper
(`csrc/ndt_accumulate.cu`, its header says what bounds it and how it is built for that),
compiled with nvcc at first use into `build/` and bound with ctypes.

Beside it, `ndt_accumulate_plain` is the plain PyTorch version — the port of
`ndt_accumulate_xla` with `point_jacobian_blocks` and `accumulate_normal_equations`
(`lidar_graph_slam_tpu/registration/base.py:38-64`). The wrapper takes it for CPU tensors
only; on a CUDA tensor it launches the kernel or raises.

Launch counts: `ndt_accumulate.launches` counts every launch in the process (odometry on
the main thread and loop verification in its worker thread both launch the kernel), and
`thread_launches()` counts the calling thread's, so a caller can tell the two paths apart.
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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "ndt_accumulate.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_BLOCKS = 1024

_lib = None  # the loaded shared library (built at first use)
_lib_lock = threading.Lock()
build_info: dict = {}  # {"path", "seconds", "log"} of this process's build or load
_count_lock = threading.Lock()
_thread_counts = threading.local()


def thread_launches() -> int:
    """Kernel launches made by the calling thread since it started."""
    return getattr(_thread_counts, "launches", 0)


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
    vp = ctypes.c_void_p
    lib.lgs_ndt_accumulate.argtypes = [vp, vp, vp, vp, vp, ctypes.c_float, vp, ctypes.c_float,
                                       ctypes.c_longlong, vp, ctypes.c_int, vp, vp]
    lib.lgs_ndt_accumulate.restype = ctypes.c_int
    lib.lgs_ndt_threads.argtypes = []
    lib.lgs_ndt_threads.restype = ctypes.c_int
    lib.lgs_ndt_quantities.argtypes = []
    lib.lgs_ndt_quantities.restype = ctypes.c_int
    lib.lgs_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lgs_cuda_error_string.restype = ctypes.c_char_p
    build_info.update(path=so_path, seconds=seconds, log=log)
    _lib = lib
    return lib


def _scalar_arg(x, device):
    """(device pointer, host value) for a scalar given as a 0-d f32 tensor or a number."""
    if isinstance(x, torch.Tensor):
        if x.device != device or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"scalar tensor must be one float32 on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x.data_ptr(), 0.0
    return None, float(x)


def ndt_accumulate(e, icovs, p, hit, d2, w_scale):
    """Weighted 6x6 normal-equation accumulation over correspondences.

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
    expect = {"e": (e, (K, 3), torch.float32), "icovs": (icovs, (K, 3, 3), torch.float32),
              "p": (p, (K, 3), torch.float32), "hit": (hit, (K,), torch.bool)}
    for name, (t, shape, dtype) in expect.items():
        if t.device != e.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"ndt_accumulate: {name} must be {dtype} {shape} on {e.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ndt_accumulate: {name} must be contiguous")
    d2_ptr, d2_val = _scalar_arg(d2, e.device)
    ws_ptr, ws_val = _scalar_arg(w_scale, e.device)

    lib = load_library()
    threads = lib.lgs_ndt_threads()
    nblocks = min(max(-(-K // threads), 1), _MAX_BLOCKS)
    partials = torch.empty(lib.lgs_ndt_quantities() * nblocks, dtype=torch.float32,
                           device=e.device)
    out = torch.empty(44, dtype=torch.float32, device=e.device)
    stream = torch.cuda.current_stream(e.device).cuda_stream
    err = lib.lgs_ndt_accumulate(
        e.data_ptr(), icovs.data_ptr(), p.data_ptr(), hit.data_ptr(), d2_ptr, d2_val,
        ws_ptr, ws_val, K, partials.data_ptr(), nblocks, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ndt_accumulate launch failed: "
                           f"{lib.lgs_cuda_error_string(err).decode()} ({err})")
    with _count_lock:
        ndt_accumulate.launches += 1
    _thread_counts.launches = thread_launches() + 1
    return out[:36].view(6, 6), out[36:42], out[42], out[43]


ndt_accumulate.launches = 0
