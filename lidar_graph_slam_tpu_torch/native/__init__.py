"""ctypes bindings for the native host-IO library (`lgs_io.cpp`), built on demand.

Port of `lidar_graph_slam_tpu/native/__init__.py`, with the package's own copy of the C++
source. The library is host code: `g++` builds it at first use from the source in this
directory into the package's `build/` directory (never next to the source), named by a
hash of the source and the flags, so an edited source is rebuilt and a stale build is
never loaded. Without a C++ toolchain the wrappers fall back to numpy; `available()` says
which one runs, and a caller that must not run the fallback asserts it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_HERE, "lgs_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
# No -march=native: the build directory may travel with the tree to another machine.
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_build_lock = threading.Lock()
_build_failed = False
build_info: dict = {}  # {"path", "built"} of this process's build or load


def _so_path() -> str:
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"liblgs_io-{digest}.so")


def _build(so_path: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC_PATH, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _open(so_path: str):
    try:
        return ctypes.CDLL(so_path)
    except OSError:
        return None


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = _so_path()
        built = False
        lib = _open(so_path) if os.path.exists(so_path) else None
        if lib is None:
            # Not built yet, or built where it cannot be loaded here: build it here.
            built = _build(so_path)
            lib = _open(so_path) if built else None
        if lib is None:
            _build_failed = True
            return None
        f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        lib.lgs_read_bin.restype = i64
        lib.lgs_read_bin.argtypes = [ctypes.c_char_p, f32p, i64]
        lib.lgs_voxel_downsample.restype = i64
        lib.lgs_voxel_downsample.argtypes = [f32p, i64, ctypes.c_float, f32p, i64]
        lib.lgs_prefetcher_create.restype = ctypes.c_void_p
        lib.lgs_prefetcher_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, i64, i64]
        lib.lgs_prefetcher_next.restype = i64
        lib.lgs_prefetcher_next.argtypes = [ctypes.c_void_p, f32p, ctypes.POINTER(i64)]
        lib.lgs_prefetcher_destroy.restype = None
        lib.lgs_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        build_info.update(path=so_path, built=built)
        _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loaded (False: the numpy fallback runs)."""
    return _load() is not None


PAD_VALUE = 1.0e6


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_bin(path: str, capacity: int) -> tuple[np.ndarray, int]:
    """Read a KITTI .bin into a padded [capacity, 3] buffer. Returns (points, n_valid)."""
    lib = _load()
    if lib is not None:
        out = np.empty((capacity, 3), dtype=np.float32)
        n = lib.lgs_read_bin(path.encode(), _f32p(out), capacity)
        if n >= 0:
            return out, int(n)
    data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:capacity, :3]
    out = np.full((capacity, 3), PAD_VALUE, dtype=np.float32)
    out[: data.shape[0]] = data
    return out, data.shape[0]


def voxel_downsample_host(points: np.ndarray, leaf: float,
                          out_capacity: int | None = None) -> np.ndarray:
    """Exact host-side voxel-centroid downsample (for huge map exports)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    cap = out_capacity or points.shape[0]
    lib = _load()
    if lib is not None and points.shape[0] > 0:
        out = np.empty((cap, 3), dtype=np.float32)
        n = lib.lgs_voxel_downsample(_f32p(points), points.shape[0], leaf, _f32p(out), cap)
        return out[:n].copy()
    # numpy fallback
    if points.shape[0] == 0:
        return points
    coords = np.floor((points - points.min(0)) / leaf).astype(np.int64)
    key = (coords[:, 0] << 42) | (coords[:, 1] << 21) | coords[:, 2]
    order = np.argsort(key)
    key_s, pts_s = key[order], points[order]
    first = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    seg = np.cumsum(first) - 1
    sums = np.zeros((seg[-1] + 1, 3), np.float64)
    np.add.at(sums, seg, pts_s)
    counts = np.bincount(seg)
    return (sums / counts[:, None]).astype(np.float32)[:cap]


class ScanPrefetcher:
    """Background native read-ahead over scan files; iterate to get (points, n) tuples.

    The host decode of scan t+1 overlaps the device compute of scan t."""

    def __init__(self, paths: list, capacity: int, depth: int = 4):
        self.capacity = capacity
        self.paths = list(paths)
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._handle = self._lib.lgs_prefetcher_create(arr, len(self.paths), capacity, depth)
            self._keepalive = arr

    def __iter__(self):
        if self._handle is None:
            for p in self.paths:  # pure-python fallback, no read-ahead
                yield read_bin(p, self.capacity)
            return
        while True:
            out = np.empty((self.capacity, 3), dtype=np.float32)
            n = ctypes.c_int64(0)
            idx = self._lib.lgs_prefetcher_next(self._handle, _f32p(out), ctypes.byref(n))
            if idx == -2:
                return
            if int(n.value) < 0:
                # The C reader returns n=-1 when fopen/fread fails; yielding it would
                # slice `out[:-1]` — a capacity-1 block of UNINITIALIZED memory fed to
                # the pipeline as a real scan. Match the non-prefetch path, which raises
                # on unreadable files.
                raise IOError(
                    f"native prefetcher failed to read scan {int(idx)} "
                    f"({self.paths[int(idx)] if 0 <= int(idx) < len(self.paths) else '?'})")
            yield out, int(n.value)

    def close(self):
        if self._handle is not None:
            self._lib.lgs_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
