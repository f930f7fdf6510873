"""NDT/GICP normal-equation accumulation, the whole NDT, GICP and ICP loops, the ICP loop
gate's fitness, and the NDT target's voxel finalize with its 3x3 eigensolve.

The wrappers port the TPU kernel `ndt_accumulate` of
`lidar_graph_slam_tpu/ops/pallas_kernels.py` (deleted in commit 4350000; live reference
`ndt_accumulate_xla`, same file), the `lax.while_loop`s around it
(`lidar_graph_slam_tpu/registration/ndt.py:81-147`, `registration/gicp.py:146-191`), ICP's
(`registration/icp.py:47-122`) and its fitness (`:155-188`), the voxel finalize of the
jitted target build (`lidar_graph_slam_tpu/ops/voxel.py:182-339`), the centroid sums
and the outlier filter's window statistics of the jitted prefilter
(`lidar_graph_slam_tpu/filters/prefilter.py:94-117`) and its passes around the two sorts
(the keys with the distance filter, the sorted runs, the SOR threshold, the compaction;
`:88-119`), GICP's jitted covariances
(`lidar_graph_slam_tpu/registration/gicp.py:61-90`) and the jitted hash grid build with
its dense table (`lidar_graph_slam_tpu/ops/neighbors.py:68-100`, `ops/voxel.py:60-76`)
as hand-written CUDA kernels for Hopper in nine sources (`csrc/ndt_accumulate.cu`,
`csrc/ndt_loop.cu`, `csrc/gicp_loop.cu`, `csrc/icp_loop.cu`, `csrc/voxel_finalize.cu`,
`csrc/prefilter.cu`, `csrc/covariances.cu`, `csrc/grid.cu`, `csrc/prefilter_pass.cu`; the
headers
`csrc/ndt_common.cuh`, `csrc/loop_common.cuh`, `csrc/nn_stage.cuh` (the grid-NN query)
and `csrc/eigh3x3.cuh` hold what they share; each source's header says what bounds its
kernels), compiled with nvcc (one process a source, all at once) into one library at
first use in `build/` and bound with ctypes:

* `ndt_align_loop(vmap, source_points, source_mask, T0, d2, w_scale, step_size,
  transform_epsilon, damping, max_iterations, polish_iterations)`: the NDT loop of
  `ndt_align` (line search off) — one C call enqueues `max_iterations` launches of the
  `ndt_iteration` kernel (transform, DIRECT7 gather, accumulation and the 6x6 step in one
  launch, the carry in device memory; a launch that finds the carry done exits at once),
  then the polish launches. Nothing is read back.
* `ndt_align_loop_batched(...)`: the same for B sequences, one launch of
  `ndt_iteration_batched` an iteration (`parallel/multi_sequence.py`); row b equals the
  single loop on sequence b bit for bit on the card.
* `gicp_align_loop(target, source_points, source_mask, source_covs, T0, corr2,
  transform_epsilon, damping, max_iterations, bucket_cap, neighborhood, source_grid)`: the
  GICP loop of `registration/gicp.py:gicp_align` — one C call enqueues `max_iterations`
  launches of the `gicp_iteration` kernel (transform, the grid-NN match, with the
  reciprocal test when `source_grid` is given, the plane-to-plane rows, accumulation and
  the 6x6 step in one launch; a launch that finds the carry done exits at once). Nothing
  is read back.
* `icp_align_loop(grid, source_points, source_mask, T0, corr2, transform_epsilon,
  euclidean_fitness_epsilon, max_iterations, bucket_cap, neighborhood)`: the ICP loop of
  `registration/icp.py:icp_align` — one C call enqueues `max_iterations` launches of the
  `icp_iteration` kernel (transform, the grid-NN match, the sums about an anchor, and the
  closed-form step with its 3x3 SVD and stop test in the last block's warp 0). Nothing is
  read back.
* `icp_fitness(grid, points, mask, transform, max_range, bucket_cap, neighborhood, mode)`:
  `fitness_and_match_fraction`'s score and matched fraction in one launch (a programmatic
  dependent of the launch before it).
* `ndt_direct7_accumulate(vmap, p, source_mask, d2, w_scale)`: one NDT iteration's
  reduction in one launch — the DIRECT7 gather of `ops/voxel.py:lookup_direct7`, the
  accumulation, and the centre-residual sums of NDT's fitness. The loop kernel runs the
  same gather and reduction; this entry point stays for measurement against it.
* `ndt_direct7_accumulate_batched(vmaps, p, source_mask, d2, w_scale)`: the same
  reduction for B sequences in one launch, each against its own map (the maps' tensors
  stacked on a leading batch axis, `stack_maps`), one output row per sequence. Row b
  equals `ndt_direct7_accumulate` on sequence b alone bit for bit (the same kernel, the
  same number of blocks per sequence).
* `ndt_accumulate(e, icovs, p, hit, d2, w_scale)`: the reference's interface over gathered
  rows, for NDT's line search (which needs the gathered means).
* `ndt_finalize(runs, origin, resolution, min_points, points=..., merge=...)`: one level
  of an NDT map from its rows sorted by voxel key in one launch — each voxel's run summed
  in order (the fine level's points, or a coarse level's shifted fine moments), then the
  sample covariance, the Jacobi eigensolve, the floored inverse and the packed row; what
  `ops/voxel.py:build_ndt_map` and `build_ndt_pyramid` build every target from.
* `eigh3x3(A)`: the batched symmetric 3x3 eigensolve in one launch, for the FPFH
  normals.
* `voxel_centroids(keys_sorted, pts_sorted, starts, lengths, origin, leaf)`: the
  centroid of each voxel from the rows sorted by voxel key in one launch, for every
  `ops/voxel.py:voxel_downsample` (the prefilter, the loop verifier's input, the map
  export, the FPFH keypoints).
* `sor_window_stats(keys, points, order, k)`: the outlier filter's per-row mean
  distance to its k nearest same-cell rows within +-`SOR_WINDOW` sorted rows and their
  count, in the original row order, in one launch.
* `gicp_covariances(keys, points, order, mask)`: GICP's covariances
  (`registration/gicp.py:estimate_covariances`, `build_gicp_target`) in one launch: each
  sorted row's same-cell window over +-16 sorted rows, the identity below 5 points, the
  eigensolve, the (1e-3, 1, 1) plane regularization and the scatter to the original rows.
* `dense_table(keys, row_valid, dims)`: a dense cell table (each cell's smallest valid
  row, -1 where none) in one clear and one launch, for every `ops/voxel.py:
  build_dense_table` (each NDT map level, the RANSAC occupancy table).
* `grid_rows(keys_sorted, points_sorted)`: the rest of `ops/neighbors.py:build_hash_grid`
  after the sort by cell in one clear and one launch: each row's run start, the packed
  rows and the table of the runs' first valid rows.
* `cell_keys(points, mask, leaf, bounds)`: every sort by key's keys in two launches (the
  valid rows' minimum corner, then the clamped packed keys; the second a programmatic
  dependent of the first), with `bounds` after the prefilter's distance filter, crop and
  pad.
* `sorted_runs(keys_sorted, order, points, capacity)`: what follows the sort in two
  launches likewise (the gather and each block's record, then the runs' starts, lengths
  and count), or the gather and pad alone in one.
* `sor_threshold(mean_d, n_found, mask, points, stddev_mult)`: the outlier filter's mean,
  deviation, mask and pad in three launches, summed in a fixed order.
* `compact_rows(points, mask, capacity)`: the stable compaction in two launches (each
  block's count, then the scan and scatter).

Beside each, its plain PyTorch version: `ndt_accumulate_plain` is the port of
`ndt_accumulate_xla` with `point_jacobian_blocks` and `accumulate_normal_equations`
(`lidar_graph_slam_tpu/registration/base.py:38-64`); `ndt_direct7_accumulate_plain` is
`lookup_direct7` followed by it (`direct7_gathered`); `ndt_align_loop_plain` is the
reference's body (`ndt_direct7_accumulate_plain`, then `ndt_step_plain`) with the carry
frozen after `done`; `gicp_align_loop_plain` is GICP's body (`gicp_sums_plain`: `nearest`,
`gicp_match`, `gicp_residual_rows` and `ndt_accumulate_plain`; then `gicp_step_plain`), the
same way; `icp_align_loop_plain` is ICP's body (`icp_match`, `umeyama_step`, the
guarded update and the stop test, `icp_body_plain`) and `icp_fitness_plain`
`fitness_and_match_fraction`'s; the batched plain versions loop the single ones over the
batch;
`ops/voxel.py:ndt_finalize_plain` (the sorted rows' run sums by `torch.segment_reduce`,
then `_finalize_ndt_plain`) and `_eigh3x3` are the finalize's and the eigensolve's,
`ops/voxel.py:voxel_centroids_plain` and `ops/neighbors.py:sor_window_stats_plain` the
prefilter kernels', `ops/neighbors.py:gicp_covariances_plain` (`window_covariances` of
the sorted rows, then `plane_covariances_plain`) the covariance kernel's,
`ops/voxel.py:build_dense_table_plain` (the reference's scatter-min) and
`ops/neighbors.py:grid_rows_plain` (its running max of the first-of-run rows) the grid
kernels', `ops/voxel.py:cell_keys_plain` and `sorted_runs_plain`,
`ops/neighbors.py:sor_threshold_plain` (its sums in the kernel's order) and
`core/pointcloud.py:compact_rows_plain` (a stable argsort) the prefilter passes', all bit
for bit on the card. A
wrapper takes its plain version for CPU tensors only; on a CUDA tensor it launches
its kernel or raises.

Launch counts: `<wrapper>.launches` counts a kernel's launches in the process (odometry
on the main thread and loop verification in its worker thread both launch), and
`thread_launches()` the calling thread's, so a caller can tell the two paths apart. A loop
wrapper counts every launch it enqueues; `worked_launches()` reads how many of them did
work (a device counter per loop kernel, read with a device-wide synchronize: for
measurement only). A CUDA graph capture launches nothing: inside `recorded_launches()`
the calling thread's wrapper calls are tallied and not counted, and `count_launches(tally)`
counts the tally once for each replay of the graph (`utils/capture.py`).
Scratch: a kernel's last block sums the per-block partials, through a partials buffer and
a ticket counter (one per sequence of a batch); there is one such pair per CUDA stream,
made at the stream's first launch (and grown for a larger batch), because the odometry
and the verification thread launch at once on two streams. The accumulate kernels take
one block per 256 work items (at most 1,024); the loop kernels a persistent grid of one
block per tile of 128 points, at most what the card holds at once (`loop_blocks`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.pointcloud import compact_rows_plain
from lidar_graph_slam_tpu_torch.ops.neighbors import (
    SOR_SUM_ROWS,
    SOR_WINDOW,
    gicp_covariances_plain,
    grid_rows_plain,
    nearest,
    sor_threshold_plain,
    sor_window_stats_plain,
)
from lidar_graph_slam_tpu_torch.ops.voxel import (
    _BITS_Y,
    _BITS_Z,
    COORD_MAX,
    TABLE_DIMS,
    NdtVoxelMap,
    _eigh3x3,
    build_dense_table_plain,
    cell_keys_plain,
    lookup_direct7,
    ndt_finalize_plain,
    sorted_runs_plain,
    voxel_centroids_plain,
)
from lidar_graph_slam_tpu_torch.registration.base import cap_step, norm, solve_damped

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
# Built together into one library; the headers are part of the digest too.
_SOURCES = [os.path.join(_CSRC, f) for f in ("ndt_accumulate.cu", "ndt_loop.cu",
                                              "gicp_loop.cu", "icp_loop.cu",
                                              "voxel_finalize.cu", "prefilter.cu",
                                              "covariances.cu", "grid.cu",
                                              "prefilter_pass.cu")]
_HEADERS = [os.path.join(_CSRC, f) for f in ("ndt_common.cuh", "loop_common.cuh",
                                              "nn_stage.cuh", "eigh3x3.cuh")]
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
# Each source compiled to an object by its own nvcc, all at once; then one link.
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_BLOCKS = 1024
_TABLE_SIZE = TABLE_DIMS[0] * TABLE_DIMS[1] * TABLE_DIMS[2]

_lib = None  # the loaded shared library (built at first use)
_lib_lock = threading.Lock()
build_info: dict = {}  # {"path", "seconds", "log"} of this process's build or load
_consts: dict = {}     # the library's threads per block, accumulators, outputs, loop tile
                       # and loop partial row
_scratch: dict = {}    # (device index, stream handle) -> (partials f32, counters i32)
_occupancy: dict = {}  # (device index, kernel, variant) -> (SMs, a loop kernel's resident
                       # blocks per SM)
_count_lock = threading.Lock()
_thread_counts = threading.local()


def thread_launches() -> int:
    """Kernel launches (of every kernel) made by the calling thread since it started."""
    return getattr(_thread_counts, "launches", 0)


def _count(wrapper, n: int = 1) -> None:
    tally = getattr(_thread_counts, "tally", None)
    if tally is not None:  # a capture: the launches run at each replay, not now
        tally[wrapper] = tally.get(wrapper, 0) + n
        return
    with _count_lock:
        wrapper.launches += n
    _thread_counts.launches = thread_launches() + n


@contextlib.contextmanager
def recorded_launches():
    """Inside, the calling thread's kernel launches are tallied into the yielded dict
    (wrapper -> launches) and not counted: a stream capture enqueues nothing. Pass the
    tally to `count_launches` at each replay of what was captured."""
    if getattr(_thread_counts, "tally", None) is not None:
        raise RuntimeError("recorded_launches: already recording on this thread")
    tally: dict = {}
    _thread_counts.tally = tally
    try:
        yield tally
    finally:
        _thread_counts.tally = None


def count_launches(tally: dict) -> None:
    """Count a recorded tally (`recorded_launches`) as launched, in the wrappers' counts
    and the calling thread's: one replay of a captured graph."""
    for wrapper, n in tally.items():
        _count(wrapper, n)


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


def ndt_step_plain(sums, T, done, iters, step_size, transform_epsilon, damping,
                   refine=None):
    """One Gauss-Newton step from an iteration's reduction (`ndt_direct7_accumulate`'s
    outputs), the reference's body after its accumulation: the damped solve, the step cap
    (then `refine`, the line search, if given), the fitness, the guarded update and the
    convergence test. Returns the next carry (T, done, iterations, fitness, inliers)."""
    H, g, _sum_w, n_hit, centre_d2, centre_count = sums
    n_inliers = n_hit.to(torch.int32)
    delta = cap_step(solve_damped(H, g, damping), step_size)
    if refine is not None:
        delta = refine(delta)
    # Mean squared distance to the matched voxel means (diagnostic fitness).
    fitness = centre_d2 / torch.clamp(centre_count, min=1.0)
    step_ok = torch.isfinite(delta).all() & (n_inliers > 0)
    delta = torch.where(step_ok, delta, 0.0)
    T_new = se3.se3_exp(delta) @ T
    newly_done = norm(delta) < transform_epsilon
    return T_new, done | newly_done, iters + 1, fitness, n_inliers


def ndt_carry_update(sums, carry, step_size, transform_epsilon, damping, polish: bool):
    """Plain version of what one `ndt_iteration` launch does to the carry (T, done,
    iterations, fitness, inliers) given the iteration's reduction `sums`: a non-polish
    launch whose carry is done leaves it as it is (the while_loop's cond), otherwise takes
    `ndt_step_plain`'s carry; a polish launch updates T, fitness and inliers and keeps done
    and iterations. Returns the next carry."""
    T, done, iters, _, _ = carry
    new = ndt_step_plain(sums, T, done, iters, step_size, transform_epsilon, damping)
    if polish:
        return new[0], done, iters, new[3], new[4]
    return tuple(torch.where(done, old, n) for old, n in zip(carry, new))


def ndt_align_loop_plain(vmap, source_points, source_mask, T0, d2, w_scale, step_size,
                         transform_epsilon, damping, max_iterations, polish_iterations,
                         stop_early=None):
    """Plain PyTorch version of `ndt_align_loop`: the reference's `while_loop` as
    `max_iterations` torch-op bodies whose carry is frozen from the iteration that finds
    it done (the cond's semantics), then `polish_iterations` bodies that update only T,
    fitness and inliers (`ndt_carry_update`). `stop_early` (default: on the CPU, where
    reading `done` costs nothing) ends the loop at the first `done` instead; a frozen carry
    gives the same result bit for bit. Returns (T, done, iterations, fitness, inliers)."""
    dev = source_points.device
    if stop_early is None:
        stop_early = dev.type == "cpu"

    def launch(carry, polish):
        p = se3.transform_points(carry[0], source_points)
        sums = ndt_direct7_accumulate_plain(vmap, p, source_mask, d2, w_scale)
        return ndt_carry_update(sums, carry, step_size, transform_epsilon, damping, polish)

    carry = (T0.to(torch.float32), torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.full((), torch.inf, dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    for _ in range(max_iterations):
        if stop_early and bool(carry[1]):
            break
        carry = launch(carry, polish=False)
    for _ in range(polish_iterations):
        carry = launch(carry, polish=True)
    return carry


def ndt_align_loop_batched_plain(vmaps, source_points, source_mask, T0, d2, w_scale,
                                 step_size, transform_epsilon, damping, max_iterations,
                                 polish_iterations, stop_early=None):
    """Plain PyTorch version of `ndt_align_loop_batched`: `ndt_align_loop_plain` on each
    sequence against its own map, each carry stacked on a leading batch axis."""
    rows = [ndt_align_loop_plain(map_at(vmaps, b), source_points[b], source_mask[b], T0[b],
                                 _scalar_at(d2, b), _scalar_at(w_scale, b), step_size,
                                 transform_epsilon, damping, max_iterations,
                                 polish_iterations, stop_early)
            for b in range(source_points.shape[0])]
    return tuple(torch.stack(x) for x in zip(*rows))


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate. A determinant below 1e-12 in
    magnitude is replaced by +1e-12 (its sign dropped), as in the reference."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def gicp_match(target, p: torch.Tensor, source_mask: torch.Tensor, corr2,
               bucket_cap: int = 32, neighborhood: int = 7):
    """Forward correspondences of the transformed source `p` in a `GicpTarget`: (idx [N]
    into the target's sorted rows, d2 [N], matched [N]) — NN found, source row valid,
    within the distance gate (`corr2` is its square) and a valid target covariance."""
    idx, d2, found = nearest(target.grid, p, bucket_cap=bucket_cap, neighborhood=neighborhood)
    return idx, d2, found & source_mask & (d2 < corr2) & target.valid[idx]


def gicp_residual_rows(target, idx: torch.Tensor, p: torch.Tensor, R: torch.Tensor,
                       source_covs: torch.Tensor):
    """(e [N, 3], M [N, 3, 3]): the residual p - q and the plane-to-plane metric
    (C_q + R C_p R^T)^-1 of every row, matched or not — the rows the accumulation takes."""
    M = inv3x3(target.covs[idx] + R @ source_covs @ R.T)
    return p - target.grid.points[idx], M


def gicp_sums_plain(target, source_points, source_mask, source_covs, T, corr2,
                    bucket_cap: int = 32, neighborhood: int = 7, source_grid=None):
    """One GICP iteration's reduction at T (the reference's body before its solve): the
    match (with PCL's reciprocal test when `source_grid`, the untransformed source's grid,
    is given: the backward NN of T^-1 q must be the source row itself), the rows, and
    `ndt_accumulate_plain` with d2 = 0 and w_scale = 1, where the weight is the match mask.
    Returns (H, g, sum_w, n_hit, sum of the matched d2, matched count): the layout of
    `ndt_direct7_accumulate`'s outputs, the fitness being the ratio of the last two."""
    p = se3.transform_points(T, source_points)
    idx, d2, matched = gicp_match(target, p, source_mask, corr2, bucket_cap, neighborhood)
    if source_grid is not None:
        q_back = se3.transform_points(se3.inverse(T), target.grid.points[idx])
        bidx, _bd2, bfound = nearest(source_grid, q_back, bucket_cap=bucket_cap,
                                     neighborhood=neighborhood)
        rows = torch.arange(p.shape[0], device=p.device)
        matched = matched & bfound & (source_grid.order[bidx] == rows)
    e, M = gicp_residual_rows(target, idx, p, T[:3, :3], source_covs)
    # Unmatched rows (e up to ~1e6 at padding) get weight exactly 0.
    H, g, sum_w, n_hit = ndt_accumulate_plain(e, M, p, matched, 0.0, 1.0)
    d2_sum = torch.sum(torch.where(matched, d2, 0.0))
    return H, g, sum_w, n_hit, d2_sum, torch.sum(matched.to(torch.float32))


def gicp_step_plain(sums, T, done, iters, transform_epsilon, damping):
    """GICP's step from one iteration's reduction (`gicp_sums_plain`), the reference's
    body after its accumulation: the damped solve (no cap), zeroed when it is not finite
    or has fewer than 6 inliers, T <- se3_exp(delta) T, the fitness sum(d2) / max(inliers,
    1) and the convergence test. Returns the next carry (T, done, iterations, fitness,
    inliers)."""
    H, g, _sum_w, n_hit, d2_sum, _count = sums
    n_inl = n_hit.to(torch.int32)
    delta = solve_damped(H, g, damping)
    ok = torch.isfinite(delta).all() & (n_inl >= 6)
    delta = torch.where(ok, delta, 0.0)
    T_new = se3.se3_exp(delta) @ T
    fitness = d2_sum / torch.clamp(n_inl, min=1)
    newly_done = norm(delta) < transform_epsilon
    return T_new, done | newly_done, iters + 1, fitness, n_inl


def gicp_carry_update(sums, carry, transform_epsilon, damping):
    """Plain version of what one `gicp_iteration` launch does to the carry (T, done,
    iterations, fitness, inliers) given the iteration's reduction `sums`: a carry that is
    done stays as it is (the while_loop's cond), otherwise `gicp_step_plain`'s."""
    T, done, iters, _, _ = carry
    new = gicp_step_plain(sums, T, done, iters, transform_epsilon, damping)
    return tuple(torch.where(done, old, n) for old, n in zip(carry, new))


def gicp_align_loop_plain(target, source_points, source_mask, source_covs, T0, corr2,
                          transform_epsilon, damping, max_iterations, bucket_cap: int = 32,
                          neighborhood: int = 7, source_grid=None, stop_early=None):
    """Plain PyTorch version of `gicp_align_loop`: the reference's `while_loop` as
    `max_iterations` torch-op bodies (`gicp_sums_plain`, `gicp_carry_update`) whose carry
    is frozen from the iteration that finds it done. `stop_early` (default: on the CPU,
    where reading `done` costs nothing) ends the loop at the first `done` instead; a
    frozen carry gives the same result bit for bit. Returns (T, done, iterations,
    fitness, inliers)."""
    dev = source_points.device
    if stop_early is None:
        stop_early = dev.type == "cpu"
    carry = (T0.to(torch.float32), torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.full((), torch.inf, dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    for _ in range(max_iterations):
        if stop_early and bool(carry[1]):
            break
        sums = gicp_sums_plain(target, source_points, source_mask, source_covs, carry[0],
                               corr2, bucket_cap, neighborhood, source_grid)
        carry = gicp_carry_update(sums, carry, transform_epsilon, damping)
    return carry


# -- ICP: the loop verifier and the ICP front end ----------------------------------------

def umeyama_step(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Optimal R, t minimizing sum w ||R src + t - dst||^2 (closed form): the reference's
    `_umeyama_step` (`lidar_graph_slam_tpu/registration/icp.py:31-45`) — the weighted
    means, the centred cross-covariance and a 3x3 SVD with the det(U V^T) sign."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    sc = src - mu_s
    dc = dst - mu_d
    Sigma = torch.einsum("ni,nj,n->ij", dc, sc, w) / wsum
    U, _, Vt = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    return R, t


def icp_match(grid, p: torch.Tensor, source_mask: torch.Tensor, corr2, bucket_cap: int = 32,
              neighborhood: int = 27):
    """ICP's correspondences of the transformed source `p` in the target `HashGrid`: (idx
    [N] into its sorted rows, d2 [N], found [N], matched [N]) — matched: NN found, source
    row valid, within the distance gate (`corr2` is its square)."""
    idx, d2, found = nearest(grid, p, bucket_cap=bucket_cap, neighborhood=neighborhood)
    return idx, d2, found, found & source_mask & (d2 < corr2)


def icp_body_plain(grid, source_points, source_mask, carry, corr2, transform_epsilon,
                   euclidean_fitness_epsilon: float = 0.0, bucket_cap: int = 32,
                   neighborhood: int = 27):
    """One iteration of the reference's ICP body (`registration/icp.py:73-101`) on the
    carry (T, done, iterations, fitness, inliers): the match, `umeyama_step`, the step
    taken with 3 or more inliers when finite (else the identity), T <- dT T, the fitness
    (min(d2, corr2) of each valid point, corr2 when unmatched, averaged) and the stop test
    (|se3_log(dT)| below `transform_epsilon`, or with a positive
    `euclidean_fitness_epsilon` a fitness change below it). Returns the next carry."""
    T, done, iters, fitness_prev, _ = carry
    dtype, dev = source_points.dtype, source_points.device
    pen = torch.full((), corr2, dtype=dtype, device=dev)
    nvalid = torch.clamp(torch.sum(source_mask.to(torch.int64)), min=1)
    p = se3.transform_points(T, source_points)
    idx, d2, found, matched = icp_match(grid, p, source_mask, corr2, bucket_cap, neighborhood)
    w = matched.to(dtype)
    R, t = umeyama_step(p, grid.points[idx], w)
    delta_T = se3.make_transform(R, t)
    n_inl = torch.sum(matched.to(torch.int32))
    ok = (n_inl >= 3) & torch.isfinite(delta_T).all()
    delta_T = torch.where(ok, delta_T, torch.eye(4, dtype=dtype, device=dev))
    T_new = delta_T @ T
    per_pt = torch.where(found, torch.minimum(d2, pen), pen)
    fitness = torch.sum(torch.where(source_mask, per_pt, 0.0)) / nvalid
    newly_done = norm(se3.se3_log(delta_T)) < transform_epsilon
    if euclidean_fitness_epsilon > 0.0:
        newly_done = newly_done | (torch.abs(fitness_prev - fitness) < euclidean_fitness_epsilon)
    return T_new, done | newly_done, iters + 1, fitness, n_inl


def icp_align_loop_plain(grid, source_points, source_mask, T0, corr2, transform_epsilon,
                         euclidean_fitness_epsilon, max_iterations, bucket_cap: int = 32,
                         neighborhood: int = 27, stop_early=None):
    """Plain PyTorch version of `icp_align_loop`: the reference's `while_loop` as
    `max_iterations` `icp_body_plain`s whose carry is frozen from the iteration that finds
    it done (the cond's semantics). `stop_early` (default: on the CPU, where reading `done`
    costs nothing) ends the loop at the first `done` instead; a frozen carry gives the
    same result bit for bit. Returns (T, done, iterations, fitness, inliers)."""
    dev = source_points.device
    if stop_early is None:
        stop_early = dev.type == "cpu"
    carry = (T0.to(source_points.dtype), torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.full((), torch.inf, dtype=source_points.dtype, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    for _ in range(max_iterations):
        if stop_early and bool(carry[1]):
            break
        new = icp_body_plain(grid, source_points, source_mask, carry, corr2,
                             transform_epsilon, euclidean_fitness_epsilon, bucket_cap,
                             neighborhood)
        carry = tuple(torch.where(carry[1], old, n) for old, n in zip(carry, new))
    return carry


def icp_fitness_plain(grid, points, mask, transform, max_range, bucket_cap: int = 16,
                      neighborhood: int = 27, mode: str = "penalized"):
    """Plain PyTorch version of `icp_fitness`: the reference's
    `fitness_and_match_fraction` (`registration/icp.py:155-188`) from one NN query —
    "pcl": the mean d2 of the matched points (d2 < max_range^2), +inf with none;
    "penalized": min(d2, max_range^2) of each valid point, max_range^2 when unmatched,
    averaged; and the matched fraction of the valid points. Returns (score, frac)."""
    p = se3.transform_points(transform, points)
    _, d2, found = nearest(grid, p, bucket_cap=bucket_cap, neighborhood=neighborhood)
    pen = max_range * max_range
    matched = found & mask & (d2 < pen)
    frac = torch.sum(matched.to(torch.int64)) / torch.clamp(
        torch.sum(mask.to(torch.int64)), min=1)
    if mode == "pcl":
        n = torch.sum(matched.to(torch.int64))
        score = torch.where(
            n > 0,
            torch.sum(torch.where(matched, d2, 0.0)) / torch.clamp(n, min=1),
            torch.full((), torch.inf, dtype=p.dtype, device=p.device),
        )
        return score, frac
    per_pt = torch.where(found, torch.clamp(d2, max=pen), pen)
    nvalid = torch.clamp(torch.sum(mask.to(torch.int64)), min=1)
    return torch.sum(torch.where(mask, per_pt, 0.0)) / nvalid, frac


# The `icp_iteration` kernel's own step, in torch ops: the CPU tests hold it against the
# reference's `_umeyama_step` on the inputs where a closed-form step is fragile (planar,
# near-collinear, reflected, far from the origin).

def icp_anchor(source_points, source_mask, T0):
    """The origin of `icp_iteration`'s sums for an align: the masked source centroid moved
    by T0 ([3]; the origin itself when nothing is masked in). Inside the cloud, so the
    moments about it are of the cloud's spread and do not cancel as world-coordinate
    moments would far from the origin."""
    m = source_mask.to(source_points.dtype)
    centroid = torch.sum(source_points * m[:, None], dim=0) / torch.clamp(torch.sum(m), min=1.0)
    return T0[:3, :3] @ centroid + T0[:3, 3]


def icp_moments_plain(p, q, matched, anchor):
    """The sums one `icp_iteration` launch reduces, over the matched rows of p [N, 3]
    (transformed source) and q [N, 3] (their targets): (n, S_p [3], S_q [3], S_qp [3, 3])
    of 1, p - c, q - c and (q - c)_i (p - c)_j about the anchor c."""
    w = matched.to(p.dtype)
    pc, qc = p - anchor, q - anchor
    return (torch.sum(w), torch.sum(pc * w[:, None], dim=0), torch.sum(qc * w[:, None], dim=0),
            torch.einsum("ni,nj,n->ij", qc, pc, w))


def _dot3(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


# The kernel's one-sided Jacobi: at most ICP_SVD_SWEEPS sweeps, ended by the first that
# finds every pair of columns orthogonal, gamma^2 <= ICP_ORTHO2 alpha beta (the cosine of
# their angle within float32's epsilon, 2^-23): `kSvdSweeps` and `kOrtho2` of
# `csrc/icp_loop.cu`.
ICP_SVD_SWEEPS = 6
ICP_ORTHO2 = 2.0 ** -46


def rotation_of_plain(S: torch.Tensor, return_sweeps: bool = False):
    """The rotation R maximizing trace(R^T S) over SO(3) for S [..., 3, 3], as the kernel's
    `rotation_of` (`csrc/icp_loop.cu`) computes it, elementwise: sweeps of the one-sided
    Jacobi SVD (the columns of S V orthogonalized in place, pairs (0, 1), (0, 2), (1, 2);
    a pair already orthogonal to float32 is not turned, and the sweeps end at the first
    that turns none), each divide one reciprocal, 1 / sqrt one `rsqrt`; the two largest
    singular pairs by squared norm (ties: the lower column), u2 made orthogonal to u1, and
    R = u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T — `umeyama_step`'s U diag(1, 1, det(U
    V^T)) V^T without the signs of U and V. With `return_sweeps`, also the sweeps each
    matrix ran (int32, the last one the sweep that found the columns orthogonal)."""
    one = torch.ones_like(S[..., 0, 0])
    a = [[S[..., i, k] for i in range(3)] for k in range(3)]  # a[k]: column k of S V
    v = [[one if i == k else torch.zeros_like(one) for i in range(3)] for k in range(3)]
    active = torch.ones_like(one, dtype=torch.bool)
    sweeps = torch.zeros_like(one, dtype=torch.int32)
    for _ in range(ICP_SVD_SWEEPS):
        sweeps = sweeps + active.to(torch.int32)
        turned = torch.zeros_like(active)
        for p_, q_ in ((0, 1), (0, 2), (1, 2)):
            alpha, beta, gamma = _dot3(a[p_], a[p_]), _dot3(a[q_], a[q_]), _dot3(a[p_], a[q_])
            turn = active & (gamma * gamma > ICP_ORTHO2 * (alpha * beta))
            zeta = (beta - alpha) * torch.reciprocal(2.0 * torch.where(turn, gamma, one))
            r = torch.reciprocal(torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(zeta >= 0, r, -r)
            c = torch.rsqrt(1.0 + t * t)
            s = t * c
            for m in (a, v):
                m[p_], m[q_] = ([torch.where(turn, c * x - s * y, x) for x, y in zip(m[p_], m[q_])],
                                [torch.where(turn, s * x + c * y, y) for x, y in zip(m[p_], m[q_])])
            turned = turned | turn
        active = active & turned
    n2 = [_dot3(col, col) for col in a]
    k1 = torch.where(n2[1] > n2[0], 1, 0)
    k1 = torch.where(n2[2] > torch.where(k1 == 1, n2[1], n2[0]), 2, k1)
    k2 = torch.where(k1 == 0, 1, 0)
    other = torch.where(k1 == 2, 1, 2)

    def pick(k, cols):
        return [torch.where(k == 0, cols[0][i], torch.where(k == 1, cols[1][i], cols[2][i]))
                for i in range(3)]

    def at(k, xs):
        return torch.where(k == 0, xs[0], torch.where(k == 1, xs[1], xs[2]))

    k2 = torch.where(at(other, n2) > at(k2, n2), other, k2)
    inv1 = torch.rsqrt(at(k1, n2))
    u1 = [x * inv1 for x in pick(k1, a)]
    a2 = pick(k2, a)
    proj = _dot3(u1, a2)
    u2 = [x - proj * y for x, y in zip(a2, u1)]
    inv2 = torch.rsqrt(_dot3(u2, u2))
    u2 = [x * inv2 for x in u2]
    v1, v2 = pick(k1, v), pick(k2, v)
    u3, v3 = _cross3(u1, u2), _cross3(v1, v2)
    R = torch.stack([torch.stack([(u1[i] * v1[j] + u2[i] * v2[j]) + u3[i] * v3[j]
                                  for j in range(3)], dim=-1) for i in range(3)], dim=-2)
    return (R, sweeps) if return_sweeps else R


def umeyama_from_moments(moments, anchor):
    """`umeyama_step` as `icp_iteration`'s last block takes it from `icp_moments_plain`'s
    sums about the anchor c: W = max(n, 1e-9), the means m = S (1 / W) (one reciprocal),
    the centred cross-covariance S_qp (1 / W) - m_q m_p^T, R = `rotation_of_plain`, t =
    mu_d - R mu_s with mu = c + m. Returns (R, t)."""
    n, Sp, Sq, Sqp = moments
    inv_w = torch.reciprocal(torch.clamp(n, min=1e-9))
    mp, mq = Sp * inv_w, Sq * inv_w
    R = rotation_of_plain(Sqp * inv_w - mq[:, None] * mp[None, :])
    mu_s, mu_d = anchor + mp, anchor + mq
    t = mu_d - torch.stack([_dot3([R[i, j] for j in range(3)], mu_s) for i in range(3)])
    return R, t


# -- the library -------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the "
                       "kernels of csrc/")


def load_library():
    """Build (once per source version) and load the kernel library; returns it.

    The library is named by a hash of the sources and the header they share, so an
    edited file is rebuilt and a stale build is never loaded. `build_info` records the
    path, the build seconds (0.0 when an existing build was loaded) and the compiler's
    output.
    """
    if _lib is not None:
        return _lib
    with _lib_lock:
        return _load_library_locked()


def _load_library_locked():
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
    for path in _SOURCES + _HEADERS:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libndt_accumulate-{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _SOURCES]
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode != 0 else []
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        seconds = time.perf_counter() - t0
        log = "".join(outs)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
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
    lib.lgs_ndt_align_loop.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp, f32, vp, f32, i64, f32, f32,
        vp, f32, vp, vp, vp, vp, vp, i32, i32, vp, vp, i32, vp]
    lib.lgs_ndt_align_loop_batched.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i64, i32, vp, f32, vp, f32, i64,
        i32, f32, f32, vp, f32, vp, vp, vp, vp, vp, i32, i32, vp, vp, i32, vp]
    lib.lgs_gicp_align_loop.argtypes = [
        vp, vp, vp, i64, vp, vp, vp, vp, i32, vp, vp, vp, vp, vp, vp, i32, vp, i32, i32, i32,
        i32, i32, i32, i32, i32, i32, i32, f32, f32, vp, f32, vp, vp, vp, vp, vp, i32, vp, vp,
        i32, vp]
    lib.lgs_icp_align_loop.argtypes = [
        vp, vp, i64, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp,
        f32, f32, f32, vp, vp, vp, vp, vp, i32, vp, vp, i32, vp]
    lib.lgs_icp_fitness.argtypes = [
        vp, vp, i64, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp,
        f32, i32, vp, vp, vp, i32, vp]
    lib.lgs_ndt_finalize.argtypes = [vp, vp, vp, i64, vp, vp, vp, vp, vp, i32, vp, vp, f32,
                                     i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.lgs_eigh3x3.argtypes = [vp, i64, vp, vp, vp]
    lib.lgs_voxel_centroids.argtypes = [vp, vp, vp, vp, i64, vp, vp, i32, i32, i32, i32, vp,
                                        vp, vp]
    lib.lgs_sor_window_stats.argtypes = [vp, vp, vp, i64, i32, vp, vp, vp]
    lib.lgs_gicp_covariances.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp]
    lib.lgs_dense_table.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp, vp]
    lib.lgs_grid_rows.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp,
                                  vp]
    lib.lgs_cell_keys.argtypes = [vp, vp, i64, i32, f32, f32, i32, i32, f32, f32, f32, f32, f32,
                                  f32, vp, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp, vp]
    lib.lgs_sorted_runs.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp, vp, vp, vp]
    lib.lgs_sor_threshold.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp, vp, vp]
    lib.lgs_compact_rows.argtypes = [vp, vp, i64, i64, vp, vp, vp, vp]
    for fn in (lib.lgs_ndt_accumulate, lib.lgs_ndt_direct7_accumulate,
               lib.lgs_ndt_direct7_accumulate_batched, lib.lgs_ndt_align_loop,
               lib.lgs_ndt_align_loop_batched, lib.lgs_gicp_align_loop, lib.lgs_icp_align_loop,
               lib.lgs_icp_fitness, lib.lgs_ndt_finalize, lib.lgs_eigh3x3,
               lib.lgs_voxel_centroids, lib.lgs_sor_window_stats, lib.lgs_gicp_covariances,
               lib.lgs_dense_table, lib.lgs_grid_rows, lib.lgs_cell_keys,
               lib.lgs_sorted_runs, lib.lgs_sor_threshold, lib.lgs_compact_rows):
        fn.restype = ctypes.c_int
    for fn in (lib.lgs_ndt_worked_launches, lib.lgs_gicp_worked_launches,
               lib.lgs_icp_worked_launches):
        fn.argtypes, fn.restype = [i32], i64
    lib.lgs_ndt_loop_blocks_per_sm.argtypes, lib.lgs_ndt_loop_blocks_per_sm.restype = [], i32
    lib.lgs_ndt_loop_attributes.argtypes, lib.lgs_ndt_loop_attributes.restype = [vp], i32
    lib.lgs_gicp_loop_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.lgs_gicp_loop_blocks_per_sm.restype = i32
    lib.lgs_gicp_loop_attributes.argtypes = [i32, i32, i32, vp]
    lib.lgs_gicp_loop_attributes.restype = i32
    lib.lgs_icp_loop_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.lgs_icp_loop_blocks_per_sm.restype = i32
    lib.lgs_icp_loop_attributes.argtypes = [i32, i32, i32, vp]
    lib.lgs_icp_loop_attributes.restype = i32
    for name in ("threads", "quantities", "outputs", "loop_tile", "loop_row"):
        fn = getattr(lib, f"lgs_ndt_{name}")
        fn.argtypes, fn.restype = [], ctypes.c_int
        _consts[name] = fn()
    lib.lgs_prefilter_pass_rows.argtypes, lib.lgs_prefilter_pass_rows.restype = [], i32
    if lib.lgs_prefilter_pass_rows() != SOR_SUM_ROWS:
        raise RuntimeError("csrc/prefilter_pass.cu: kRows differs from "
                           "ops/neighbors.py:SOR_SUM_ROWS")
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


def loop_blocks(n: int, sms: int, blocks_per_sm: int, tile: int) -> int:
    """Blocks of one sequence in a launch of the loop kernel (`ndt_iteration`): one per
    tile of `tile` source points, at most the blocks the card holds at once (`sms` x the
    kernel's resident `blocks_per_sm`) and 1,024, at least 1. A function of N and the card
    only, never of the batch, so row b of a batch is reduced in the same order as the
    single loop on sequence b."""
    return max(1, min(-(-n // tile), sms * blocks_per_sm, _MAX_BLOCKS))


def _loop_occupancy(device, gicp=None, icp=None) -> tuple[int, int]:
    """(SMs, resident blocks per SM) of the NDT loop kernel on `device`, or with `gicp` =
    (neighborhood, bucket_cap, reciprocal) of that instantiation of the GICP loop kernel,
    or with `icp` = (neighborhood, bucket_cap, fitness) of `icp_iteration` (fitness 0) or
    `icp_fitness` (1) (read once per card and kernel)."""
    key = (device.index, gicp, icp)
    occ = _occupancy.get(key)
    if occ is None:
        name = ("ndt_iteration" if gicp is None and icp is None else
                "gicp_iteration" if icp is None else ("icp_iteration", "icp_fitness")[icp[2]])
        with torch.cuda.device(device):
            lib = load_library()
            if icp is not None:
                per_sm = lib.lgs_icp_loop_blocks_per_sm(*map(int, icp))
            elif gicp is not None:
                per_sm = lib.lgs_gicp_loop_blocks_per_sm(*map(int, gicp))
            else:
                per_sm = lib.lgs_ndt_loop_blocks_per_sm()
        _raise_on(max(-per_sm, 0), f"{name} occupancy")
        if per_sm == 0:
            raise RuntimeError(f"{name}: no block of it fits on an SM")
        occ = _occupancy[key] = (
            torch.cuda.get_device_properties(device).multi_processor_count, per_sm)
    return occ


def loop_grid(device, n: int, gicp=None, icp=None) -> int:
    """`loop_blocks` for N = n on the CUDA `device`: the blocks of one sequence in each
    launch of the NDT loop kernel there, or with `gicp` = (neighborhood, bucket_cap,
    reciprocal) of that GICP loop kernel, or with `icp` = (neighborhood, bucket_cap,
    fitness) of that ICP kernel."""
    return loop_blocks(n, *_loop_occupancy(device, gicp, icp), _consts["loop_tile"])


def _stream_scratch(device, batch: int = 1):
    """(stream handle, partials pointer, counters pointer) on the current stream of
    `device`, for `batch` sequences: a row of partials per block (at most `_MAX_BLOCKS`),
    wide enough for the accumulate and the loop kernels, and one ticket counter per
    sequence."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    scratch = _scratch.get(key)
    if scratch is None or scratch[1].numel() < batch:
        with _lib_lock:
            scratch = _scratch.get(key)
            if scratch is None or scratch[1].numel() < batch:
                # Zeroed on this stream, before its first launch that uses them; a smaller
                # pair it replaces is freed in this stream's order.
                scratch = _scratch[key] = (
                    torch.empty(max(_consts["quantities"], _consts["loop_row"])
                                * _MAX_BLOCKS * batch, dtype=torch.float32, device=device),
                    torch.zeros(batch, dtype=torch.int32, device=device))
    return stream, scratch[0].data_ptr(), scratch[1].data_ptr()


def _launch_args(device, rows: int, batch: int | None = None):
    """(stream handle, partials pointer, counters pointer, blocks, fresh output) for one
    launch of an accumulate kernel over `rows` work items (per sequence of `batch`, whose
    output then has a leading batch axis) on the current stream of `device`. The block
    count depends on `rows` only, so a sequence of a batch is reduced in the same order as
    alone."""
    stream, partials, counters = _stream_scratch(device, batch or 1)
    nblocks = min(max(-(-rows // _consts["threads"]), 1), _MAX_BLOCKS)
    shape = (_consts["outputs"],) if batch is None else (batch, _consts["outputs"])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return stream, partials, counters, nblocks, out


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


def _batched_scalar_arg(x, device, batch: int, wrapper: str = "ndt_direct7_accumulate_batched"):
    """(device pointer, host value, one value per sequence) for d2 / w_scale of a batched
    kernel: a number, a 0-d f32 tensor, or a [batch] f32 tensor."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        _check(wrapper, device, scalars=(x, (batch,), torch.float32))
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


def _loop_carry(T0, batch: tuple):
    """The loop's carry, allocated once per call: (T f32 copy of T0, done, iterations,
    fitness, inliers), each with the leading `batch` shape."""
    dev = T0.device
    return (T0.to(dtype=torch.float32, copy=True).contiguous(),
            torch.zeros(batch, dtype=torch.bool, device=dev),
            torch.zeros(batch, dtype=torch.int32, device=dev),
            torch.full(batch, torch.inf, dtype=torch.float32, device=dev),
            torch.zeros(batch, dtype=torch.int32, device=dev))


def _check_transform(wrapper: str, dev, T0, lead: tuple) -> None:
    if T0.device != dev or tuple(T0.shape) != lead + (4, 4) or not T0.is_floating_point():
        raise ValueError(f"{wrapper}: T0 must be a float {lead + (4, 4)} tensor on {dev}, got "
                         f"{T0.dtype} {tuple(T0.shape)} on {T0.device}")


def _check_map(wrapper: str, dev, vmap, lead: tuple) -> None:
    C = vmap.packed.shape[len(lead)]
    _check(wrapper, dev, table=(vmap.table, lead + (_TABLE_SIZE,), torch.int32),
           packed=(vmap.packed, lead + (C, 16), torch.float32),
           origin=(vmap.origin, lead + (3,), torch.float32),
           inv_leaf=(vmap.inv_leaf, lead, torch.float32))
    if vmap.packed.data_ptr() % 16:
        raise ValueError(f"{wrapper}: packed rows must be 16-byte aligned")


def ndt_align_loop(vmap, source_points, source_mask, T0, d2, w_scale, step_size,
                   transform_epsilon, damping, max_iterations, polish_iterations):
    """The whole NDT Gauss-Newton loop of `registration/ndt.py:ndt_align` (line search
    off) against a voxel map, as the reference's `lax.while_loop` runs it on the device.

    vmap:          `ops.voxel.NdtVoxelMap` (as `ndt_direct7_accumulate` takes it)
    source_points: [N, 3] f32 source points (untransformed), source_mask: [N] bool
    T0:            [4, 4] initial transform
    d2, w_scale, damping: 0-d f32 tensors on the device, or numbers
    step_size, transform_epsilon: numbers (rounded to float32, as the reference's)
    Returns the device carry (T, done, iterations, fitness, inliers): T [4,4] f32 after
    the polish, done bool, iterations i32 (the bodies that ran before `done`, at most
    `max_iterations`), fitness f32 and inliers i32 of the last body (polish included).
    Nothing is read back.

    CPU tensors take `ndt_align_loop_plain`. On CUDA tensors one C call enqueues
    `max_iterations` launches of the `ndt_iteration` kernel (`csrc/ndt_loop.cu`: the
    transform, gather, accumulation and the step in one launch; a launch that finds the
    carry done exits at once), then `polish_iterations` polish launches, on the current
    stream, counted in `ndt_align_loop.launches`; it raises if the kernel fails to build
    or a launch is refused.
    """
    if source_points.device.type == "cpu":
        return ndt_align_loop_plain(vmap, source_points, source_mask, T0, d2, w_scale,
                                    step_size, transform_epsilon, damping, max_iterations,
                                    polish_iterations)
    dev = source_points.device
    if dev.type != "cuda":
        raise ValueError(f"ndt_align_loop: unsupported device {dev}")
    n = source_points.shape[0]
    _check("ndt_align_loop", dev, source_points=(source_points, (n, 3), torch.float32),
           source_mask=(source_mask, (n,), torch.bool))
    _check_transform("ndt_align_loop", dev, T0, ())
    _check_map("ndt_align_loop", dev, vmap, ())
    d2_ptr, d2_val = _scalar_arg(d2, dev)
    ws_ptr, ws_val = _scalar_arg(w_scale, dev)
    dp_ptr, dp_val = _scalar_arg(damping, dev)
    lib = load_library()
    stream, partials, counter = _stream_scratch(dev)
    carry = _loop_carry(T0, ())
    _raise_on(lib.lgs_ndt_align_loop(
        source_points.data_ptr(), source_mask.data_ptr(), vmap.table.data_ptr(),
        vmap.packed.data_ptr(), vmap.origin.data_ptr(), vmap.inv_leaf.data_ptr(), *TABLE_DIMS,
        *COORD_MAX, d2_ptr, d2_val, ws_ptr, ws_val, n, step_size, transform_epsilon, dp_ptr,
        dp_val, *(x.data_ptr() for x in carry), max_iterations, polish_iterations, partials,
        counter, loop_grid(dev, n), stream), "ndt_align_loop")
    _count(ndt_align_loop, max_iterations + polish_iterations)
    return carry


def ndt_align_loop_batched(vmaps, source_points, source_mask, T0, d2, w_scale, step_size,
                           transform_epsilon, damping, max_iterations, polish_iterations):
    """`ndt_align_loop` for B sequences in one launch an iteration, each against its own
    map (`stack_maps`): source_points [B, N, 3] f32, source_mask [B, N] bool, T0 [B, 4, 4];
    d2 and w_scale numbers, 0-d or [B] f32 tensors; damping a number or a 0-d f32 tensor.
    Returns the carry with a leading batch axis. A finished sequence's blocks exit on its
    own `done`; row b equals `ndt_align_loop` on sequence b alone bit for bit on the card.

    CPU tensors take `ndt_align_loop_batched_plain`; CUDA tensors launch the
    `ndt_iteration_batched` kernel (counted in `ndt_align_loop_batched.launches`) or
    raise.
    """
    if source_points.device.type == "cpu":
        return ndt_align_loop_batched_plain(vmaps, source_points, source_mask, T0, d2,
                                            w_scale, step_size, transform_epsilon, damping,
                                            max_iterations, polish_iterations)
    dev = source_points.device
    if dev.type != "cuda":
        raise ValueError(f"ndt_align_loop_batched: unsupported device {dev}")
    B, n = source_points.shape[:2]
    name = "ndt_align_loop_batched"
    _check(name, dev, source_points=(source_points, (B, n, 3), torch.float32),
           source_mask=(source_mask, (B, n), torch.bool))
    _check_transform(name, dev, T0, (B,))
    _check_map(name, dev, vmaps, (B,))
    d2_ptr, d2_val, per_seq = _batched_scalar_arg(d2, dev, B, name)
    ws_ptr, ws_val, per_seq_ws = _batched_scalar_arg(w_scale, dev, B, name)
    if d2_ptr is not None and ws_ptr is not None and per_seq != per_seq_ws:
        raise ValueError(f"{name}: d2 and w_scale must both be per-sequence tensors or both "
                         "shared")
    dp_ptr, dp_val = _scalar_arg(damping, dev)
    lib = load_library()
    stream, partials, counters = _stream_scratch(dev, B)
    carry = _loop_carry(T0, (B,))
    _raise_on(lib.lgs_ndt_align_loop_batched(
        source_points.data_ptr(), source_mask.data_ptr(), vmaps.table.data_ptr(),
        vmaps.packed.data_ptr(), vmaps.origin.data_ptr(), vmaps.inv_leaf.data_ptr(),
        *TABLE_DIMS, *COORD_MAX, vmaps.packed.shape[1], B, d2_ptr, d2_val, ws_ptr, ws_val, n,
        max(per_seq, per_seq_ws), step_size, transform_epsilon, dp_ptr, dp_val,
        *(x.data_ptr() for x in carry), max_iterations, polish_iterations, partials, counters,
        loop_grid(dev, n), stream), name)
    _count(ndt_align_loop_batched, max_iterations + polish_iterations)
    return carry


# The grid-NN queries the matching loop kernels take (`csrc/nn_stage.cuh`).
GICP_NEIGHBORHOODS = (7, 27)
GICP_BUCKET_CAPS = (16, 32)


def _check_query(name: str, bucket_cap: int, neighborhood: int) -> None:
    """Refuses a `neighborhood` or `bucket_cap` the grid-NN kernels do not take."""
    if neighborhood not in GICP_NEIGHBORHOODS:
        raise ValueError(f"{name}: neighborhood must be one of {GICP_NEIGHBORHOODS}, got "
                         f"{neighborhood}")
    if bucket_cap not in GICP_BUCKET_CAPS:
        raise ValueError(f"{name}: bucket_cap must be one of {GICP_BUCKET_CAPS}, got "
                         f"{bucket_cap}")


def _check_grid(wrapper: str, dev, label: str, grid, bucket_cap: int) -> None:
    """A `HashGrid` the GICP loop kernel reads: packed [n, 4] f32 16-byte aligned with n >=
    bucket_cap, the dense table, origin [3] f32, cell_size 0-d f32, order [n] i64."""
    n = grid.packed.shape[0]
    _check(wrapper, dev, **{f"{label}.packed": (grid.packed, (n, 4), torch.float32),
                            f"{label}.table": (grid.table, (_TABLE_SIZE,), torch.int32),
                            f"{label}.origin": (grid.origin, (3,), torch.float32),
                            f"{label}.cell_size": (grid.cell_size, (), torch.float32),
                            f"{label}.order": (grid.order, (n,), torch.int64)})
    if grid.packed.data_ptr() % 16:
        raise ValueError(f"{wrapper}: {label}.packed rows must be 16-byte aligned")
    if not bucket_cap <= n < 2**31:
        raise ValueError(f"{wrapper}: {label} holds {n} rows, outside [bucket_cap, 2**31)")


def _icp_grid_args(grid):
    """The ICP kernels' target-grid arguments: table, packed rows, origin, cell size (the
    kernels take its float32 reciprocal themselves, so no torch operation runs between a
    loop launch and the next kernel), rows."""
    return (grid.table.data_ptr(), grid.packed.data_ptr(), grid.origin.data_ptr(),
            grid.cell_size.data_ptr(), grid.packed.shape[0])


def _grid_args(grid):
    """The C entry points' target-grid arguments: table, packed rows, origin, the float32
    reciprocal of the cell that `ops/neighbors.py:_candidate_scan` computes (a fresh
    device tensor, kept alive by the caller), rows."""
    inv_cell = 1.0 / grid.cell_size
    return (grid.table.data_ptr(), grid.packed.data_ptr(), grid.origin.data_ptr(),
            inv_cell.data_ptr(), grid.packed.shape[0]), inv_cell


def gicp_align_loop(target, source_points, source_mask, source_covs, T0, corr2,
                    transform_epsilon, damping, max_iterations, bucket_cap: int = 32,
                    neighborhood: int = 7, source_grid=None):
    """The whole GICP Gauss-Newton loop of `registration/gicp.py:gicp_align`, as the
    reference's `lax.while_loop` runs it on the device.

    target:        `registration.gicp.GicpTarget` (its grid, covs [n, 3, 3] f32 and valid
                   [n] bool in the grid's sorted order)
    source_points: [N, 3] f32 source points (untransformed), source_mask: [N] bool,
    source_covs:   [N, 3, 3] f32
    T0:            [4, 4] initial transform
    corr2:         the squared correspondence distance (a number, rounded to float32)
    transform_epsilon: a number (rounded to float32); damping: a number or a 0-d f32
                   tensor on the device
    bucket_cap, neighborhood: the grid query's (16 or 32, 7 or 27)
    source_grid:   the untransformed source's `HashGrid` for PCL's reciprocal test, or None
    Returns the device carry (T [4,4] f32, done bool, iterations i32 (the bodies that ran
    before `done`, at most `max_iterations`), fitness f32 and inliers i32 of the last
    body). Nothing is read back.

    Refuses a `bucket_cap` or `neighborhood` the kernel does not take, on every device.
    CPU tensors take `gicp_align_loop_plain`. On CUDA tensors one C call enqueues
    `max_iterations` launches of the `gicp_iteration` kernel (`csrc/gicp_loop.cu`; a launch
    that finds the carry done exits at once) on the current stream, counted in
    `gicp_align_loop.launches`; it raises if the kernel fails to build or a launch is
    refused.
    """
    name = "gicp_align_loop"
    _check_query(name, bucket_cap, neighborhood)
    if source_points.device.type == "cpu":
        return gicp_align_loop_plain(target, source_points, source_mask, source_covs, T0,
                                     corr2, transform_epsilon, damping, max_iterations,
                                     bucket_cap, neighborhood, source_grid)
    dev = source_points.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n = source_points.shape[0]
    _check(name, dev, source_points=(source_points, (n, 3), torch.float32),
           source_mask=(source_mask, (n,), torch.bool),
           source_covs=(source_covs, (n, 3, 3), torch.float32))
    _check_transform(name, dev, T0, ())
    _check_grid(name, dev, "target.grid", target.grid, bucket_cap)
    rows = target.grid.packed.shape[0]
    _check(name, dev, **{"target.covs": (target.covs, (rows, 3, 3), torch.float32),
                         "target.valid": (target.valid, (rows,), torch.bool)})
    if source_grid is not None:
        _check_grid(name, dev, "source_grid", source_grid, bucket_cap)
    dp_ptr, dp_val = _scalar_arg(damping, dev)
    lib = load_library()
    stream, partials, counter = _stream_scratch(dev)
    carry = _loop_carry(T0, ())
    tgt_args, _tgt_inv_cell = _grid_args(target.grid)
    src_grid_args, _src_inv_cell = (None, None, None, None, 0, None), None
    if source_grid is not None:
        s_args, _src_inv_cell = _grid_args(source_grid)
        src_grid_args = (*s_args, source_grid.order.data_ptr())
    variant = (neighborhood, bucket_cap, source_grid is not None)
    _raise_on(lib.lgs_gicp_align_loop(
        source_points.data_ptr(), source_mask.data_ptr(), source_covs.data_ptr(), n,
        *tgt_args, target.covs.data_ptr(), target.valid.data_ptr(), *src_grid_args,
        *TABLE_DIMS, *COORD_MAX, _BITS_Y + _BITS_Z, _BITS_Z, neighborhood, bucket_cap,
        corr2, transform_epsilon, dp_ptr, dp_val, *(x.data_ptr() for x in carry),
        max_iterations, partials, counter, loop_grid(dev, n, variant), stream), name)
    _count(gicp_align_loop, max_iterations)
    return carry


def icp_align_loop(grid, source_points, source_mask, T0, corr2, transform_epsilon,
                   euclidean_fitness_epsilon, max_iterations, bucket_cap: int = 32,
                   neighborhood: int = 27):
    """The whole ICP loop of `registration/icp.py:icp_align`, as the reference's
    `lax.while_loop` runs it on the device.

    grid:          the target's `HashGrid` (its cell bounds the search, one cell ring)
    source_points: [N, 3] f32 source points (untransformed), source_mask: [N] bool
    T0:            [4, 4] initial transform
    corr2:         the squared correspondence distance (a number, rounded to float32)
    transform_epsilon, euclidean_fitness_epsilon: numbers (rounded to float32; the
                   second's stop is off at 0)
    bucket_cap, neighborhood: the grid query's (16 or 32, 7 or 27)
    Returns the device carry (T [4,4] f32, done bool, iterations i32 (the bodies that ran
    before `done`, at most `max_iterations`), fitness f32 and inliers i32 of the last
    body). Nothing is read back.

    Refuses a `bucket_cap` or `neighborhood` the kernel does not take, on every device.
    CPU tensors take `icp_align_loop_plain`. On CUDA tensors one C call enqueues
    `max_iterations` launches of the `icp_iteration` kernel (`csrc/icp_loop.cu`; a launch
    that finds the carry done exits at once; each after the first a programmatic
    dependent of the one before it) on the current stream, counted in
    `icp_align_loop.launches`, after a few torch operations that make the carry and the
    sums' anchor (`icp_anchor`); it raises if the kernel fails to build or a launch is
    refused.
    """
    name = "icp_align_loop"
    _check_query(name, bucket_cap, neighborhood)
    if source_points.device.type == "cpu":
        return icp_align_loop_plain(grid, source_points, source_mask, T0, corr2,
                                    transform_epsilon, euclidean_fitness_epsilon,
                                    max_iterations, bucket_cap, neighborhood)
    dev = source_points.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n = source_points.shape[0]
    _check(name, dev, source_points=(source_points, (n, 3), torch.float32),
           source_mask=(source_mask, (n,), torch.bool))
    _check_transform(name, dev, T0, ())
    _check_grid(name, dev, "grid", grid, bucket_cap)
    lib = load_library()
    stream, partials, counter = _stream_scratch(dev)
    carry = _loop_carry(T0, ())
    anchor = icp_anchor(source_points, source_mask, carry[0]).contiguous()
    _raise_on(lib.lgs_icp_align_loop(
        source_points.data_ptr(), source_mask.data_ptr(), n, *_icp_grid_args(grid),
        *TABLE_DIMS, *COORD_MAX,
        _BITS_Y + _BITS_Z, _BITS_Z, neighborhood, bucket_cap, anchor.data_ptr(), corr2,
        transform_epsilon, euclidean_fitness_epsilon, *(x.data_ptr() for x in carry),
        max_iterations, partials, counter, loop_grid(dev, n, icp=(neighborhood, bucket_cap, 0)),
        stream), name)
    _count(icp_align_loop, max_iterations)
    return carry


ICP_FITNESS_MODES = ("pcl", "penalized")


def icp_fitness(grid, points, mask, transform, max_range, bucket_cap: int = 16,
                neighborhood: int = 27, mode: str = "penalized"):
    """The loop gate's fitness of `registration/icp.py:fitness_and_match_fraction` in one
    launch: (score, matched fraction) as 0-d f32 tensors on the device — "pcl": the mean
    d2 of the matched points (d2 < max_range^2), +inf with none; "penalized":
    min(d2, max_range^2) of each valid point, max_range^2 when unmatched, averaged.

    grid: the target's `HashGrid`; points [N, 3] f32, mask [N] bool; transform [4, 4];
    max_range a number (its square rounded to float32); bucket_cap, neighborhood: the
    grid query's (16 or 32, 7 or 27).

    Refuses an unknown `mode` and a `bucket_cap` or `neighborhood` the kernel does not
    take, on every device. CPU tensors take `icp_fitness_plain`; CUDA tensors launch the
    `icp_fitness` kernel (`csrc/icp_loop.cu`, counted in `icp_fitness.launches`) or raise:
    no torch operation runs before it, and it is a programmatic dependent of the launch
    before it (right after a loop kernel it starts while that launch ends and reads T
    after it). Nothing is read back.
    """
    name = "icp_fitness"
    if mode not in ICP_FITNESS_MODES:
        raise ValueError(f"unknown fitness mode {mode!r}")
    _check_query(name, bucket_cap, neighborhood)
    if points.device.type == "cpu":
        return icp_fitness_plain(grid, points, mask, transform, max_range, bucket_cap,
                                 neighborhood, mode)
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n = points.shape[0]
    _check(name, dev, points=(points, (n, 3), torch.float32), mask=(mask, (n,), torch.bool))
    _check_transform(name, dev, transform, ())
    _check_grid(name, dev, "grid", grid, bucket_cap)
    T = transform.to(torch.float32).contiguous()
    lib = load_library()
    stream, partials, counter = _stream_scratch(dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    _raise_on(lib.lgs_icp_fitness(
        points.data_ptr(), mask.data_ptr(), n, *_icp_grid_args(grid), *TABLE_DIMS, *COORD_MAX,
        _BITS_Y + _BITS_Z, _BITS_Z, neighborhood, bucket_cap, T.data_ptr(),
        max_range * max_range, int(mode == "pcl"), out.data_ptr(), partials, counter,
        loop_grid(dev, n, icp=(neighborhood, bucket_cap, 1)), stream), name)
    _count(icp_fitness)
    return out[0], out[1]


def ndt_finalize(runs, origin, resolution, min_points: int, points=None, merge=None):
    """One level of an NDT map from its rows sorted by voxel key, in one launch: each run's
    moments summed in order, then the map's rows.

    runs:       (keys_sorted [N] i32, starts [C+1] i64, lengths [C+1] i64): row r < C is
                the run keys_sorted[starts[r] : starts[r] + lengths[r]] (`ops/voxel.py:
                _sorted_runs`; run C, the invalid rows and the voxels past C, is not read)
    points:     pts_sorted [N, 3] f32, the fine level's points in the keys' order; or
    merge:      (order [N] i64, fine_moments, fine_resolution, factor) for a coarse level:
                its runs are over the fine level's rows (`ops/voxel.py:_coarse_runs`),
                fine_moments = (seg_keys [C_f] i32, stats [C_f, 13] f32) as this returns
    origin:     [3] f32; resolution, fine_resolution: 0-d f32 (read on the device)
    min_points: a voxel with fewer points is invalid
    Returns (moments, rows): moments = (seg_keys [C] i32, stats [C, 13] f32: count | sums
    | outer sums), rows = (keys [C] i32, means [C, 3], inv_covs [C, 3, 3], valid [C] bool,
    packed [C, 16]), as `ops/voxel.py:ndt_finalize_plain`, bit for bit on the card.

    CPU tensors take `ndt_finalize_plain`; CUDA tensors launch the `ndt_finalize` kernel
    (counted in `ndt_finalize.launches`; none for C = 0) or raise. Nothing is read back.
    """
    keys_sorted, starts, lengths = runs
    dev = starts.device
    if dev.type == "cpu":
        return ndt_finalize_plain(runs, origin, resolution, min_points, points, merge)
    if dev.type != "cuda":
        raise ValueError(f"ndt_finalize: unsupported device {dev}")
    if (points is None) == (merge is None):
        raise ValueError("ndt_finalize: give exactly one of points and merge")
    N = keys_sorted.shape[0] if keys_sorted.dim() == 1 else -1
    C = starts.shape[0] - 1 if starts.dim() == 1 else -1
    _check("ndt_finalize", dev, keys_sorted=(keys_sorted, (N,), torch.int32),
           starts=(starts, (C + 1,), torch.int64), lengths=(lengths, (C + 1,), torch.int64),
           origin=(origin, (3,), torch.float32), resolution=(resolution, (), torch.float32))
    if C < 0:
        raise ValueError("ndt_finalize: runs need C >= 0")
    if points is not None:
        _check("ndt_finalize", dev, points=(points, (N, 3), torch.float32))
        if points.data_ptr() % 16:
            raise ValueError("ndt_finalize: points must be 16-byte aligned")
        src = (points.data_ptr(), None, None, None, None, 0)
    else:
        order, (fine_keys, fine_stats), fine_res, factor = merge
        Cf = fine_keys.shape[0] if fine_keys.dim() == 1 else -1
        _check("ndt_finalize", dev, order=(order, (N,), torch.int64),
               fine_keys=(fine_keys, (Cf,), torch.int32),
               fine_stats=(fine_stats, (Cf, 13), torch.float32),
               fine_resolution=(fine_res, (), torch.float32))
        if int(factor) < 1:
            raise ValueError(f"ndt_finalize: factor must be >= 1, got {factor}")
        src = (None, order.data_ptr(), fine_keys.data_ptr(), fine_stats.data_ptr(),
               fine_res.data_ptr(), int(factor))
    seg_keys = torch.empty((C,), dtype=torch.int32, device=dev)
    stats = torch.empty((C, 13), dtype=torch.float32, device=dev)
    keys = torch.empty((C,), dtype=torch.int32, device=dev)
    means = torch.empty((C, 3), dtype=torch.float32, device=dev)
    inv_covs = torch.empty((C, 3, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((C,), dtype=torch.bool, device=dev)
    packed = torch.empty((C, 16), dtype=torch.float32, device=dev)
    if C:
        lib = load_library()
        _raise_on(lib.lgs_ndt_finalize(
            keys_sorted.data_ptr(), starts.data_ptr(), lengths.data_ptr(), C, *src,
            origin.data_ptr(), resolution.data_ptr(), float(min_points), _BITS_Y + _BITS_Z,
            _BITS_Z, COORD_MAX[1], COORD_MAX[2], seg_keys.data_ptr(), stats.data_ptr(),
            keys.data_ptr(), means.data_ptr(), inv_covs.data_ptr(), valid.data_ptr(),
            packed.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "ndt_finalize")
        _count(ndt_finalize)
    return (seg_keys, stats), (keys, means, inv_covs, valid, packed)


def eigh3x3(A):
    """Batched symmetric 3x3 eigendecomposition, one launch: A [M, 3, 3] f32 (its upper
    triangle is read) -> (w [M, 3] ascending, V [M, 3, 3] with eigenvector columns), as
    `ops/voxel.py:_eigh3x3`, bit for bit on the card.

    CPU tensors take `_eigh3x3`; CUDA tensors launch the `eigh3x3` kernel (counted in
    `eigh3x3.launches`; none for M = 0) or raise. Nothing is read back.
    """
    if A.device.type == "cpu":
        return _eigh3x3(A)
    if A.device.type != "cuda":
        raise ValueError(f"eigh3x3: unsupported device {A.device}")
    M = A.shape[0] if A.dim() == 3 else -1
    _check("eigh3x3", A.device, A=(A, (M, 3, 3), torch.float32))
    w = torch.empty((M, 3), dtype=torch.float32, device=A.device)
    V = torch.empty((M, 3, 3), dtype=torch.float32, device=A.device)
    if M:
        lib = load_library()
        _raise_on(lib.lgs_eigh3x3(A.data_ptr(), M, w.data_ptr(), V.data_ptr(),
                                  torch.cuda.current_stream(A.device).cuda_stream),
                  "eigh3x3")
        _count(eigh3x3)
    return w, V


def voxel_centroids(keys_sorted, pts_sorted, starts, lengths, origin, leaf):
    """The centroid of each voxel row from the rows sorted by voxel key, in one launch.

    keys_sorted: [N] i32 sorted voxel keys (INVALID_KEY rows last)
    pts_sorted:  [N, 3] f32 in the keys' order
    starts, lengths: [C+1] i64 (`ops/voxel.py:_sorted_runs`): row r < C is the run
                 keys_sorted[starts[r] : starts[r] + lengths[r]]; run C, the invalid rows
                 and the voxels past C, is not read
    origin:      [3] f32; leaf: 0-d f32 (read on the device)
    Returns (points [C, 3] f32: each occupied row's centroid, corner + sums / count with
    the sums of the offsets from the voxel corner, PAD_VALUE where empty; mask [C] bool),
    as `ops/voxel.py:voxel_centroids_plain`, bit for bit on the card.

    CPU tensors take `voxel_centroids_plain`; CUDA tensors launch the `voxel_centroids`
    kernel (`csrc/prefilter.cu`, counted in `voxel_centroids.launches`; none for C = 0)
    or raise. Nothing is read back.
    """
    dev = starts.device
    if dev.type == "cpu":
        return voxel_centroids_plain(keys_sorted, pts_sorted, starts, lengths, origin, leaf)
    if dev.type != "cuda":
        raise ValueError(f"voxel_centroids: unsupported device {dev}")
    N = keys_sorted.shape[0] if keys_sorted.dim() == 1 else -1
    C = starts.shape[0] - 1 if starts.dim() == 1 else -1
    _check("voxel_centroids", dev, keys_sorted=(keys_sorted, (N,), torch.int32),
           pts_sorted=(pts_sorted, (N, 3), torch.float32),
           starts=(starts, (C + 1,), torch.int64), lengths=(lengths, (C + 1,), torch.int64),
           origin=(origin, (3,), torch.float32), leaf=(leaf, (), torch.float32))
    if C < 0:
        raise ValueError("voxel_centroids: runs need C >= 0")
    points = torch.empty((C, 3), dtype=torch.float32, device=dev)
    mask = torch.empty((C,), dtype=torch.bool, device=dev)
    if C:
        lib = load_library()
        _raise_on(lib.lgs_voxel_centroids(
            keys_sorted.data_ptr(), pts_sorted.data_ptr(), starts.data_ptr(),
            lengths.data_ptr(), C, origin.data_ptr(), leaf.data_ptr(), _BITS_Y + _BITS_Z,
            _BITS_Z, COORD_MAX[1], COORD_MAX[2], points.data_ptr(), mask.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "voxel_centroids")
        _count(voxel_centroids)
    return points, mask


def sor_window_stats(keys, points, order, k: int):
    """The statistical outlier filter's per-row statistics in one launch: for each row
    sorted by cell key, the mean distance to its k nearest same-cell rows among the
    +-SOR_WINDOW (24) sorted rows around it (wrapping at the ends, as `torch.roll` does)
    and their count, written at the row's original index.

    keys:   [N] i32 ascending cell keys (INVALID_KEY rows last)
    points: [N, 3] f32 in the keys' order
    order:  [N] i64 each sorted row's original index (a permutation)
    Returns (mean_d [N] f32, n_found [N] i64) in the original row order, as
    `ops/neighbors.py:sor_window_stats_plain`, bit for bit on the card.

    CPU tensors take `sor_window_stats_plain`; CUDA tensors launch the `sor_window_stats`
    kernel (`csrc/prefilter.cu`, counted in `sor_window_stats.launches`; none for N = 0)
    or raise. Nothing is read back.
    """
    dev = keys.device
    if dev.type == "cpu":
        return sor_window_stats_plain(keys, points, order, k)
    if dev.type != "cuda":
        raise ValueError(f"sor_window_stats: unsupported device {dev}")
    N = keys.shape[0] if keys.dim() == 1 else -1
    _check("sor_window_stats", dev, keys=(keys, (N,), torch.int32),
           points=(points, (N, 3), torch.float32), order=(order, (N,), torch.int64))
    if int(k) < 0:
        raise ValueError(f"sor_window_stats: k must be >= 0, got {k}")
    mean_d = torch.empty((N,), dtype=torch.float32, device=dev)
    n_found = torch.empty((N,), dtype=torch.int64, device=dev)
    if N:
        lib = load_library()
        _raise_on(lib.lgs_sor_window_stats(
            keys.data_ptr(), points.data_ptr(), order.data_ptr(), N,
            min(int(k), 2 * SOR_WINDOW), mean_d.data_ptr(), n_found.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "sor_window_stats")
        _count(sor_window_stats)
    return mean_d, n_found


def gicp_covariances(keys, points, order, mask):
    """GICP's covariances of rows sorted by cell key, in one launch: for each row, the
    count, mean and covariance of the same-cell rows among the +-16 sorted rows around it,
    itself included (wrapping at the ends, as `torch.roll` does); the identity where
    fewer than 5 points were summed, else V diag(1e-3, 1, 1) V^T of the covariance's
    eigenvectors V; written at the row's original index.

    keys:   [N] i32 ascending cell keys (INVALID_KEY rows last)
    points: [N, 3] f32 in the keys' order
    order:  [N] i64 each sorted row's original index (a permutation)
    mask:   [N] bool in the original order
    Returns (covs [N, 3, 3] f32, ok [N] bool: 5 or more points and mask) in the original
    order, as `ops/neighbors.py:gicp_covariances_plain` at its window of 16 (the
    reference's, which every caller uses), bit for bit on the card.

    CPU tensors take `gicp_covariances_plain`; CUDA tensors launch the `gicp_covariances`
    kernel (`csrc/covariances.cu`, counted in `gicp_covariances.launches`; none for N = 0)
    or raise. Nothing is read back.
    """
    dev = keys.device
    if dev.type == "cpu":
        return gicp_covariances_plain(keys, points, order, mask)
    if dev.type != "cuda":
        raise ValueError(f"gicp_covariances: unsupported device {dev}")
    N = keys.shape[0] if keys.dim() == 1 else -1
    _check("gicp_covariances", dev, keys=(keys, (N,), torch.int32),
           points=(points, (N, 3), torch.float32), order=(order, (N,), torch.int64),
           mask=(mask, (N,), torch.bool))
    covs = torch.empty((N, 3, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((N,), dtype=torch.bool, device=dev)
    if N:
        lib = load_library()
        _raise_on(lib.lgs_gicp_covariances(
            keys.data_ptr(), points.data_ptr(), order.data_ptr(), mask.data_ptr(), N,
            covs.data_ptr(), ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "gicp_covariances")
        _count(gicp_covariances)
    return covs, ok


def _table_args(dims) -> list:
    """The C entries' table arguments: its cells (dx, dy, dz) and `unpack_key`'s shifts
    and masks."""
    dx, dy, dz = (int(x) for x in dims)
    if min(dx, dy, dz) < 1 or dx * dy * dz >= 2**31:
        raise ValueError(f"dense table: dims must be positive with fewer than 2**31 cells, "
                         f"got {dims}")
    return [dx, dy, dz, _BITS_Y + _BITS_Z, _BITS_Z, COORD_MAX[1], COORD_MAX[2]]


def _check_rows(wrapper: str, n: int) -> None:
    if n >= 2**31 - 1:
        raise ValueError(f"{wrapper}: a row index must fit the int32 table, got N = {n}")


def dense_table(keys, row_valid, dims=TABLE_DIMS):
    """A dense cell table in one clear and one launch: for each of the prod(dims) cells,
    the smallest index among the rows that are `row_valid` and whose unpacked key lies in
    that cell inside `dims`, -1 where there is none.

    keys:      [N] i32 packed cell keys, in any order, repeats allowed
    row_valid: [N] bool
    Returns table [prod(dims)] i32, as `ops/voxel.py:build_dense_table_plain`, bit for bit
    on the card.

    CPU tensors take `build_dense_table_plain`; CUDA tensors clear the table on the
    current stream and launch the `dense_table` kernel (`csrc/grid.cu`, counted in
    `dense_table.launches`; no launch for N = 0, only the clear) or raise. Nothing is read
    back.
    """
    dev = keys.device
    if dev.type == "cpu":
        return build_dense_table_plain(keys, row_valid, dims)
    if dev.type != "cuda":
        raise ValueError(f"dense_table: unsupported device {dev}")
    N = keys.shape[0] if keys.dim() == 1 else -1
    _check("dense_table", dev, keys=(keys, (N,), torch.int32),
           row_valid=(row_valid, (N,), torch.bool))
    _check_rows("dense_table", N)
    table_args = _table_args(dims)
    table = torch.empty((table_args[0] * table_args[1] * table_args[2],), dtype=torch.int32,
                        device=dev)
    lib = load_library()
    _raise_on(lib.lgs_dense_table(keys.data_ptr(), row_valid.data_ptr(), N, *table_args,
                                  table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
              "dense_table")
    if N:
        _count(dense_table)
    return table


def grid_rows(keys_sorted, points_sorted):
    """What `build_hash_grid` makes from the rows sorted by cell, in one clear and one
    launch: each row's first row of its run of equal keys, the packed rows and the dense
    table of the runs' first valid rows.

    keys_sorted:   [N] i32 ascending cell keys (INVALID_KEY rows last)
    points_sorted: [N, 3] f32 in the keys' order
    Returns (starts [N] i64, packed [N, 4] f32: x, y, z and the key's bits, table
    [prod(TABLE_DIMS)] i32), as `ops/neighbors.py:grid_rows_plain`, bit for bit on the
    card. The keys must ascend, as the sort leaves them: `starts` is each row's lower
    bound among them.

    CPU tensors take `grid_rows_plain`; CUDA tensors clear the table on the current
    stream and launch the `grid_rows` kernel (`csrc/grid.cu`, counted in
    `grid_rows.launches`; no launch for N = 0, only the clear) or raise. Nothing is read
    back.
    """
    dev = keys_sorted.device
    if dev.type == "cpu":
        return grid_rows_plain(keys_sorted, points_sorted)
    if dev.type != "cuda":
        raise ValueError(f"grid_rows: unsupported device {dev}")
    N = keys_sorted.shape[0] if keys_sorted.dim() == 1 else -1
    _check("grid_rows", dev, keys_sorted=(keys_sorted, (N,), torch.int32),
           points_sorted=(points_sorted, (N, 3), torch.float32))
    _check_rows("grid_rows", N)
    starts = torch.empty((N,), dtype=torch.int64, device=dev)
    packed = torch.empty((N, 4), dtype=torch.float32, device=dev)
    table = torch.empty((_TABLE_SIZE,), dtype=torch.int32, device=dev)
    lib = load_library()
    _raise_on(lib.lgs_grid_rows(keys_sorted.data_ptr(), points_sorted.data_ptr(), N,
                                *_table_args(TABLE_DIMS), starts.data_ptr(), packed.data_ptr(),
                                table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
              "grid_rows")
    if N:
        _count(grid_rows)
    return starts, packed, table


def _pass_blocks(n: int) -> int:
    """Blocks of a launch of `csrc/prefilter_pass.cu` over n rows: SOR_SUM_ROWS rows a
    block, at least one."""
    return max(1, -(-n // SOR_SUM_ROWS))


def cell_keys(points, mask, leaf, bounds=None):
    """Each valid row's packed cell key at `leaf`, relative to origin = the valid rows'
    minimum corner less one leaf.

    points: [N, 3] f32; mask: [N] bool; leaf: 0-d f32 (read on the device)
    bounds: None, or a `voxel.KeyFilter` (the prefilter's distance filter and crop), which
            drops rows from `mask` first
    Returns (keys [N] i32: INVALID_KEY where not valid, origin [3] f32), with `bounds`
    also (the kept mask [N] bool, the points [N, 3] f32 with the dropped rows at
    PAD_VALUE), as `ops/voxel.py:cell_keys_plain`, bit for bit on the card.

    CPU tensors take `cell_keys_plain`; CUDA tensors launch the `cell_corner` kernel and
    `cell_keys_pair`, a programmatic dependent of it (`csrc/prefilter_pass.cu`, counted in
    `cell_keys.launches`) or raise. Nothing is read back.
    """
    dev = points.device
    if dev.type == "cpu":
        return cell_keys_plain(points, mask, leaf, bounds)
    if dev.type != "cuda":
        raise ValueError(f"cell_keys: unsupported device {dev}")
    N = points.shape[0] if points.dim() == 2 else -1
    if not isinstance(leaf, torch.Tensor):
        raise ValueError("cell_keys: leaf must be a 0-d float32 tensor on the card")
    _check("cell_keys", dev, points=(points, (N, 3), torch.float32),
           mask=(mask, (N,), torch.bool), leaf=(leaf, (), torch.float32))
    _check_rows("cell_keys", N)
    keys = torch.empty((N,), dtype=torch.int32, device=dev)
    origin = torch.empty((3,), dtype=torch.float32, device=dev)
    partials = torch.empty((3 * _pass_blocks(N),), dtype=torch.float32, device=dev)
    kept = padded = None
    filt = (0.0, 0.0, 0, 0) + (0.0,) * 6
    if bounds is not None:
        filt = bounds.kernel_args()
        kept = torch.empty((N,), dtype=torch.bool, device=dev)
        padded = torch.empty((N, 3), dtype=torch.float32, device=dev)
    lib = load_library()
    _raise_on(lib.lgs_cell_keys(
        points.data_ptr(), mask.data_ptr(), N, int(bounds is not None), *filt,
        leaf.data_ptr(), _BITS_Y + _BITS_Z, _BITS_Z, *COORD_MAX, partials.data_ptr(),
        None if kept is None else kept.data_ptr(),
        None if padded is None else padded.data_ptr(), keys.data_ptr(), origin.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "cell_keys")
    _count(cell_keys, 2)
    return (keys, origin) if bounds is None else (keys, origin, kept, padded)


def sorted_runs(keys_sorted, order=None, points=None, capacity=None):
    """What follows a sort by key: with `points`, the sorted points; with `capacity` = C,
    the runs of equal valid keys as `_sorted_runs` gives them and their count.

    keys_sorted: [N] i32 ascending (INVALID_KEY rows last)
    order:       [N] i64, the sort's permutation (with `points`)
    points:      [N, 3] f32 or None
    capacity:    C >= 0 or None
    Returns (pts_sorted [N, 3] f32 = points[order] or None, runs or None), runs =
    (starts [C+1] i64, lengths [C+1] i64, num_voxels 0-d i64): row r < C is the r-th run,
    empty past the last; row C holds the invalid rows and every run past C. Without
    `capacity`, the rows whose key is INVALID_KEY are parked at PAD_VALUE (the SOR's cell
    sort). As `ops/voxel.py:sorted_runs_plain`, bit for bit on the card.

    CPU tensors take `sorted_runs_plain`; CUDA tensors launch, with `capacity`, the
    `runs_record` kernel and `runs_write`, a programmatic dependent of it, or without it
    the `gather_pad` kernel (`csrc/prefilter_pass.cu`, counted in `sorted_runs.launches`;
    no launch for the gather alone at N = 0) or raise. Nothing is read back.
    """
    dev = keys_sorted.device
    if dev.type == "cpu":
        return sorted_runs_plain(keys_sorted, order, points, capacity)
    if dev.type != "cuda":
        raise ValueError(f"sorted_runs: unsupported device {dev}")
    if points is None and capacity is None:
        raise ValueError("sorted_runs: give points, capacity or both")
    N = keys_sorted.shape[0] if keys_sorted.dim() == 1 else -1
    _check("sorted_runs", dev, keys_sorted=(keys_sorted, (N,), torch.int32))
    _check_rows("sorted_runs", N)
    pts_sorted = runs = None
    args = [None, None, None]
    if points is not None:
        _check("sorted_runs", dev, order=(order, (N,), torch.int64),
               points=(points, (N, 3), torch.float32))
        pts_sorted = torch.empty((N, 3), dtype=torch.float32, device=dev)
        args = [order.data_ptr(), points.data_ptr(), pts_sorted.data_ptr()]
    C, rec, launches = -1, None, int(N > 0)
    if capacity is not None:
        C = int(capacity)
        if C < 0:
            raise ValueError(f"sorted_runs: capacity must be >= 0, got {capacity}")
        runs = (torch.empty((C + 1,), dtype=torch.int64, device=dev),
                torch.empty((C + 1,), dtype=torch.int64, device=dev),
                torch.empty((), dtype=torch.int64, device=dev))
        rec = torch.empty((3 * _pass_blocks(N),), dtype=torch.int32, device=dev)
        launches = 2
    lib = load_library()
    _raise_on(lib.lgs_sorted_runs(
        keys_sorted.data_ptr(), args[0], args[1], N, C, args[2],
        None if rec is None else rec.data_ptr(),
        *(None,) * 3 if runs is None else (t.data_ptr() for t in runs),
        torch.cuda.current_stream(dev).cuda_stream), "sorted_runs")
    if launches:
        _count(sorted_runs, launches)
    return pts_sorted, runs


def sor_threshold(mean_d, n_found, mask, points, stddev_mult):
    """The statistical outlier filter after its window statistics, in three launches
    (mu's sums, the variance's, the mask): the rows that `mask` keeps with 2 or more
    neighbours contribute; a row is kept where `mask`, 2 or more neighbours and mean_d <=
    mu + stddev_mult * sigma, the sums in a fixed order (a tree over each block's
    SOR_SUM_ROWS rows, then the blocks in index order).

    mean_d: [N] f32; n_found: [N] i64 (`sor_window_stats`, the original row order)
    mask: [N] bool; points: [N, 3] f32; stddev_mult: 0-d f32 (read on the device)
    Returns (kept [N] bool, points [N, 3] f32 with the other rows at PAD_VALUE), as
    `ops/neighbors.py:sor_threshold_plain`, bit for bit on the card.

    CPU tensors take `sor_threshold_plain`; CUDA tensors launch the `sor_threshold`
    kernel's three passes (`csrc/prefilter_pass.cu`, counted in `sor_threshold.launches`;
    none for N = 0) or raise. Nothing is read back.
    """
    dev = mean_d.device
    if dev.type == "cpu":
        return sor_threshold_plain(mean_d, n_found, mask, points, stddev_mult)
    if dev.type != "cuda":
        raise ValueError(f"sor_threshold: unsupported device {dev}")
    N = mean_d.shape[0] if mean_d.dim() == 1 else -1
    if not isinstance(stddev_mult, torch.Tensor):
        raise ValueError("sor_threshold: stddev_mult must be a 0-d float32 tensor on the card")
    _check("sor_threshold", dev, mean_d=(mean_d, (N,), torch.float32),
           n_found=(n_found, (N,), torch.int64), mask=(mask, (N,), torch.bool),
           points=(points, (N, 3), torch.float32),
           stddev_mult=(stddev_mult, (), torch.float32))
    _check_rows("sor_threshold", N)
    kept = torch.empty((N,), dtype=torch.bool, device=dev)
    padded = torch.empty((N, 3), dtype=torch.float32, device=dev)
    if N:
        blocks = _pass_blocks(N)
        partials = torch.empty((2 * blocks,), dtype=torch.float32, device=dev)
        counts = torch.empty((blocks,), dtype=torch.int32, device=dev)
        lib = load_library()
        _raise_on(lib.lgs_sor_threshold(
            mean_d.data_ptr(), n_found.data_ptr(), mask.data_ptr(), points.data_ptr(), N,
            stddev_mult.data_ptr(), partials.data_ptr(), counts.data_ptr(), kept.data_ptr(),
            padded.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "sor_threshold")
        _count(sor_threshold, 3)
    return kept, padded


def compact_rows(points, mask, capacity: int):
    """A stable compaction in two launches (each block's valid rows counted, then the
    counts scanned and the rows scattered): the valid rows to the front in their order,
    the first `capacity` of them kept, the other rows PAD_VALUE and False.

    points: [N, 3] f32; mask: [N] bool; capacity >= 0
    Returns (points [min(N, capacity), 3] f32, mask [min(N, capacity)] bool), as
    `core/pointcloud.py:compact_rows_plain` (a stable argsort of the inverted mask and its
    gathers), bit for bit on the card.

    CPU tensors take `compact_rows_plain`; CUDA tensors launch the `compact_count` and
    `compact_write` kernels (`csrc/prefilter_pass.cu`, counted in
    `compact_rows.launches`; none for N = 0) or raise. Nothing is read back.
    """
    dev = points.device
    if dev.type == "cpu":
        return compact_rows_plain(points, mask, capacity)
    if dev.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {dev}")
    N = points.shape[0] if points.dim() == 2 else -1
    _check("compact_rows", dev, points=(points, (N, 3), torch.float32),
           mask=(mask, (N,), torch.bool))
    _check_rows("compact_rows", N)
    if int(capacity) < 0:
        raise ValueError(f"compact_rows: capacity must be >= 0, got {capacity}")
    rows = min(N, int(capacity))
    out = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    out_mask = torch.empty((rows,), dtype=torch.bool, device=dev)
    if N:
        rec = torch.empty((_pass_blocks(N),), dtype=torch.int32, device=dev)
        lib = load_library()
        _raise_on(lib.lgs_compact_rows(
            points.data_ptr(), mask.data_ptr(), N, rows, rec.data_ptr(), out.data_ptr(),
            out_mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "compact_rows")
        _count(compact_rows, 2)
    return out, out_mask


def loop_kernel_attributes(device, gicp=None, icp=None) -> dict:
    """The NDT loop kernel's registers per thread, shared memory bytes a block and local
    memory bytes per thread (`cudaFuncGetAttributes`), its tile of source points a block,
    and the SMs of the CUDA `device` with the kernel's resident blocks per SM there; with
    `gicp` = (neighborhood, bucket_cap, reciprocal), those of that GICP loop kernel (its
    shared memory with its stage) and the runs of B rows its stage holds (`stage_runs`);
    with `icp` = (neighborhood, bucket_cap, fitness), those of `icp_iteration` (fitness 0)
    or `icp_fitness` (1)."""
    out = (ctypes.c_int * 4)()
    lib = load_library()
    if icp is not None:
        err = lib.lgs_icp_loop_attributes(*map(int, icp), out)
    elif gicp is not None:
        err = lib.lgs_gicp_loop_attributes(*map(int, gicp), out)
    else:
        err = lib.lgs_ndt_loop_attributes(out)
    _raise_on(err, "loop_kernel_attributes")
    sms, per_sm = _loop_occupancy(device, gicp, icp)
    extra = {} if gicp is None and icp is None else {"stage_runs": out[3]}
    return dict(registers=out[0], smem_bytes=out[1], local_bytes=out[2],
                tile=_consts["loop_tile"], sms=sms, blocks_per_sm=per_sm, **extra)


_WORKED = {"ndt_iteration": "lgs_ndt_worked_launches",
           "gicp_iteration": "lgs_gicp_worked_launches",
           "icp_iteration": "lgs_icp_worked_launches"}


def worked_launches(reset: bool = False, kernel: str | None = None) -> int:
    """The loop kernels' launches (`ndt_iteration` single and batched, one per sequence of
    a batch, `gicp_iteration` and `icp_iteration`) that did work rather than exit on a
    finished carry, since the last reset, on the current card: the kernels' sum, or with
    `kernel` one of those names, that kernel's (`reset` then resets only its count).
    Synchronizes the whole device: for measurement only, never on a hot path."""
    if kernel is not None and kernel not in _WORKED:
        raise ValueError(f"worked_launches: kernel must be one of {tuple(_WORKED)}")
    lib = load_library()
    total = 0
    for name, fn in _WORKED.items():
        if kernel in (None, name):
            n = getattr(lib, fn)(int(reset))
            if n < 0:
                _raise_on(-n, "worked_launches")
            total += n
    return total


ndt_accumulate.launches = 0
ndt_direct7_accumulate.launches = 0
ndt_direct7_accumulate_batched.launches = 0
ndt_align_loop.launches = 0
ndt_align_loop_batched.launches = 0
gicp_align_loop.launches = 0
icp_align_loop.launches = 0
icp_fitness.launches = 0
ndt_finalize.launches = 0
eigh3x3.launches = 0
voxel_centroids.launches = 0
sor_window_stats.launches = 0
gicp_covariances.launches = 0
dense_table.launches = 0
grid_rows.launches = 0
cell_keys.launches = 0
sorted_runs.launches = 0
sor_threshold.launches = 0
compact_rows.launches = 0
