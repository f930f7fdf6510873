"""Voxel-grid ops: centroid downsampling and NDT voxel-Gaussian construction.

Port of `lidar_graph_slam_tpu/ops/voxel.py`. Points are keyed by integer voxel
coordinates packed into one monotone int32, stably sorted, and reduced per voxel over
the sorted runs; NDT's DIRECT7 lookup indexes a dense cell table directly.

Determinism: the per-voxel sums add each run's rows in order on every device — no float
`index_add_` / `scatter_add_` atomics, whose order (and so whose map) would change from run
to run and feed FP-level noise into the odometry loop
(`lidar_graph_slam_tpu/odometry/fused.py` docstring). The dense table is an integer
min, whose result does not depend on order.

An NDT map level goes from its rows sorted by voxel key to its finished rows through
`ops/kernels.py:ndt_finalize`: one hand-written kernel launch on the card that sums the
runs itself, `ndt_finalize_plain` on the CPU (the run sums by `torch.segment_reduce` over
the run lengths, then `_finalize_ndt_plain`, the reference's arithmetic op for op);
`kernels.eigh3x3` serves `_eigh3x3` to the FPFH normals the same way (GICP's covariances
run it inside `kernels.gicp_covariances`, the product in `_scaled_gram`'s order). The
centroid downsample (`voxel_downsample`) goes from its sorted rows to its centroids through
`kernels.voxel_centroids` (one launch on the card; on the CPU `voxel_centroids_plain`, the
run sums by `torch.segment_reduce`). Every sort by key (`_key_sort`: the downsample, the
map's fine level, and through `ops/neighbors.py` the hash grid and the SOR's cells) takes
its keys from `kernels.cell_keys` (`cell_keys_plain`: the minimum corner, `voxel_coords`,
`pack_key`; optionally the prefilter's distance filter first) and what follows the sort
from `kernels.sorted_runs` (`sorted_runs_plain`: the gather and `_sorted_runs`), two
launches each on the card. A dense cell table (`build_dense_table`: every NDT
map level, the RANSAC occupancy table) is `kernels.dense_table` (one clear and one launch
on the card; `build_dense_table_plain`, the reference's scatter-min, on the CPU).
`ops/kernels.py` imports this module, so the map builders, the downsample and the table
import it inside.

Key packing uses (11, 11, 8) bits for (x, y, z) relative to the batch min corner; out-of-
range points clamp to border cells. Key arithmetic stays in float32 tensors, as the
reference's does (`1.0 / leaf` in f32, not in Python f64), so border points get the
reference's keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, pad_points

_BITS_X, _BITS_Y, _BITS_Z = 11, 11, 8
_NX, _NY, _NZ = 1 << _BITS_X, 1 << _BITS_Y, 1 << _BITS_Z
COORD_MAX = (_NX - 1, _NY - 1, _NZ - 1)  # largest packable voxel coordinate per axis
INVALID_KEY = 2**31 - 1
_INT32_MIN = -(2**31)

# Dense lookup-table dims (cells): (256, 256, 64) cells cover 512 m x 512 m x 128 m at NDT
# resolution 2.0 and cost 16 MB of int32 device memory.
TABLE_DIMS = (256, 256, 64)


def as_f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on `like`'s device (scalar arguments become tensors so the
    arithmetic on them is float32, as in the reference). A number is filled on the
    device, not copied from the host, so it costs no host-device sync."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=like.device)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


_CONSTS: dict = {}


def const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor, made once per device (a fresh `torch.tensor(..., device=)`
    would copy from pageable host memory and sync the stream on every call)."""
    key = (values, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def unpack_key(key: torch.Tensor):
    """Inverse of pack_key: int32 key -> (cx, cy, cz)."""
    cx = key >> (_BITS_Y + _BITS_Z)
    cy = (key >> _BITS_Z) & (_NY - 1)
    cz = key & (_NZ - 1)
    return cx, cy, cz


def _flat_table_index(coords: torch.Tensor, dims):
    """Coords [..., 3] -> (flat index into the dense table, in-range mask)."""
    dx, dy, dz = dims
    in_range = (
        (coords[..., 0] >= 0) & (coords[..., 0] < dx)
        & (coords[..., 1] >= 0) & (coords[..., 1] < dy)
        & (coords[..., 2] >= 0) & (coords[..., 2] < dz)
    )
    flat = (coords[..., 0] * dy + coords[..., 1]) * dz + coords[..., 2]
    return torch.where(in_range, flat, dx * dy * dz), in_range


def build_dense_table_plain(keys: torch.Tensor, row_valid: torch.Tensor, dims) -> torch.Tensor:
    """Plain version of the `dense_table` kernel (`ops/kernels.py`): scatter row indices
    into a dense [prod(dims)] int32 table (-1 = empty).

    Rows with row_valid=False (or out of table range) park in an overflow slot that is
    cut off. When several rows share a cell, the FIRST row wins via scatter-min.
    """
    dx, dy, dz = dims
    size = dx * dy * dz
    coords = torch.stack(unpack_key(keys), dim=-1)
    flat, in_range = _flat_table_index(coords, dims)
    flat = torch.where(row_valid & in_range, flat, size)
    n = keys.shape[0]
    table = torch.full((size + 1,), INVALID_KEY, dtype=torch.int32, device=keys.device)
    table.scatter_reduce_(0, flat.long(), torch.arange(n, dtype=torch.int32, device=keys.device),
                          reduce="amin", include_self=True)
    table = torch.where(table == INVALID_KEY, -1, table)
    return table[:size]


def build_dense_table(keys: torch.Tensor, row_valid: torch.Tensor, dims) -> torch.Tensor:
    """A dense [prod(dims)] int32 table of each cell's smallest row index among the rows
    that are `row_valid` and whose unpacked key lies inside `dims` (-1 = empty): the
    `dense_table` kernel on the card (one clear and one launch), `build_dense_table_plain`
    on the CPU."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    return kernels.dense_table(keys, row_valid, dims)


def voxel_coords(points: torch.Tensor, origin: torch.Tensor, inv_leaf) -> torch.Tensor:
    """Integer voxel coords [N, 3] relative to `origin`, clamped into the packable range."""
    c = torch.floor((points - origin) * inv_leaf).to(torch.int32)
    hi = const(COORD_MAX, torch.int32, points.device)
    return torch.minimum(torch.clamp(c, min=0), hi)


def pack_key(coords: torch.Tensor) -> torch.Tensor:
    """Pack clamped coords [..., 3] into a single monotone non-negative int32 key."""
    return (
        (coords[..., 0] << (_BITS_Y + _BITS_Z))
        | (coords[..., 1] << _BITS_Z)
        | coords[..., 2]
    )


def min_corner(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Min corner over valid points (padded rows sit at +PAD_VALUE)."""
    return torch.where(mask[:, None], points, PAD_VALUE).amin(dim=0)


def in_range(points: torch.Tensor, min_distance, max_distance=0.0) -> torch.Tensor:
    """The prefilter's distance filter: range > min_distance (and < max_distance when that
    is > 0), the range sqrt((x x + y y) + z z) with the sum in float32 in that order and
    the root taken in float64 and rounded once — the correctly rounded float32 root, as
    the `cell_keys` kernel's `__fsqrt_rn` (the CPU's float32 `torch.sqrt` is not always
    correctly rounded)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(((x * x + y * y) + z * z).double()).float()
    keep = r > min_distance
    if max_distance > 0.0:
        keep = keep & (r < max_distance)
    return keep


def in_box(points: torch.Tensor, min_xyz, max_xyz) -> torch.Tensor:
    """The prefilter's axis-aligned crop box."""
    lo = const(tuple(min_xyz), points.dtype, points.device)
    hi = const(tuple(max_xyz), points.dtype, points.device)
    return torch.all((points >= lo) & (points <= hi), dim=-1)


@dataclass(frozen=True)
class KeyFilter:
    """The prefilter's distance filter and crop, as `cell_keys` applies them to its mask
    before the keys: range > min_distance (and < max_distance when that is > 0) by
    `in_range`, and, when min_xyz is not None, inside [min_xyz, max_xyz] by `in_box`.
    `filters/prefilter.py:filter_bounds` builds it; only `cell_keys_plain` (`keep`) and
    the `cell_keys` kernel wrapper (`kernel_args`) read it."""

    min_distance: float
    max_distance: float = 0.0
    min_xyz: tuple | None = None
    max_xyz: tuple | None = None

    def keep(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """`mask` with the rows the filter drops cleared."""
        mask = mask & in_range(points, self.min_distance, self.max_distance)
        if self.min_xyz is not None:
            mask = mask & in_box(points, self.min_xyz, self.max_xyz)
        return mask

    def kernel_args(self) -> tuple:
        """The kernel's filter arguments: min_distance, max_distance, whether the maximum
        applies, whether the crop does, and the crop's lower and upper corners (zeros
        without it)."""
        crop = self.min_xyz is not None
        corners = (tuple(map(float, self.min_xyz)) + tuple(map(float, self.max_xyz))
                   if crop else (0.0,) * 6)
        return (float(self.min_distance), float(self.max_distance),
                int(self.max_distance > 0.0), int(crop), *corners)


def cell_keys_plain(points: torch.Tensor, mask: torch.Tensor, leaf: torch.Tensor,
                    bounds: KeyFilter | None = None):
    """Plain version of the `cell_keys` kernel (`ops/kernels.py`): each valid row's packed
    cell key at `leaf` (0-d f32) relative to origin = the valid rows' minimum corner less
    one leaf, INVALID_KEY for the other rows. Returns (keys [N] i32, origin [3] f32).

    With `bounds` (a `KeyFilter`) the prefilter's distance filter and crop first drop
    rows from `mask`, the dropped rows parked at PAD_VALUE, and the keys are those of the
    kept rows: (keys, origin, kept mask [N] bool, padded points [N, 3] f32)."""
    if bounds is not None:
        mask = bounds.keep(points, mask)
        points = pad_points(points, mask)
    origin = min_corner(points, mask) - leaf
    keys = torch.where(mask, pack_key(voxel_coords(points, origin, 1.0 / leaf)), INVALID_KEY)
    return (keys, origin) if bounds is None else (keys, origin, mask, points)


def _sorted_runs(keys_sorted: torch.Tensor, capacity: int):
    """Per-row segment ids and per-segment run lengths of a sorted key array.

    Returns (first [N] bool, seg [N] int64 in [0, capacity], lengths [capacity+1] int64,
    starts [capacity+1] int64). Segment `capacity` collects the invalid rows and every
    voxel past `capacity` (the reference drops both through its segment-sum range); it is
    cut off by the callers.
    """
    valid = keys_sorted != INVALID_KEY
    first = torch.cat([valid[:1], (keys_sorted[1:] != keys_sorted[:-1]) & valid[1:]])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    seg = torch.where(valid, seg.clamp(max=capacity), capacity)
    bounds = torch.searchsorted(
        seg, torch.arange(capacity + 2, dtype=torch.int64, device=seg.device))
    return first, seg, bounds[1:] - bounds[:-1], bounds[:-1]


def sorted_runs_plain(keys_sorted: torch.Tensor, order=None, points=None, capacity=None):
    """Plain version of the `sorted_runs` kernel (`ops/kernels.py`): what follows a sort by
    key. With `points` (and `order`, the sort's permutation), pts_sorted = points[order];
    with `capacity` = C, the runs of `_sorted_runs`: (starts [C+1] i64, lengths [C+1] i64,
    num_voxels 0-d i64, the first-of-run rows). Without `capacity` the gather alone,
    rows whose key is INVALID_KEY parked at PAD_VALUE (the SOR's cell sort). Returns
    (pts_sorted or None, runs or None)."""
    if points is None and capacity is None:
        raise ValueError("sorted_runs: give points, capacity or both")
    pts_sorted = None if points is None else points[order]
    if capacity is None:
        return pad_points(pts_sorted, keys_sorted != INVALID_KEY), None
    first, _, lengths, starts = _sorted_runs(keys_sorted, capacity)
    return pts_sorted, (starts, lengths, torch.sum(first.to(torch.int32)))


def _segment_sum(data: torch.Tensor, lengths: torch.Tensor, capacity: int) -> torch.Tensor:
    """Sum each run of sorted rows (rows of a run added in order; empty runs give 0)."""
    out = torch.segment_reduce(data, "sum", lengths=lengths, axis=0, unsafe=True, initial=0.0)
    return out[:capacity]


def _segment_keys(keys_sorted, starts, lengths, capacity: int):
    """The reference's `segment_max` of the keys: every row of a run holds the same key;
    an empty segment gives int32 min, as `segment_max` does."""
    n = keys_sorted.shape[0]
    k = keys_sorted[starts[:capacity].clamp(max=max(n - 1, 0))] if n else torch.zeros(
        capacity, dtype=torch.int32, device=keys_sorted.device)
    return torch.where(lengths[:capacity] > 0, k, _INT32_MIN)


@dataclass
class VoxelGrid:
    """Centroid-downsample result (pcl::VoxelGrid semantics: one centroid per occupied voxel)."""

    points: torch.Tensor      # [capacity, 3] centroids (padded with PAD_VALUE)
    mask: torch.Tensor        # [capacity] bool
    num_voxels: torch.Tensor  # 0-d int32
    overflow: torch.Tensor    # 0-d bool — True if > capacity voxels were occupied


def voxel_centroids_plain(keys_sorted, pts_sorted, starts, lengths, origin, leaf):
    """Plain version of the `voxel_centroids` kernel (`ops/kernels.py`): the centroid of
    each voxel row r < C from the rows sorted by voxel key, the reference's arithmetic op
    for op. keys_sorted [N] i32, pts_sorted [N, 3] f32, starts / lengths [C+1] i64
    (`_sorted_runs`), origin [3] f32, leaf 0-d f32. Returns (points [C, 3] padded with
    PAD_VALUE, mask [C] bool). Occupied rows are a prefix: row r < C has a run exactly
    when r < min(num_voxels, C)."""
    capacity = starts.shape[0] - 1
    valid_sorted = keys_sorted != INVALID_KEY
    # Voxel-local accumulation: centroid sums of raw world coordinates lose precision
    # once |x| >> leaf; local offsets are bounded by the leaf.
    row_coords = torch.stack(unpack_key(torch.where(valid_sorted, keys_sorted, 0)), dim=-1)
    row_corner = origin + row_coords.to(pts_sorted.dtype) * leaf
    cols = torch.cat([valid_sorted.to(pts_sorted.dtype)[:, None],
                      torch.where(valid_sorted[:, None], pts_sorted - row_corner, 0.0)], dim=1)
    stats = _segment_sum(cols, lengths, capacity)
    counts, sums = stats[:, 0], stats[:, 1:4]
    seg_keys = _segment_keys(keys_sorted, starts, lengths, capacity)
    out_mask = lengths[:capacity] > 0
    seg_corner = origin + torch.stack(unpack_key(seg_keys), dim=-1).to(pts_sorted.dtype) * leaf
    centroids = seg_corner + sums / torch.clamp(counts, min=1.0)[:, None]
    return pad_points(centroids, out_mask), out_mask


def _key_sort(points, mask, leaf, capacity: int, bounds=None):
    """One stable sort of a masked cloud by its cell keys at `leaf` (0-d f32), between the
    `cell_keys` and `sorted_runs` kernels of `ops/kernels.py` (their plain versions on the
    CPU): (origin, keys_sorted, pts_sorted, (starts, lengths, num_voxels)). `bounds` is
    `cell_keys`' filter."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    keys, origin, *kept = kernels.cell_keys(points, mask, leaf, bounds)
    if kept:
        mask, points = kept
    keys_sorted, order = torch.sort(keys, stable=True)
    pts_sorted, runs = kernels.sorted_runs(keys_sorted, order, points, capacity)
    return origin, keys_sorted, pts_sorted, runs


def centroid_runs(points: torch.Tensor, mask: torch.Tensor, leaf, capacity: int,
                  bounds=None):
    """The downsample's sort by voxel key and its runs: ((keys_sorted, pts_sorted, starts,
    lengths, origin, leaf), num_voxels), the first being `kernels.voxel_centroids`'
    arguments. `bounds` is `cell_keys`' filter (the prefilter's distance filter)."""
    leaf = as_f32(leaf, points)
    origin, keys_sorted, pts_sorted, (starts, lengths, num_voxels) = _key_sort(
        points, mask, leaf, capacity, bounds)
    return (keys_sorted, pts_sorted, starts, lengths, origin, leaf), num_voxels


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf, capacity: int,
                     bounds=None) -> VoxelGrid:
    """Centroid-per-voxel downsample of a masked cloud into `capacity` output slots: the
    keys and one sort by voxel key (`centroid_runs`; with `bounds`, the prefilter's
    distance filter first, in the keys' kernel), then the centroids by
    `kernels.voxel_centroids` (its kernel on the card, `voxel_centroids_plain` on the
    CPU)."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    runs, num_voxels = centroid_runs(points, mask, leaf, capacity, bounds)
    centroids, out_mask = kernels.voxel_centroids(*runs)
    return VoxelGrid(
        points=centroids,
        mask=out_mask,
        num_voxels=num_voxels,
        overflow=num_voxels > capacity,
    )


@dataclass
class NdtVoxelMap:
    """Sorted voxel-Gaussian map for NDT registration (ndt_omp's TargetGrid equivalent).

    Field names are the reference's (`lidar_graph_slam_tpu/ops/voxel.py:160-179`);
    `utils/state.py` builds one from the reference's arrays. `inv_leaf` is the port's
    own: `1.0 / leaf`, made once with the map, so that `lookup_direct7` and the fused
    NDT kernel take the same float32 for the voxel arithmetic.
    """

    keys: torch.Tensor        # [capacity] int32 sorted, INVALID_KEY padding
    means: torch.Tensor       # [capacity, 3]
    inv_covs: torch.Tensor    # [capacity, 3, 3]
    valid: torch.Tensor       # [capacity] bool (occupied AND >= min_points)
    origin: torch.Tensor      # [3] min corner used for packing
    leaf: torch.Tensor        # 0-d voxel resolution
    num_voxels: torch.Tensor  # 0-d int32
    table: torch.Tensor       # [prod(TABLE_DIMS)] int32 dense cell -> voxel row (-1 empty)
    packed: torch.Tensor      # [capacity, 16] f32: mean(3) | inv_cov row-major(9) | valid | pad
    inv_leaf: torch.Tensor = field(init=False)  # 0-d f32, 1.0 / leaf

    def __post_init__(self):
        self.inv_leaf = 1.0 / self.leaf


def _eigh3x3(A: torch.Tensor):
    """Batched symmetric 3x3 eigendecomposition by fixed-sweep cyclic Jacobi, unrolled to
    elementwise arithmetic on the 6 unique entries (the reference's algorithm, op for op).
    Returns (w [..., 3] ascending, V [..., 3, 3]) with eigenvector COLUMNS."""
    a = {
        (0, 0): A[..., 0, 0], (1, 1): A[..., 1, 1], (2, 2): A[..., 2, 2],
        (0, 1): A[..., 0, 1], (0, 2): A[..., 0, 2], (1, 2): A[..., 1, 2],
    }
    one = torch.ones_like(a[(0, 0)])
    zero = torch.zeros_like(one)
    # V stored column-major: v[j][i] = V[i, j] (column j = j-th eigenvector).
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def key(i, j):
        return (i, j) if i <= j else (j, i)

    for _ in range(6):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            app, aqq, apq = a[(p, p)], a[(q, q)], a[key(p, q)]
            nz = torch.abs(apq) > 0
            tau = (aqq - app) / (2.0 * torch.where(nz, apq, one))
            # Never-zero sign: tau == 0 (equal diagonal entries with nonzero coupling)
            # must take the exact 45-degree rotation t = 1, not t = 0 — torch.sign would
            # discard the off-diagonal mass there.
            sgn = torch.where(tau >= 0, one, -one)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, zero)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            apr, aqr = a[key(p, r)], a[key(q, r)]
            a[(p, p)] = app - t * apq
            a[(q, q)] = aqq + t * apq
            a[key(p, q)] = zero
            a[key(p, r)] = c * apr - s * aqr
            a[key(q, r)] = s * apr + c * aqr
            vp, vq = v[p], v[q]
            v[p] = [c * vp[i] - s * vq[i] for i in range(3)]
            v[q] = [s * vp[i] + c * vq[i] for i in range(3)]

    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]
    # Ascending 3-sort network with paired column swaps — elementwise selects.
    for (i, j) in ((0, 1), (1, 2), (0, 1)):
        swap = w[i] > w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        vi, vj = v[i], v[j]
        v[i] = [torch.where(swap, vj[k], vi[k]) for k in range(3)]
        v[j] = [torch.where(swap, vi[k], vj[k]) for k in range(3)]
    W = torch.stack(w, dim=-1)
    V = torch.stack([torch.stack(col, dim=-1) for col in v], dim=-1)  # [..., i, j]
    return W, V


def _scaled_gram(V: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """V diag(d) V^T for [..., 3, 3] V and [..., 3] d: entry (i, j) is the sum over k =
    0, 1, 2, in that order, of (V[i, k] d[k]) V[j, k], each product and sum rounded once —
    the `ndt_finalize` kernel's order on every device (a batched `@` sums in the order of
    its library: cuBLAS's on the card, another on the CPU)."""
    M = V * d[..., None, :]
    terms = [M[..., :, k, None] * V[..., None, :, k] for k in range(3)]
    return (terms[0] + terms[1]) + terms[2]


def regularize_covariance(cov: torch.Tensor, min_eig_ratio: float = 1e-2):
    """Inflate small eigenvalues to `min_eig_ratio * lambda_max` (ndt_omp-style) and return
    (cov_reg, inv_cov_reg)."""
    w, V = _eigh3x3(cov)
    w_max = torch.clamp(w[..., 2:3], min=1e-9)
    w_reg = torch.maximum(w, min_eig_ratio * w_max)
    return _scaled_gram(V, w_reg), _scaled_gram(V, 1.0 / w_reg)


def _sorted_points(points, mask, resolution, capacity: int):
    """One stable sort of a masked cloud by voxel key (`_key_sort`): (origin, runs,
    pts_sorted, num_voxels), with runs = (keys_sorted [N] i32, starts [capacity+1] i64,
    lengths [capacity+1] i64) of `_sorted_runs`."""
    origin, keys_sorted, pts_sorted, (starts, lengths, num_voxels) = _key_sort(
        points, mask, resolution, capacity)
    return origin, (keys_sorted, starts, lengths), pts_sorted, num_voxels


def _row_corners(keys, origin, resolution):
    """The corner of each key's voxel, origin + coord * resolution, in float32."""
    return origin + torch.stack(unpack_key(keys), dim=-1).to(origin.dtype) * resolution


def _point_moments(runs, pts_sorted, origin, resolution):
    """Each run's raw moments over its sorted points, in VOXEL-LOCAL coordinates (point
    minus its voxel's corner), which bounds every term by O(leaf^2); world-frame float32
    moments cancel catastrophically once |x| >> leaf. Returns (seg_keys [C] i32, stats
    [C, 13] f32: count | sums (3) | outer sums (9, row-major)), each run summed in order
    from 0.0 (`_segment_sum`)."""
    keys_sorted, starts, lengths = runs
    capacity = lengths.shape[0] - 1
    valid_sorted = keys_sorted != INVALID_KEY
    row_corner = _row_corners(torch.where(valid_sorted, keys_sorted, 0), origin, resolution)
    loc = torch.where(valid_sorted[:, None], pts_sorted - row_corner, 0.0)
    outer = (loc[:, :, None] * loc[:, None, :]).reshape(-1, 9)
    cols = torch.cat([valid_sorted.to(pts_sorted.dtype)[:, None], loc, outer], dim=1)
    return (_segment_keys(keys_sorted, starts, lengths, capacity),
            _segment_sum(cols, lengths, capacity))


def _coarse_runs(fine_moments, occupied, factor: int, coarse_capacity: int):
    """The coarse level's runs over the fine map's stat rows: each occupied fine voxel
    keyed by its parent coarse voxel, one stable sort. Returns ((ck_sorted, starts,
    lengths), order [C_f] i64, num_voxels)."""
    seg_keys, stats = fine_moments
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    coords = torch.stack(unpack_key(torch.where(occupied, seg_keys, 0)), dim=-1)
    live = occupied & (stats[:, 0] > 0)
    ckeys = torch.where(live, pack_key(coords // factor), INVALID_KEY)
    ck_sorted, order = torch.sort(ckeys, stable=True)
    _, (starts, lengths, num_voxels) = kernels.sorted_runs(ck_sorted,
                                                           capacity=coarse_capacity)
    return (ck_sorted, starts, lengths), order, num_voxels


def _merged_moments(runs, order, fine_moments, fine_resolution, factor: int):
    """The coarse level's raw moments from the fine level's (`_point_moments`'s layout):
    shifting each fine voxel's local moments by its corner offset inside the parent coarse
    voxel is exact, x_c = x_f + o with o = (child corner - parent corner): sum(x_c) = sum
    + n o, sum(x_c x_c^T) = outer + o sum^T + sum o^T + n o o^T. The shifted rows are
    then summed over the coarse runs (of `_coarse_runs`) in order, as `_point_moments`
    sums points."""
    ck_sorted, starts, lengths = runs
    capacity = lengths.shape[0] - 1
    seg_keys, stats = fine_moments
    counts, sums = stats[:, 0], stats[:, 1:4]
    outer_sums = stats[:, 4:13].reshape(-1, 3, 3)
    # A dead fine row's key is INT32_MIN; its shifted moments sort into the overflow
    # segment with it and are cut off.
    coords = torch.stack(unpack_key(seg_keys), dim=-1)
    off = (coords - (coords // factor) * factor).to(stats.dtype) * fine_resolution  # [C, 3]
    sums_c = sums + counts[:, None] * off
    outer_c = (
        outer_sums
        + off[:, :, None] * sums[:, None, :]
        + sums[:, :, None] * off[:, None, :]
        + counts[:, None, None] * off[:, :, None] * off[:, None, :]
    )
    rows = torch.cat([counts[:, None], sums_c, outer_c.reshape(-1, 9)], dim=1)[order]
    rows = torch.where((ck_sorted != INVALID_KEY)[:, None], rows, 0.0)
    return (_segment_keys(ck_sorted, starts, lengths, capacity),
            _segment_sum(rows, lengths, capacity))


def _finalize_ndt_plain(seg_keys, counts, sums, outer_sums, occupied, origin, resolution,
                        min_points: int):
    """Raw per-voxel moments -> the map's rows (keys, means, inv_covs, valid, packed):
    means and the regularized inverse covariances; voxels with fewer than `min_points`
    points are invalid."""
    dtype, capacity = sums.dtype, sums.shape[0]
    cnt = torch.clamp(counts, min=1.0)[:, None]
    means_local = sums / cnt
    means = _row_corners(seg_keys, origin, resolution) + means_local
    # Sample covariance (ndt_omp divides by n-1); translation-invariant, so local
    # moments give it exactly.
    cov = (
        outer_sums - cnt[..., None] * means_local[:, :, None] * means_local[:, None, :]
    ) / torch.clamp(counts - 1.0, min=1.0)[:, None, None]
    valid = occupied & (counts >= min_points)
    # Only regularize valid voxels; others get identity to keep the eigensolve well-posed.
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    cov_safe = torch.where(valid[:, None, None], cov, eye)
    _, inv_covs = regularize_covariance(cov_safe)

    keys_out = torch.where(occupied, seg_keys, INVALID_KEY)
    means_out = pad_points(means, occupied)
    packed = torch.zeros((capacity, 16), dtype=dtype, device=means.device)
    packed[:, 0:3] = means_out
    packed[:, 3:12] = inv_covs.reshape(capacity, 9)
    packed[:, 12] = valid.to(dtype)
    return keys_out, means_out, inv_covs, valid, packed


def ndt_finalize_plain(runs, origin, resolution, min_points: int, points=None, merge=None):
    """Plain version of the `ndt_finalize` kernel (`ops/kernels.py`): one level of an NDT
    map from its sorted rows. `runs` = (keys_sorted, starts, lengths) over C voxel rows;
    either `points` (pts_sorted [N, 3], the fine level: `_point_moments`) or `merge` =
    (order, fine_moments, fine_resolution, factor) (a coarse level: `_merged_moments`).
    Returns (moments, rows): moments = (seg_keys [C] i32, stats [C, 13] f32) and rows =
    `_finalize_ndt_plain`'s (keys, means, inv_covs, valid, packed). A row is occupied
    where its run is not empty."""
    if (points is None) == (merge is None):
        raise ValueError("ndt_finalize: give exactly one of points and merge")
    if points is not None:
        seg_keys, stats = _point_moments(runs, points, origin, resolution)
    else:
        seg_keys, stats = _merged_moments(runs, *merge)
    C = stats.shape[0]
    rows = _finalize_ndt_plain(seg_keys, stats[:, 0], stats[:, 1:4],
                               stats[:, 4:13].reshape(C, 3, 3), runs[2][:C] > 0, origin,
                               resolution, min_points)
    return (seg_keys, stats), rows


def _voxel_map(rows, origin, resolution, num_voxels) -> NdtVoxelMap:
    """An NdtVoxelMap from a level's finished rows and its dense lookup table."""
    keys, means, inv_covs, valid, packed = rows
    return NdtVoxelMap(
        keys=keys,
        means=means,
        inv_covs=inv_covs,
        valid=valid,
        origin=origin,
        leaf=as_f32(resolution, means),
        num_voxels=num_voxels,
        table=build_dense_table(keys, valid, TABLE_DIMS),
        packed=packed,
    )


def build_ndt_map(points, mask, resolution, capacity: int, min_points: int = 6) -> NdtVoxelMap:
    """Build per-voxel Gaussians (mean + regularized inverse covariance) from a masked
    cloud: one sort (`_sorted_points`), then the run sums and the rows in one
    `kernels.ndt_finalize` (its kernel on the card, `ndt_finalize_plain` on the CPU)."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    resolution = as_f32(resolution, points)
    origin, runs, pts_sorted, num_voxels = _sorted_points(points, mask, resolution, capacity)
    _, rows = kernels.ndt_finalize(runs, origin, resolution, min_points, points=pts_sorted)
    return _voxel_map(rows, origin, resolution, num_voxels)


def build_ndt_pyramid(points, mask, resolution, factor: int, capacity: int,
                      coarse_capacity: int, min_points: int = 6):
    """Build (coarse, fine) NDT maps with ONE pass over the points.

    The fine map is exactly `build_ndt_map(points, mask, resolution, capacity)`. The
    coarse map (leaf = factor * resolution, same origin) merges the fine map's raw voxel
    moments (`_coarse_runs`, `_merged_moments`): one `kernels.ndt_finalize` a level."""
    from lidar_graph_slam_tpu_torch.ops import kernels  # it imports this module

    resolution = as_f32(resolution, points)
    origin, runs, pts_sorted, num_voxels = _sorted_points(points, mask, resolution, capacity)
    fine_moments, rows = kernels.ndt_finalize(runs, origin, resolution, min_points,
                                              points=pts_sorted)
    fine = _voxel_map(rows, origin, resolution, num_voxels)
    occupied = torch.arange(capacity, device=points.device) < torch.clamp(num_voxels,
                                                                          max=capacity)
    cruns, order, cnum = _coarse_runs(fine_moments, occupied, factor, coarse_capacity)
    coarse_resolution = resolution * factor
    _, crows = kernels.ndt_finalize(cruns, origin, coarse_resolution, min_points,
                                    merge=(order, fine_moments, resolution, factor))
    return _voxel_map(crows, origin, coarse_resolution, cnum), fine


# DIRECT7 neighborhood: the voxel containing the point plus its 6 face-adjacent voxels
# (ndt_omp NeighborSearchMethod::DIRECT7).
DIRECT7_OFFSETS = (
    (0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def lookup_direct7(vmap: NdtVoxelMap, query_points: torch.Tensor):
    """For each query point, gather the DIRECT7 neighbor voxels' Gaussians.

    Returns (means [Q, 7, 3], inv_covs [Q, 7, 3, 3], found [Q, 7]): one dense-table
    gather per (query, neighbor), then one packed-row gather.
    """
    q = query_points.shape[0]
    offsets = const(DIRECT7_OFFSETS, torch.int32, query_points.device)
    coords = voxel_coords(query_points, vmap.origin, vmap.inv_leaf)     # [Q, 3]
    ncoords = coords[:, None, :] + offsets[None, :, :]                   # [Q, 7, 3]
    flat, in_range = _flat_table_index(ncoords, TABLE_DIMS)
    # Out-of-range cells index the overflow slot in the reference, which reads -1; here
    # they read any cell and `in_range` drops them — the same hits.
    size = vmap.table.shape[0]
    idx = vmap.table[flat.reshape(-1).clamp(max=size - 1).long()]
    hit = (idx >= 0) & in_range.reshape(-1)
    rows = vmap.packed[idx.clamp(min=0).long()]                          # [Q*7, 16]
    means = rows[:, 0:3].reshape(q, 7, 3)
    icovs = rows[:, 3:12].reshape(q, 7, 3, 3)
    hit = (hit & (rows[:, 12] > 0.5)).reshape(q, 7)
    return means, icovs, hit
