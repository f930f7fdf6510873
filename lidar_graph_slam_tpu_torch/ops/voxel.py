"""Voxel-grid ops: centroid downsampling and NDT voxel-Gaussian construction.

Port of `lidar_graph_slam_tpu/ops/voxel.py`. Points are keyed by integer voxel
coordinates packed into one monotone int32, stably sorted, and reduced per voxel over
the sorted runs; NDT's DIRECT7 lookup indexes a dense cell table directly.

Determinism: the per-voxel sums go through `torch.segment_reduce` over run lengths,
which adds each run's rows in order on every device — no float `index_add_` /
`scatter_add_` atomics, whose order (and so whose map) would change from run to run and
feed FP-level noise into the odometry loop (`lidar_graph_slam_tpu/odometry/fused.py`
docstring). The dense table is an integer scatter-min, whose result does not depend on
order.

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


def build_dense_table(keys: torch.Tensor, row_valid: torch.Tensor, dims) -> torch.Tensor:
    """Scatter row indices into a dense [prod(dims)] int32 table (-1 = empty).

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


def _sort_points(points, mask, origin, inv_leaf):
    keys = pack_key(voxel_coords(points, origin, inv_leaf))
    keys = torch.where(mask, keys, INVALID_KEY)
    keys_sorted, order = torch.sort(keys, stable=True)
    return keys_sorted, points[order]


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf, capacity: int) -> VoxelGrid:
    """Centroid-per-voxel downsample of a masked cloud into `capacity` output slots."""
    leaf = as_f32(leaf, points)
    origin = min_corner(points, mask) - leaf
    keys_sorted, pts_sorted = _sort_points(points, mask, origin, 1.0 / leaf)
    valid_sorted = keys_sorted != INVALID_KEY
    first, _, lengths, starts = _sorted_runs(keys_sorted, capacity)

    # Voxel-local accumulation: centroid sums of raw world coordinates lose precision
    # once |x| >> leaf; local offsets are bounded by the leaf.
    row_coords = torch.stack(unpack_key(torch.where(valid_sorted, keys_sorted, 0)), dim=-1)
    row_corner = origin + row_coords.to(points.dtype) * leaf
    cols = torch.cat([valid_sorted.to(points.dtype)[:, None],
                      torch.where(valid_sorted[:, None], pts_sorted - row_corner, 0.0)], dim=1)
    stats = _segment_sum(cols, lengths, capacity)
    counts, sums = stats[:, 0], stats[:, 1:4]
    seg_keys = _segment_keys(keys_sorted, starts, lengths, capacity)

    num_voxels = torch.sum(first.to(torch.int32))
    out_mask = torch.arange(capacity, device=points.device) < torch.clamp(num_voxels, max=capacity)
    seg_corner = origin + torch.stack(unpack_key(seg_keys), dim=-1).to(points.dtype) * leaf
    centroids = seg_corner + sums / torch.clamp(counts, min=1.0)[:, None]
    return VoxelGrid(
        points=pad_points(centroids, out_mask),
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


def regularize_covariance(cov: torch.Tensor, min_eig_ratio: float = 1e-2):
    """Inflate small eigenvalues to `min_eig_ratio * lambda_max` (ndt_omp-style) and return
    (cov_reg, inv_cov_reg)."""
    w, V = _eigh3x3(cov)
    w_max = torch.clamp(w[..., 2:3], min=1e-9)
    w_reg = torch.maximum(w, min_eig_ratio * w_max)
    Vt = V.transpose(-1, -2)
    cov_reg = (V * w_reg[..., None, :]) @ Vt
    inv = (V * (1.0 / w_reg)[..., None, :]) @ Vt
    return cov_reg, inv


def _sorted_voxel_stats(points, mask, resolution, capacity: int):
    """Per-voxel raw moments via one stable sort: (seg_keys, counts, sums, outer_sums,
    origin, num_voxels, occupied). Moments are accumulated in VOXEL-LOCAL coordinates
    (point minus its voxel's corner), which bounds every term by O(leaf^2); world-frame
    float32 moments cancel catastrophically once |x| >> leaf."""
    origin = min_corner(points, mask) - resolution
    keys_sorted, pts_sorted = _sort_points(points, mask, origin, 1.0 / resolution)
    valid_sorted = keys_sorted != INVALID_KEY
    first, _, lengths, starts = _sorted_runs(keys_sorted, capacity)

    row_coords = torch.stack(unpack_key(torch.where(valid_sorted, keys_sorted, 0)), dim=-1)
    row_corner = origin + row_coords.to(points.dtype) * resolution
    loc = torch.where(valid_sorted[:, None], pts_sorted - row_corner, 0.0)
    outer = (loc[:, :, None] * loc[:, None, :]).reshape(-1, 9)
    cols = torch.cat([valid_sorted.to(points.dtype)[:, None], loc, outer], dim=1)
    stats = _segment_sum(cols, lengths, capacity)
    counts, sums, outer_sums = stats[:, 0], stats[:, 1:4], stats[:, 4:13].reshape(capacity, 3, 3)
    seg_keys = _segment_keys(keys_sorted, starts, lengths, capacity)

    num_voxels = torch.sum(first.to(torch.int32))
    occupied = torch.arange(capacity, device=points.device) < torch.clamp(num_voxels, max=capacity)
    return seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied


def _finalize_ndt(
    seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied,
    resolution, capacity: int, min_points: int, dtype,
) -> NdtVoxelMap:
    """Raw per-voxel moments -> NdtVoxelMap (means, regularized inverse covariances,
    dense lookup table). Voxels with fewer than `min_points` points are invalid."""
    cnt = torch.clamp(counts, min=1.0)[:, None]
    means_local = sums / cnt
    seg_corner = origin + torch.stack(unpack_key(seg_keys), dim=-1).to(dtype) * resolution
    means = seg_corner + means_local
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
    return NdtVoxelMap(
        keys=keys_out,
        means=means_out,
        inv_covs=inv_covs,
        valid=valid,
        origin=origin,
        leaf=as_f32(resolution, means),
        num_voxels=num_voxels,
        table=build_dense_table(keys_out, valid, TABLE_DIMS),
        packed=packed,
    )


def build_ndt_map(points, mask, resolution, capacity: int, min_points: int = 6) -> NdtVoxelMap:
    """Build per-voxel Gaussians (mean + regularized inverse covariance) from a masked
    cloud (see `_sorted_voxel_stats` / `_finalize_ndt` for the numerics)."""
    resolution = as_f32(resolution, points)
    stats = _sorted_voxel_stats(points, mask, resolution, capacity)
    return _finalize_ndt(*stats, resolution, capacity, min_points, points.dtype)


def build_ndt_pyramid(points, mask, resolution, factor: int, capacity: int,
                      coarse_capacity: int, min_points: int = 6):
    """Build (coarse, fine) NDT maps with ONE pass over the points.

    The fine map is exactly `build_ndt_map(points, mask, resolution, capacity)`. The
    coarse map (leaf = factor * resolution, same origin) merges the fine map's raw voxel
    moments: shifting each fine voxel's local moments by its corner offset inside the
    parent coarse voxel is exact, so the merge sorts `capacity` stat rows instead of
    re-sorting every point."""
    dtype = points.dtype
    resolution = as_f32(resolution, points)
    seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied = _sorted_voxel_stats(
        points, mask, resolution, capacity)
    fine = _finalize_ndt(seg_keys, counts, sums, outer_sums, origin, num_voxels, occupied,
                         resolution, capacity, min_points, dtype)

    # Shift fine-local moments to coarse-local: x_c = x_f + o with o = (child corner -
    # parent corner); sum(x_c) = sum + n*o; sum(x_c x_c^T) = outer + o sum^T + sum o^T
    # + n o o^T. Exact in every entry.
    coords = torch.stack(unpack_key(torch.where(occupied, seg_keys, 0)), dim=-1)
    ccoords = coords // factor
    off = (coords - ccoords * factor).to(dtype) * resolution          # [C, 3]
    live = occupied & (counts > 0)
    ckeys = torch.where(live, pack_key(ccoords), INVALID_KEY)
    sums_c = sums + counts[:, None] * off
    outer_c = (
        outer_sums
        + off[:, :, None] * sums[:, None, :]
        + sums[:, :, None] * off[:, None, :]
        + counts[:, None, None] * off[:, :, None] * off[:, None, :]
    )

    # Merge stat rows by coarse key: stable sort, then the sorted run sums.
    ck_s, order = torch.sort(ckeys, stable=True)
    valid_s = ck_s != INVALID_KEY
    rows = torch.cat([counts[:, None], sums_c, outer_c.reshape(capacity, 9)], dim=1)[order]
    first_c, _, lengths, starts = _sorted_runs(ck_s, coarse_capacity)
    stats = _segment_sum(torch.where(valid_s[:, None], rows, 0.0), lengths, coarse_capacity)
    ccounts, csums = stats[:, 0], stats[:, 1:4]
    couters = stats[:, 4:13].reshape(coarse_capacity, 3, 3)
    cseg_keys = _segment_keys(ck_s, starts, lengths, coarse_capacity)
    cnum = torch.sum(first_c.to(torch.int32))
    coccupied = torch.arange(coarse_capacity, device=points.device) < torch.clamp(
        cnum, max=coarse_capacity)
    coarse = _finalize_ndt(cseg_keys, ccounts, csums, couters, origin, cnum, coccupied,
                           resolution * factor, coarse_capacity, min_points, dtype)
    return coarse, fine


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
