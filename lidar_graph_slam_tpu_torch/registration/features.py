"""FPFH features + vectorized-RANSAC global registration.

Port of `lidar_graph_slam_tpu/registration/features.py`: the coarse, basin-free stage
whose result feeds the loop verifier as its initial guess
(`GraphSlamConfig.use_global_init`).

  * Normals and FPFH neighborhoods come from the sorted-grid kNN (`ops/neighbors.py`).
  * The 33-bin FPFH histograms are one-hot comparisons and masked sums over fixed [Q, k]
    neighbor index arrays.
  * Feature matching is one [Q, M] squared-distance matrix from one matrix product, under
    the package's full-float32 pin (`__init__.py`): the distances cancel
    (|f|^2 - 2 f.g + |g|^2 on L1-normalised vectors), so a TF32 product would change the
    ratio test and the mutual check. The matrix is updated in place for the second-best
    pass, so one copy of it is alive at a time (256 MiB at 8,192 x 8,192).
  * RANSAC is not a sequential loop: H hypotheses are drawn, solved (batched 3-point
    Kabsch via SVD), edge-length-checked and scored together, then the winner is refined
    by masked inlier Kabsch. Shapes are fixed and this module reads nothing back to
    the host; on a CUDA device `torch.linalg.svd` reads its own status there, so each
    `_kabsch` call is a point at which the calling thread waits for the device.

Random draws: the reference draws from a threefry key, which PyTorch cannot reproduce.
`ransac_align` draws from an explicit `torch.Generator` on the tensors' device
(`floor(rand * n_valid)`, which needs no host read of the data-dependent bound);
`ransac_align_from_draws` takes the draws as tensors, so a test can feed it the
reference's. Two calls with one seed on one device give bit-identical results; the CPU
and a CUDA card draw different streams.
"""

from __future__ import annotations

import math

import torch

from lidar_graph_slam_tpu_torch.ops.neighbors import HashGrid, build_hash_grid, knn
from lidar_graph_slam_tpu_torch.ops.voxel import (
    INVALID_KEY,
    TABLE_DIMS,
    _eigh3x3,
    _flat_table_index,
    as_f32,
    build_dense_table,
    min_corner,
    pack_key,
    voxel_coords,
    voxel_downsample,
)


def estimate_normals(grid: HashGrid, queries: torch.Tensor, qmask: torch.Tensor, k: int = 16,
                     viewpoint=None, bucket_cap: int = 16):
    """Per-query surface normals from the k-NN covariance's smallest eigenvector.

    Orientation follows PCL: flipped toward `viewpoint` (default origin — the sensor
    position for a sensor-frame cloud). Returns (normals [Q, 3], valid [Q]). A row whose
    normal is perpendicular to the view ray within rounding may flip the other way in
    another implementation of the same arithmetic."""
    idx, _, nvalid = knn(grid, queries, k=k, bucket_cap=bucket_cap)
    nbrs = grid.points[idx]                                   # [Q, k, 3]
    w = nvalid.to(queries.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)           # [Q, 1]
    mu = torch.sum(nbrs * w, dim=1) / cnt
    d = (nbrs - mu[:, None, :]) * w
    cov = torch.einsum("qki,qkj->qij", d, d) / cnt[..., None]
    # Guard degenerate rows so the eigensolve stays well-posed.
    ok = qmask & (torch.sum(nvalid, dim=1) >= 3)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    cov = torch.where(ok[:, None, None], cov, eye)
    _, vecs = _eigh3x3(cov)
    n = vecs[..., 0]                                          # smallest-eigenvalue column
    if viewpoint is None:
        vp = torch.zeros(3, dtype=queries.dtype, device=queries.device)
    else:
        vp = torch.as_tensor(viewpoint, dtype=queries.dtype, device=queries.device)
    flip = torch.sum(n * (vp[None, :] - queries), dim=-1) < 0.0
    n = torch.where(flip[:, None], -n, n)
    return n, ok


def _bin_index(x: torch.Tensor, lo: float, hi: float, bins: int) -> torch.Tensor:
    f = (x - lo) / (hi - lo)
    return torch.clamp((f * bins).to(torch.int32), 0, bins - 1)


def _histogram(bin_idx: torch.Tensor, weight: torch.Tensor, bins: int) -> torch.Tensor:
    """Weighted histogram over the last axis: bin_idx/weight [Q, k] -> [Q, bins]."""
    edges = torch.arange(bins, dtype=torch.int32, device=bin_idx.device)
    onehot = (bin_idx[..., None] == edges).to(weight.dtype)   # [Q, k, bins]
    return torch.sum(onehot * weight[..., None], dim=-2)


def _pair_features(p, n_p, q, n_q, eps=1e-12):
    """Darboux-frame angular features (alpha, phi, theta) and distance for point pairs.

    p, n_p: [..., 3] source point/normal; q, n_q: [..., 3] neighbor point/normal. The
    frame keeps the fixed (p, q) ordering — consistent across both clouds, which is all
    matching needs."""
    d = q - p
    dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=eps))
    dn = d / dist[..., None]
    u = n_p.expand_as(dn)
    v = torch.linalg.cross(dn, u, dim=-1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = torch.sum(v * n_q, dim=-1)                 # [-1, 1]
    phi = torch.sum(u * dn, dim=-1)                    # [-1, 1]
    theta = torch.atan2(torch.sum(w * n_q, dim=-1), torch.sum(u * n_q, dim=-1))
    return alpha, phi, theta, dist


def compute_fpfh(grid: HashGrid, points: torch.Tensor, mask: torch.Tensor,
                 normals: torch.Tensor, k: int = 16, bins: int = 11, bucket_cap: int = 16):
    """Fast Point Feature Histograms [Rusu 2009] for a keypoint cloud.

    `grid` must be built over `points` (self-neighborhoods). Returns ([Q, 3*bins]
    L1-normalized histograms, valid [Q]). SPFH is computed per point over its k
    neighbors, then FPFH(p) = SPFH(p) + mean_j( SPFH(q_j) / dist_j ). A pair whose
    feature lies within rounding of a bin edge may fall into the next bin in another
    implementation of the same arithmetic."""
    q = points.shape[0]
    idx, d2, nvalid = knn(grid, points, k=k, bucket_cap=bucket_cap)
    # Drop self-matches (distance ~ 0).
    nvalid = nvalid & (d2 > 1e-12) & mask[:, None]
    nbr_pts = grid.points[idx]                               # [Q, k, 3]
    # Neighbor normals: grid rows are sorted copies of `points`; map back via grid.order.
    nbr_nrm = normals[grid.order][idx]                       # [Q, k, 3]

    alpha, phi, theta, _dist = _pair_features(
        points[:, None, :], normals[:, None, :], nbr_pts, nbr_nrm)
    wgt = nvalid.to(points.dtype)
    h_a = _histogram(_bin_index(alpha, -1.0, 1.0, bins), wgt, bins)
    h_p = _histogram(_bin_index(phi, -1.0, 1.0, bins), wgt, bins)
    h_t = _histogram(_bin_index(theta, -math.pi, math.pi, bins), wgt, bins)
    spfh = torch.cat([h_a, h_p, h_t], dim=-1)                # [Q, 3*bins]
    cnt = torch.clamp(torch.sum(wgt, dim=-1, keepdim=True), min=1.0)
    spfh = spfh / cnt                                        # per-point normalized SPFH

    # FPFH aggregation: gather neighbors' SPFH (sorted-row indexing again).
    nbr_spfh = spfh[grid.order][idx]                         # [Q, k, 3*bins]
    inv_d = torch.where(nvalid, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-12)), 0.0)
    agg = torch.sum(nbr_spfh * inv_d[..., None], dim=1) / torch.clamp(
        torch.sum(inv_d, dim=1, keepdim=True), min=1e-12)
    fpfh = spfh + agg
    # L1-normalize each sub-histogram block (scale invariance across densities).
    blocks = fpfh.reshape(q, 3, bins)
    blocks = blocks / torch.clamp(torch.sum(blocks, dim=-1, keepdim=True), min=1e-12)
    valid = mask & (torch.sum(nvalid, dim=-1) >= 3)
    return torch.where(valid[:, None], blocks.reshape(q, 3 * bins), 0.0), valid


def match_features(f_src, src_valid, f_tgt, tgt_valid, ratio: float = 0.85):
    """Mutual-nearest correspondence in feature space with a Lowe ratio test.

    Returns (match_idx [Q] into target rows, match_ok [Q]). The ratio test (best /
    second-best feature distance < `ratio`) rejects ambiguous matches from repeated
    structure (ground planes, parallel walls). `argmin` takes the first minimum, as the
    reference's does; a near-tie can still resolve differently under another rounding of
    the product."""
    d2 = torch.sum(f_src * f_src, dim=-1)[:, None] - 2.0 * (f_src @ f_tgt.T)
    d2 += torch.sum(f_tgt * f_tgt, dim=-1)[None, :]
    d2.masked_fill_(~tgt_valid[None, :], torch.inf)
    d2.masked_fill_(~src_valid[:, None], torch.inf)
    best, fwd = torch.min(d2, dim=1)                          # [Q]
    bwd = torch.argmin(d2, dim=0)                             # [M]
    # Second-best: mask the winning column per row (in place), take the min again.
    d2.scatter_(1, fwd[:, None], torch.inf)
    second = torch.amin(d2, dim=1)
    distinct = best < (ratio * ratio) * second                # squared distances
    mutual = bwd[fwd] == torch.arange(f_src.shape[0], device=f_src.device)
    ok = src_valid & mutual & distinct & torch.isfinite(best)
    return fwd, ok


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors (elementwise: no LU launch per batch)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _kabsch(src, tgt, w):
    """Weighted rigid alignment src -> tgt. src/tgt [..., P, 3], w [..., P] >= 0.

    The SVD's U and V are unique only up to paired signs (and arbitrary for a degenerate
    S: collinear triples, zero weights), so only R and t compare across implementations,
    and only for rows the caller keeps."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.einsum("...p,...pi->...i", wn, src)
    mu_t = torch.einsum("...p,...pi->...i", wn, tgt)
    S = torch.einsum("...p,...pi,...pj->...ij", wn, src - mu_s[..., None, :],
                     tgt - mu_t[..., None, :])
    U, _, Vt = torch.linalg.svd(S)
    det = _det3(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, D, U)  # V diag(D) U^T
    t = mu_t - torch.einsum("...ij,...j->...i", R, mu_s)
    return _make_T(R, t)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def ransac_align_from_draws(
    src_kp, src_valid, tgt_kp, tgt_valid, match_idx, match_ok, pos, pos1=None,
    src_normals=None, tgt_normals=None, inlier_threshold: float = 1.0,
    occupancy_leaf: float = 2.0, edge_similarity: float = 0.9, min_occupancy: float = 0.3,
):
    """`ransac_align` with the random draws given: `pos` [H, 3] and `pos1` [H] are
    positions in [0, max(n_valid, 1)) among the valid correspondences (compacted to the
    front in row order). `pos1` and both normals arrays are needed for the 1-point yaw
    family. Returns (T [4,4], occupancy_hits i32, ok bool, diag)."""
    hypotheses = pos.shape[0]
    dev, dtype = src_kp.device, src_kp.dtype
    tgt_of_src = tgt_kp[match_idx]                            # [Q, 3]

    # Occupancy table over target keypoints.
    leaf = as_f32(occupancy_leaf, src_kp)
    inv_leaf = 1.0 / leaf
    origin = min_corner(tgt_kp, tgt_valid) - leaf
    tkeys = pack_key(voxel_coords(tgt_kp, origin, inv_leaf))
    table = build_dense_table(torch.where(tgt_valid, tkeys, INVALID_KEY), tgt_valid, TABLE_DIMS)
    occupied = torch.cat([table >= 0, torch.zeros(1, dtype=torch.bool, device=dev)])

    def occupancy_score(T_batch):
        """Hits for [B, 4, 4] transforms: count of valid src keypoints in occupied cells."""
        p = torch.einsum("bij,qj->bqi", T_batch[:, :3, :3], src_kp) + T_batch[:, None, :3, 3]
        flat, in_range = _flat_table_index(voxel_coords(p, origin, inv_leaf), TABLE_DIMS)
        hit = occupied[flat.long()] & in_range & src_valid
        return torch.sum(hit, dim=-1, dtype=torch.int32)

    # 3 VALID correspondence rows per hypothesis: valid rows compacted to the front
    # (stable argsort of ~ok), positions drawn in [0, n_valid) — every draw is a real
    # correspondence, so the hypothesis yield doesn't collapse when matches are sparse.
    order = torch.argsort(torch.logical_not(match_ok).to(torch.int8), stable=True)
    n_valid = torch.sum(match_ok.to(torch.int32))
    samp = order[pos.long()]                                  # [H, 3]
    s3 = src_kp[samp]                                         # [H, 3, 3]
    t3 = tgt_of_src[samp]
    s_ok = torch.all(match_ok[samp], dim=-1) & (n_valid >= 3)

    # Edge-length similarity prefilter (Open3D's edge-length checker): each triangle side
    # must match across clouds within `edge_similarity`.
    def edges(x):
        return torch.stack([_norm(x[:, 0] - x[:, 1]), _norm(x[:, 1] - x[:, 2]),
                            _norm(x[:, 2] - x[:, 0])], dim=-1)

    es, et = edges(s3), edges(t3)
    lo = torch.minimum(es, et)
    hi = torch.maximum(es, et)
    shape_ok = torch.all(lo > edge_similarity * hi, dim=-1) & torch.all(hi > 1e-3, dim=-1)

    T_h = _kabsch(s3, t3, torch.ones((hypotheses, 3), dtype=dtype, device=dev))  # [H, 4, 4]
    h_ok = s_ok & shape_ok
    h_ok_3pt = h_ok  # pre-merge view for the family-yield diagnostics below
    yaw_ok = torch.zeros(hypotheses, dtype=torch.bool, device=dev)
    second_half = torch.zeros(hypotheses, dtype=torch.bool, device=dev)

    if src_normals is not None and tgt_normals is not None:
        # 1-point yaw family: replace the second half of the hypothesis buffer.
        r1 = order[pos1.long()]                                # [H]
        p_h = src_kp[r1]
        q_h = tgt_of_src[r1]
        np_h = src_normals[r1]
        nq_h = tgt_normals[match_idx[r1]]
        # Azimuth difference of the normals' horizontal components fixes the yaw;
        # near-vertical normals (ground) leave it undefined -> hypothesis voided.
        horiz_ok = (_norm(np_h[:, :2]) > 0.2) & (_norm(nq_h[:, :2]) > 0.2)
        theta = torch.atan2(nq_h[:, 1], nq_h[:, 0]) - torch.atan2(np_h[:, 1], np_h[:, 0])
        c, s = torch.cos(theta), torch.sin(theta)
        zero = torch.zeros_like(c)
        one = torch.ones_like(c)
        Rz = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                         dim=-1).reshape(hypotheses, 3, 3)
        t_yaw = q_h - torch.einsum("hij,hj->hi", Rz, p_h)
        T_yaw = _make_T(Rz, t_yaw)
        yaw_ok = match_ok[r1] & horiz_ok & (n_valid >= 1)
        second_half = torch.arange(hypotheses, device=dev) >= hypotheses // 2
        T_h = torch.where(second_half[:, None, None], T_yaw, T_h)
        h_ok = torch.where(second_half, yaw_ok, h_ok)

    score = occupancy_score(T_h) * h_ok
    best = torch.argmax(score)  # the first maximum, as the reference's argmax
    T_best = T_h[best]

    # Refine: two rounds of inlier-masked Kabsch over the feature correspondences (they
    # polish the pose once it is roughly right), kept only if occupancy agrees.
    T_ref = T_best
    for _ in range(2):
        src_t = src_kp @ T_ref[:3, :3].T + T_ref[:3, 3]
        r2 = torch.sum((src_t - tgt_of_src) ** 2, dim=-1)
        w = ((r2 < inlier_threshold * inlier_threshold) & match_ok).to(dtype)
        T_new = _kabsch(src_kp, tgt_of_src, w)
        T_ref = torch.where(torch.sum(w) >= 3, T_new, T_ref)

    keep_refined = occupancy_score(T_ref[None])[0] >= score[best]
    T_out = torch.where(keep_refined, T_ref, T_best)
    hits = occupancy_score(T_out[None])[0]
    n_src = torch.clamp(torch.sum(src_valid.to(torch.int32)), min=1)
    ok = (score[best] > 0) & (hits >= (min_occupancy * n_src).to(torch.int32))
    # Family-yield diagnostics: with normals, the 3-point family is halved to
    # hypotheses/2 in favor of 1-point-yaw — report each family's valid-hypothesis count
    # and which family won, so a starved budget is visible.
    diag = {
        "n_3pt_valid": torch.sum((h_ok_3pt & ~second_half).to(torch.int32)),
        "n_yaw_valid": torch.sum((yaw_ok & second_half).to(torch.int32)),
        "best_is_yaw": second_half[best],
    }
    return T_out, hits, ok, diag


def _draw_positions(generator: torch.Generator, shape, n_valid: torch.Tensor) -> torch.Tensor:
    """Uniform positions in [0, max(n_valid, 1)) from `generator`, bound on the device:
    `torch.randint` would need the bound as a Python number, a host read per call."""
    hi = torch.clamp(n_valid, min=1)
    u = torch.rand(shape, generator=generator, device=n_valid.device, dtype=torch.float32)
    return torch.minimum(torch.floor(u * hi).to(torch.int64), (hi - 1).to(torch.int64))


def ransac_align(
    src_kp, src_valid, tgt_kp, tgt_valid, match_idx, match_ok, generator: torch.Generator,
    src_normals=None, tgt_normals=None, hypotheses: int = 1024,
    inlier_threshold: float = 1.0, occupancy_leaf: float = 2.0,
    edge_similarity: float = 0.9, min_occupancy: float = 0.3,
):
    """Global alignment: feature matches generate hypotheses, voxel occupancy scores them.

    src_kp [Q, 3], tgt_kp [M, 3], match_idx/match_ok from `match_features`; `generator`
    is a `torch.Generator` on the tensors' device. Returns (T [4,4], occupancy_hits i32,
    ok bool, diag).

    Scoring is deliberately correspondence-FREE: a hypothesis is judged by how many valid
    source keypoints land in target-occupied voxels (DIRECT1 lookup at `occupancy_leaf`),
    not by feature-match agreement. Feature matching on sparse or repetitive scenes yields
    few trustworthy pairs — enough to *propose* a pose, far too few to *rank* poses.

    Two proposal families run half-and-half (when normals are given):
      * 3-point Kabsch triples — full SE(3), needs THREE correct matches (rate^3);
      * 1-point yaw — one correct match + the normal-azimuth difference fixes a
        gravity-aligned pose (rate^1). On non-gravity-aligned worlds these simply score
        low and lose the argmax — the scorer arbitrates, no prior is imposed."""
    n_valid = torch.sum(match_ok.to(torch.int32))
    pos = _draw_positions(generator, (hypotheses, 3), n_valid)
    pos1 = None
    if src_normals is not None and tgt_normals is not None:
        pos1 = _draw_positions(generator, (hypotheses,), n_valid)
    return ransac_align_from_draws(
        src_kp, src_valid, tgt_kp, tgt_valid, match_idx, match_ok, pos, pos1,
        src_normals=src_normals, tgt_normals=tgt_normals,
        inlier_threshold=inlier_threshold, occupancy_leaf=occupancy_leaf,
        edge_similarity=edge_similarity, min_occupancy=min_occupancy)


def keypoint_features(points, mask, keypoint_leaf: float, normal_k: int, fpfh_k: int,
                      max_keypoints: int, viewpoint=None):
    """One cloud's side of `global_register`: voxel keypoints, their normals and FPFH.
    Returns (keypoints [Q,3], mask [Q], feature-valid [Q], features [Q,33], normals)."""
    g = voxel_downsample(points, mask, keypoint_leaf, capacity=max_keypoints)
    grid = build_hash_grid(g.points, g.mask, 2.0 * keypoint_leaf)
    nrm, n_ok = estimate_normals(grid, g.points, g.mask, k=normal_k, viewpoint=viewpoint)
    feats, f_ok = compute_fpfh(grid, g.points, g.mask, nrm, k=fpfh_k)
    return g.points, g.mask, n_ok & f_ok, feats, nrm


def global_register(
    src_points, src_mask, tgt_points, tgt_mask, keypoint_leaf: float = 1.0,
    normal_k: int = 16, fpfh_k: int = 32, hypotheses: int = 2048,
    inlier_threshold: float = 1.0, min_occupancy: float = 0.5, max_keypoints: int = 8192,
    src_viewpoint=None, tgt_viewpoint=None, seed: int = 0, return_diag: bool = False,
):
    """FPFH + RANSAC coarse registration of two masked clouds: (T src->tgt, hits, ok),
    on the device the clouds live on.

    The output feeds the ICP/GICP/NDT loop verifier as its initial guess where drift
    exceeds the verifier's basin. `ok` requires a `min_occupancy` fraction of valid source
    keypoints to land in target-occupied voxels. The hypotheses are drawn from a
    generator on the clouds' device, seeded with `seed`. Pass `return_diag=True` for a
    4th element: the RANSAC family-yield diagnostics (3-point vs 1-point-yaw valid counts
    and the winning family). All outputs are tensors and the caller reads none back, but
    on a CUDA device `torch.linalg.svd` (three calls in `ransac_align`) reads its status
    on the host, so the calling thread waits for the device there."""
    generator = torch.Generator(device=src_points.device)
    generator.manual_seed(seed)
    s_kp, s_m, s_ok, s_f, s_n = keypoint_features(
        src_points, src_mask, keypoint_leaf, normal_k, fpfh_k, max_keypoints, src_viewpoint)
    t_kp, t_m, t_ok, t_f, t_n = keypoint_features(
        tgt_points, tgt_mask, keypoint_leaf, normal_k, fpfh_k, max_keypoints, tgt_viewpoint)
    m_idx, m_ok = match_features(s_f, s_ok, t_f, t_ok)
    T, hits, ok, diag = ransac_align(
        s_kp, s_m, t_kp, t_m, m_idx, m_ok, generator,
        src_normals=s_n, tgt_normals=t_n,
        hypotheses=hypotheses, inlier_threshold=inlier_threshold,
        occupancy_leaf=2.0 * keypoint_leaf, min_occupancy=min_occupancy,
    )
    if return_diag:
        return T, hits, ok, diag
    return T, hits, ok
