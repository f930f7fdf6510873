"""The GICP loop on the device (`ops.kernels.gicp_align_loop`, the port of the reference's
`lax.while_loop` in `registration/gicp.py:gicp_align`) through its plain PyTorch version
on the CPU; the kernel itself (`gicp_iteration`, `csrc/gicp_loop.cu`) is tested on a card
by `tests/test_torch_cuda.py`.

- The plain loop run to `max_iterations` with its carry frozen after `done` (what the
  kernel loop does on the card) equals the early-stop run bit for bit in all five carry
  fields.
- `gicp_align` and `make_gicp_matcher`'s align make one loop call an alignment.
- The frozen plain loop against the JAX `gicp_align` on the fixtures of
  `tests/test_torch_gicp.py` (the reference's and the port's own target and
  covariances; reciprocal off and on; the max-iterations stop; a source with no match):
  the transform to atol 1e-4, iterations and converged equal, inliers within 1%, fitness
  to rtol 1e-3 — the bounds `tests/test_torch_gicp.py` holds `gicp_align` to.
- One launch's carry update (`gicp_carry_update`: the step in the kernel's last block)
  against a float64 numpy oracle of the JAX body's step: T to rtol 1e-5 / atol 1e-6,
  fitness to rtol 1e-6, done, iterations and inliers exact; the inlier floor of 6, a
  singular system and a step far past NDT's cap (GICP takes it whole).
- The wrapper takes the plain version for CPU tensors, and refuses other devices and a
  `neighborhood` or `bucket_cap` the kernel does not take.
- A plain model of the kernel's staged grid-NN query (`staged_nearest`: a tile's runs
  de-duplicated and copied into a stage, runs past the stage read from the grid's rows,
  each point's cells walked in flat order eight slots at a time until a batch leaves the
  cell, a strict-less merge) bit-equal to the plain `nearest` (idx, d2 and found), and
  equal to the JAX `nearest` (idx and found exact, d2 to rtol 1e-6, as
  `tests/test_torch_icp.py` holds the plain one), at C 7/27 and B 16/32: tiles that lie
  in one cell, tiles whose runs overflow a small stage, and planted ties (equal d2 in
  two cells and in two slots of one cell, where the lower flat index must win).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.ops import neighbors as jnb
from lidar_graph_slam_tpu.registration import gicp as jgicp
from lidar_graph_slam_tpu_torch.core.config import GicpConfig as TGicpConfig
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
from lidar_graph_slam_tpu_torch.ops.voxel import (
    TABLE_DIMS,
    _flat_table_index,
    pack_key,
    voxel_coords,
)
from lidar_graph_slam_tpu_torch.registration import gicp as tgicp
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult
from lidar_graph_slam_tpu_torch.utils.state import gicp_target_from_numpy, hash_grid_from_numpy
from tests.test_registration import perturbation
from tests.test_torch_gicp import (  # noqa: F401  (fixtures)
    GICP_CASES,
    _assert_results_close,
    _moved,
    _t,
    _target_arrays,
    gicp_problem,
    one_intra_op_thread,
    scans,
)
from tests.test_torch_ndt_loop import _oracle_se3_exp, _singular_h, _spd

FIELDS = ("T", "done", "iterations", "fitness", "inliers")


def _source(g, case: str):
    """(source points, source covariances as the reference takes them, T_true, whether
    the covariances are rotated with the cloud) of a `GICP_CASES` case, or of "no_match":
    the reciprocal_off source 500 m away."""
    c = GICP_CASES["reciprocal_off" if case == "no_match" else case]
    T_true = perturbation(seed=c["seed"], rot=c["rot"], trans=c["trans"])
    src = _moved(g["spts"], g["smask"], T_true)
    R = T_true[:3, :3]
    jcovs = np.einsum("ij,njk,lk->nil", R, g["jc"], R) if c["rotate_covs"] else g["jc"]
    if case == "no_match":
        src = (src + np.float32(500.0)).astype(np.float32)
    return src, jcovs.astype(np.float32), T_true, c["rotate_covs"]


def _loop_args(g, src, covs, target, max_iterations, reciprocal=False,
               transform_epsilon=0.01):
    src_t, mask_t = _t(src, g["smask"])
    grid = tnb.build_hash_grid(src_t, mask_t, 2.0) if reciprocal else None
    return (target, src_t, mask_t, torch.as_tensor(covs), torch.eye(4), 4.0,
            transform_epsilon, torch.tensor(1e-6), max_iterations, 32, 7, grid)


def _result(carry, max_iterations) -> RegistrationResult:
    """The loop's carry as `gicp_align` returns it."""
    T, done, iters, fitness, n_inl = carry
    converged = (done | (iters >= max_iterations)) & (n_inl >= 6) & torch.isfinite(T).all()
    return RegistrationResult(transform=T, converged=converged, iterations=iters,
                              fitness=fitness, num_inliers=n_inl)


# (case, reciprocal, max_iterations, transform_epsilon): the last two never converge by
# epsilon (the max-iterations stop) or find nothing to match.
FROZEN_CASES = [("recover", False, 16, 0.01), ("reciprocal_on", True, 16, 0.01),
                ("reciprocal_off", False, 2, 1e-12), ("no_match", False, 16, 0.01)]


@pytest.mark.parametrize("case,reciprocal,max_iterations,eps", FROZEN_CASES,
                         ids=[c[0] + ("-2" if c[2] == 2 else "") for c in FROZEN_CASES])
def test_frozen_loop_equals_early_stop(gicp_problem, case, reciprocal, max_iterations, eps):
    g = gicp_problem
    src, covs, *_ = _source(g, case)
    args = _loop_args(g, src, torch.as_tensor(covs), g["tt"], max_iterations, reciprocal, eps)
    early = tk.gicp_align_loop_plain(*args, stop_early=True)
    frozen = tk.gicp_align_loop_plain(*args, stop_early=False)
    for name, a, b in zip(FIELDS, early, frozen):
        assert torch.equal(a, b), name
    iters, done = int(early[2]), bool(early[1])
    if max_iterations == 2:
        assert iters == 2 and not done
    else:
        assert done and 0 < iters < max_iterations
    if case == "no_match":
        assert iters == 1 and int(early[4]) == 0
        assert torch.equal(early[0], torch.eye(4))


@pytest.mark.parametrize("use_reciprocal", [False, True])
def test_gicp_align_makes_one_loop_call(gicp_problem, monkeypatch, use_reciprocal):
    """`gicp_align` through `make_gicp_matcher`'s align (which builds the source grid when
    reciprocal) is one `gicp_align_loop` call with the configured gate, epsilon,
    iterations and query, and returns that call's carry."""
    g = gicp_problem
    src, *_ = _source(g, "reciprocal_off")
    calls = []
    loop = tk.gicp_align_loop
    monkeypatch.setattr(tk, "gicp_align_loop",
                        lambda *a: calls.append(a) or loop(*a))
    cfg = TGicpConfig(use_reciprocal=use_reciprocal)
    _, align = tgicp.make_gicp_matcher(cfg)
    res = align(g["tt"], *_t(src, g["smask"]), torch.eye(4), g["tc"])
    assert len(calls) == 1
    a = calls[0]
    assert a[5] == cfg.max_correspondence_distance ** 2
    assert (a[6], a[8], a[9], a[10]) == (cfg.transform_epsilon, cfg.max_iterations, 32, 7)
    assert (a[11] is not None) == use_reciprocal
    assert bool(res.converged) and int(res.num_inliers) > 1000
    want = tk.gicp_align_loop_plain(*a)
    for name, x, y in zip(FIELDS, (res.transform, None, res.iterations, res.fitness,
                                   res.num_inliers), want):
        if x is not None:
            assert torch.equal(x, y), name


# case -> (GICP_CASES source, reciprocal, max_iterations, transform_epsilon)
REFERENCE_CASES = {
    "recover": ("recover", False, 16, 0.01),
    "reciprocal_off": ("reciprocal_off", False, 16, 0.01),
    "reciprocal_on": ("reciprocal_on", True, 16, 0.01),
    "max_iterations_1": ("reciprocal_off", False, 1, 1e-12),
    "no_match": ("no_match", False, 16, 0.01),
}


@pytest.mark.parametrize("inputs", ["reference", "own"])
@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_frozen_plain_loop_matches_reference(gicp_problem, case, inputs):
    g = gicp_problem
    source, reciprocal, max_iterations, eps = REFERENCE_CASES[case]
    src, jcovs, T_true, rotate_covs = _source(g, source)
    kw = dict(max_correspondence_distance=2.0, max_iterations=max_iterations,
              transform_epsilon=eps)
    if reciprocal:
        kw.update(reciprocal=True, source_grid=jnb.build_hash_grid(
            jnp.asarray(src), jnp.asarray(g["smask"]), 2.0))
    j = jgicp.gicp_align(g["jt"], jnp.asarray(src), jnp.asarray(g["smask"]), jnp.eye(4),
                         jnp.asarray(jcovs), **kw)
    if inputs == "reference":
        target, covs = gicp_target_from_numpy(_target_arrays(g["jt"])), torch.as_tensor(jcovs)
    else:
        target = g["tt"]
        Rt = torch.as_tensor(np.array(T_true[:3, :3]))
        covs = Rt @ g["tc"] @ Rt.T if rotate_covs else g["tc"]
    carry = tk.gicp_align_loop_plain(
        *_loop_args(g, src, covs, target, max_iterations, reciprocal, eps), stop_early=False)
    t = _result(carry, max_iterations)
    _assert_results_close(t, j)
    if case == "no_match":
        assert int(t.num_inliers) == int(j.num_inliers) == 0
        assert not bool(t.converged) and int(t.iterations) == 1
        np.testing.assert_array_equal(t.transform.numpy(), np.eye(4, dtype=np.float32))
        return
    assert bool(t.converged) and int(t.num_inliers) > 1000
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-3)
    if case == "max_iterations_1":
        assert int(t.iterations) == 1 and not bool(carry[1])
    else:
        err = t.transform.numpy() @ T_true  # the perturbation is undone
        assert np.linalg.norm(err[:3, 3]) < 0.1


# -- one launch's carry update against a float64 oracle of the reference's step ------------


def _oracle_step(H, g, n_hit, d2_sum, carry, eps):
    """The reference body's step (`registration/gicp.py:169-178`) in float64 after the
    damped system is formed in float32, as both packages form it. Returns the next carry,
    as the kernel's launch updates it."""
    T, done, iters, fitness, inliers = carry
    if done:
        return carry
    H32 = H.astype(np.float32)
    scale = np.maximum(np.trace(H32) / np.float32(6), np.float32(1e-12))
    A = (H32 + np.float32(1e-6) * scale * np.eye(6, dtype=np.float32)).astype(np.float64)
    try:
        delta = np.linalg.solve(A, -g.astype(np.float64))
    except np.linalg.LinAlgError:
        delta = np.full(6, np.nan)
    n_inliers = int(n_hit)
    if not (np.isfinite(delta).all() and n_inliers >= 6):
        delta = np.zeros(6)
    T_new = _oracle_se3_exp(delta) @ T
    fit = d2_sum / max(n_inliers, 1)
    return T_new, bool(np.sqrt(delta @ delta) < eps), iters + 1, fit, n_inliers


# name -> (H, g, n_hit): a plain step, one of |delta| = 1.4 (fourteen times NDT's default
# cap of 0.1: GICP takes it whole), a singular system, 5 and 6 inliers (either side of the floor),
# and a twist with theta^2 < 1e-8 (the Taylor branch).
def _step_cases(rng):
    return {
        "plain": (_spd(rng, 50.0), rng.normal(size=6), 900.0),
        "uncapped": (_spd(rng, 5.0), 5.0 * rng.normal(size=6), 900.0),
        "singular": (_singular_h(), rng.normal(size=6), 900.0),
        "five_inliers": (_spd(rng, 50.0), rng.normal(size=6), 5.0),
        "six_inliers": (_spd(rng, 50.0), rng.normal(size=6), 6.0),
        "small_twist": (100.0 * np.eye(6), 1e-4 * rng.normal(size=6), 12.0),
    }


@pytest.mark.parametrize("done", [False, True], ids=["live", "frozen"])
@pytest.mark.parametrize("case", ["plain", "uncapped", "singular", "five_inliers",
                                  "six_inliers", "small_twist"])
def test_carry_update_matches_float64_oracle(case, done):
    rng = np.random.default_rng(11)
    H, g, n_hit = _step_cases(rng)[case]
    c, s = np.cos(0.3), np.sin(0.3)
    T = np.array([[c, -s, 0, 4.0], [s, c, 0, -2.0], [0, 0, 1, 0.5], [0, 0, 0, 1]])
    d2_sum = 37.5
    want = _oracle_step(H, g, n_hit, d2_sum, (T, done, 5, 0.25, 700), 0.01)
    sums = (torch.tensor(H, dtype=torch.float32), torch.tensor(g, dtype=torch.float32),
            torch.tensor(n_hit, dtype=torch.float32), torch.tensor(n_hit, dtype=torch.float32),
            torch.tensor(d2_sum, dtype=torch.float32), torch.tensor(n_hit, dtype=torch.float32))
    carry = (torch.tensor(T, dtype=torch.float32), torch.tensor(done),
             torch.tensor(5, dtype=torch.int32), torch.tensor(0.25),
             torch.tensor(700, dtype=torch.int32))
    got = tk.gicp_carry_update(sums, carry, 0.01, torch.tensor(1e-6))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-6)
    assert bool(got[1]) == bool(want[1])
    assert int(got[2]) == want[2]
    np.testing.assert_allclose(float(got[3]), want[3], rtol=1e-6)
    assert int(got[4]) == want[4]
    if done:
        assert all(torch.equal(a, b) for a, b in zip(got, carry))
        return
    zeroed = case in ("singular", "five_inliers")
    assert torch.equal(got[0], carry[0]) == zeroed
    assert bool(got[1]) or not zeroed  # a zeroed step is done
    if case == "uncapped":
        step = np.linalg.solve(H, -g)
        assert np.linalg.norm(step) > 0.5  # NDT's cap (0.1) would have scaled it down
    if case == "small_twist":
        omega = np.linalg.solve(H, -g)[:3]
        assert 0 < omega @ omega < 1e-8


# -- the wrapper ---------------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_cpu(gicp_problem):
    g = gicp_problem
    src, covs, *_ = _source(g, "reciprocal_on")
    args = _loop_args(g, src, torch.as_tensor(covs), g["tt"], 8, reciprocal=True)
    before = (tk.gicp_align_loop.launches, tk.thread_launches())
    got = tk.gicp_align_loop(*args)
    want = tk.gicp_align_loop_plain(*args)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    assert (tk.gicp_align_loop.launches, tk.thread_launches()) == before


def test_wrapper_refuses_other_devices_and_unsupported_queries(gicp_problem):
    g = gicp_problem
    src, covs, *_ = _source(g, "reciprocal_off")
    args = list(_loop_args(g, src, torch.as_tensor(covs), g["tt"], 8))
    meta = list(args)
    meta[1] = torch.empty(args[1].shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tk.gicp_align_loop(*meta)
    for i, bad, word in ((9, 8, "bucket_cap"), (9, 64, "bucket_cap"), (10, 9, "neighborhood"),
                         (10, 1, "neighborhood")):
        with pytest.raises(ValueError, match=word):
            tk.gicp_align_loop(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError, match="kernel must be one of"):
        tk.worked_launches(kernel="ndt_finalize")


@pytest.mark.parametrize("neighborhood,bucket_cap", [(7, 16), (27, 32)])
def test_other_queries_take_the_plain_version_on_cpu(gicp_problem, neighborhood, bucket_cap):
    """The kernel's other instantiations (16-row buckets, the 27-cell ring) on the CPU:
    the plain loop with that query, which undoes the perturbation as the default does."""
    g = gicp_problem
    src, covs, T_true, _ = _source(g, "reciprocal_off")
    args = list(_loop_args(g, src, torch.as_tensor(covs), g["tt"], 16))
    args[9], args[10] = bucket_cap, neighborhood
    got = tk.gicp_align_loop(*args)
    want = tk.gicp_align_loop_plain(*args)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    assert bool(got[1]) and int(got[4]) > 1000
    err = got[0].numpy() @ T_true
    assert np.linalg.norm(err[:3, 3]) < 0.1


# -- the kernel's staged grid-NN query, modelled in plain PyTorch --------------------------

STAGE_TILE = 128  # points a block of the kernel takes at once
STAGE_BATCH = 8   # slots a thread evaluates at once


def _face_gap(o: int, k, p, org, cell):
    """The kernel's `face_gap`: the least distance along one axis from p to the rows of
    the neighbour cell at offset o of p's cell k, less a margin for float32 rounding."""
    if o == 0:
        return torch.zeros_like(p)
    face = org + (k + 1 if o > 0 else k).to(torch.float32) * cell
    margin = 1e-3 + 1e-5 * (torch.abs(org) + (k + 1).to(torch.float32) * cell)
    gap = (face - margin) - p if o > 0 else p - (face + margin)
    return torch.clamp(gap, min=0.0)


def _scan_cells(rows, p, key, walking, flat0):
    """The kernel's `scan_run` for one cell of each query: the B slots of its run `rows`
    [P, B, 4] from the cell's table start, STAGE_BATCH at a time while the query walks (a
    slot counts if its key is the cell's; the walk ends after a batch whose last slot is
    not the cell's), each batch's first minimum by a left-biased tree. Returns the least
    (d2, flat) of each query, flat = flat0 + the slot, or (+inf, flat0)."""
    q, B = rows.shape[0], rows.shape[1]
    best = torch.full((q,), torch.inf)
    flat = flat0.clone()
    for s in range(0, B, STAGE_BATCH):
        v = rows[:, s:s + STAGE_BATCH]
        diff = v[..., :3] - p[:, None, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        same = v[..., 3].contiguous().view(torch.int32) == key[:, None]
        d = torch.where(same, d2, torch.inf)
        at = torch.arange(STAGE_BATCH).expand(q, -1).clone()
        w = 1
        while w < STAGE_BATCH:
            for i in range(0, STAGE_BATCH - w, 2 * w):
                right = d[:, i + w] < d[:, i]
                d[:, i] = torch.where(right, d[:, i + w], d[:, i])
                at[:, i] = torch.where(right, at[:, i + w], at[:, i])
            w *= 2
        take = walking & ((d[:, 0] < best) | ((d[:, 0] == best) & (flat0 + s + at[:, 0] < flat)))
        best = torch.where(take, d[:, 0], best)
        flat = torch.where(take, flat0 + s + at[:, 0], flat)
        walking = walking & same[:, -1]
    return best, flat


def staged_nearest(grid, queries, bucket_cap: int, neighborhood: int, stage_runs: int):
    """The GICP loop kernel's grid-NN query (`stage_nearest`, `csrc/gicp_loop.cu`) in
    plain PyTorch. Per tile of STAGE_TILE queries: each query's C table starts, the
    tile's distinct runs (B rows from a table start; rows past the grid's end are no
    cell's), the first `stage_runs` of them copied into a stage, any other read from the
    grid's rows. Each query scans its own cell (`_scan_cells`), then the neighbour cells
    whose face bound does not exceed that cell's best; the least (d2, flat index) over
    them, flat = c B + the slot of the plain version's run (from the start clamped to
    [0, n - B]). Returns (idx, d2, found) as `nearest` does (a miss takes the first
    cell's clamped start, `nearest`'s convention; the kernel reads no row of a miss) and
    counts: the runs a tile names, the (query, cell) pairs scanned from the stage and
    from the rows, the neighbour pairs skipped by their bound, and the starts that the
    plain version clamps."""
    B, C = bucket_cap, neighborhood
    n, size = grid.packed.shape[0], grid.table.shape[0]
    inv = 1.0 / grid.cell_size
    cell = 1.0 / inv
    base = voxel_coords(queries, grid.origin, inv)
    offsets = tnb._offsets_for(C, queries.device)
    nc = base[:, None, :] + offsets
    flat, in_range = _flat_table_index(nc, TABLE_DIMS)
    start = torch.where(in_range, grid.table[flat.clamp(max=size - 1).long()], -1).long()
    key = pack_key(nc.clamp(min=0))
    lo = start - start.clamp(0, n - B)  # the table start's slot in the plain version's run
    slots = torch.arange(B)
    padded = torch.cat([grid.packed, torch.tensor([[0.0, 0.0, 0.0, -1.0]]).expand(B, -1)])
    padded[n:, 3] = torch.tensor(-1, dtype=torch.int32).view(torch.float32)
    q = queries.shape[0]
    best = torch.full((q,), torch.inf)
    bflat = torch.zeros(q, dtype=torch.int64)
    counts = dict(runs=[], staged=0, read_from_rows=0, skipped=0,
                  clamped=int(((start >= 0) & (lo > 0)).sum()))
    own = 0 if C == 7 else 13
    for t0 in range(0, q, STAGE_TILE):
        sl = slice(t0, min(t0 + STAGE_TILE, q))
        live = start[sl] >= 0
        runs = torch.unique(start[sl][live])
        counts["runs"].append(runs.numel())
        staged = runs[:stage_runs]
        stage = padded[staged[:, None] + slots]  # the copy, [S, B, 4]
        eq = start[sl][..., None] == staged
        in_stage = live & eq.any(-1)
        from_stage = stage[eq.to(torch.int64).argmax(-1)] if staged.numel() else 0
        rows = torch.where(in_stage[..., None, None], from_stage,
                           padded[start[sl].clamp(min=0)[..., None] + slots])  # [P, C, B, 4]
        p, k = queries[sl], base[sl]

        def scan(c, walking):
            counts["staged"] += int((walking & in_stage[:, c]).sum())
            counts["read_from_rows"] += int((walking & ~in_stage[:, c]).sum())
            return _scan_cells(rows[:, c], p, key[sl, c], walking, c * B + lo[sl, c])

        bs, bf = scan(own, live[:, own])
        for c in range(C):
            if c == own:
                continue
            o = offsets[c].tolist()
            h = [_face_gap(o[a], k[:, a], p[:, a], grid.origin[a], cell) for a in range(3)]
            bound = h[0] * h[0] + h[1] * h[1] + h[2] * h[2]
            wants = live[:, c] & ~(bound > bs)
            counts["skipped"] += int((live[:, c] & ~wants).sum())
            d, f = scan(c, wants)
            take = (d < bs) | ((d == bs) & (f < bf))
            bs, bf = torch.where(take, d, bs), torch.where(take, f, bf)
        best[sl], bflat[sl] = bs, bf
    found = torch.isfinite(best)
    c = (bflat // B).clamp(0, C - 1)
    row = start.clamp(0, n - B).gather(1, c[:, None])[:, 0] + bflat % B
    return torch.where(found, row, start[:, 0].clamp(0, n - B)), best, found, counts


def _dyadic(x, step=1.0 / 64):
    return (np.round(np.asarray(x) / step) * step).astype(np.float32)


def _staged_case(case: str):
    """(grid points [n, 3], queries [Q, 3], stage runs) of a staged-scan case, made from a
    seed with numpy; every coordinate a multiple of 1/64 m, so that distances are exact.
    one_cell: two tiles (128 and 41 queries), each inside one 2 m cell of a 2,000-point
    cloud; overflow: 300 queries spread over the cloud against a stage of 3 runs; ties:
    queries on a 3 m lattice, each with two planted rows at equal distance (+-0.5 m along
    x or +-0.375 m along y), in two cells or in two slots of one cell, nothing else
    within 2 m."""
    rng = np.random.default_rng({"one_cell": 3, "overflow": 4, "ties": 5}[case])
    if case == "ties":
        g = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(3), indexing="ij"), -1)
        q = _dyadic(g.reshape(-1, 3) * 3.0 + 1.5 + rng.uniform(-0.6, 0.6, (108, 3)), 1 / 8)
        along = np.where(np.arange(108)[:, None] % 2 == 0, [[0.5, 0.0, 0.0]], [[0.0, 0.375, 0.0]])
        flip = np.where(rng.random((108, 1)) < 0.5, 1.0, -1.0)
        pts = np.concatenate([q + flip * along, q - flip * along]).astype(np.float32)
        return pts, q, 128
    pts = _dyadic(rng.uniform([0, 0, 0], [16, 16, 8], (2000, 3)))
    if case == "overflow":
        return pts, _dyadic(rng.uniform([-1, -1, -1], [17, 17, 9], (300, 3))), 3
    origin = pts.min(axis=0) - 2.0
    cells = np.floor((pts[[0, 1000]] - origin) / 2.0)
    q = [origin + 2.0 * (c + rng.uniform(0.05, 0.95, (m, 3))) for c, m in zip(cells, (128, 41))]
    return pts, _dyadic(np.concatenate(q)), 128


STAGED_QUERIES = [(7, 32), (7, 16), (27, 32), (27, 16)]


@pytest.mark.parametrize("case", ["one_cell", "overflow", "ties"])
@pytest.mark.parametrize("neighborhood,bucket_cap", STAGED_QUERIES,
                         ids=[f"C{c}-B{b}" for c, b in STAGED_QUERIES])
def test_staged_scan_model_matches_nearest(case, neighborhood, bucket_cap):
    pts, q, stage_runs = _staged_case(case)
    mask = np.ones(len(pts), bool)
    jg = jnb.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), 2.0)
    grid = hash_grid_from_numpy({f.name: np.array(getattr(jg, f.name))
                                 for f in dataclasses.fields(jg)})
    qt = torch.as_tensor(q)
    idx, d2, found, counts = staged_nearest(grid, qt, bucket_cap, neighborhood, stage_runs)
    pidx, pd2, pfound = tnb.nearest(grid, qt, bucket_cap=bucket_cap, neighborhood=neighborhood)
    assert torch.equal(idx, pidx) and torch.equal(found, pfound)
    assert torch.equal(d2.view(torch.int32), pd2.view(torch.int32))
    jidx, jd2, jfound = jnb.nearest(jg, jnp.asarray(q), bucket_cap=bucket_cap,
                                    neighborhood=neighborhood)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6)
    assert bool(found.any())
    if case == "one_cell":
        base = pack_key(voxel_coords(qt, grid.origin, 1.0 / grid.cell_size))
        assert [torch.unique(base[t:t + STAGE_TILE]).numel() for t in (0, STAGE_TILE)] == [1, 1]
        assert max(counts["runs"]) <= neighborhood and counts["read_from_rows"] == 0
        assert counts["skipped"] > 0
    elif case == "overflow":
        assert counts["read_from_rows"] > 0 and counts["staged"] > 0 and counts["clamped"] > 0
        assert max(counts["runs"]) > stage_runs
    else:
        # Every query ties: its two planted rows at the least d2, the one of lower flat
        # index found; some pairs lie in two cells, some in two slots of one cell.
        d2_all, cand = tnb._candidate_scan(grid, qt, tnb._offsets_for(neighborhood, "cpu"),
                                           bucket_cap)
        ties = d2_all == d2[:, None]
        assert bool(found.all()) and bool((ties.sum(1) == 2).all())
        first = ties.to(torch.int64).argmax(1)
        assert torch.equal(idx, cand[torch.arange(len(q)), first])
        cells = torch.nonzero(ties)[:, 1].reshape(-1, 2) // bucket_cap
        two_cells = cells[:, 0] != cells[:, 1]
        assert bool(two_cells.any()) and bool((~two_cells).any())
        np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
