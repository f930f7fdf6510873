"""The PyTorch port on a CUDA card: the hand-written kernels `ndt_accumulate` (gathered
rows) against its plain PyTorch version and a float64 evaluation, and
`ndt_direct7_accumulate` (DIRECT7 gather fused in) against its plain version on real
maps and edge cases; both launched at once from two threads on two streams; the
loops-off pipeline, the grid nearest-neighbor query, one loop verification (ICP and
GICP) and `gicp_align` on the card against the same on the CPU; `ndt_accumulate` on
GICP's own rows, unmatched padding rows included; the classic driver's device default.

Every test here is marked `cuda` and skips without a card. This file imports no JAX
(the card's machine has none), so it also runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Tolerances: per output, max |kernel - reference| <= 1e-5 * max |reference| + 2e-3 (both
sum ~1e5 float32 terms in different orders), hit and centre counts exact; two launches on
the same inputs bit-identical, and so are launches made concurrently on two streams. Pipeline poses: card vs CPU within 1 cm and 1 mrad per frame. Grid
NN: idx and found equal, d2 to rtol 1e-6. Verification: the same candidate and decision,
fitness to rtol 1e-3, transform to atol 1e-3. `gicp_align`: transform to atol 1e-4,
iterations and converged equal, num_inliers within 1%.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu_torch.core.config import (
    CapacityConfig,
    GraphSlamConfig,
    IcpConfig,
    PipelineConfig,
    apply_cli_overrides,
)
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud
from lidar_graph_slam_tpu_torch.graph.slam import GraphBasedSLAM
from lidar_graph_slam_tpu_torch.odometry.scan_matcher import ScanMatcher
from lidar_graph_slam_tpu_torch.io.synthetic import (
    SyntheticSequence,
    make_loop_trajectory,
    make_world,
    simulate_scan,
)
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops.neighbors import build_hash_grid, nearest
from lidar_graph_slam_tpu_torch.registration import gicp
from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_map
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from lidar_graph_slam_tpu_torch.registration.ndt import magnusson_constants
from lidar_graph_slam_tpu_torch.utils.state import gicp_target_from_numpy

pytestmark = pytest.mark.cuda

REL, ABS = 1e-5, 2e-3
# K = 7 x filtered points: the fine stage at the default capacity, the coarse stage
# (stride 4), a small one, a single row and none.
SIZES = [7 * 32768, 7 * 8192, 7 * 300, 1, 0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(K, device, seed=0, hit_rate=0.7):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(K, 3)).astype(np.float32)
    A = rng.normal(size=(K, 3, 3)).astype(np.float32)
    icovs = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3, dtype=np.float32)
    p = (rng.normal(size=(K, 3)) * 5.0).astype(np.float32)
    hit = rng.random(K) < hit_rate
    return [torch.as_tensor(x, device=device) for x in (e, icovs, p, hit)]


def _assert_close(out, ref):
    for name, a, c in zip(("H", "g", "sum_w", "n_hit"), out, ref):
        a, c = a.double(), c.double()
        bound = 0.0 if name == "n_hit" else REL * float(c.abs().max()) + ABS
        err = float((a - c).abs().max())
        assert err <= bound, f"{name}: max err {err} > {bound}"


@pytest.mark.parametrize("K", SIZES)
def test_kernel_matches_plain_and_float64(cuda, K):
    args = _inputs(K, cuda)
    d2 = torch.tensor(0.25, device=cuda)
    ws = torch.tensor(1.05, device=cuda)
    before = tk.ndt_accumulate.launches
    out = tk.ndt_accumulate(*args, d2, ws)
    again = tk.ndt_accumulate(*args, d2, ws)
    torch.cuda.synchronize()
    assert tk.ndt_accumulate.launches == before + 2
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert out[0].shape == (6, 6) and out[1].shape == (6,)
    assert torch.equal(out[0], out[0].T)
    _assert_close(out, tk.ndt_accumulate_plain(*args, d2, ws))
    e, icovs, p, hit = args
    f64 = tk.ndt_accumulate_plain(e.double(), icovs.double(), p.double(), hit, 0.25, 1.05)
    _assert_close(out, f64)


def test_kernel_scalars_by_pointer_or_value(cuda):
    """d2 and w_scale read from device tensors or passed as numbers: the same bits."""
    args = _inputs(7 * 1000, cuda, seed=1)
    by_ptr = tk.ndt_accumulate(*args, torch.tensor(0.5, device=cuda),
                               torch.tensor(2.0, device=cuda))
    by_val = tk.ndt_accumulate(*args, 0.5, 2.0)
    for a, b in zip(by_ptr, by_val):
        assert torch.equal(a, b)


def test_kernel_all_miss_is_zero(cuda):
    args = _inputs(7 * 1000, cuda, seed=2, hit_rate=0.0)
    H, g, sw, nh = tk.ndt_accumulate(*args, 0.25, 1.05)
    assert not H.any() and not g.any() and float(sw) == 0.0 and float(nh) == 0.0


def test_kernel_rejects_bad_inputs(cuda):
    e, icovs, p, hit = _inputs(70, cuda)
    bad = [
        (e[:, :2].contiguous(), icovs, p, hit, 0.25),          # shape
        (e.double(), icovs, p, hit, 0.25),                      # dtype
        (e, icovs.transpose(1, 2), p, hit, 0.25),               # not contiguous
        (e, icovs, p.cpu(), hit, 0.25),                         # device
        (e, icovs, p, hit.to(torch.uint8), 0.25),               # mask dtype
        (e, icovs, p, hit, torch.tensor(0.25)),                 # scalar on the host
    ]
    before = tk.ndt_accumulate.launches
    for e_, ic_, p_, hit_, d2 in bad:
        with pytest.raises(ValueError):
            tk.ndt_accumulate(e_, ic_, p_, hit_, d2, 1.0)
    assert tk.ndt_accumulate.launches == before


# (points N, map leaf): the fine stage at the default capacity, the coarse stage (stride
# 4, 4 m map), the verification's pre-align (16,384 keyframe points, 4 m map), a small
# one, a single point and none.
DIRECT7_SIZES = [(32768, 2.0), (8192, 4.0), (16384, 4.0), (300, 2.0), (1, 2.0), (0, 2.0)]
DIRECT7_OUT = ("H", "g", "sum_w", "n_hit", "centre_d2", "centre_count")


def _direct7_inputs(n, leaf, device, seed=0):
    """A map from one dense synthetic scan and `n` query points on `device`: points near
    the surfaces, points outside the dense table (below the origin and past 512 m),
    points exactly on cell borders, and a source mask dropping ~20% of the rows."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=60.0, density=40.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=65536)
    pts = torch.as_tensor(scan, device=device)
    vmap = build_ndt_map(pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device),
                         leaf, capacity=65536)
    origin = vmap.origin.cpu().numpy()
    p = scan[rng.integers(0, scan.shape[0], n)] + rng.normal(scale=0.3, size=(n, 3))
    p[: n // 10] = origin - rng.uniform(5.0, 50.0, size=(n // 10, 3))
    p[n // 10: n // 5] = origin + rng.uniform(520.0, 900.0, size=(n // 5 - n // 10, 3))
    border = np.arange(n // 5, n // 3)
    axis = border % 3
    p[border, axis] = origin[axis] + rng.integers(1, 40, size=border.size) * np.float32(leaf)
    mask = rng.random(n) > 0.2
    d1, d2 = magnusson_constants(vmap.leaf, 0.55)
    return (vmap, torch.as_tensor(p.astype(np.float32), device=device),
            torch.as_tensor(mask, device=device), d2, -d1 * d2)


def _assert_direct7_close(out, ref):
    for name, a, c in zip(DIRECT7_OUT, out, ref):
        a, c = a.double(), c.double()
        exact = name in ("n_hit", "centre_count")
        bound = 0.0 if exact else REL * float(c.abs().max()) + ABS
        err = float((a - c).abs().max())
        assert err <= bound, f"{name}: max err {err} > {bound}"


@pytest.mark.parametrize("n,leaf", DIRECT7_SIZES)
def test_direct7_kernel_matches_plain(cuda, n, leaf):
    vmap, p, mask, d2, ws = _direct7_inputs(n, leaf, cuda)
    before = tk.ndt_direct7_accumulate.launches
    out = tk.ndt_direct7_accumulate(vmap, p, mask, d2, ws)
    again = tk.ndt_direct7_accumulate(vmap, p, mask, d2, ws)
    torch.cuda.synchronize()
    assert tk.ndt_direct7_accumulate.launches == before + 2
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert out[0].shape == (6, 6) and out[1].shape == (6,)
    assert torch.equal(out[0], out[0].T)
    ref = tk.ndt_direct7_accumulate_plain(vmap, p, mask, d2, ws)
    _assert_direct7_close(out, ref)
    if n >= 300:
        assert 0 < float(ref[3]) < 7 * n  # hits and misses both present


def test_direct7_kernel_edge_maps(cuda):
    """Rows whose valid flag is 0 (voxels under min_points; `build_ndt_map` keeps them out
    of the table, so they are made here) are misses: half of them, then all. With all
    invalid, or every source row masked out, the outputs are exact zeros."""
    vmap, p, mask, d2, ws = _direct7_inputs(4096, 2.0, cuda, seed=3)
    full = tk.ndt_direct7_accumulate(vmap, p, mask, d2, ws)
    for step in (2, 1):
        packed = vmap.packed.clone()
        packed[::step, 12] = 0.0
        cut = dataclasses.replace(vmap, packed=packed)
        out = tk.ndt_direct7_accumulate(cut, p, mask, d2, ws)
        _assert_direct7_close(out, tk.ndt_direct7_accumulate_plain(cut, p, mask, d2, ws))
        assert float(out[3]) < float(full[3])
        if step == 1:
            assert all(not t.any() for t in out)
    masked = tk.ndt_direct7_accumulate(vmap, p, torch.zeros_like(mask), d2, ws)
    assert all(not t.any() for t in masked)


def test_direct7_kernel_rejects_bad_inputs(cuda):
    vmap, p, mask, d2, ws = _direct7_inputs(300, 2.0, cuda)
    bad = [
        (vmap, p[:, :2].contiguous(), mask, d2),                 # shape
        (vmap, p.double(), mask, d2),                            # dtype
        (vmap, p.T.contiguous().T, mask, d2),                    # not contiguous
        (vmap, p, mask.cpu(), d2),                               # device
        (vmap, p, mask.to(torch.uint8), d2),                     # mask dtype
        (vmap, p, mask, torch.tensor(0.25)),                     # scalar on the host
    ]
    before = tk.ndt_direct7_accumulate.launches
    for vm, p_, m_, d2_ in bad:
        with pytest.raises(ValueError):
            tk.ndt_direct7_accumulate(vm, p_, m_, d2_, ws)
    assert tk.ndt_direct7_accumulate.launches == before


def test_both_kernels_on_two_streams_at_once(cuda):
    """Two threads, each on its own stream, launch both entry points 50 times each at
    the same time: every result equals the serial one bit for bit (each stream has its
    own partials and ticket counter)."""
    vmap, p, mask, d2, ws = _direct7_inputs(32768, 2.0, cuda, seed=4)
    rows = _inputs(7 * 8192, cuda, seed=4)
    calls = {"direct7": lambda: tk.ndt_direct7_accumulate(vmap, p, mask, d2, ws),
             "rows": lambda: tk.ndt_accumulate(*rows, d2, ws)}
    serial = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    barrier = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def run(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [(k, calls[k]()) for _ in range(50) for k in calls]
            stream.synchronize()
            results[t] = outs
        except BaseException as e:  # noqa: BLE001 — raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for outs in results.values():
        for k, out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, serial[k])), k


def test_pipeline_card_matches_cpu(cuda):
    """Five frames of the loops-off pipeline at a small capacity on the card and on the
    CPU (plain versions): poses within 1 cm / 1 mrad, the same keyframes, and the fused
    kernel launched by the card's run (the gathered-rows kernel not at all: only NDT's
    line search uses it)."""
    cfg = apply_cli_overrides(PipelineConfig(), [
        "enable_loop_closure=False", "prefilter.leaf_size=0.3", "prefilter.mean_k=10",
        "capacity.raw_points=16384", "capacity.filtered_points=4096",
        "capacity.voxel_capacity=32768", "scan_matcher.max_scan_accumulate_num=5"])
    seq = SyntheticSequence(n_frames=5, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 5 / 90)
    scans = [s for s, _ in seq]
    results = {}
    for device in ("cuda", "cpu"):
        before = tk.ndt_direct7_accumulate.launches, tk.ndt_accumulate.launches
        pipe = SlamPipeline(cfg, device=device)
        for s in scans:
            pipe.process_scan(s)
        results[device] = pipe.result()
        fused = tk.ndt_direct7_accumulate.launches - before[0]
        assert (fused > 0) if device == "cuda" else (fused == 0)
        assert tk.ndt_accumulate.launches == before[1]
    a, b = results["cuda"], results["cpu"]
    assert a.odometry_poses.shape == b.odometry_poses.shape == (5, 4, 4)
    np.testing.assert_array_equal(a.keyframe_frame_indices, b.keyframe_frame_indices)
    for x, y in zip(a.odometry_poses, b.odometry_poses):
        assert np.linalg.norm(x[:3, 3] - y[:3, 3]) < 0.01
        chord = np.linalg.norm(x[:3, :3].astype(np.float64) - y[:3, :3].astype(np.float64))
        assert 2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0)) < 1e-3


@pytest.mark.parametrize("neighborhood,bucket_cap", [(7, 16), (27, 32)])
def test_nearest_card_matches_cpu(cuda, neighborhood, bucket_cap):
    rng = np.random.default_rng(5)
    world = make_world(rng, extent=40.0, density=3.0)
    target = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=8192)
    tc = PointCloud.from_array(target, capacity=8192)
    q = np.concatenate([target[:3000] + rng.normal(scale=0.3, size=(3000, 3)),
                        rng.uniform(500.0, 5000.0, size=(64, 3))]).astype(np.float32)
    out = []
    for device in (cuda, torch.device("cpu")):
        grid = build_hash_grid(tc.points.to(device), tc.mask.to(device), 2.0)
        out.append([t.cpu() for t in nearest(grid, torch.as_tensor(q, device=device),
                                             bucket_cap=bucket_cap, neighborhood=neighborhood)])
    (ci, cd, cf), (pi, pd, pf) = out
    assert torch.equal(ci, pi) and torch.equal(cf, pf)
    assert cf[:3000].float().mean() > 0.9 and not cf[3000:].any()
    torch.testing.assert_close(cd[cf], pd[pf], rtol=1e-6, atol=0.0)


def _gicp_problem(device, n=8192, seed=7):
    """The registration fixture of `tests/test_registration.py` on `device`: a GICP target
    of one scan and the other scan moved by a perturbation, with its covariances; both
    clouds hold padding rows (capacity above the scan). Returns (target, source, mask,
    covs)."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [5.0, -3.0, 1.5]
    tgt = simulate_scan(world, pose, rng, max_range=45.0, max_points=n, noise=0.01)
    src = simulate_scan(world, pose, rng, max_range=45.0, max_points=n, noise=0.01)
    tc = PointCloud.from_array(tgt, capacity=2 * n, device=device)
    sc = PointCloud.from_array(src, capacity=n + 1024, device=device)
    c, s_ = np.cos(0.03), np.sin(0.03)
    T = torch.tensor([[c, -s_, 0.0, 0.3], [s_, c, 0.0, -0.2], [0.0, 0.0, 1.0, 0.05],
                      [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
    moved = torch.where(sc.mask[:, None], sc.points @ T[:3, :3].T + T[:3, 3], sc.points)
    target = gicp.build_gicp_target(tc.points, tc.mask, 2.0)
    covs, _ = gicp.estimate_covariances(sc.points, sc.mask, 2.0)
    return target, moved.contiguous(), sc.mask, covs


def test_kernel_on_gicp_rows(cuda):
    """`ndt_accumulate` on the rows of a GICP iteration (d2 = 0, w_scale = 1): matched
    rows, unmatched ones, and rows far off (source padding at 1e6 and points 500 m away,
    whose nearest target row may be padding: |e| up to ~1.7e6). Unmatched rows get weight
    exactly 0 — the outputs equal those of the matched rows alone — and never a NaN."""
    target, src, mask, covs = _gicp_problem(cuda)
    src[:500] += 500.0
    R = torch.eye(3, device=cuda)
    idx, _d2, matched = gicp.match(target, src, mask, 4.0)
    e, M = gicp.residual_rows(target, idx, src, R, covs)
    assert float(e[~mask].abs().max()) > 1e5 and bool(matched.any())
    assert int((~matched).sum()) > 1000
    before = tk.ndt_accumulate.launches
    out = tk.ndt_accumulate(e, M, src, matched, 0.0, 1.0)
    again = tk.ndt_accumulate(e, M, src, matched, 0.0, 1.0)
    torch.cuda.synchronize()
    assert tk.ndt_accumulate.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert all(bool(torch.isfinite(t).all()) for t in out)
    _assert_close(out, tk.ndt_accumulate_plain(e, M, src, matched, 0.0, 1.0))
    sel = matched
    only = tk.ndt_accumulate(e[sel].contiguous(), M[sel].contiguous(), src[sel].contiguous(),
                             torch.ones(int(sel.sum()), dtype=torch.bool, device=cuda), 0.0, 1.0)
    _assert_close(out, only)
    assert float(out[2]) == float(out[3]) == float(sel.sum())  # weight 1 per matched row


def test_gicp_align_card_matches_cpu(cuda):
    """One `gicp_align` from the same target and covariances on the card (one kernel
    launch per iteration) and on the CPU (plain version), with and without reciprocal."""
    target, src, mask, covs = _gicp_problem(cuda)
    cpu = torch.device("cpu")
    target_cpu = gicp.GicpTarget(grid=type(target.grid)(**{
        k: v.to(cpu) for k, v in vars(target.grid).items()}), covs=target.covs.to(cpu),
        valid=target.valid.to(cpu))
    for reciprocal in (False, True):
        res = {}
        for dev, tgt in ((cuda, target), (cpu, target_cpu)):
            p, m, c = src.to(dev), mask.to(dev), covs.to(dev)
            kw = dict(reciprocal=True, source_grid=build_hash_grid(p, m, 2.0)) if reciprocal else {}
            before = tk.ndt_accumulate.launches
            r = gicp.gicp_align(tgt, p, m, torch.eye(4, device=dev), c, **kw)
            launched = tk.ndt_accumulate.launches - before
            assert launched == (int(r.iterations) if dev.type == "cuda" else 0)
            res[dev.type] = r
        a, b = res["cuda"], res["cpu"]
        np.testing.assert_allclose(a.transform.cpu().numpy(), b.transform.numpy(), atol=1e-4)
        assert int(a.iterations) == int(b.iterations) and bool(a.converged) == bool(b.converged)
        assert abs(int(a.num_inliers) - int(b.num_inliers)) <= 0.01 * int(b.num_inliers)
        assert bool(a.converged) and int(a.num_inliers) > 1000


def test_gicp_target_round_trips(cuda):
    target, *_ = _gicp_problem(cuda, n=2048)
    arrays = {k: v.cpu().numpy() for k, v in vars(target.grid).items()}
    arrays.update(covs=target.covs.cpu().numpy(), valid=target.valid.cpu().numpy())
    back = gicp_target_from_numpy(arrays, device=cuda)
    for k, v in vars(target.grid).items():
        got = getattr(back.grid, k)
        if v.dtype == torch.float32:  # bit for bit: `packed` holds int32 keys (NaN bits)
            got, v = got.view(torch.int32), v.view(torch.int32)
        assert torch.equal(got, v), k
    assert torch.equal(back.covs, target.covs) and torch.equal(back.valid, target.valid)
    assert back.covs.device.type == "cuda"


def test_scan_matcher_defaults_to_the_card(cuda, monkeypatch):
    from lidar_graph_slam_tpu_torch.core.config import ScanMatcherConfig

    sm = ScanMatcher(ScanMatcherConfig(registration_method="GICP"), 512)
    assert sm.device.type == "cuda" and sm.ring.clouds.device.type == "cuda"
    assert ScanMatcher(ScanMatcherConfig(), 512, device="cpu").ring.clouds.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ScanMatcher(ScanMatcherConfig(), 512)


def _loop_backend(device, async_backend, method="ICP"):
    """The verifier fixture of `tests/test_loop_verifiers.py:build_loop_backend("ICP")`:
    31 keyframes on a ~128 m loop, the latest reported with 0.6 m / 0.03 rad of drift."""
    cfg = GraphSlamConfig(accumulate_distance_threshold=100.0,
                          search_for_candidate_threshold=15.0, registration_method=method,
                          icp=IcpConfig(max_iterations=40), async_backend=async_backend)
    cap = CapacityConfig(max_keyframes=64, max_loop_factors=8, keyframe_points=4096,
                         loop_submap_points=65536, voxel_capacity=32768)
    back = GraphBasedSLAM(cfg, cap, device=device)
    rng = np.random.default_rng(7)
    world = make_world(rng, extent=40.0, density=2.0)
    traj = make_loop_trajectory(31, radius=20.0, laps=1.02)
    err = np.eye(4, dtype=np.float32)
    err[:2, :2] = [[np.cos(0.03), -np.sin(0.03)], [np.sin(0.03), np.cos(0.03)]]
    err[:2, 3] = [0.6, -0.4]
    accum = 0.0
    for k in range(31):
        accum += float(np.linalg.norm(traj[k][:3, 3] - traj[k - 1][:3, 3])) if k else 0.0
        scan = simulate_scan(world, traj[k], rng, max_points=4096, noise=0.01)
        back.add_keyframe({"pose": traj[k] if k < 30 else (traj[k] @ err).astype(np.float32),
                           "cloud": scan, "cloud_mask": np.ones(scan.shape[0], bool),
                           "accum_distance": accum if k < 30 else accum + 110.0})
    return back


@pytest.mark.parametrize("method", ["ICP", "GICP"])
def test_verification_card_matches_cpu(cuda, method):
    """One loop verification through the asynchronous path (worker thread, own stream)
    on the card against the synchronous one on the CPU: the same decision, and the card
    launched the kernels in the verification's NDT pre-align (and, for GICP, in every
    GICP iteration)."""
    rec = {}
    for device, async_backend in ((cuda, True), (torch.device("cpu"), False)):
        before = tk.ndt_accumulate.launches
        back = _loop_backend(device, async_backend, method)
        assert back.try_close_loop()
        rec[device.type] = (back.loop_log[-1], back.verify_launches, back.optimized_poses())
        rows = tk.ndt_accumulate.launches - before
        assert (rows > 0) == (device.type == "cuda" and method == "GICP"), rows
    (a, launches, pa), (c, cpu_launches, pc) = rec["cuda"], rec["cpu"]
    assert (a["candidate"], a["accepted"], a["converged"]) == (c["candidate"], c["accepted"],
                                                              c["converged"])
    assert launches > 0 and cpu_launches == 0
    np.testing.assert_allclose(a["fitness"], c["fitness"], rtol=1e-3)
    np.testing.assert_allclose(a["transform"], c["transform"], atol=1e-3)
    np.testing.assert_allclose(pa, pc, atol=1e-3)
