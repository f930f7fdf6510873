"""The PyTorch port on a CUDA card: the hand-written kernels `ndt_accumulate` (gathered
rows) against its plain PyTorch version and a float64 evaluation, and
`ndt_direct7_accumulate` (DIRECT7 gather fused in) against its plain version on real
maps and edge cases; both launched at once from two threads on two streams; the
loops-off pipeline, the grid nearest-neighbor query, one loop verification (ICP and
GICP) and `gicp_align` on the card against the same on the CPU; `ndt_accumulate` on
GICP's own rows, unmatched padding rows included; the batched fused kernel against its
plain version, row by row against the single kernel, masked, on two streams, and
`batch_odometry` card against CPU and against single-sequence runs; one verification
with a mesh of the card against the unmeshed one; the classic driver's device default;
`match_features` under the float32 pin, `argmax`'s first maximum, `global_register` card
and CPU, and a checkpoint carried from the card to the CPU and back. The NDT loop kernel
against the plain loop: the dense course's stages, ragged sizes around its tile (N = 1,
300, 4,097, 50,000), steps with no inliers or a singular system, batches of 1, 3, 4 and 5
row by row against single loops, a block count that does not depend on the batch, two
streams at once. The voxel finalize `ndt_finalize` and `eigh3x3` (`csrc/voxel_finalize.cu`)
against `ndt_finalize_plain` and `_eigh3x3`, bit for bit: the fine level from sorted
points and the coarse one from the merged fine moments, on a real ring, the ring ~28%
valid, a run longer than the shared stage, voxels past C, no valid point, one point,
capacities of 3 and 1,000, a far origin with keys up to COORD_MAX, at min_points 6 and 1; `segment_reduce`'s run sums in order on the card; the empty ring,
GICP's window covariances; the pyramid, the GICP covariances and the FPFH normals through
them; refusals, no synchronous read, two streams at once.

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
from lidar_graph_slam_tpu_torch.ops.neighbors import _offsets_for, build_hash_grid, nearest
from lidar_graph_slam_tpu_torch.registration import gicp
from lidar_graph_slam_tpu_torch.ops.voxel import (
    INVALID_KEY,
    TABLE_DIMS,
    _flat_table_index,
    build_ndt_map,
    pack_key,
    voxel_coords,
)
from lidar_graph_slam_tpu_torch.parallel.distributed import Mesh
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


def _batched_inputs(B, n, cuda):
    """B sequences of `_direct7_inputs` (seeds 0..B-1: each its own map and points)."""
    seqs = [_direct7_inputs(n, 2.0, cuda, seed=b) for b in range(B)]
    vmaps = tk.stack_maps([s[0] for s in seqs])
    p = torch.stack([s[1] for s in seqs])
    mask = torch.stack([s[2] for s in seqs])
    return seqs, vmaps, p, mask, seqs[0][3], seqs[0][4]


@pytest.mark.parametrize("B", [4, 1])
def test_batched_direct7_matches_plain_and_single_rows(cuda, B):
    """The batched kernel at the multi-sequence odometry's shape (N = 32,768 a sequence):
    against its plain version to the kernel tolerance, row b equal to
    `ndt_direct7_accumulate` on sequence b bit for bit, two launches bit-identical."""
    seqs, vmaps, p, mask, d2, ws = _batched_inputs(B, 32768, cuda)
    before = tk.ndt_direct7_accumulate_batched.launches
    out = tk.ndt_direct7_accumulate_batched(vmaps, p, mask, d2, ws)
    again = tk.ndt_direct7_accumulate_batched(vmaps, p, mask, d2, ws)
    torch.cuda.synchronize()
    assert tk.ndt_direct7_accumulate_batched.launches == before + 2
    assert out[0].shape == (B, 6, 6) and out[5].shape == (B,)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    ref = tk.ndt_direct7_accumulate_batched_plain(vmaps, p, mask, d2, ws)
    for b, (vmap, pb, mb, _, _) in enumerate(seqs):
        _assert_direct7_close([x[b] for x in out], [x[b] for x in ref])
        single = tk.ndt_direct7_accumulate(vmap, pb, mb, d2, ws)
        assert all(torch.equal(x[b], y) for x, y in zip(out, single)), b


def test_batched_direct7_masked_sequence_and_per_sequence_scalars(cuda):
    """An all-masked sequence gives an exact zero row and leaves the others' rows as they
    are; d2 / w_scale given one per sequence equal the shared ones row by row."""
    seqs, vmaps, p, mask, d2, ws = _batched_inputs(3, 4096, cuda)
    full = tk.ndt_direct7_accumulate_batched(vmaps, p, mask, d2, ws)
    cut = mask.clone()
    cut[1] = False
    out = tk.ndt_direct7_accumulate_batched(vmaps, p, cut, d2, ws)
    assert all(not x[1].any() for x in out)
    for b in (0, 2):
        assert all(torch.equal(x[b], y[b]) for x, y in zip(out, full))
    per = tk.ndt_direct7_accumulate_batched(vmaps, p, mask, d2.expand(3).contiguous(),
                                            ws.expand(3).contiguous())
    assert all(torch.equal(x, y) for x, y in zip(per, full))


def test_batched_direct7_rejects_bad_inputs(cuda):
    _, vmaps, p, mask, d2, ws = _batched_inputs(2, 300, cuda)
    bad = [(p[:1], mask), (p, mask[:, :10].contiguous()), (p.double(), mask),
           (p, mask.cpu())]
    before = tk.ndt_direct7_accumulate_batched.launches
    for p_, m_ in bad:
        with pytest.raises(ValueError):
            tk.ndt_direct7_accumulate_batched(vmaps, p_, m_, d2, ws)
    with pytest.raises(ValueError):  # one d2 per sequence, but 3 for 2 sequences
        tk.ndt_direct7_accumulate_batched(vmaps, p, mask, torch.full((3,), 0.2, device=cuda), ws)
    assert tk.ndt_direct7_accumulate_batched.launches == before


def test_batched_direct7_on_two_streams_at_once(cuda):
    """Two threads on two streams launch the batched kernel (B = 4) and the single one 30
    times each at once: every result equals the serial one bit for bit (each stream's
    partials and per-sequence ticket counters are its own)."""
    seqs, vmaps, p, mask, d2, ws = _batched_inputs(4, 8192, cuda)
    calls = {"batched": lambda: tk.ndt_direct7_accumulate_batched(vmaps, p, mask, d2, ws),
             "single": lambda: tk.ndt_direct7_accumulate(seqs[2][0], p[2], mask[2], d2, ws)}
    serial = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    barrier = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def run(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [(k, calls[k]()) for _ in range(30) for k in calls]
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


# -- the NDT loop kernel (`ndt_iteration`, `csrc/ndt_loop.cu`) -----------------------------

LOOP_FIELDS = ("T", "done", "iterations", "fitness", "inliers")


def _loop_inputs(n, leaf, device, seed=0, offset=(0.4, -0.3, 0.1), yaw=0.03):
    """A source cloud of `n` points sampled from a dense synthetic scan, its map, and an
    initial guess off the true (identity) pose by `offset` m and `yaw` rad."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=60.0, density=40.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=65536)
    pts = torch.as_tensor(scan, device=device)
    vmap = build_ndt_map(pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device),
                         leaf, capacity=65536)
    src = scan[rng.integers(0, scan.shape[0], n)] + rng.normal(scale=0.02, size=(n, 3))
    mask = rng.random(n) > 0.1
    T0 = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T0[:2, :2] = [[c, -s], [s, c]]
    T0[:3, 3] = offset
    d1, d2 = magnusson_constants(vmap.leaf, 0.55)
    return (vmap, torch.as_tensor(src.astype(np.float32), device=device),
            torch.as_tensor(mask, device=device), torch.as_tensor(T0, device=device), d2,
            -d1 * d2)


def _loop_call(inputs, step_size=0.1, max_iterations=64, polish=2):
    vmap, src, mask, T0, d2, ws = inputs
    damping = torch.full((), 1e-6, device=src.device)
    return (vmap, src, mask, T0, d2, ws, step_size, 0.01, damping, max_iterations, polish)


def _loop_matches_plain(args):
    """The kernel loop (run twice: bit-identical) against the plain loop (torch ops, carry
    frozen after done) on the same card tensors: T to 1e-4, the same iterations and done,
    inliers within 0.1%, fitness to rtol 1e-4. Returns the kernel loop's carry."""
    out = tk.ndt_align_loop(*args)
    again = tk.ndt_align_loop(*args)
    ref = tk.ndt_align_loop_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert float((out[0] - ref[0]).abs().max()) <= 1e-4
    assert (bool(out[1]), int(out[2])) == (bool(ref[1]), int(ref[2]))
    assert abs(int(out[4]) - int(ref[4])) <= 0.001 * int(ref[4])
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-4)
    return out


# (N, leaf, step, max_iterations, polish, damping): the fine stage, the coarse stage
# (stride 4, 4 m map, 4x the step, no polish), one that runs out of iterations, and sizes
# around the loop kernel's tile of 128 source points: a ragged third block, one point, a
# ragged last tile, and more tiles than the card holds at once (391 at 50,000: persistent
# blocks run two). One point's H has rank 3, so it damps by 0.5 to keep the 6x6 solve
# well conditioned for the comparison with cuSOLVER's.
LOOP_SIZES = [(32768, 2.0, 0.1, 64, 2, 1e-6), (8192, 4.0, 0.4, 16, 0, 1e-6),
              (32768, 2.0, 0.1, 3, 2, 1e-6), (300, 2.0, 0.1, 64, 2, 1e-6),
              (1, 2.0, 0.1, 64, 2, 0.5), (4097, 2.0, 0.1, 64, 2, 1e-6),
              (50000, 2.0, 0.1, 64, 2, 1e-6)]


@pytest.mark.parametrize("n,leaf,step,iters,polish,damping", LOOP_SIZES)
def test_loop_kernel_matches_plain_loop(cuda, n, leaf, step, iters, polish, damping):
    """The kernel loop against the plain loop (`_loop_matches_plain`); one C call enqueues
    max_iterations + polish launches."""
    args = list(_loop_call(_loop_inputs(n, leaf, cuda), step, iters, polish))
    args[8] = torch.full((), damping, device=cuda)
    before = tk.ndt_align_loop.launches
    _, done, it, _, inl = _loop_matches_plain(args)
    assert tk.ndt_align_loop.launches == before + 2 * (iters + polish)
    assert int(inl) > 0
    if iters == 3:
        assert int(it) == 3 and not bool(done)
    else:
        assert bool(done) and int(it) < iters


def test_loop_kernel_early_exit_and_worked_count(cuda):
    """A loop whose carry is done after k iterations does work in k + polish launches
    only; the others exit at once (the device count of working launches)."""
    args = _loop_call(_loop_inputs(32768, 2.0, cuda, seed=2))
    tk.worked_launches(reset=True)
    out = tk.ndt_align_loop(*args)
    worked = tk.worked_launches(reset=True)
    assert worked == int(out[2]) + 2 < 64 + 2


@pytest.mark.parametrize("B", [4, 1, 3, 5])
def test_batched_loop_matches_plain_and_single_rows(cuda, B):
    """The batched loop kernel at B = 4 x 32,768 (the multi-sequence odometry's shape),
    one sequence from its true pose (it finishes first): row b equal to the single loop
    on sequence b bit for bit, and to the plain loop to the single kernel's tolerance."""
    seqs = [_loop_inputs(32768, 2.0, cuda, seed=b,
                         offset=(0.0, 0.0, 0.0) if b == 1 else (0.4, -0.3, 0.1))
            for b in range(B)]
    vmaps = tk.stack_maps([s[0] for s in seqs])
    src = torch.stack([s[1] for s in seqs])
    mask = torch.stack([s[2] for s in seqs])
    T0 = torch.stack([s[3] for s in seqs])
    d2 = torch.stack([s[4] for s in seqs])
    ws = torch.stack([s[5] for s in seqs])
    damping = torch.full((), 1e-6, device=cuda)
    before = tk.ndt_align_loop_batched.launches
    out = tk.ndt_align_loop_batched(vmaps, src, mask, T0, d2, ws, 0.1, 0.01, damping, 64, 2)
    torch.cuda.synchronize()
    assert tk.ndt_align_loop_batched.launches == before + 66
    ref = tk.ndt_align_loop_batched_plain(vmaps, src, mask, T0, d2, ws, 0.1, 0.01, damping,
                                          64, 2)
    for b in range(B):
        single = tk.ndt_align_loop(*_loop_call(seqs[b]))
        assert all(torch.equal(x[b], y) for x, y in zip(out, single)), b
        assert float((out[0][b] - ref[0][b]).abs().max()) <= 1e-4
        assert int(out[2][b]) == int(ref[2][b]) and bool(out[1][b])
    if B == 4:
        assert int(out[2][1]) < min(int(out[2][b]) for b in (0, 2, 3))


def test_loop_kernels_on_two_streams_at_once(cuda):
    """Two threads, each on its own stream, run the single and the batched loop 10 times
    each at the same time: every result equals the serial one bit for bit (each stream
    has its own partials and ticket counters)."""
    seqs = [_loop_inputs(32768, 2.0, cuda, seed=b) for b in range(2)]
    batched = (tk.stack_maps([s[0] for s in seqs]), *(torch.stack([s[i] for s in seqs])
                                                       for i in range(1, 6)))
    damping = torch.full((), 1e-6, device=cuda)
    calls = {"single": lambda: tk.ndt_align_loop(*_loop_call(seqs[0])),
             "batched": lambda: tk.ndt_align_loop_batched(*batched, 0.1, 0.01, damping, 64, 2)}
    serial = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    barrier = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def run(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [(k, calls[k]()) for _ in range(10) for k in calls]
            stream.synchronize()
            results[t] = outs
        except BaseException as e:  # noqa: BLE001 — raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for outs in results.values():
        for k, out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, serial[k])), k


@pytest.mark.parametrize("case", ["all-masked", "outside-the-table", "singular"])
def test_loop_kernel_degenerate_steps(cuda, case):
    """No inliers (every point masked out, or every point past the dense table's far
    end), or a singular system (w_scale 0 and damping 0: H = 0, so the LU divides 0 by a
    zero pivot): the step is zeroed, T stays T0 bit for bit, and the loop is done after
    one iteration, as in the plain loop."""
    vmap, src, mask, T0, d2, ws = _loop_inputs(4096, 2.0, cuda, seed=7)
    args = list(_loop_call((vmap, src, mask, T0, d2, ws)))
    if case == "all-masked":
        args[2] = torch.zeros_like(mask)
    elif case == "outside-the-table":
        args[1] = src + vmap.origin + 900.0
    else:
        args[5], args[8] = 0.0, torch.zeros((), device=cuda)
    out = _loop_matches_plain(args)
    assert torch.equal(out[0], T0)
    assert bool(out[1]) and int(out[2]) == 1
    assert (int(out[4]) > 0) == (case == "singular")


def test_loop_block_count_does_not_depend_on_the_batch(cuda, monkeypatch):
    """The single loop and the batched loop at B = 1, 3 and 5 launch the same persistent
    grid per sequence: `loop_blocks` of N and the card (SMs x the kernel's occupancy)."""
    seqs = [_loop_inputs(32768, 2.0, cuda, seed=b) for b in range(5)]
    lib, seen = tk.load_library(), []

    class Spy:  # the library, recording the block count each loop call passes
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in ("lgs_ndt_align_loop", "lgs_ndt_align_loop_batched"):
                return fn

            def call(*a):
                seen.append(a[-2])
                return fn(*a)
            return call

    monkeypatch.setattr(tk, "load_library", Spy)
    damping = torch.full((), 1e-6, device=cuda)
    tk.ndt_align_loop(*_loop_call(seqs[0]))
    for B in (1, 3, 5):
        tk.ndt_align_loop_batched(tk.stack_maps([s[0] for s in seqs[:B]]),
                                  *(torch.stack([s[i] for s in seqs[:B]]) for i in range(1, 6)),
                                  0.1, 0.01, damping, 64, 2)
    torch.cuda.synchronize()
    per_sm = lib.lgs_ndt_loop_blocks_per_sm()
    want = tk.loop_blocks(32768, torch.cuda.get_device_properties(cuda).multi_processor_count,
                          per_sm, lib.lgs_ndt_loop_tile())
    assert per_sm >= 1 and seen == [want] * 4


def test_loop_rejects_bad_inputs(cuda):
    args = list(_loop_call(_loop_inputs(300, 2.0, cuda)))
    bad = {1: args[1].double(), 2: args[2].cpu(), 3: args[3][:3], 4: torch.tensor(0.25)}
    before = tk.ndt_align_loop.launches
    for i, x in bad.items():
        with pytest.raises(ValueError):
            tk.ndt_align_loop(*args[:i], x, *args[i + 1:])
    assert tk.ndt_align_loop.launches == before


def test_fused_step_makes_no_synchronous_read(cuda):
    """`odometry/fused.py`'s step with NDT, given its inputs on the card, makes no
    synchronous read: three frames under `torch.cuda.set_sync_debug_mode("error")`
    (after one warm-up frame, which builds the library and the cached constants), with a
    real target rebuilt from the ring."""
    from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
    from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend

    cfg = apply_cli_overrides(PipelineConfig(), [
        "prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=16384",
        "capacity.filtered_points=4096", "capacity.voxel_capacity=32768",
        "scan_matcher.max_scan_accumulate_num=5"])
    init_state, step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter,
                                                cfg.capacity, device=cuda)
    seq = SyntheticSequence(n_frames=4, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 4 / 90)
    raws = []
    for scan, _ in seq:
        raw = np.full((cfg.capacity.raw_points, 3), PAD_VALUE, np.float32)
        raw[:len(scan)] = scan
        raws.append(torch.as_tensor(raw, device=cuda))
    eye3 = torch.eye(3, device=cuda)
    eye4 = torch.eye(4, device=cuda)
    state, ring = init_state(), aux["init_ring"]()
    state, out = step(state, raws[0], aux["rebuild"](ring), eye3, False, eye4, False)
    ring, target = aux["insert_and_rebuild"](ring, 0, out.kf_cloud, out.kf_mask, out.pose)
    torch.cuda.synchronize()
    outs = []
    try:
        torch.cuda.set_sync_debug_mode("error")
        for raw in raws[1:]:
            state, out = step(state, raw, target, eye3, False, eye4, False)
            outs.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(o.converged) for o in outs)
    assert all(int(o.iterations) > 0 for o in outs)


def test_batch_odometry_card_matches_cpu_and_single_runs(cuda):
    """`batch_odometry` on the card (B = 2, 4 frames of 4,096 points): the first frames
    agree with the CPU's to 1 cm / 1e-3 (pose entries), `is_keyframe` equal, and the batch
    equals two runs of one bit for bit; the batched loop kernel launched, the single not."""
    from lidar_graph_slam_tpu_torch.core.config import NdtConfig, ScanMatcherConfig
    from lidar_graph_slam_tpu_torch.parallel.multi_sequence import batch_odometry

    B, F, N = 2, 4, 4096
    scans = np.full((B, F, N, 3), 1.0e6, np.float32)
    masks = np.zeros((B, F, N), bool)
    for b in range(B):
        for f, (scan, _) in enumerate(SyntheticSequence(n_frames=F, seed=10 + b, max_points=N,
                                                        laps=0.1, radius=30.0 + 2 * b)):
            scans[b, f, :len(scan)], masks[b, f, :len(scan)] = scan, True
    cfg = ScanMatcherConfig(max_scan_accumulate_num=3, ndt=NdtConfig(max_iterations=32))
    before = (tk.ndt_align_loop_batched.launches, tk.ndt_align_loop.launches)
    _, card = batch_odometry(scans, masks, cfg, map_capacity=8192, device=cuda)
    assert tk.ndt_align_loop_batched.launches > before[0]
    assert tk.ndt_align_loop.launches == before[1]
    _, cpu = batch_odometry(scans, masks, cfg, map_capacity=8192, device="cpu")
    np.testing.assert_allclose(card["pose"].cpu().numpy(), cpu["pose"].numpy(), atol=1e-2)
    assert torch.equal(card["is_keyframe"].cpu(), cpu["is_keyframe"])
    for b in range(B):
        _, one = batch_odometry(scans[b:b + 1], masks[b:b + 1], cfg, map_capacity=8192,
                                device=cuda)
        assert all(torch.equal(v[b], one[k][0]) for k, v in card.items())


def test_pipeline_card_matches_cpu(cuda):
    """Five frames of the loops-off pipeline at a small capacity on the card and on the
    CPU (plain versions): poses within 1 cm / 1 mrad, the same keyframes, and the NDT
    loop kernel launched by the card's run (the gathered-rows kernel not at all: only
    NDT's line search uses it)."""
    cfg = apply_cli_overrides(PipelineConfig(), [
        "enable_loop_closure=False", "prefilter.leaf_size=0.3", "prefilter.mean_k=10",
        "capacity.raw_points=16384", "capacity.filtered_points=4096",
        "capacity.voxel_capacity=32768", "scan_matcher.max_scan_accumulate_num=5"])
    seq = SyntheticSequence(n_frames=5, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 5 / 90)
    scans = [s for s, _ in seq]
    results = {}
    for device in ("cuda", "cpu"):
        before = tk.ndt_align_loop.launches, tk.ndt_accumulate.launches
        pipe = SlamPipeline(cfg, device=device)
        for s in scans:
            pipe.process_scan(s)
        results[device] = pipe.result()
        fused = tk.ndt_align_loop.launches - before[0]
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


def _gicp_to(target, device):
    return gicp.GicpTarget(grid=type(target.grid)(**{
        k: v.to(device) for k, v in vars(target.grid).items()}), covs=target.covs.to(device),
        valid=target.valid.to(device))


def test_gicp_align_card_matches_cpu(cuda):
    """One `gicp_align` from the same target and covariances on the card (one C call of
    max_iterations launches of the GICP loop kernel, and no `ndt_accumulate`) and on the
    CPU (plain version, no launch), with and without reciprocal."""
    target, src, mask, covs = _gicp_problem(cuda)
    cpu = torch.device("cpu")
    target_cpu = _gicp_to(target, cpu)
    for reciprocal in (False, True):
        res = {}
        for dev, tgt in ((cuda, target), (cpu, target_cpu)):
            p, m, c = src.to(dev), mask.to(dev), covs.to(dev)
            kw = dict(reciprocal=True, source_grid=build_hash_grid(p, m, 2.0)) if reciprocal else {}
            before = (tk.gicp_align_loop.launches, tk.ndt_accumulate.launches)
            r = gicp.gicp_align(tgt, p, m, torch.eye(4, device=dev), c, **kw)
            launched = (tk.gicp_align_loop.launches - before[0],
                        tk.ndt_accumulate.launches - before[1])
            assert launched == ((64, 0) if dev.type == "cuda" else (0, 0))
            res[dev.type] = r
        a, b = res["cuda"], res["cpu"]
        np.testing.assert_allclose(a.transform.cpu().numpy(), b.transform.numpy(), atol=1e-4)
        assert int(a.iterations) == int(b.iterations) and bool(a.converged) == bool(b.converged)
        assert abs(int(a.num_inliers) - int(b.num_inliers)) <= 0.01 * int(b.num_inliers)
        assert bool(a.converged) and int(a.num_inliers) > 1000


# -- the GICP loop kernel (`gicp_iteration`, `csrc/gicp_loop.cu`) ---------------------------


def _gicp_loop_args(problem, max_iterations=64, bucket_cap=32, neighborhood=7,
                    reciprocal=False, T0=None):
    target, src, mask, covs = problem
    grid = build_hash_grid(src, mask, 2.0) if reciprocal else None
    T0 = torch.eye(4, device=src.device) if T0 is None else T0
    return [target, src, mask, covs, T0, 4.0, 0.01, torch.full((), 1e-6, device=src.device),
            max_iterations, bucket_cap, neighborhood, grid]


def _gicp_loop_matches_plain(args):
    """The GICP kernel loop (run twice: bit-identical) against the plain loop on the same
    card tensors: T to 1e-4, the same iterations and done, inliers within 0.1%, fitness
    to rtol 1e-4. Returns the kernel loop's carry."""
    out = tk.gicp_align_loop(*args)
    again = tk.gicp_align_loop(*args)
    ref = tk.gicp_align_loop_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert float((out[0] - ref[0]).abs().max()) <= 1e-4
    assert (bool(out[1]), int(out[2])) == (bool(ref[1]), int(ref[2]))
    assert abs(int(out[4]) - int(ref[4])) <= 0.001 * int(ref[4])
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-4)
    return out


def _tile_runs(problem, bucket_cap=32, neighborhood=7, tile=128):
    """Per tile of `tile` source points at T = I: the distinct runs (table starts clamped
    to [0, n - B]) its masked-in points' cells name, and their base cells' distinct keys
    (what the kernel stages a tile; `chip_smoke.stage_counts`)."""
    target, src, mask, _ = problem
    grid = target.grid
    n, size = grid.packed.shape[0], grid.table.shape[0]
    base = voxel_coords(src, grid.origin, 1.0 / grid.cell_size)
    nc = base[:, None, :] + _offsets_for(neighborhood, src.device)
    flat, in_range = _flat_table_index(nc, TABLE_DIMS)
    start = torch.where(in_range & mask[:, None], grid.table[flat.clamp(max=size - 1).long()],
                        -1)
    keys = pack_key(base)
    runs, cells = [], []
    for t in range(0, src.shape[0], tile):
        live = start[t:t + tile] >= 0
        if bool(mask[t:t + tile].any()):
            runs.append(torch.unique(start[t:t + tile][live].clamp(max=n - bucket_cap)).numel())
            cells.append(torch.unique(keys[t:t + tile][mask[t:t + tile]]).numel())
    return runs, cells


def _gicp_case_problem(device, case):
    """A GICP problem whose tiles stress the kernel's stage, with the comparison's
    iterations. `scan`: `_gicp_problem`. `one_cell`: a tile of 128 for each 2 m cell of the
    target's grid that holds at least 32 masked-in source rows, those rows repeated. `overflow`: its
    masked-in source rows in a seeded random order, so that a tile's points spread over
    the scan and name more runs than the stage holds (read from global memory). `ties`:
    a source on a 3 m lattice and a target that holds, for each source point p, two rows
    at the same distance (p +- 0.5 m along x, or +- 0.375 m along y; in two cells or in
    two slots of one cell) and eight filler rows each (0.625 m or more further out, so
    that a row's cell holds enough rows for a covariance), every coordinate a multiple of
    1/8 m: exact distances, so the first of the two in flat order must win; compared at
    one iteration (from T = I, where the kernel's transform and the plain one are
    exact)."""
    if case == "ties":
        rng = np.random.default_rng(21)
        g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(4), indexing="ij"), -1)
        q = g.reshape(-1, 3) * 3.0 + 1.5 + np.round(rng.uniform(-0.6, 0.6, (1024, 3)) * 8) / 8
        along = np.where(np.arange(1024)[:, None] % 2 == 0, [[0.5, 0.0, 0.0]],
                         [[0.0, 0.375, 0.0]])
        flip = np.where(rng.random((1024, 1)) < 0.5, 1.0, -1.0)
        rows = np.concatenate([q + flip * along, q - flip * along])
        out = np.sign(np.concatenate([flip * along, -flip * along])) * 0.625
        perp = np.concatenate([along[:, [1, 0, 2]]] * 2) > 0  # y for x-pairs, x for y
        a, z = perp * 0.625, np.array([0.0, 0.0, 0.625])
        fill = [rows + out, rows + 2 * out, rows + out + a, rows + out - a, rows + out + z,
                rows + out - z, rows + z, rows - z]
        tgt = np.concatenate([rows] + fill).astype(np.float32)
        tc = torch.as_tensor(tgt, device=device)
        target = gicp.build_gicp_target(tc, torch.ones(len(tgt), dtype=torch.bool,
                                                       device=device), 2.0)
        src = torch.as_tensor(q.astype(np.float32), device=device)
        mask = torch.ones(len(q), dtype=torch.bool, device=device)
        covs, _ = gicp.estimate_covariances(src, mask, 2.0)
        return (target, src, mask, covs), 1
    problem = _gicp_problem(device)
    if case == "scan":
        return problem, 64
    target, src, mask, covs = problem
    rows = torch.nonzero(mask)[:, 0]
    if case == "overflow":
        g = torch.Generator().manual_seed(5)
        rows = rows[torch.randperm(rows.numel(), generator=g).to(device)]
    else:  # one_cell: a tile for each cell of at least 32 rows, its rows repeated
        key = pack_key(voxel_coords(src[rows], target.grid.origin,
                                    1.0 / target.grid.cell_size))
        key, order = torch.sort(key, stable=True)
        _, counts = torch.unique_consecutive(key, return_counts=True)
        first = torch.cumsum(counts, 0) - counts
        rows = torch.cat([rows[order[f + torch.arange(128, device=device) % c]]
                          for f, c in zip(first.tolist(), counts.tolist()) if c >= 32])
    return (target, src[rows].contiguous(), mask[rows].contiguous(),
            covs[rows].contiguous()), 64


# (neighborhood, bucket_cap, reciprocal): every instantiation of the kernel but one.
GICP_VARIANTS = [(7, 32, False), (7, 32, True), (7, 16, False), (7, 16, True),
                 (27, 32, False), (27, 16, False), (27, 32, True)]
# Each stage case at the path's query and at the largest stage (27 cells, 32 rows).
GICP_STAGE_CASES = [pytest.param(case, *v, id=f"{case}-{v[0]}-{v[1]}-{v[2]}")
                    for case in ("one_cell", "overflow", "ties")
                    for v in ((7, 32, False), (27, 32, False))]
GICP_LOOP_CASES = [pytest.param("scan", *v, id="-".join(map(str, v)))
                   for v in GICP_VARIANTS] + GICP_STAGE_CASES


@pytest.mark.parametrize("case,neighborhood,bucket_cap,reciprocal", GICP_LOOP_CASES)
def test_gicp_loop_kernel_matches_plain_loop(cuda, case, neighborhood, bucket_cap, reciprocal):
    """The GICP loop kernel against the plain loop (`_gicp_loop_matches_plain`); one C
    call enqueues max_iterations launches; a loop cut at one iteration has exactly the
    plain loop's inliers (the same matches). On the real scan and on the stage's cases
    (`_gicp_case_problem`): tiles in one cell, tiles whose runs overflow the stage, and
    planted ties."""
    problem, its = _gicp_case_problem(cuda, case)
    runs, cells = _tile_runs(problem, bucket_cap, neighborhood)
    stage = tk.loop_kernel_attributes(cuda, (neighborhood, bucket_cap, reciprocal))["stage_runs"]
    if case == "one_cell":
        assert len(cells) >= 2 and max(cells) == 1
    if case == "overflow":
        assert max(runs) > stage
    args = _gicp_loop_args(problem, its, bucket_cap, neighborhood, reciprocal)
    before = tk.gicp_align_loop.launches
    _, done, it, _, inl = _gicp_loop_matches_plain(args)
    assert tk.gicp_align_loop.launches == before + 2 * its
    if case == "scan":
        assert bool(done) and 0 < int(it) < 64 and int(inl) > 1000
    else:
        assert int(inl) > 100
    args[8] = 1
    one, ref = tk.gicp_align_loop(*args), tk.gicp_align_loop_plain(*args)
    assert int(one[4]) == int(ref[4]) and int(one[2]) == 1


@pytest.mark.parametrize("case,n", [pytest.param("scan", n, id=str(n)) for n in (1, 300, 50000)]
                         + [pytest.param(c, 300, id=f"{c}-300")
                            for c in ("one_cell", "overflow", "ties")])
def test_gicp_loop_kernel_ragged_sizes(cuda, case, n):
    """Source sizes around the kernel's tile of 128 points and beyond the resident grid
    (391 tiles at 50,000: persistent blocks take two): the kernel against the plain loop;
    also the stage's cases cut to 300 points (a ragged last tile). One point matches at
    most one row: fewer than 6 inliers zero the step."""
    (target, src, mask, covs), its = _gicp_case_problem(cuda, case)
    idx = torch.arange(n, device=cuda) % src.shape[0]
    problem = (target, src[idx].contiguous(), mask[idx].contiguous(), covs[idx].contiguous())
    out = _gicp_loop_matches_plain(_gicp_loop_args(problem, its))
    if n == 1:
        assert int(out[2]) == 1 and torch.equal(out[0], torch.eye(4, device=cuda))


@pytest.mark.parametrize("case", ["scan", "overflow", "ties"])
@pytest.mark.parametrize("its", [1, 64])
def test_gicp_loop_kernel_reruns_bit_identical(cuda, case, its):
    """The kernel's carry after one and after 64 launches is the same bit for bit in two
    runs on the same inputs (no float atomics; the stage's numbering of runs may differ
    between runs, its rows do not)."""
    problem, _ = _gicp_case_problem(cuda, case)
    for reciprocal in (False, True):
        args = _gicp_loop_args(problem, its, reciprocal=reciprocal)
        first = [x.clone() for x in tk.gicp_align_loop(*args)]
        again = tk.gicp_align_loop(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_gicp_loop_kernel_early_exit_and_worked_count(cuda):
    """A loop that is done after k iterations does work in k launches only; the others
    exit at once (the device count of the GICP kernel's working launches, apart from the
    NDT loop kernel's)."""
    args = _gicp_loop_args(_gicp_problem(cuda))
    tk.worked_launches(reset=True)
    out = tk.gicp_align_loop(*args)
    worked = tk.worked_launches(kernel="gicp_iteration")
    assert worked == int(out[2]) < 64
    assert tk.worked_launches(kernel="ndt_iteration") == 0
    assert tk.worked_launches(reset=True) == worked


@pytest.mark.parametrize("case", ["all-masked", "far-away"])
def test_gicp_loop_kernel_degenerate_steps(cuda, case):
    """No inliers (every point masked out, or every point 500 m from the target): the
    step is zeroed, T stays T0 bit for bit, and the loop is done after one iteration with
    0 inliers, as in the plain loop."""
    target, src, mask, covs = _gicp_problem(cuda)
    if case == "all-masked":
        mask = torch.zeros_like(mask)
    else:
        src = src + 500.0
    T0 = torch.eye(4, device=cuda)
    out = _gicp_loop_matches_plain(_gicp_loop_args((target, src, mask, covs), T0=T0))
    assert torch.equal(out[0], T0) and bool(out[1]) and int(out[2]) == 1
    assert int(out[4]) == 0


def test_gicp_loop_on_two_streams_at_once(cuda):
    """Two threads, each on its own stream, run the GICP loop and the NDT loop 10 times
    each at the same time: every result equals the serial one bit for bit."""
    gargs = _gicp_loop_args(_gicp_problem(cuda), reciprocal=True)
    nargs = _loop_call(_loop_inputs(32768, 2.0, cuda, seed=3))
    calls = {"gicp": lambda: tk.gicp_align_loop(*gargs),
             "ndt": lambda: tk.ndt_align_loop(*nargs)}
    serial = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    barrier = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def run(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [(k, calls[k]()) for _ in range(10) for k in calls]
            stream.synchronize()
            results[t] = outs
        except BaseException as e:  # noqa: BLE001 — raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for outs in results.values():
        for k, out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, serial[k])), k


def test_gicp_loop_rejects_bad_inputs(cuda):
    problem = _gicp_problem(cuda, n=1024)
    args = _gicp_loop_args(problem)
    target = problem[0]
    bad = {1: args[1].double(), 2: args[2].cpu(), 3: args[3][:, :2], 4: args[4][:3],
           7: torch.tensor(1e-6), 9: 8, 10: 9,
           0: gicp.GicpTarget(grid=target.grid, covs=target.covs[:-1], valid=target.valid)}
    before = tk.gicp_align_loop.launches
    for i, x in bad.items():
        with pytest.raises(ValueError):
            tk.gicp_align_loop(*args[:i], x, *args[i + 1:])
    assert tk.gicp_align_loop.launches == before


def test_gicp_align_makes_no_synchronous_read(cuda):
    """`make_gicp_matcher`'s align (the classic driver's GICP alignment: its source grid
    when reciprocal, and one loop call) under `torch.cuda.set_sync_debug_mode("error")`,
    after a warm-up align that builds the library and the cached constants."""
    from lidar_graph_slam_tpu_torch.core.config import GicpConfig

    target, src, mask, covs = _gicp_problem(cuda)
    for use_reciprocal in (False, True):
        _, align = gicp.make_gicp_matcher(GicpConfig(use_reciprocal=use_reciprocal))
        T0 = torch.eye(4, device=cuda)
        align(target, src, mask, T0, covs)
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            res = align(target, src, mask, T0, covs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert bool(res.converged) and int(res.num_inliers) > 1000


def test_fused_gicp_step_makes_no_synchronous_read(cuda):
    """`odometry/fused.py`'s step with GICP (its covariances and the GICP loop) makes no
    synchronous read: three frames under `torch.cuda.set_sync_debug_mode("error")` after
    one warm-up frame, against a real target rebuilt from the ring; the GICP loop kernel
    launched, `ndt_accumulate` not."""
    from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
    from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend

    cfg = apply_cli_overrides(PipelineConfig(), [
        "prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=16384",
        "capacity.filtered_points=4096", "capacity.voxel_capacity=32768",
        "scan_matcher.max_scan_accumulate_num=5", "scan_matcher.registration_method=GICP"])
    init_state, step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter,
                                                cfg.capacity, device=cuda)
    seq = SyntheticSequence(n_frames=4, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 4 / 90)
    raws = []
    for scan, _ in seq:
        raw = np.full((cfg.capacity.raw_points, 3), PAD_VALUE, np.float32)
        raw[:len(scan)] = scan
        raws.append(torch.as_tensor(raw, device=cuda))
    eye3 = torch.eye(3, device=cuda)
    eye4 = torch.eye(4, device=cuda)
    state, ring = init_state(), aux["init_ring"]()
    state, out = step(state, raws[0], aux["rebuild"](ring), eye3, False, eye4, False)
    ring, target = aux["insert_and_rebuild"](ring, 0, out.kf_cloud, out.kf_mask, out.pose)
    torch.cuda.synchronize()
    before = (tk.gicp_align_loop.launches, tk.ndt_accumulate.launches)
    outs = []
    try:
        torch.cuda.set_sync_debug_mode("error")
        for raw in raws[1:]:
            state, out = step(state, raw, target, eye3, False, eye4, False)
            outs.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(o.converged) for o in outs)
    assert tk.gicp_align_loop.launches == before[0] + 3 * cfg.scan_matcher.gicp.max_iterations
    assert tk.ndt_accumulate.launches == before[1]


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


def _loop_backend(device, async_backend, method="ICP", mesh=None):
    """The verifier fixture of `tests/test_loop_verifiers.py:build_loop_backend("ICP")`:
    31 keyframes on a ~128 m loop, the latest reported with 0.6 m / 0.03 rad of drift."""
    cfg = GraphSlamConfig(accumulate_distance_threshold=100.0,
                          search_for_candidate_threshold=15.0, registration_method=method,
                          icp=IcpConfig(max_iterations=40), async_backend=async_backend)
    cap = CapacityConfig(max_keyframes=64, max_loop_factors=8, keyframe_points=4096,
                         loop_submap_points=65536, voxel_capacity=32768)
    back = GraphBasedSLAM(cfg, cap, device=device, mesh=mesh)
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
    launched the kernels in the verification's NDT pre-align (and, for GICP, the GICP
    loop kernel; `ndt_accumulate` not at all)."""
    rec = {}
    for device, async_backend in ((cuda, True), (torch.device("cpu"), False)):
        before = (tk.gicp_align_loop.launches, tk.ndt_accumulate.launches)
        back = _loop_backend(device, async_backend, method)
        assert back.try_close_loop()
        rec[device.type] = (back.loop_log[-1], back.verify_launches, back.optimized_poses())
        loops = tk.gicp_align_loop.launches - before[0]
        assert (loops > 0) == (device.type == "cuda" and method == "GICP"), loops
        assert tk.ndt_accumulate.launches == before[1]
    (a, launches, pa), (c, cpu_launches, pc) = rec["cuda"], rec["cpu"]
    assert (a["candidate"], a["accepted"], a["converged"]) == (c["candidate"], c["accepted"],
                                                              c["converged"])
    assert launches > 0 and cpu_launches == 0
    np.testing.assert_allclose(a["fitness"], c["fitness"], rtol=1e-3)
    np.testing.assert_allclose(a["transform"], c["transform"], atol=1e-3)
    np.testing.assert_allclose(pa, pc, atol=1e-3)


def test_verification_on_a_card_mesh_matches_unmeshed(cuda):
    """The asynchronous verification with a mesh of the card (the candidate and the source
    placed by `shard_batch`, each result read back on the stream that computed it) makes
    the unmeshed back end's decision, fitness and transform."""
    logs = []
    for mesh in (None, Mesh((cuda,))):
        back = _loop_backend(cuda, True, mesh=mesh)
        assert back.try_close_loop()
        logs.append(back.loop_log[-1])
    a, b = logs
    assert (a["candidate"], a["accepted"], a["converged"]) == (b["candidate"], b["accepted"],
                                                              b["converged"])
    assert abs(a["fitness"] - b["fitness"]) < 1e-4
    np.testing.assert_allclose(a["transform"], b["transform"], atol=1e-4)


# -- FPFH + RANSAC global registration, and the checkpoint, on the card ------------------
# `match_features` under the package's float32 pin: against a float64 evaluation the card's
# distances agree to 1e-5 (a TF32 product would be off by ~1e-3 on these L1-normalised
# vectors) and its matches equal the CPU's on 99.5% of rows. `global_register` card
# against CPU: both recover the offset within 5 deg / 1 m (the streams of the two
# generators differ, so the transforms are not compared with each other). A checkpoint
# saved on the card and loaded on the CPU, and back, holds the same arrays.

def _feature_pair(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.random((n, 33)).astype(np.float32) ** 4
    f = (f.reshape(n, 3, 11) / f.reshape(n, 3, 11).sum(-1, keepdims=True)).reshape(n, 33)
    g = f[rng.permutation(n)] + rng.normal(scale=2e-3, size=(n, 33)).astype(np.float32)
    valid_f, valid_g = rng.random(n) > 0.1, rng.random(n) > 0.1
    return f, valid_f, g.astype(np.float32), valid_g


def test_match_features_keeps_full_float32(cuda):
    from lidar_graph_slam_tpu_torch.registration import features

    f, vf, g, vg = _feature_pair()
    seen = {}
    real_matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen["precision"] = torch.get_float32_matmul_precision()
        seen["tf32"] = torch.backends.cuda.matmul.allow_tf32
        return real_matmul(a, b)

    torch.Tensor.__matmul__ = spy
    try:
        idx, ok = features.match_features(*(torch.as_tensor(x, device=cuda)
                                            for x in (f, vf, g, vg)))
    finally:
        torch.Tensor.__matmul__ = real_matmul
    assert seen == {"precision": "highest", "tf32": False}
    # The product itself, against float64: full float32, not TF32.
    fc, gc = torch.as_tensor(f, device=cuda), torch.as_tensor(g, device=cuda)
    exact = (fc.double() @ gc.double().T)
    assert float((fc @ gc.T - exact).abs().max()) < 1e-6
    c_idx, c_ok = features.match_features(*(torch.as_tensor(x) for x in (f, vf, g, vg)))
    assert float((ok.cpu() == c_ok).float().mean()) >= 0.995 and int(c_ok.sum()) > 100
    both = ok.cpu() & c_ok
    assert torch.equal(idx.cpu()[both], c_idx[both])


def test_argmax_takes_the_first_maximum(cuda):
    """RANSAC's integer scores tie often; the winner must be the first maximum, as on the
    CPU and in the reference."""
    rng = np.random.default_rng(0)
    for n in (2048, 100_000):
        score = torch.as_tensor(rng.integers(0, 40, size=n).astype(np.int32))
        first = int(torch.nonzero(score == score.max())[0])
        assert int(torch.argmax(score)) == first
        assert int(torch.argmax(score.to(cuda))) == first
    d2 = torch.as_tensor(rng.integers(0, 5, size=(512, 512)).astype(np.float32))
    assert torch.equal(torch.argmin(d2.to(cuda), dim=1).cpu(), torch.argmin(d2, dim=1))
    assert torch.equal(torch.min(d2.to(cuda), dim=1).indices.cpu(), torch.argmin(d2, dim=1))


def _offset_pair(yaw_deg, offset, n=8192):
    rng = np.random.default_rng(0)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (8.0, -3.0, 1.5)
    tgt = simulate_scan(world, pose, rng, max_points=n, noise=0.015)
    a = np.deg2rad(yaw_deg)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    t = np.asarray(offset, np.float32)
    return ((tgt - t) @ R).astype(np.float32), tgt, R, t


@pytest.mark.parametrize("yaw_deg,offset", [(150.0, (18.0, -9.0, 0.3)),
                                            (75.0, (-12.0, 20.0, -0.2))])
def test_global_register_card_and_cpu(cuda, yaw_deg, offset):
    from lidar_graph_slam_tpu_torch.registration.features import global_register

    src, tgt, R, t = _offset_pair(yaw_deg, offset)
    sc, tc = PointCloud.from_array(src, capacity=8192), PointCloud.from_array(tgt, capacity=8192)
    for device in (cuda, torch.device("cpu")):
        args = [x.to(device) for x in (sc.points, sc.mask, tc.points, tc.mask)]
        T, hits, ok, diag = global_register(*args, tgt_viewpoint=np.zeros(3, np.float32),
                                            return_diag=True)
        again = global_register(*args, tgt_viewpoint=np.zeros(3, np.float32))
        assert T.device.type == device.type and torch.equal(T, again[0])
        T = T.cpu().numpy()
        rot = np.rad2deg(np.arccos(np.clip((np.trace(T[:3, :3].T @ R) - 1) / 2, -1, 1)))
        assert bool(ok) and rot < 5.0 and np.linalg.norm(T[:3, 3] - t) < 1.0, (device, rot)
        assert int(diag["n_3pt_valid"]) + int(diag["n_yaw_valid"]) > 0


@pytest.mark.parametrize("fused", [True, False])
def test_checkpoint_card_to_cpu_and_back(cuda, tmp_path, fused):
    from lidar_graph_slam_tpu_torch.utils import checkpoint

    cfg = apply_cli_overrides(PipelineConfig(), [
        "prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=8192",
        "capacity.filtered_points=4096", "capacity.keyframe_points=4096",
        "capacity.loop_submap_points=65536", "capacity.max_keyframes=256",
        "capacity.voxel_capacity=32768", "capacity.max_loop_factors=16",
        f"fused_frontend={fused}"])
    scans = [s for s, _ in SyntheticSequence(n_frames=8, seed=6, max_points=4096,
                                             laps=0.25 * 8 / 24)]
    pipe = SlamPipeline(cfg)
    assert pipe.device.type == "cuda"
    for s in scans[:5]:
        pipe.process_scan(s)
    on_card, on_cpu = str(tmp_path / "card.npz"), str(tmp_path / "cpu.npz")
    checkpoint.save_pipeline(pipe, on_card)
    cpu_pipe = checkpoint.load_pipeline(on_card, device="cpu")
    assert cpu_pipe.device.type == "cpu" and cpu_pipe.back.graph.poses.device.type == "cpu"
    checkpoint.save_pipeline(cpu_pipe, on_cpu)
    a, b = np.load(on_card), np.load(on_cpu)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = checkpoint.load_pipeline(on_cpu)  # onto the card, the default
    assert back.device.type == "cuda" and back.back.graph.poses.device.type == "cuda"
    for s in scans[5:]:
        pipe.process_scan(s)
        back.process_scan(s)
    res, res_b = pipe.result(), back.result()
    np.testing.assert_array_equal(res_b.keyframe_frame_indices, res.keyframe_frame_indices)
    np.testing.assert_allclose(res_b.odometry_poses, res.odometry_poses,
                               atol=5e-2 if fused else 1e-4)


# -- the voxel finalize and the 3x3 eigensolve (csrc/voxel_finalize.cu) -------------------

FINALIZE_OUT = ("seg_keys", "stats", "keys", "means", "inv_covs", "valid", "packed")


def _flat(out):
    """`ndt_finalize`'s ((seg_keys, stats), rows) as one tuple, in FINALIZE_OUT's order."""
    return (*out[0], *out[1])


def _ring_points(seed=3, n_frames=5, max_points=16384):
    """A real ring's points: scans of the loop course at their poses."""
    seq = SyntheticSequence(n_frames=n_frames, seed=seed, max_points=max_points, radius=30.0,
                            laps=0.05)
    return np.concatenate([scan @ gt[:3, :3].T + gt[:3, 3] for scan, gt in seq]).astype(
        np.float32)


# The far case's offset: the cloud's min corner lies far from the world origin.
FAR_ORIGIN = np.array([-812.5, 433.25, -21.0], np.float32)


def _finalize_cloud(kind, seed=0):
    """(points, mask, capacity) of a card case: `ring` (five 16,384-point scans, fine C =
    65,536), `ring28` (the same ring, ~28% of its rows valid as on the drift course, the
    rest padding spread through it), `long_run` (6,000 points in one 2 m voxel, longer
    than a warp's stage of two 128-point rounds, among a few hundred others), `over_capacity` (a
    uniform 40 m cube, ~7 points a voxel, at C = 1,024: voxels past C), `no_valid` (every
    row padding), `one_point`, `tiny` (six voxels of 1 and 8 points at C = 3, coarse C = 1:
    a partial last block in both modes), `odd_capacity` (the ring at C = 1,000, coarse C =
    500: partial last blocks, voxels past C) and `far` (a quarter of the ring moved to
    FAR_ORIGIN, with 2,000 points spread over 4.2 km x 4.2 km x 520 m from it, so the keys
    reach COORD_MAX on every axis; C = 12,345, coarse C = 6,172)."""
    rng = np.random.default_rng(seed)
    if kind in ("ring", "ring28", "odd_capacity"):
        pts = _ring_points()
        mask = rng.random(len(pts)) < 0.28 if kind == "ring28" else np.ones(len(pts), bool)
        cap = 1000 if kind == "odd_capacity" else 65536
        return np.where(mask[:, None], pts, 1.0e6).astype(np.float32), mask, cap
    if kind == "far":
        spread = rng.uniform(0.0, 1.0, (2000, 3)) * np.array([4200.0, 4200.0, 520.0])
        quarter = _ring_points()[::4]
        pts = np.concatenate([quarter - quarter.min(0), spread])
        pts = (pts + FAR_ORIGIN).astype(np.float32)
        return pts, np.ones(len(pts), bool), 12345
    if kind == "tiny":
        centres = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 5.0], [11.0, 3.0, 1.0],
                            [21.0, 1.0, 5.0], [31.0, 7.0, 1.0]])
        pts = np.concatenate([np.full((1, 3), -20.0)]
                             + [c + rng.uniform(-0.3, 0.3, (8, 3)) for c in centres])
        return pts.astype(np.float32), np.ones(len(pts), bool), 3
    if kind == "long_run":
        # The anchor at (-20, -20, -20) puts the voxel borders on even coordinates.
        pts = np.concatenate([np.full((1, 3), -20.0), rng.uniform(40.1, 41.9, (6000, 3)),
                              rng.uniform(-20.0, 20.0, (500, 3))]).astype(np.float32)
        return pts, np.ones(len(pts), bool), 4096
    if kind == "over_capacity":
        pts = rng.uniform(-20.0, 20.0, (60000, 3)).astype(np.float32)
        return pts, np.ones(len(pts), bool), 1024
    n = 4096
    pts = rng.uniform(-30.0, 30.0, (n, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    if kind == "one_point":
        mask[1234] = True
    return np.where(mask[:, None], pts, 1.0e6).astype(np.float32), mask, 1024


def _level_inputs(device, kind="ring", coarse=False, seed=0):
    """`ndt_finalize`'s arguments (args, kwargs) for one level of `_finalize_cloud(kind)`
    as `build_ndt_pyramid` makes them: the fine level's sorted points, or the coarse
    level's runs over the fine moments (those of the plain version)."""
    from lidar_graph_slam_tpu_torch.ops import voxel as tv

    pts, mask, cap = _finalize_cloud(kind, seed)
    p, m = torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)
    res = tv.as_f32(2.0, p)
    origin, runs, pts_sorted, num_voxels = tv._sorted_points(p, m, res, cap)
    if not coarse:
        return (runs, origin, res), {"points": pts_sorted}
    fine_moments, _ = tv.ndt_finalize_plain(runs, origin, res, 6, points=pts_sorted)
    occupied = torch.arange(cap, device=device) < torch.clamp(num_voxels, max=cap)
    cruns, order, _ = tv._coarse_runs(fine_moments, occupied, 2, cap // 2)
    return (cruns, origin, res * 2), {"merge": (order, fine_moments, res, 2)}


def _assert_finalize_bit_equal(level, min_points=6):
    from lidar_graph_slam_tpu_torch.ops.voxel import ndt_finalize_plain

    args, kwargs = level
    before = tk.ndt_finalize.launches
    out = _flat(tk.ndt_finalize(*args, min_points, **kwargs))
    again = _flat(tk.ndt_finalize(*args, min_points, **kwargs))
    ref = _flat(ndt_finalize_plain(*args, min_points, **kwargs))
    torch.cuda.synchronize()
    assert tk.ndt_finalize.launches == before + 2
    for name, a, b, c in zip(FINALIZE_OUT, out, again, ref):
        assert torch.equal(a, b), name
        assert a.dtype == c.dtype and a.shape == c.shape, name
        assert torch.equal(a, c), (name, float((a.double() - c.double()).abs().max()))
        assert torch.equal(a.reshape(-1).view(torch.uint8), c.reshape(-1).view(torch.uint8)), name
    return dict(zip(FINALIZE_OUT, out))


@pytest.mark.parametrize("min_points", [6, 1])
@pytest.mark.parametrize("case", ["ring", "ring28", "long_run", "over_capacity", "no_valid",
                                  "one_point", "tiny", "odd_capacity", "far"])
def test_ndt_finalize_bit_equal_to_plain(cuda, case, min_points):
    """The kernel's moments and rows equal `ndt_finalize_plain`'s on the card bit for bit
    (signed zeros included), fine (the sorted points) and coarse (the merged fine
    moments): a real ring, the same ring ~28% valid, a run longer than the shared stage,
    more voxels than C, no valid point and one point, capacities of 3 and 1,000 (partial
    last blocks), a far origin with keys up to COORD_MAX, at min_points 6 and 1."""
    from lidar_graph_slam_tpu_torch.ops.voxel import COORD_MAX, unpack_key

    for coarse in (False, True):
        out = _assert_finalize_bit_equal(_level_inputs(cuda, case, coarse), min_points)
        valid, counts = out["valid"], out["stats"][:, 0]
        if case == "no_valid":
            assert not valid.any() and not counts.any()
        elif case == "one_point":
            assert int((counts > 0).sum()) == 1 and int(valid.sum()) == (min_points == 1)
        elif case == "tiny":  # the coarse row holds the 1-point voxel alone
            assert counts.tolist() == ([1.0] if coarse else [1.0, 8.0, 8.0])
            assert int(valid.sum()) == (min_points == 1) + (0 if coarse else 2)
        elif case in ("over_capacity", "odd_capacity"):
            assert bool(valid.any()) and (coarse or bool((counts > 0).all()))
        elif case == "far":
            assert bool(valid.any()) and int(valid.sum()) < valid.numel()
            if not coarse:
                coords = torch.stack(unpack_key(out["keys"][counts > 0]), -1)
                assert coords.amax(0).tolist() == list(COORD_MAX)
        else:
            assert 0 < int(valid.sum()) < valid.numel()
        if case == "long_run":
            assert float(counts.max()) == 6000.0


def test_segment_sum_adds_runs_in_order_on_the_card(cuda):
    """`torch.segment_reduce`, the plain version's run sums, adds each run in order on the
    card as on the CPU (where `tests/test_torch_voxel_finalize.py` holds it to an in-order
    loop): the ring's [N, 13] columns, bit for bit."""
    from lidar_graph_slam_tpu_torch.ops import voxel as tv

    (runs, origin, res), kw = _level_inputs(cuda, "ring28")
    card = tv._point_moments(runs, kw["points"], origin, res)
    cpu = tv._point_moments(tuple(x.cpu() for x in runs), kw["points"].cpu(), origin.cpu(),
                            res.cpu())
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu().reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_ndt_finalize_empty_ring(cuda):
    """The bootstrap target: no occupied voxel; every row invalid, padded, the identity,
    one launch a map on the pyramid's path; C = 0 launches nothing."""
    from lidar_graph_slam_tpu_torch.ops.voxel import build_ndt_pyramid

    out = _assert_finalize_bit_equal(_level_inputs(cuda, "no_valid"))
    assert not out["valid"].any() and torch.equal(
        out["inv_covs"], torch.eye(3, device=cuda).expand(1024, 3, 3))
    before = tk.ndt_finalize.launches
    pts = torch.full((512, 3), 1.0e6, device=cuda)
    coarse, fine = build_ndt_pyramid(pts, torch.zeros(512, dtype=torch.bool, device=cuda), 2.0,
                                     2, capacity=1024, coarse_capacity=512)
    assert tk.ndt_finalize.launches == before + 2
    assert int((fine.table >= 0).sum()) == int((coarse.table >= 0).sum()) == 0
    (runs, origin, res), kw = _level_inputs(cuda, "no_valid")
    empty = (runs[0], runs[1][:1], runs[2][:1])
    out = tk.ndt_finalize(empty, origin, res, 6, **kw)
    assert tk.ndt_finalize.launches == before + 2 and all(r.shape[0] == 0 for r in _flat(out))


def test_pyramid_on_the_card_equals_its_plain_rows(cuda, monkeypatch):
    """`build_ndt_pyramid` on the card launches `ndt_finalize` once a map, and its maps
    equal the same build with the plain version, every field bit for bit."""
    from lidar_graph_slam_tpu_torch.ops import voxel as tv

    p = torch.as_tensor(_ring_points(seed=5, n_frames=3), device=cuda)
    m = torch.ones(p.shape[0], dtype=torch.bool, device=cuda)
    before = tk.ndt_finalize.launches
    maps = tv.build_ndt_pyramid(p, m, 2.0, 2, capacity=65536, coarse_capacity=32768)
    assert tk.ndt_finalize.launches == before + 2
    monkeypatch.setattr(tk, "ndt_finalize", tv.ndt_finalize_plain)
    plain = tv.build_ndt_pyramid(p, m, 2.0, 2, capacity=65536, coarse_capacity=32768)
    for a, b in zip(maps, plain):
        for name in tv.NdtVoxelMap.__dataclass_fields__:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def _window_covariances(device, n=32768, seed=3):
    """GICP's matrices for the eigensolve (`gicp.safe_window_covariances`) of a
    synthetic scan."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=40.0, density=20.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=n)
    p = torch.as_tensor(scan, device=device)
    return gicp.safe_window_covariances(
        p, torch.ones(p.shape[0], dtype=torch.bool, device=device), 2.0)[1]


def test_eigh3x3_bit_equal_to_plain(cuda):
    """`eigh3x3` equals `_eigh3x3` on the card bit for bit: GICP's window covariances,
    random symmetric matrices (non-symmetric input: only the upper triangle is read),
    diagonal and tau = 0 ones, and a single matrix."""
    from lidar_graph_slam_tpu_torch.ops.voxel import _eigh3x3

    rng = np.random.default_rng(0)
    A = rng.normal(size=(4096, 3, 3)).astype(np.float32)
    tau0 = np.array([[2.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    cases = [_window_covariances(cuda), torch.as_tensor(A @ A.transpose(0, 2, 1), device=cuda),
             torch.as_tensor(A, device=cuda),
             torch.as_tensor(np.stack([np.diag(rng.normal(size=3)) for _ in range(64)]
                                      + [tau0] * 4).astype(np.float32), device=cuda),
             torch.as_tensor(tau0[None], device=cuda)]
    for M in cases:
        before = tk.eigh3x3.launches
        w, V = tk.eigh3x3(M)
        w2, V2 = tk.eigh3x3(M)
        rw, rV = _eigh3x3(M)
        torch.cuda.synchronize()
        assert tk.eigh3x3.launches == before + 2
        assert torch.equal(w, w2) and torch.equal(V, V2)
        assert torch.equal(w, rw) and torch.equal(V, rV)
        assert torch.equal(V.view(torch.int32), rV.view(torch.int32))


def test_gicp_covariances_and_normals_launch_eigh3x3(cuda, monkeypatch):
    """`estimate_covariances` and the FPFH normals launch `eigh3x3` once a call on the
    card, and equal the same calls with the plain eigensolve bit for bit."""
    from lidar_graph_slam_tpu_torch.ops.voxel import _eigh3x3
    from lidar_graph_slam_tpu_torch.registration import features

    rng = np.random.default_rng(1)
    world = make_world(rng, extent=30.0, density=5.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=8192)
    p = torch.as_tensor(scan, device=cuda)
    m = torch.ones(p.shape[0], dtype=torch.bool, device=cuda)

    def run():
        covs, ok = gicp.estimate_covariances(p, m, 1.0)
        normals, nok = features.estimate_normals(build_hash_grid(p, m, 1.0), p[:2048], m[:2048])
        return covs, ok, normals, nok

    before = tk.eigh3x3.launches
    out = run()
    assert tk.eigh3x3.launches == before + 2
    monkeypatch.setattr(tk, "eigh3x3", _eigh3x3)
    for a, b in zip(out, run()):
        assert torch.equal(a, b)
    assert bool(out[1].any()) and bool(out[3].any())


def test_voxel_finalize_kernels_reject_bad_inputs(cuda):
    (runs, origin, res), kw = _level_inputs(cuda, "over_capacity")
    (cruns, _, cres), ckw = _level_inputs(cuda, "over_capacity", coarse=True)
    order, (fkeys, fstats), fres, factor = ckw["merge"]
    pts = kw["points"]
    misaligned = torch.empty(pts.numel() + 1, device=cuda)[1:].view(-1, 3).copy_(pts)
    A = torch.eye(3, device=cuda).expand(8, 3, 3).contiguous()
    bad_finalize = [
        ((runs[0].long(), *runs[1:]), origin, res, kw),
        ((runs[0], runs[1].int(), runs[2]), origin, res, kw),
        ((runs[0], runs[1], runs[2][:-1]), origin, res, kw),
        (runs, origin.cpu(), res, kw),
        (runs, origin, res[None], kw),
        (runs, origin, res, {"points": pts[:, :2]}),
        (runs, origin, res, {"points": pts.double()}),
        (runs, origin, res, {"points": misaligned}),
        (runs, origin, res, {}),
        (runs, origin, res, {"points": pts, "merge": ckw["merge"]}),
        (cruns, origin, cres, {"merge": (order.int(), (fkeys, fstats), fres, factor)}),
        (cruns, origin, cres, {"merge": (order, (fkeys, fstats[:, :12]), fres, factor)}),
        (cruns, origin, cres, {"merge": (order, (fkeys.long(), fstats), fres, factor)}),
        (cruns, origin, cres, {"merge": (order, (fkeys, fstats), fres, 0)}),
    ]
    before = (tk.ndt_finalize.launches, tk.eigh3x3.launches)
    for r, o, rs, k in bad_finalize:
        with pytest.raises(ValueError):
            tk.ndt_finalize(r, o, rs, 6, **k)
    for bad in (A.double(), A[:, :2], A.transpose(1, 2), A.reshape(8, 9), A[0]):
        with pytest.raises(ValueError):
            tk.eigh3x3(bad)
    assert (tk.ndt_finalize.launches, tk.eigh3x3.launches) == before


def test_voxel_finalize_kernels_make_no_synchronous_read(cuda):
    """Both wrappers, both modes of `ndt_finalize`, under
    `torch.cuda.set_sync_debug_mode("error")` after a warm-up call."""
    (runs, origin, res), kw = _level_inputs(cuda, "ring28")
    (cruns, _, cres), ckw = _level_inputs(cuda, "ring28", coarse=True)
    A = _window_covariances(cuda, n=4096)
    tk.ndt_finalize(runs, origin, res, 6, **kw)
    tk.eigh3x3(A)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        _, rows = tk.ndt_finalize(runs, origin, res, 6, **kw)
        _, crows = tk.ndt_finalize(cruns, origin, cres, 6, **ckw)
        w, _ = tk.eigh3x3(A)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(rows[3].sum()) > 0 and int(crows[3].sum()) > 0 and bool(torch.isfinite(w).all())


def test_voxel_finalize_kernels_on_two_streams_at_once(cuda):
    """Two threads, each on its own stream, launch both entry points 20 times each at the
    same time: every result equals the serial one bit for bit."""
    (runs, origin, res), kw = _level_inputs(cuda, "ring", seed=2)
    A = _window_covariances(cuda, n=16384)
    calls = {"finalize": lambda: _flat(tk.ndt_finalize(runs, origin, res, 6, **kw)),
             "eigh": lambda: tk.eigh3x3(A)}
    serial = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    barrier = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def run(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [(k, calls[k]()) for _ in range(20) for k in calls]
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


# -- the ICP loop kernel and the loop gate's fitness (`csrc/icp_loop.cu`) --------------------
# `icp_iteration` against the plain loop (the reference's body in torch ops, the carry
# frozen after done) on the same card tensors: T to 1e-4, the same iterations and done,
# inliers within 0.1%, fitness to rtol 1e-4 (float32 sums in other orders, the step from
# moments about an anchor and a one-sided Jacobi SVD against cuSOLVER's); a loop cut at one
# iteration has exactly the plain loop's inliers (the same matches). 1 km from the origin
# the kernel is held to the same registration at the origin, moved there, no worse than
# the plain loop. `icp_fitness` against its plain version: score and fraction to rtol
# 1e-6.


def _icp_problem(device, n=8192, seed=7, far=0.0):
    """The registration fixture of `_gicp_problem` for ICP: the target's grid (2 m cells)
    and the source moved by the same perturbation, both clouds `far` m along each axis
    (the perturbation about the source's own position). Returns (grid, source, mask)."""
    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [5.0, -3.0, 1.5]
    tgt = simulate_scan(world, pose, rng, max_range=45.0, max_points=n, noise=0.01) + far
    src = simulate_scan(world, pose, rng, max_range=45.0, max_points=n, noise=0.01)
    tc = PointCloud.from_array(tgt.astype(np.float32), capacity=2 * n, device=device)
    sc = PointCloud.from_array(src, capacity=n + 1024, device=device)
    c, s_ = np.cos(0.03), np.sin(0.03)
    T = torch.tensor([[c, -s_, 0.0, 0.3], [s_, c, 0.0, -0.2], [0.0, 0.0, 1.0, 0.05],
                      [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
    moved = torch.where(sc.mask[:, None], sc.points @ T[:3, :3].T + T[:3, 3] + far, sc.points)
    return build_hash_grid(tc.points, tc.mask, 2.0), moved.contiguous(), sc.mask


def _icp_loop_args(problem, max_iterations=40, bucket_cap=16, neighborhood=7,
                   transform_epsilon=1e-7, fitness_epsilon=1e-6, T0=None):
    grid, src, mask = problem
    T0 = torch.eye(4, device=src.device) if T0 is None else T0
    return [grid, src, mask, T0, 4.0, transform_epsilon, fitness_epsilon, max_iterations,
            bucket_cap, neighborhood]


def _icp_loop_matches_plain(args):
    """The ICP kernel loop (run twice: bit-identical) against the plain loop on the same
    card tensors. Returns the kernel loop's carry."""
    out = tk.icp_align_loop(*args)
    again = tk.icp_align_loop(*args)
    ref = tk.icp_align_loop_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert float((out[0] - ref[0]).abs().max()) <= 1e-4
    assert (bool(out[1]), int(out[2])) == (bool(ref[1]), int(ref[2]))
    assert abs(int(out[4]) - int(ref[4])) <= 0.001 * int(ref[4])
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-4)
    return out


# (neighborhood, bucket_cap, transform epsilon, fitness epsilon): the verifier's query and
# stops, the ICP front end's, and the other two instantiations.
ICP_VARIANTS = [(7, 16, 1e-7, 1e-6), (7, 32, 0.01, 0.0), (27, 16, 1e-6, 0.0),
                (27, 32, 1e-7, 1e-6)]


@pytest.mark.parametrize("neighborhood,bucket_cap,eps,fit_eps", ICP_VARIANTS,
                         ids=[f"{v[0]}-{v[1]}" for v in ICP_VARIANTS])
def test_icp_loop_kernel_matches_plain_loop(cuda, neighborhood, bucket_cap, eps, fit_eps):
    """Every instantiation of `icp_iteration` against the plain loop; one C call enqueues
    max_iterations launches; the loop converges before max_iterations; a loop cut at one
    iteration has exactly the plain loop's inliers."""
    args = _icp_loop_args(_icp_problem(cuda), 40, bucket_cap, neighborhood, eps, fit_eps)
    before = tk.icp_align_loop.launches
    _, done, it, _, inl = _icp_loop_matches_plain(args)
    assert tk.icp_align_loop.launches == before + 2 * 40
    assert bool(done) and 0 < int(it) < 40 and int(inl) > 1000
    args[7] = 1
    one, ref = tk.icp_align_loop(*args), tk.icp_align_loop_plain(*args)
    assert int(one[4]) == int(ref[4]) and int(one[2]) == 1
    assert float((one[0] - ref[0]).abs().max()) <= 1e-4


def test_icp_loop_kernel_far_from_the_origin(cuda):
    """Both clouds 1 km from the origin, where a float32 coordinate's spacing is 6.1e-5 m:
    the same registration as at the origin, moved there (C T C^-1), is the yardstick. The
    kernel loop (its sums about the anchor) lands no farther from it than the plain loop
    (the reference's float32 means of world coordinates) does, plus 1e-4; the rotations
    agree to 1e-4 and the inliers to 0.1%; both loops converge."""
    args = _icp_loop_args(_icp_problem(cuda, far=1000.0))
    far, ref = tk.icp_align_loop(*args), tk.icp_align_loop_plain(*args)
    near = tk.icp_align_loop(*_icp_loop_args(_icp_problem(cuda)))
    C = torch.eye(4, dtype=torch.float64, device=cuda)
    C[:3, 3] = 1000.0
    want = C @ near[0].double() @ torch.linalg.inv(C)
    err, err_plain = (float((x[0].double() - want).abs().max()) for x in (far, ref))
    assert err <= err_plain + 1e-4, (err, err_plain)
    assert float((far[0][:3, :3] - ref[0][:3, :3]).abs().max()) <= 1e-4
    assert abs(int(far[4]) - int(ref[4])) <= 0.001 * int(ref[4])
    assert bool(far[1]) and bool(ref[1]) and int(far[4]) > 1000


@pytest.mark.parametrize("n", [1, 300, 50000])
def test_icp_loop_kernel_ragged_sizes(cuda, n):
    """Source sizes around the kernel's tile of 128 points and beyond the resident grid:
    the kernel against the plain loop. One point matches at most one row: fewer than 3
    inliers take the identity step, which ends the loop."""
    grid, src, mask = _icp_problem(cuda)
    idx = torch.arange(n, device=cuda) % src.shape[0]
    out = _icp_loop_matches_plain(_icp_loop_args((grid, src[idx].contiguous(),
                                                  mask[idx].contiguous())))
    if n == 1:
        assert int(out[2]) == 1 and torch.equal(out[0], torch.eye(4, device=cuda))


@pytest.mark.parametrize("case", ["all-masked", "far-away"])
def test_icp_loop_kernel_degenerate_steps(cuda, case):
    """No inliers (every point masked out, or every point 500 m from the target): T stays
    T0 bit for bit, the loop is done after one iteration with 0 inliers, and the fitness
    is the plain loop's (0 with no valid point, the capped penalty when nothing matches)."""
    grid, src, mask = _icp_problem(cuda)
    if case == "all-masked":
        mask = torch.zeros_like(mask)
    else:
        src = src + 500.0
    T0 = torch.eye(4, device=cuda)
    out = _icp_loop_matches_plain(_icp_loop_args((grid, src, mask), T0=T0))
    assert torch.equal(out[0], T0) and bool(out[1]) and int(out[2]) == 1
    assert int(out[4]) == 0 and float(out[3]) == (0.0 if case == "all-masked" else 4.0)


def test_icp_loop_kernel_early_exit_and_worked_count(cuda):
    """A loop that is done after k iterations does work in k launches only (the device
    count of `icp_iteration`'s working launches, apart from the other loop kernels')."""
    args = _icp_loop_args(_icp_problem(cuda))
    tk.worked_launches(reset=True)
    out = tk.icp_align_loop(*args)
    worked = tk.worked_launches(kernel="icp_iteration")
    assert worked == int(out[2]) < 40
    assert tk.worked_launches(kernel="gicp_iteration") == 0
    assert tk.worked_launches(reset=True) == worked


def test_icp_loop_kernel_reruns_and_two_streams(cuda):
    """Two threads, each on its own stream, run the ICP loop and the fitness 10 times each
    at once: every result equals the serial one bit for bit."""
    problem = _icp_problem(cuda)
    args = _icp_loop_args(problem)
    T = tk.icp_align_loop(*args)[0]
    calls = {"loop": lambda: tk.icp_align_loop(*args),
             "fitness": lambda: tk.icp_fitness(*problem, T, 2.0, 16, 7, "pcl")}
    serial = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    barrier = threading.Barrier(2, timeout=60)
    results, errors = {}, []

    def run(t):
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                barrier.wait()
                outs = [(k, calls[k]()) for _ in range(10) for k in calls]
            stream.synchronize()
            results[t] = outs
        except BaseException as e:  # noqa: BLE001 — raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,), daemon=True) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for outs in results.values():
        for k, out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, serial[k])), k


@pytest.mark.parametrize("mode", ["pcl", "penalized"])
@pytest.mark.parametrize("neighborhood,bucket_cap", [(7, 16), (7, 32), (27, 16), (27, 32)])
def test_icp_fitness_kernel_matches_plain(cuda, mode, neighborhood, bucket_cap):
    """`icp_fitness` against its plain version at the aligned and at the initial
    transform, and on a source that matches nothing: the matched count exact, score and
    fraction to rtol 1e-6; one launch a call."""
    grid, src, mask = _icp_problem(cuda)
    T = tk.icp_align_loop(*_icp_loop_args((grid, src, mask)))[0]
    nvalid = int(mask.sum())
    for pts, tr in ((src, T), (src, torch.eye(4, device=cuda)), (src + 500.0, T)):
        before = tk.icp_fitness.launches
        out = tk.icp_fitness(grid, pts, mask, tr, 2.0, bucket_cap, neighborhood, mode)
        ref = tk.icp_fitness_plain(grid, pts, mask, tr, 2.0, bucket_cap, neighborhood, mode)
        assert tk.icp_fitness.launches == before + 1
        assert round(float(out[1]) * nvalid) == round(float(ref[1]) * nvalid)
        np.testing.assert_allclose(float(out[1]), float(ref[1]), rtol=1e-6)
        if np.isinf(float(ref[0])):
            assert float(out[0]) == float(ref[0])
        else:
            np.testing.assert_allclose(float(out[0]), float(ref[0]), rtol=1e-6)


def test_icp_kernels_reject_bad_inputs(cuda):
    problem = _icp_problem(cuda, n=1024)
    args = _icp_loop_args(problem)
    bad = {1: args[1].double(), 2: args[2].cpu(), 3: args[3][:3], 8: 8, 9: 9}
    before = (tk.icp_align_loop.launches, tk.icp_fitness.launches)
    for i, x in bad.items():
        with pytest.raises(ValueError):
            tk.icp_align_loop(*args[:i], x, *args[i + 1:])
    grid, src, mask = problem
    for kw in (dict(points=src[:, :2]), dict(mask=mask.cpu()), dict(mode="other"),
               dict(bucket_cap=8)):
        call = dict(grid=grid, points=src, mask=mask, transform=args[3], max_range=2.0)
        call.update(kw)
        with pytest.raises(ValueError):
            tk.icp_fitness(**call)
    assert (tk.icp_align_loop.launches, tk.icp_fitness.launches) == before


def test_icp_verification_makes_no_synchronous_read(cuda):
    """One loop verification with the ICP verifier (`graph/slam.py:make_verify_one`: the
    coarse NDT pre-align, the ICP loop, the gate's fitness) under
    `torch.cuda.set_sync_debug_mode("error")`, after a warm-up verification: one
    `icp_align_loop` call (max_iterations launches) and one `icp_fitness` launch."""
    from lidar_graph_slam_tpu_torch.graph.slam import make_verify_one

    grid, src, mask = _icp_problem(cuda)
    pts = grid.points
    pre_map = build_ndt_map(pts, grid.keys != INVALID_KEY, 4.0,
                            capacity=16384)
    cfg = GraphSlamConfig(icp=IcpConfig(max_iterations=40))
    verify = make_verify_one(cfg, "ICP")
    eye = torch.eye(4, device=cuda)
    verify(grid, pre_map, None, eye, src, mask)
    torch.cuda.synchronize()
    before = (tk.icp_align_loop.launches, tk.icp_fitness.launches)
    try:
        torch.cuda.set_sync_debug_mode("error")
        T, score, ok = verify(grid, pre_map, None, eye, src, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tk.icp_align_loop.launches, tk.icp_fitness.launches) == (before[0] + 40,
                                                                     before[1] + 1)
    assert bool(ok) and float(score) < 0.3


def test_fused_icp_step_makes_no_synchronous_read(cuda):
    """`odometry/fused.py`'s step with ICP makes no synchronous read: three frames under
    `torch.cuda.set_sync_debug_mode("error")` after one warm-up frame, against a real
    target rebuilt from the ring; the ICP loop kernel launched, the others not."""
    from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
    from lidar_graph_slam_tpu_torch.odometry.fused import make_fused_frontend

    cfg = apply_cli_overrides(PipelineConfig(), [
        "prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=16384",
        "capacity.filtered_points=4096", "capacity.voxel_capacity=32768",
        "scan_matcher.max_scan_accumulate_num=5", "scan_matcher.registration_method=ICP"])
    init_state, step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter,
                                                cfg.capacity, device=cuda)
    seq = SyntheticSequence(n_frames=4, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 4 / 90)
    raws = []
    for scan, _ in seq:
        raw = np.full((cfg.capacity.raw_points, 3), PAD_VALUE, np.float32)
        raw[:len(scan)] = scan
        raws.append(torch.as_tensor(raw, device=cuda))
    eye3 = torch.eye(3, device=cuda)
    eye4 = torch.eye(4, device=cuda)
    state, ring = init_state(), aux["init_ring"]()
    state, out = step(state, raws[0], aux["rebuild"](ring), eye3, False, eye4, False)
    ring, target = aux["insert_and_rebuild"](ring, 0, out.kf_cloud, out.kf_mask, out.pose)
    torch.cuda.synchronize()
    before = (tk.icp_align_loop.launches, tk.gicp_align_loop.launches,
              tk.ndt_align_loop.launches)
    outs = []
    try:
        torch.cuda.set_sync_debug_mode("error")
        for raw in raws[1:]:
            state, out = step(state, raw, target, eye3, False, eye4, False)
            outs.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(o.converged) for o in outs)
    its = cfg.scan_matcher.gicp.max_iterations
    assert (tk.icp_align_loop.launches, tk.gicp_align_loop.launches,
            tk.ndt_align_loop.launches) == (before[0] + 3 * its, before[1], before[2])


def test_gicp_loop_carry_equals_the_parent_tree(cuda):
    """With `LGS_PARENT_TREE` naming another tree of the package (the parent commit
    unpacked by `git archive`), that tree's GICP loop kernel leaves the carry of this
    tree's bit for bit, after one iteration and after the whole loop, with the reciprocal
    test and without: the grid-NN query moved into `csrc/nn_stage.cuh` unchanged."""
    import importlib.util
    import os

    root = os.environ.get("LGS_PARENT_TREE")
    if not root:
        pytest.skip("LGS_PARENT_TREE names no parent tree")
    path = os.path.join(os.path.abspath(root), "lidar_graph_slam_tpu_torch", "ops",
                        "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels_test", path)
    parent = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent)
    problem = _gicp_problem(cuda)
    for reciprocal in (False, True):
        for its in (1, 64):
            args = _gicp_loop_args(problem, its, reciprocal=reciprocal)
            out, ref = tk.gicp_align_loop(*args), parent.gicp_align_loop(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, ref)), (reciprocal, its)
