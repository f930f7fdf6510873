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
them; refusals, no synchronous read, two streams at once. The ICP kernels (`icp_iteration`,
`icp_fitness`, `csrc/icp_loop.cu`) against the plain loop and fitness: every
instantiation, the verifier's and the front end's shapes, 1 km from the origin, ragged
sizes, no inliers; two aligns and a fitness back to back on one stream, and the fitness
right after each loop kernel, bit for bit as each alone (their loads before the
programmatic wait read nothing a launch before them writes). The fused front end's
captured programs (`odometry/fused.py:FusedFrontEnd`, CUDA graphs after the first call):
a lagged course with NDT, GICP and ICP bit for bit against the plain step and
insert-and-rebuild, the launches a replay counts, and replays without a synchronous read;
`batch_odometry`'s frame program (one capture, then a replay a batch frame) bit for bit
against its body run eagerly, without a synchronous read. The classic driver's three
programs (prefilter, register, insert) over 12 dense frames bit for bit against their
bodies run eagerly with NDT, ICP and GICP, one capture each; the random sample's draws in
the classic and fused programs; and no kernel launch call from a classic frame after
frame 2 (torch.profiler). A loop attempt's two programs (the inputs' build and the
verification) over three attempts with ICP, NDT and GICP, bit for bit against the same
attempts operator by operator, one capture each.
GICP's covariance kernel (`gicp_covariances`, `csrc/covariances.cu`) against its plain
version bit for bit, from the dense ring's 655,360 rows down to N = 0, one launch a call,
its refusals, no synchronous read, and inside the captured GICP step and insert. The
prefilter's passes (`cell_keys`, `sorted_runs`, `sor_threshold`, `compact_rows`,
`csrc/prefilter_pass.cu`) against their plain versions bit for bit with reruns at the
dense and drift buckets, the SOR's rows, the loop submap, the ring's fine and coarse
levels and edge cases (a NaN corner, N = 0), their refusals, the default prefilter
captured into a program, replayed bit-equal to its body without a synchronous read, and
the fused step's programs replayed while a loop attempt's replay in another thread.

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
import importlib.util
import os
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
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE, PointCloud
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


def _capture_course(cuda, method):
    """A small config with `method`, and 5 frames of a synthetic course in their bucket."""
    cfg = apply_cli_overrides(PipelineConfig(), [
        "prefilter.leaf_size=0.3", "prefilter.mean_k=10", "capacity.raw_points=16384",
        "capacity.filtered_points=4096", "capacity.voxel_capacity=32768",
        "scan_matcher.max_scan_accumulate_num=5",
        f"scan_matcher.registration_method={method}"])
    seq = SyntheticSequence(n_frames=5, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 5 / 90)
    raws = []
    for scan, _ in seq:
        raw = np.full((cfg.capacity.raw_points, 3), PAD_VALUE, np.float32)
        raw[:len(scan)] = scan
        raws.append(raw)
    return cfg, raws


def _lagged_course(cuda, cfg, raws, after_dispatch=None):
    """`FusedFrontEnd`'s programs and the plain step and insert-and-rebuild on the card
    over `raws`, lagged as the runner lags them (`after_dispatch(t)` called after frame
    t's dispatch): (the programs' per-frame rows, the plain ones, the front end, the plain
    ring and target)."""
    from collections import deque

    from lidar_graph_slam_tpu_torch.odometry.fused import (
        FusedFrontEnd,
        make_fused_frontend,
        pack_scalars,
    )

    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=cuda)
    init_state, step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter,
                                                cfg.capacity, device=cuda)
    state, ring = init_state(), aux["init_ring"]()
    target = aux["rebuild"](ring)
    eye3, eye4 = torch.eye(3, device=cuda), torch.eye(4, device=cuda)
    got, want, pending = [], [], deque()
    for t, raw in enumerate(raws):
        front.dispatch(raw, None, None, t % 2)
        if after_dispatch is not None:
            after_dispatch(t)
        state, out = step(state, torch.as_tensor(raw, device=cuda), target, eye3, False,
                          eye4, False)
        pending.append((t % 2, out))
        while pending and (t == 0 or len(pending) > 1):
            slot, out = pending.popleft()
            got.append(front.slots.scalars[slot].clone())
            want.append(pack_scalars(out))
            if bool(out.is_keyframe):
                front.insert_and_rebuild(slot)
                ring, target = aux["insert_and_rebuild"](
                    ring, int(out.keyframe_id) % aux["window"], out.kf_cloud, out.kf_mask,
                    out.pose)
    while pending:
        slot, out = pending.popleft()
        got.append(front.slots.scalars[slot].clone())
        want.append(pack_scalars(out))
    return got, want, front, ring, target


def _leaves(x):
    """Every tensor of a tensor, a tuple or a dataclass, in order."""
    return [x] if isinstance(x, torch.Tensor) else (
        [t for item in x for t in _leaves(item)] if isinstance(x, tuple) else
        [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))])


@pytest.mark.parametrize("method", ["NDT", "GICP", "ICP"])
def test_captured_programs_equal_the_bodies(cuda, method):
    """`FusedFrontEnd`'s programs (CUDA graphs after the first call) against the plain
    step and insert-and-rebuild on the card, lagged as the runner lags them: every
    frame's outputs, the ring and the target bit for bit; one capture a bucket and one
    for the insert."""
    cfg, raws = _capture_course(cuda, method)
    got, want, front, ring, target = _lagged_course(cuda, cfg, raws)
    assert torch.equal(torch.stack(got), torch.stack(want))
    for a, b in zip(_leaves((front.ring, front.target)), _leaves((ring, target))):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    assert front.captures == 2 and front.programs[16384].replays == len(raws) - 1


def test_captured_step_and_verify_inputs_replay_together(cuda):
    """The fused front end's step and insert programs and a loop attempt's two programs
    (the inputs' build, the verification) replayed at once, the attempts in a second
    thread and its worker's stream: the frames' rows, the ring and the target equal the
    plain step and insert-and-rebuild's bit for bit, and the attempts' records and solved
    poses those of the same attempts operator by operator. The key passes inside both
    graphs (`cell_keys` and `sorted_runs`, their records allocated in each graph's pool)
    share no scratch."""
    cfg, raws = _capture_course(cuda, "NDT")
    backs = _loop_backend(cuda, True), _loop_backend(cuda, True)
    backs[1].programs_enabled = False
    want_loops = [backs[1].try_close_loop() for _ in range(3)]
    got_loops = [backs[0].try_close_loop()]  # captures the attempt's programs
    attempts = threading.Thread(
        target=lambda: got_loops.extend(backs[0].try_close_loop() for _ in range(2)))

    def after_dispatch(t):
        if t == 1:  # the step captured at frame 0: from here its replays
            attempts.start()

    got, want, front, ring, target = _lagged_course(cuda, cfg, raws, after_dispatch)
    attempts.join()
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(got), torch.stack(want))
    for a, b in zip(_leaves((front.ring, front.target)), _leaves((ring, target))):
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    assert got_loops == want_loops
    for a, b in zip(*(b.loop_log for b in backs)):
        assert (a["candidate"], a["accepted"], a["fitness"]) == (
            b["candidate"], b["accepted"], b["fitness"])
        np.testing.assert_array_equal(a["transform"], b["transform"])
    np.testing.assert_array_equal(backs[0].optimized_poses(), backs[1].optimized_poses())
    log = backs[0].loop_programs.log()["ICP_1"]
    assert all((v["captures"], v["replays"]) == (1, 2) for v in log.values())
    assert front.programs[16384].replays == len(raws) - 1


def test_captured_program_counts_its_launches_at_each_replay(cuda):
    """A replay counts the launches its capture recorded, in the wrappers' counts and the
    calling thread's; the warm-up counted its own, the capture none."""
    from lidar_graph_slam_tpu_torch.odometry.fused import FusedFrontEnd

    cfg, raws = _capture_course(cuda, "NDT")
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=cuda)
    before = (tk.ndt_align_loop.launches, tk.voxel_centroids.launches,
              tk.ndt_finalize.launches, tk.dense_table.launches, tk.thread_launches())
    front.dispatch(raws[0], None, None, 0)
    front.insert_and_rebuild(0)
    per_step = cfg.scan_matcher.ndt.coarse_iterations + cfg.scan_matcher.ndt.max_iterations + 2
    step_tally = front.programs[16384].tally
    assert step_tally[tk.ndt_align_loop] == per_step and step_tally[tk.voxel_centroids] == 1
    # Each map level's finalize and its dense table; the fine level's keys (two launches)
    # and both levels' runs (two launches each).
    assert front.insert_program.tally == {tk.ndt_finalize: 2, tk.dense_table: 2,
                                          tk.cell_keys: 2, tk.sorted_runs: 4}
    for t in range(1, 4):
        front.dispatch(raws[t], None, None, t % 2)
        front.insert_and_rebuild(t % 2)
    torch.cuda.synchronize()
    assert tk.ndt_align_loop.launches - before[0] == 4 * per_step
    assert tk.voxel_centroids.launches - before[1] == 4
    assert tk.ndt_finalize.launches - before[2] == 4 * 2
    assert tk.dense_table.launches - before[3] == 4 * 2
    assert tk.thread_launches() - before[4] == 4 * (
        sum(step_tally.values()) + sum(front.insert_program.tally.values()))


@pytest.mark.parametrize("method", ["NDT", "GICP", "ICP"])
def test_captured_programs_make_no_synchronous_read(cuda, method):
    """After the captures, step and insert replays (their uploads included) under
    `torch.cuda.set_sync_debug_mode("error")`."""
    from lidar_graph_slam_tpu_torch.odometry.fused import FusedFrontEnd

    cfg, raws = _capture_course(cuda, method)
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=cuda)
    front.dispatch(raws[0], None, None, 0)
    front.insert_and_rebuild(0)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for t in range(1, len(raws)):
            front.dispatch(raws[t], None, None, t % 2)
            front.insert_and_rebuild(t % 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows = front.slots.scalars.cpu()
    assert torch.isfinite(rows).all() and bool((rows[:, 16] > 0.5).all())
    assert front.programs[16384].replays == len(raws) - 1


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



def test_captured_batch_odometry_equals_its_eager_body(cuda):
    """`batch_odometry` on the card (B = 2, 3 frames of 2,048 points, a 2-slot ring) as its
    frame program: one capture, at frame 0, and a replay at each later frame, the whole
    call under `torch.cuda.set_sync_debug_mode("error")` after the body has warmed the
    card up; every output and final state field bit for bit against the program's body
    run eagerly on the card on the same frames."""
    from lidar_graph_slam_tpu_torch.core.config import NdtConfig, ScanMatcherConfig
    from lidar_graph_slam_tpu_torch.parallel import multi_sequence as ms

    B, F, N, window = 2, 3, 2048, 2
    scans = np.full((B, F, N, 3), PAD_VALUE, np.float32)
    masks = np.zeros((B, F, N), bool)
    for b in range(B):
        for f, (scan, _) in enumerate(SyntheticSequence(n_frames=F, seed=10 + b, max_points=N,
                                                        laps=0.1, radius=30.0 + 2 * b)):
            scans[b, f, :len(scan)], masks[b, f, :len(scan)] = scan, True
    scans, masks = torch.as_tensor(scans, device=cuda), torch.as_tensor(masks, device=cuda)
    cfg = ScanMatcherConfig(max_scan_accumulate_num=window, ndt=NdtConfig(max_iterations=32))
    eager = ms._buffers(scans, masks, window)
    for _ in range(F):
        ms._frame_body(eager, cfg, 8192)
    torch.cuda.synchronize()
    log = []
    try:
        torch.cuda.set_sync_debug_mode("error")
        final, outs = ms.batch_odometry(scans, masks, cfg, map_capacity=8192, device=cuda,
                                        program_log=log)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [(r["captures"], r["replays"]) for r in log] == [(1, F - 1)]
    assert log[0]["pool_bytes"] > 0
    for k, v in outs.items():
        assert torch.equal(v, eager.outs[k]), k
    for f in dataclasses.fields(final):
        assert torch.equal(getattr(final, f.name), getattr(eager.state, f.name)), f.name
    assert bool(outs["is_keyframe"][:, 0].all()) and bool(outs["converged"][:, 1:].all())

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


@pytest.mark.parametrize("method", ["ICP", "NDT", "GICP"])
def test_loop_programs_equal_the_operator_path(cuda, method):
    """A loop attempt's two programs (`graph/slam.py:LoopPrograms`, CUDA graphs after
    the first attempt) on the card: three attempts, each program captured once and
    replayed at the two later attempts, every loop record and the solved poses bit for
    bit those of the same attempts built and verified operator by operator."""
    backs = _loop_backend(cuda, True, method), _loop_backend(cuda, True, method)
    backs[1].programs_enabled = False
    for _ in range(3):
        assert backs[0].try_close_loop() == backs[1].try_close_loop()
    for a, b in zip(*(b.loop_log for b in backs)):
        assert (a["candidate"], a["accepted"], a["converged"], a["fitness"]) == (
            b["candidate"], b["accepted"], b["converged"], b["fitness"])
        np.testing.assert_array_equal(a["transform"], b["transform"])
    assert len(backs[0].loop_log) == 3 and backs[0].loop_log[0]["accepted"]
    np.testing.assert_array_equal(backs[0].optimized_poses(), backs[1].optimized_poses())
    log = backs[0].loop_programs.log()
    assert list(log) == [f"{method}_1"] and not backs[1].loop_programs.log()
    assert all((v["captures"], v["replays"]) == (1, 2) and v["pool_bytes"] > 0
               for v in log[f"{method}_1"].values())


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
    """GICP's window covariances of a synthetic scan as the eigensolve is handed them: the
    rows sorted by cell, their window sums (the plain version), the identity where the
    window holds fewer than 5 points."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb

    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=40.0, density=20.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=n)
    p = torch.as_tensor(scan, device=device)
    cells = tnb.sort_by_cell(p, torch.ones(p.shape[0], dtype=torch.bool, device=device), 2.0)
    _, cov, cnt = tnb.window_covariances(cells)
    eye = torch.eye(3, dtype=cov.dtype, device=device).expand(cov.shape)
    return torch.where((cnt >= 5.0)[:, None, None], cov, eye)


def test_eigh3x3_bit_equal_to_plain(cuda):
    """`eigh3x3` equals `_eigh3x3` on the card bit for bit (compared through int32 views,
    signed zeros and NaNs included): GICP's window covariances, random symmetric matrices
    (non-symmetric input: only the upper triangle is read), diagonal and tau = 0 ones, a
    single matrix, and the structured cases of `tests/torch_eigh3x3_cases.py` that reach
    each of the rotation's routes (identity, diagonal, -0, NaN and inf entries,
    subnormal and 1e-30 couplings, tau^2 overflow, tau = 0), random SPD matrices scaled
    over 12 orders of magnitude. The float32 model of the routes equals both."""
    from lidar_graph_slam_tpu_torch.ops.voxel import _eigh3x3

    # By path: on the card's machine another installed package is named `tests`.
    spec = importlib.util.spec_from_file_location(
        "torch_eigh3x3_cases", os.path.join(os.path.dirname(__file__), "torch_eigh3x3_cases.py"))
    ec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ec)

    rng = np.random.default_rng(0)
    A = rng.normal(size=(4096, 3, 3)).astype(np.float32)
    tau0 = np.array([[2.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    S = ec.spd(4096, 7)
    scale = np.float32(10.0) ** rng.uniform(-6, 6, size=(4096, 1, 1))
    cases = [_window_covariances(cuda), torch.as_tensor(A @ A.transpose(0, 2, 1), device=cuda),
             torch.as_tensor(A, device=cuda),
             torch.as_tensor(np.stack([np.diag(rng.normal(size=3)) for _ in range(64)]
                                      + [tau0] * 4).astype(np.float32), device=cuda),
             torch.as_tensor(tau0[None], device=cuda),
             torch.as_tensor((S * scale).astype(np.float32), device=cuda)]
    structured = ec.structured()
    cases += [torch.as_tensor(structured[k], device=cuda) for k in sorted(structured)]
    cases.append(torch.as_tensor(np.concatenate(list(structured.values())), device=cuda))
    split = ec.split_module()

    def bits(x):
        return x.contiguous().view(torch.int32)

    for M in cases:
        before = tk.eigh3x3.launches
        w, V = tk.eigh3x3(M)
        w2, V2 = tk.eigh3x3(M)
        rw, rV = _eigh3x3(M)
        mw, mV, _ = split.shortcut_eigh3x3(M)
        torch.cuda.synchronize()
        assert tk.eigh3x3.launches == before + 2
        for got in ((w2, V2), (rw, rV), (mw, mV)):
            assert torch.equal(bits(w), bits(got[0])) and torch.equal(bits(V), bits(got[1]))


def test_gicp_covariances_and_normals_launch_eigh3x3(cuda, monkeypatch):
    """The FPFH normals launch `eigh3x3` once a call on the card; `estimate_covariances`
    launches `gicp_covariances` once (its eigensolve runs inside it) and no `eigh3x3`.
    Both equal the same calls with the plain versions bit for bit."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
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

    before = (tk.eigh3x3.launches, tk.gicp_covariances.launches)
    out = run()
    assert (tk.eigh3x3.launches, tk.gicp_covariances.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    monkeypatch.setattr(tk, "eigh3x3", _eigh3x3)
    monkeypatch.setattr(tk, "gicp_covariances", tnb.gicp_covariances_plain)
    for a, b in zip(out, run()):
        assert torch.equal(a, b)
    assert bool(out[1].any()) and bool(out[3].any())


# -- GICP's covariances (`csrc/covariances.cu`) -----------------------------------------------
# `gicp_covariances` against its plain version (`neighbors.gicp_covariances_plain`: the
# window sums, then `plane_covariances_plain`) on the same card tensors, bit for bit, with
# a rerun: the dense ring's 655,360 rows, a 32,768-row source, the 16,384-row verifier
# cloud, N whose window wraps several times or ends inside a warp's tile, an all-invalid
# tail and an all-invalid cloud, one cell filling the window, and axis-aligned planes
# (exact zeros in the covariances and the eigenvectors, where a product's signed zero
# shows).

COV_CASES = ["ring", "source", "verifier", "n1", "n5", "n31", "n32", "n33", "n257",
             "one_cell", "planes", "all_invalid", "empty"]


def _cov_cloud(case, device, seed=0):
    """(points [N, 3], mask [N]) of a covariance case (`COV_CASES`)."""
    rng = np.random.default_rng(seed)
    if case in ("ring", "source", "verifier"):
        # The dense course's world (`chip_smoke.py:dense_course`): ~73k points a scan.
        n, scans, keep = {"ring": (655360, 9, 131072), "source": (32768, 1, 32768),
                          "verifier": (16384, 1, 9000)}[case]
        world = make_world(rng, extent=60.0, density=60.0, wall_height=12.0,
                           box_height=(6.0, 25.0), n_boxes=60)
        parts = []
        for k in range(scans):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [2.0 * k, 0.5 * k, 0.0]
            parts.append(simulate_scan(world, pose, rng, max_points=keep, n_azimuth=2048,
                                       n_elevation=64))
        scan = np.concatenate(parts)[:n]
        pts = np.full((n, 3), PAD_VALUE, np.float32)
        pts[:len(scan)] = scan
        mask = np.arange(n) < len(scan)
    elif case == "planes":  # z = 0 and x = 10 exactly
        n = 4096
        pts = rng.uniform(0.0, 8.0, (n, 3)).astype(np.float32)
        pts[: n // 2, 2] = 0.0
        pts[n // 2:, 0] = 10.0
        mask = np.ones(n, bool)
    else:
        n = {"n1": 1, "n5": 5, "n31": 31, "n32": 32, "n33": 33, "n257": 257,
             "one_cell": 300, "all_invalid": 512, "empty": 0}[case]
        spread = 0.25 if case == "one_cell" else 1.5
        pts = (np.array([40.3, -25.1, 1.2]) + rng.uniform(0.0, spread, (n, 3))).astype(
            np.float32)
        mask = np.ones(n, bool)
        if case == "all_invalid":
            mask[:] = False
        elif case == "n257":
            mask[200:] = False
    p, m = torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)
    return torch.where(m[:, None], p, PAD_VALUE), m


def _same_bits(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("case", COV_CASES)
def test_covariance_kernels_bit_equal_to_plain(cuda, case):
    """`gicp_covariances` against its plain version, twice, one launch a call (none at N
    = 0); the product V diag(1e-3, 1, 1) V^T against `_scaled_gram`'s order."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb

    p, m = _cov_cloud(case, cuda)
    n = p.shape[0]
    cells = (tnb.sort_by_cell(p, m, 2.0) if n else tnb.CellSort(
        keys=torch.empty(0, dtype=torch.int32, device=cuda), points=p,
        order=torch.empty(0, dtype=torch.int64, device=cuda)))
    args = (cells.keys, cells.points, cells.order, m)
    before = tk.gicp_covariances.launches
    got = tk.gicp_covariances(*args)
    again = tk.gicp_covariances(*args)
    want = tnb.gicp_covariances_plain(*args)
    torch.cuda.synchronize()
    _same_bits(got, want)
    _same_bits(again, want)
    assert tk.gicp_covariances.launches - before == 2 * int(n > 0)
    if case in ("ring", "source", "verifier", "one_cell", "planes"):
        assert float(want[1].sum()) > 0.5 * float(m.sum())
    if case in ("all_invalid", "empty"):
        assert not bool(want[1].any())


def test_covariance_kernels_reject_bad_inputs(cuda):
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb

    p, m = _cov_cloud("n257", cuda)
    cells = tnb.sort_by_cell(p, m, 2.0)
    keys, pts, order = cells.keys, cells.points, cells.order
    before = tk.gicp_covariances.launches
    for bad in ((keys.long(), pts, order, m), (keys, pts.double(), order, m),
                (keys[:-1], pts, order, m), (keys, pts[:, :2], order, m),
                (keys, pts.cpu(), order, m), (keys, pts.t().contiguous().t(), order, m),
                (keys, pts, order.int(), m), (keys, pts, order, m.int()),
                (keys, pts, order[:-1], m), (keys, pts, order.cpu(), m),
                (keys, pts, order, m[:-1])):
        with pytest.raises(ValueError):
            tk.gicp_covariances(*bad)
    assert tk.gicp_covariances.launches == before


def test_gicp_covariances_launch_once_and_make_no_synchronous_read(cuda):
    """`estimate_covariances` and `build_gicp_target` on the card: one launch of
    `gicp_covariances` a call, the target's grid one of `grid_rows`, each call's sort by
    cell two of `cell_keys` and one of `sorted_runs`, and no other kernel of
    `ops/kernels.py` (no `eigh3x3`), and no synchronous read under
    `torch.cuda.set_sync_debug_mode("error")` (after a warm-up call)."""
    p, m = _cov_cloud("source", cuda)
    gicp.estimate_covariances(p, m, 2.0)
    gicp.build_gicp_target(p, m, 2.0)
    torch.cuda.synchronize()
    before = (tk.gicp_covariances.launches, tk.eigh3x3.launches, tk.grid_rows.launches,
              tk.thread_launches())
    try:
        torch.cuda.set_sync_debug_mode("error")
        covs, ok = gicp.estimate_covariances(p, m, 2.0)
        target = gicp.build_gicp_target(p, m, 2.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tk.gicp_covariances.launches - before[0], tk.eigh3x3.launches - before[1],
            tk.grid_rows.launches - before[2], tk.thread_launches() - before[3]) == (
                2, 0, 1, 3 + 2 * 3)
    assert bool(torch.isfinite(covs).all()) and bool(target.valid.any()) and bool(ok.any())


def test_captured_gicp_insert_runs_the_covariance_kernels(cuda, monkeypatch):
    """The GICP front end's captured programs record one launch of `gicp_covariances`
    each (the step's source, the insert's target; the insert's grid one of `grid_rows`
    and its sort by cell two of `cell_keys` and one of `sorted_runs`) and no `eigh3x3`; a replayed insert's target equals the plain insert-and-rebuild
    body, run with the covariances' and the grid's plain versions, bit for bit."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
    from lidar_graph_slam_tpu_torch.odometry.fused import FusedFrontEnd, make_fused_frontend

    cfg, raws = _capture_course(cuda, "GICP")
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=cuda)
    for t, raw in enumerate(raws):
        front.dispatch(raw, None, None, t % 2)
        front.insert_and_rebuild(t % 2)
    torch.cuda.synchronize()
    step_tally = front.programs[16384].tally
    assert front.insert_program.tally == {tk.gicp_covariances: 1, tk.grid_rows: 1,
                                          tk.cell_keys: 2, tk.sorted_runs: 1}
    assert step_tally[tk.gicp_covariances] == 1
    assert tk.eigh3x3 not in step_tally and front.insert_program.replays == len(raws) - 1
    monkeypatch.setattr(tk, "gicp_covariances", tnb.gicp_covariances_plain)
    monkeypatch.setattr(tk, "grid_rows", tnb.grid_rows_plain)
    _, _, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter, cfg.capacity,
                                    device=cuda)
    want = aux["rebuild"](front.ring)
    for name in ("covs", "valid"):
        a, b = getattr(front.target, name), getattr(want, name)
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    assert bool(want.valid.any())


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


@pytest.mark.parametrize("n,bucket_cap,eps,fit_eps", [(16384, 16, 1e-7, 1e-6),
                                                     (32768, 32, 0.01, 0.0)],
                         ids=["verifier", "front-end"])
def test_icp_loop_kernel_at_the_path_shapes(cuda, n, bucket_cap, eps, fit_eps):
    """The loop verifier's shape (N = 16,384, 7 cells, bucket 16, PCL's fitness stop) and
    the ICP front end's (N = 32,768, bucket 32): the kernel loop against the plain loop,
    converged before max_iterations; cut at one iteration, the plain loop's inliers
    exactly."""
    args = _icp_loop_args(_icp_problem(cuda, n=n), 64, bucket_cap, 7, eps, fit_eps)
    _, done, it, _, inl = _icp_loop_matches_plain(args)
    assert bool(done) and 0 < int(it) < 64 and int(inl) > 1000
    args[7] = 1
    one, ref = tk.icp_align_loop(*args), tk.icp_align_loop_plain(*args)
    assert int(one[4]) == int(ref[4]) and int(one[2]) == 1
    assert float((one[0] - ref[0]).abs().max()) <= 1e-4


def _alone(fn):
    """fn()'s outputs with the stream idle before and after it (cloned)."""
    torch.cuda.synchronize()
    out = [x.clone() for x in fn()]
    torch.cuda.synchronize()
    return out


def test_icp_aligns_and_fitness_back_to_back_on_one_stream(cuda):
    """Two aligns from different sources and initial transforms, then a fitness launch at
    the second's result, enqueued back to back on one stream three times over (a launch
    reads its source, anchor and grid before its programmatic wait, while the launch
    before it ends): each result equals the one its call leaves alone, bit for bit — no
    launch read a carry, partial row or ticket counter the one before it had not
    finished."""
    grid, src, mask = _icp_problem(cuda)
    perm = torch.as_tensor(np.random.default_rng(3).permutation(src.shape[0]), device=cuda)
    src2, mask2 = src[perm].contiguous(), mask[perm].contiguous()
    c, s_ = np.cos(-0.02), np.sin(-0.02)
    T1 = torch.tensor([[c, -s_, 0.0, -0.2], [s_, c, 0.0, 0.1], [0.0, 0.0, 1.0, 0.02],
                       [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=cuda)
    a1 = _icp_loop_args((grid, src, mask))
    a2 = _icp_loop_args((grid, src2, mask2), transform_epsilon=1e-6, fitness_epsilon=0.0,
                        T0=T1)
    ref1 = _alone(lambda: tk.icp_align_loop(*a1))
    ref2 = _alone(lambda: tk.icp_align_loop(*a2))
    reff = _alone(lambda: tk.icp_fitness(grid, src2, mask2, ref2[0], 2.0, 16, 7, "pcl"))
    assert not torch.equal(ref1[0], ref2[0])
    for _ in range(3):
        o1 = tk.icp_align_loop(*a1)
        o2 = tk.icp_align_loop(*a2)
        f = tk.icp_fitness(grid, src2, mask2, o2[0], 2.0, 16, 7, "pcl")
        torch.cuda.synchronize()
        for out, ref in ((o1, ref1), (o2, ref2), (f, reff)):
            assert all(torch.equal(x, y) for x, y in zip(out, ref))


def test_icp_fitness_right_after_each_loop_kernel(cuda):
    """`icp_fitness` enqueued right after the last launch of the ICP, the GICP and the NDT
    loop kernel on one stream (its prologue runs while that launch ends) equals the
    fitness launched alone, bit for bit, in both modes."""
    grid, src, mask = _icp_problem(cuda)
    iargs = _icp_loop_args((grid, src, mask))
    T = _alone(lambda: tk.icp_align_loop(*iargs))[0]
    gargs = _gicp_loop_args(_gicp_problem(cuda))
    nargs = _loop_call(_loop_inputs(8192, 2.0, cuda))
    for mode in ("pcl", "penalized"):
        ref = _alone(lambda: tk.icp_fitness(grid, src, mask, T, 2.0, 16, 7, mode))
        for name, loop in (("icp", lambda: tk.icp_align_loop(*iargs)),
                           ("gicp", lambda: tk.gicp_align_loop(*gargs)),
                           ("ndt", lambda: tk.ndt_align_loop(*nargs))):
            torch.cuda.synchronize()
            loop()
            out = tk.icp_fitness(grid, src, mask, T, 2.0, 16, 7, mode)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(out, ref)), (mode, name)


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


# -- the prefilter's kernels (`csrc/prefilter.cu`) ------------------------------------------


def _prefilter_cloud(n, valid, seed=0, one_cell=False):
    """A seeded ring of points 2-60 m out (the first `valid` of `n` rows), or with
    `one_cell` every valid point inside one SOR cell; the rest PAD_VALUE."""
    rng = np.random.default_rng(seed)
    pts = np.full((n, 3), PAD_VALUE, np.float32)
    if one_cell:
        pts[:valid] = rng.uniform(0.05, 0.45, (valid, 3))
    else:
        r = 2.0 + 58.0 * rng.random(valid) ** 2
        az = rng.uniform(-np.pi, np.pi, valid)
        pts[:valid] = np.stack([r * np.cos(az), r * np.sin(az), rng.normal(0.0, 1.5, valid)], -1)
    mask = np.zeros(n, bool)
    mask[:valid] = True
    return pts, mask


# (rows N, valid rows, capacity C, leaf): the dense bucket, the drift bucket, more voxels
# than C, no valid row, and an N and a C that are not multiples of the kernels' blocks.
CENTROID_CASES = {"dense": (131072, 60000, 65536, 0.1), "drift": (16384, 9100, 65536, 0.1),
                  "overflow": (16384, 12000, 2000, 0.1), "all_invalid": (8192, 0, 4096, 0.1),
                  "ragged": (1000, 700, 777, 0.3), "coarse": (8192, 6000, 8192, 2.0)}


# (run lengths in sorted order, leaf, rows N, capacity C) for the kernel's staged rounds
# of 3,840 points a block of 256 rows (`csrc/prefilter.cu`): a cloud all in one voxel (one
# run over three rounds), a run that starts in one round and ends in the next, and a
# block's span (200 runs of 21) longer than a round.
CENTROID_RUN_CASES = {"one_voxel": ([8192], 2.0, 8192, 512),
                      "run_across_rounds": ([3000, 1500, 300, 7, 1], 0.5, 8192, 256),
                      "long_span": ([21] * 200, 0.25, 8192, 1024)}
CENTROID_CASES.update(CENTROID_RUN_CASES)


def _voxel_runs(run_lengths, leaf, n, seed=0):
    """Runs of the given lengths, in this order after the sort: voxel v (along z) holds
    run_lengths[v] points inside it, the rest of the n rows PAD_VALUE."""
    rng = np.random.default_rng(seed)
    total = int(sum(run_lengths))
    v = np.repeat(np.arange(len(run_lengths)), run_lengths)
    local = rng.uniform(0.1, 0.9, (total, 3))
    local[0] = 0.1  # the cloud's min corner, so that the voxel frame is this one
    local[:, 2] += v
    pts = np.full((n, 3), PAD_VALUE, np.float32)
    pts[:total] = local * leaf
    return pts, np.arange(n) < total


def _centroid_inputs(device, case, seed=0):
    """`voxel_centroids`' arguments as `voxel_downsample` makes them."""
    from lidar_graph_slam_tpu_torch.ops import voxel as tv

    if case in CENTROID_RUN_CASES:
        runs, leaf, n, cap = CENTROID_RUN_CASES[case]
        pts, mask = _voxel_runs(runs, leaf, n, seed)
    else:
        n, valid, cap, leaf = CENTROID_CASES[case]
        pts, mask = _prefilter_cloud(n, valid, seed)
    return tv.centroid_runs(torch.as_tensor(pts, device=device),
                            torch.as_tensor(mask, device=device), leaf, cap)[0]


def _assert_bits(out, again, ref):
    torch.cuda.synchronize()
    for a, b, c in zip(out, again, ref):
        assert a.dtype == c.dtype and a.shape == c.shape
        # Bytes, not values: a NaN (the NaN corner's origin) equals itself bit for bit.
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        assert torch.equal(a.reshape(-1).view(torch.uint8), c.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("case", list(CENTROID_CASES))
def test_voxel_centroids_bit_equal_to_plain(cuda, case):
    """The kernel's centroids and mask equal `voxel_centroids_plain`'s bit for bit, a
    rerun too, one launch a call: the dense (131,072) and drift (16,384) buckets at C =
    65,536, more voxels than C, no valid row, ragged N and C, a 2 m leaf."""
    from lidar_graph_slam_tpu_torch.ops.voxel import voxel_centroids_plain

    args = _centroid_inputs(cuda, case)
    before = tk.voxel_centroids.launches
    out, again = tk.voxel_centroids(*args), tk.voxel_centroids(*args)
    assert tk.voxel_centroids.launches == before + 2
    _assert_bits(out, again, voxel_centroids_plain(*args))
    occupied = int(out[1].sum())
    C = args[2].shape[0] - 1
    if case == "all_invalid":
        assert occupied == 0 and bool((out[0] == PAD_VALUE).all())
    elif case == "overflow":
        assert occupied == C
    else:
        assert 0 < occupied < C


# (rows N, valid rows, one cell, SOR cell m): the SOR's shape N = 65,536 (the voxel
# capacity) dense and sparse, no valid row, one cell whose window wraps, a full one-cell
# cloud, a ragged N and a tiny one.
SOR_CASES = {"dense": (65536, 60000, False, 1.0), "drift": (65536, 8000, False, 1.0),
             "all_invalid": (65536, 0, False, 1.0), "one_cell": (600, 560, True, 1.0),
             "one_cell_full": (300, 300, True, 1.0), "ragged": (1000, 900, False, 3.0),
             "tiny": (5, 5, False, 100.0)}


# (cell sizes in sorted order, invalid rows after them), 1 m cells: cells at the window's
# edges (24, 25, 48 and 49 rows), N at and past the window's 49 rows (a window meets a row
# twice below it), and warps whose rows' counts straddle 16 and 32, 32 and 40, and 40 and
# 48 (the kernel's network widths).
SOR_CELL_CASES = {"cells_24_25_48_49": ([24, 25, 48, 49], 300), "n47": ([20, 27], 0),
                  "n48": ([24, 24], 0), "n49": ([30, 19], 0), "n129": ([60, 40, 29], 0),
                  "straddle": ([10, 30, 10, 40, 5, 17, 33, 2, 45, 1, 3], 250)}
SOR_CASES.update(SOR_CELL_CASES)


def _cells(sizes, invalid=0, seed=0):
    """Cells of the given sizes, in this order after the sort (1 m cells two apart along
    x), then `invalid` PAD_VALUE rows; the rows shuffled."""
    rng = np.random.default_rng(seed)
    c = np.repeat(np.arange(len(sizes)), sizes)
    local = rng.uniform(0.05, 0.95, (len(c), 3))
    local[:, 0] += 2 * c
    pts = np.concatenate([local, np.full((invalid, 3), PAD_VALUE)]).astype(np.float32)
    perm = rng.permutation(len(pts))
    return pts[perm], (np.arange(len(pts)) < len(c))[perm]


def _sor_inputs(device, case, seed=0):
    from lidar_graph_slam_tpu_torch.ops.neighbors import sort_by_cell

    if case in SOR_CELL_CASES:
        (pts, mask), cell = _cells(*SOR_CELL_CASES[case], seed), 1.0
    else:
        n, valid, one_cell, cell = SOR_CASES[case]
        pts, mask = _prefilter_cloud(n, valid, seed, one_cell)
    cells = sort_by_cell(torch.as_tensor(pts, device=device),
                         torch.as_tensor(mask, device=device), cell)
    return cells.keys, cells.points, cells.order


@pytest.mark.parametrize("k", [30, 10])
@pytest.mark.parametrize("case", list(SOR_CASES))
def test_sor_window_stats_bit_equal_to_plain(cuda, case, k):
    """The kernel's mean distances and counts equal `sor_window_stats_plain`'s bit for bit
    in the original row order, a rerun too, one launch a call."""
    from lidar_graph_slam_tpu_torch.ops.neighbors import sor_window_stats_plain

    args = _sor_inputs(cuda, case)
    before = tk.sor_window_stats.launches
    out, again = tk.sor_window_stats(*args, k), tk.sor_window_stats(*args, k)
    assert tk.sor_window_stats.launches == before + 2
    _assert_bits(out, again, sor_window_stats_plain(*args, k))
    found = out[1]
    if case == "all_invalid":
        assert not bool(found.any())
    elif case in ("one_cell_full", "tiny"):  # every window row is a same-cell row
        assert bool((found == k).all())
    elif case in SOR_CELL_CASES:
        assert int(found.max()) == min(k, 29) if case == "n49" else int(found.max()) > 1
    else:
        assert int(found.max()) > 1 and bool((found == 0).any())


def test_prefilter_launches_each_kernel_once_without_a_read(cuda):
    """The default prefilter on a dense bucket: each kernel launched once a call, no
    synchronous read (`torch.cuda.set_sync_debug_mode("error")` after a warm-up call),
    and the result equal to the plain path's bit for bit."""
    from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig
    from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
    from lidar_graph_slam_tpu_torch.ops import neighbors, voxel

    pts, mask = _prefilter_cloud(131072, 73000, seed=4)
    p, m = torch.as_tensor(pts, device=cuda), torch.as_tensor(mask, device=cuda)
    prefilter = make_prefilter(PrefilterConfig(), 32768, 65536)
    prefilter(p, m)
    torch.cuda.synchronize()
    before = (tk.voxel_centroids.launches, tk.sor_window_stats.launches)
    try:
        torch.cuda.set_sync_debug_mode("error")
        out = prefilter(p, m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (tk.voxel_centroids.launches, tk.sor_window_stats.launches) == (
        before[0] + 1, before[1] + 1)
    kernel_fns = (tk.voxel_centroids, tk.sor_window_stats)
    try:
        tk.voxel_centroids, tk.sor_window_stats = (voxel.voxel_centroids_plain,
                                                   neighbors.sor_window_stats_plain)
        plain = prefilter(p, m)
    finally:
        tk.voxel_centroids, tk.sor_window_stats = kernel_fns
    assert torch.equal(out.points, plain.points) and torch.equal(out.mask, plain.mask)
    assert 10000 < int(out.mask.sum()) <= 32768


def test_prefilter_kernels_reject_bad_inputs(cuda):
    keys, pts, starts, lengths, origin, leaf = _centroid_inputs(cuda, "ragged")
    skeys, spts, order = _sor_inputs(cuda, "ragged")
    bad_centroids = [
        (keys.long(), pts, starts, lengths, origin, leaf),
        (keys, pts.double(), starts, lengths, origin, leaf),
        (keys, pts[:, :2], starts, lengths, origin, leaf),
        (keys, pts, starts.int(), lengths, origin, leaf),
        (keys, pts, starts, lengths[:-1], origin, leaf),
        (keys, pts, starts, lengths, origin.cpu(), leaf),
        (keys, pts, starts, lengths, origin, leaf[None]),
    ]
    bad_sor = [((skeys.long(), spts, order), {}), ((skeys, spts[:-1], order), {}),
               ((skeys, spts, order.int()), {}), ((skeys, spts.t().contiguous().t(), order), {}),
               ((skeys, spts, order[:-1]), {}), ((skeys, spts, order), {"k": -1})]
    before = (tk.voxel_centroids.launches, tk.sor_window_stats.launches)
    for args in bad_centroids:
        with pytest.raises(ValueError):
            tk.voxel_centroids(*args)
    for args, kw in bad_sor:
        with pytest.raises(ValueError):
            tk.sor_window_stats(*args, **{"k": 30, **kw})
    assert (tk.voxel_centroids.launches, tk.sor_window_stats.launches) == before


# -- the prefilter's passes (`csrc/prefilter_pass.cu`) ----------------------------------------
# `cell_keys`, `sorted_runs`, `sor_threshold` and `compact_rows` against their plain
# versions on the same card tensors, bit for bit, with a rerun: the dense (131,072) and
# drift (8,192) raw buckets with the distance filter, the SOR's 65,536 rows, the loop
# submap (N = C = 131,072), the dense ring's 655,360 grid rows, a cloud ~1 km out, a NaN
# corner, one valid row, none, ragged sizes; the captured prefilter against its body run
# eagerly.

PASS_KEY_CASES = {  # (rows, valid rows, leaf, bounds, far)
    "dense_filtered": (131072, 73000, 0.1, (1.0, 0.0, None, None), False),
    "drift_filtered": (8192, 7000, 0.1, (1.0, 0.0, None, None), False),
    "crop_and_max": (16384, 12000, 0.1, (3.0, 40.0, (-30.0, -20.0, -2.0), (30.0, 35.0, 2.5)),
                     False),
    "sor": (65536, 60000, 1.0, None, False), "ring_grid": (655360, 600000, 2.0, None, False),
    "far": (16384, 9000, 0.5, None, True), "one_valid": (4096, 1, 0.1, None, False),
    "none_valid": (4096, 0, 0.1, (1.0, 0.0, None, None), False),
    "ragged": (1000, 700, 0.3, (2.5, 0.0, None, None), False), "n1": (1, 1, 0.1, None, False),
    "nan_corner": (16384, 9000, 0.5, None, False), "n5": (5, 4, 0.1, None, False),
}


def _pass_cloud(case, device, seed=0):
    from lidar_graph_slam_tpu_torch.ops.voxel import KeyFilter

    n, valid, leaf, bounds, far = PASS_KEY_CASES[case]
    pts, mask = _prefilter_cloud(n, valid, seed)
    if far:
        pts[:valid] += np.float32([812.5, -433.0, 21.0])
    if case == "nan_corner":  # a kept row's x, a dropped row's y
        pts[4321, 0], pts[valid + 5, 1] = np.nan, np.nan
    leaf_t = torch.full((), leaf, dtype=torch.float32, device=device)
    return (torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device), leaf_t,
            None if bounds is None else KeyFilter(*bounds))


@pytest.mark.parametrize("case", list(PASS_KEY_CASES))
def test_cell_keys_bit_equal_to_plain(cuda, case):
    """Keys, origin and (with the distance filter) the kept mask and padded rows equal
    `cell_keys_plain`'s bit for bit, a rerun too, two launches a call."""
    from lidar_graph_slam_tpu_torch.ops.voxel import INVALID_KEY, cell_keys_plain

    pts, mask, leaf, bounds = _pass_cloud(case, cuda)
    before = tk.cell_keys.launches
    out, again = tk.cell_keys(pts, mask, leaf, bounds), tk.cell_keys(pts, mask, leaf, bounds)
    assert tk.cell_keys.launches == before + 4
    _assert_bits(out, again, cell_keys_plain(pts, mask, leaf, bounds))
    kept = out[2] if bounds is not None else mask
    assert torch.equal(out[0] != INVALID_KEY, kept)
    if case == "none_valid":
        assert not bool(kept.any())
    if case == "nan_corner":
        assert bool(torch.isnan(out[1][0])) and not bool(torch.isnan(out[1][1:]).any())


# (rows N, valid rows, capacity C or None, leaf, gather): the dense bucket's downsample
# runs, the drift bucket's, the loop submap's (C = N), more voxels than C, exactly C, no
# valid row, the SOR's gather alone, the runs alone (a coarse level), a ragged N and C;
# the target build's fine level on the ring's 655,360 rows and its coarse level (65,536
# rows, C = 32,768, no gather), runs longer than 8,192 rows, N = 0 and 5.
PASS_RUN_CASES = {"dense": (131072, 70000, 65536, 0.1, True),
                  "drift": (8192, 7000, 65536, 0.1, True),
                  "loop_submap": (131072, 40000, 131072, 0.5, True),
                  "overflow": (16384, 12000, 2000, 0.1, True),
                  "exact_c": (16384, 12000, None, 0.1, True),
                  "all_invalid": (8192, 0, 4096, 0.1, True),
                  "gather_only": (65536, 60000, None, 1.0, True),
                  "runs_only": (65536, 30000, 32768, 0.4, False),
                  "ragged": (1000, 700, 777, 0.3, True), "n1": (1, 1, 3, 0.1, True),
                  "ring": (655360, 655360, 65536, 1.0, True),
                  "coarse": (65536, 65536, 32768, 2.0, False),
                  "long_runs": (131072, 131072, 4096, 16.0, True),
                  "n0": (0, 0, 5, 0.1, True), "n5": (5, 4, 2, 0.1, True)}


def _run_args(case, device, seed=0):
    """(keys_sorted, order, points, C) as `_key_sort` makes them."""
    n, valid, C, leaf, gather = PASS_RUN_CASES[case]
    pts, mask = _prefilter_cloud(n, valid, seed)
    p, m = torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device)
    if n:
        keys, _ = tk.cell_keys(p, m, torch.full((), leaf, device=device))
    else:  # `cell_keys_plain` has no corner of no rows
        keys = torch.zeros((0,), dtype=torch.int32, device=device)
    keys_sorted, order = torch.sort(keys, stable=True)
    if case == "exact_c":  # C equal to the number of runs
        valid_keys = keys_sorted[keys_sorted != 2**31 - 1]
        C = int((valid_keys[1:] != valid_keys[:-1]).sum()) + 1
    return keys_sorted, order if gather else None, p if gather else None, C


@pytest.mark.parametrize("case", list(PASS_RUN_CASES))
def test_sorted_runs_bit_equal_to_plain(cuda, case):
    """The sorted points and the runs (starts, lengths, num_voxels) equal
    `sorted_runs_plain`'s bit for bit, a rerun too: two launches with the runs, one for
    the gather alone."""
    from lidar_graph_slam_tpu_torch.ops.voxel import sorted_runs_plain

    keys, order, points, C = _run_args(case, cuda)
    before = tk.sorted_runs.launches
    out = tk.sorted_runs(keys, order, points, C)
    again = tk.sorted_runs(keys, order, points, C)
    assert tk.sorted_runs.launches == before + 2 * (2 if C is not None else 1)
    ref = sorted_runs_plain(keys, order, points, C)
    flat = [lambda r: [r[0]] if r[0] is not None else [], lambda r: list(r[1] or ())]
    _assert_bits(*([x for f in flat for x in f(r)] for r in (out, again, ref)))
    if C is not None:
        starts, lengths, nv = out[1]
        assert int(lengths.sum()) == keys.shape[0]
        if case == "overflow":
            assert int(nv) > C
        if case == "exact_c":
            assert int(nv) == C
        if case == "long_runs":
            assert int(lengths[:C].max()) > 8192


# (rows N, valid rows, one cell, SOR cell m, stddev): the SOR's 65,536 rows dense and
# sparse, no valid row, a ragged N across blocks, a tiny N, one cell.
PASS_SOR_CASES = {"dense": (65536, 60000, False, 1.0, 1.2),
                  "drift": (65536, 7000, False, 1.0, 1.2),
                  "all_invalid": (65536, 0, False, 1.0, 1.2),
                  "ragged": (3001, 2900, False, 3.0, 1.0), "tiny": (5, 5, False, 100.0, 2.0),
                  "one_cell": (600, 560, True, 1.0, 0.5)}


@pytest.mark.parametrize("case", list(PASS_SOR_CASES))
def test_sor_threshold_bit_equal_to_plain(cuda, case):
    """The kept mask and the padded rows equal `sor_threshold_plain`'s bit for bit (its
    sums in the kernel's order), a rerun too, three launches a call."""
    from lidar_graph_slam_tpu_torch.ops.neighbors import sor_threshold_plain, sort_by_cell

    n, valid, one_cell, cell, stddev = PASS_SOR_CASES[case]
    pts, mask = _prefilter_cloud(n, valid, 3, one_cell)
    p, m = torch.as_tensor(pts, device=cuda), torch.as_tensor(mask, device=cuda)
    cells = sort_by_cell(p, m, cell)
    mean_d, n_found = tk.sor_window_stats(cells.keys, cells.points, cells.order, 30)
    s = torch.full((), stddev, device=cuda)
    before = tk.sor_threshold.launches
    out = tk.sor_threshold(mean_d, n_found, m, p, s)
    again = tk.sor_threshold(mean_d, n_found, m, p, s)
    assert tk.sor_threshold.launches == before + 6
    _assert_bits(out, again, sor_threshold_plain(mean_d, n_found, m, p, s))
    if case == "tiny":  # every row finds the other four
        assert int(out[0].sum()) > 0
    elif case != "all_invalid":
        assert 0 < int(out[0].sum()) < valid


# (rows N, valid rows, capacity): the prefilter's 65,536 -> 32,768 with more valid rows
# than the capacity and fewer, none valid, a capacity past N, ragged sizes, N = 1.
PASS_COMPACT_CASES = {"over": (65536, 40000, 32768), "under": (65536, 9000, 32768),
                      "none": (65536, 0, 32768), "capacity_past_n": (3000, 2000, 5000),
                      "ragged": (2049, 1500, 1025), "n1": (1, 1, 4)}


@pytest.mark.parametrize("case", list(PASS_COMPACT_CASES))
def test_compact_rows_bit_equal_to_plain(cuda, case):
    """The compacted rows and mask equal `compact_rows_plain`'s bit for bit (the valid
    rows scattered through the whole cloud, not only a prefix), a rerun too, two launches
    a call."""
    from lidar_graph_slam_tpu_torch.core.pointcloud import compact_rows_plain

    n, valid, capacity = PASS_COMPACT_CASES[case]
    pts, _ = _prefilter_cloud(n, n, 5)
    rng = np.random.default_rng(5)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:valid]] = True
    p, m = torch.as_tensor(pts, device=cuda), torch.as_tensor(mask, device=cuda)
    before = tk.compact_rows.launches
    out, again = tk.compact_rows(p, m, capacity), tk.compact_rows(p, m, capacity)
    assert tk.compact_rows.launches == before + 4
    _assert_bits(out, again, compact_rows_plain(p, m, capacity))
    assert int(out[1].sum()) == min(valid, capacity)


def test_prefilter_pass_kernels_reject_bad_inputs(cuda):
    pts, mask, leaf, _ = _pass_cloud("ragged", cuda)
    keys, order, points, C = _run_args("ragged", cuda)
    mean_d = torch.zeros(1000, device=cuda)
    n_found = torch.zeros(1000, dtype=torch.int64, device=cuda)
    s = torch.ones((), device=cuda)
    bad = [
        lambda: tk.cell_keys(pts.double(), mask, leaf),
        lambda: tk.cell_keys(pts, mask[:-1], leaf),
        lambda: tk.cell_keys(pts, mask, leaf[None]),
        lambda: tk.cell_keys(pts, mask, leaf.cpu()),
        lambda: tk.sorted_runs(keys.long(), order, points, C),
        lambda: tk.sorted_runs(keys, order.int(), points, C),
        lambda: tk.sorted_runs(keys, order, points[:-1], C),
        lambda: tk.sorted_runs(keys, order, points, -1),
        lambda: tk.sorted_runs(keys),
        lambda: tk.sor_threshold(mean_d, n_found.int(), mask, pts, s),
        lambda: tk.sor_threshold(mean_d, n_found, mask, pts, 1.2),
        lambda: tk.sor_threshold(mean_d[:-1], n_found, mask, pts, s),
        lambda: tk.compact_rows(pts, mask.int(), 10),
        lambda: tk.compact_rows(pts.t().contiguous().t(), mask, 10),
        lambda: tk.compact_rows(pts, mask, -1),
    ]
    counts = [f.launches for f in (tk.cell_keys, tk.sorted_runs, tk.sor_threshold,
                                   tk.compact_rows)]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert counts == [f.launches for f in (tk.cell_keys, tk.sorted_runs, tk.sor_threshold,
                                           tk.compact_rows)]


@pytest.mark.parametrize("rows,valid", [(131072, 73000), (8192, 7000)])
def test_captured_prefilter_equals_its_body(cuda, rows, valid):
    """The default prefilter captured into a `utils/capture.py:Program` (warm-up, then a
    CUDA graph) and replayed on new scans equals its body run eagerly on the same scans
    bit for bit; a replay counts the new kernels' launches (cell_keys 4, sorted_runs 3,
    sor_threshold 3, compact_rows 2) and no replay reads the host."""
    from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig
    from lidar_graph_slam_tpu_torch.filters.prefilter import make_prefilter
    from lidar_graph_slam_tpu_torch.utils.capture import Program

    prefilter = make_prefilter(PrefilterConfig(), 32768, 65536)
    raw = torch.empty((rows, 3), device=cuda)
    raw_mask = torch.empty((rows,), dtype=torch.bool, device=cuda)
    program = Program(lambda: prefilter(raw, raw_mask), cuda, torch.cuda.Stream(cuda))
    names = ("cell_keys", "sorted_runs", "sor_threshold", "compact_rows")
    for seed in range(4):
        pts, mask = _prefilter_cloud(rows, valid - 500 * seed, seed=10 + seed)
        raw.copy_(torch.as_tensor(pts, device=cuda))
        raw_mask.copy_(torch.as_tensor(mask, device=cuda))
        torch.cuda.synchronize()
        before = [getattr(tk, n).launches for n in names]
        try:
            if seed >= 2:
                torch.cuda.set_sync_debug_mode("error")
            program()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if seed == 0:  # the warm-up's outputs; the capture's hold nothing until a replay
            continue
        assert [getattr(tk, n).launches - b for n, b in zip(names, before)] == [4, 3, 3, 2]
        eager = prefilter(raw, raw_mask)
        torch.cuda.synchronize()
        assert torch.equal(program.outputs.points, eager.points)
        assert torch.equal(program.outputs.mask, eager.mask)
        assert int(eager.mask.sum()) > 500
    assert program.captures == 1 and program.replays == 3


# -- the hash grid's kernels (`csrc/grid.cu`) --------------------------------------------------
# `grid_rows` against `neighbors.grid_rows_plain` and `dense_table` against
# `voxel.build_dense_table_plain` on the same card tensors, bit for bit, with a rerun: the
# dense ring's 655,360 grid rows, a loop-submap-like grid (131,072 rows, most of them
# padding: a ~118,000-row INVALID_KEY tail), a 32,768-row source, small and degenerate
# grids; the NDT map levels' tables (65,536 and 32,768 rows), an occupancy table of
# unsorted repeating keys, keys outside the table or below zero, N = 0.

GRID_CASES = ["ring", "loop_submap", "source", "n1", "n257", "one_cell", "all_invalid",
              "empty"]
TABLE_CASES = ["fine_level", "coarse_level", "occupancy", "mixed", "empty"]


def _grid_rows_args(case, device):
    """(keys_sorted, points_sorted) of a grid case (`GRID_CASES`), sorted at 2 m."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
    from lidar_graph_slam_tpu_torch.ops.voxel import voxel_downsample

    if case == "loop_submap":  # a 0.5 m downsample into 131,072 rows, as a loop input
        p, m = _cov_cloud("ring", device)
        filt = voxel_downsample(p[:40000], m[:40000], 0.5, capacity=131072)
        p, m = filt.points, filt.mask
    else:
        p, m = _cov_cloud(case, device)
    cells = tnb.sort_by_cell(p, m, 2.0) if p.shape[0] else tnb.CellSort(
        keys=torch.empty(0, dtype=torch.int32, device=device), points=p,
        order=torch.empty(0, dtype=torch.int64, device=device))
    return cells.keys, cells.points


def _dense_table_args(case, device, seed=0):
    """(keys, row_valid) of a table case (`TABLE_CASES`)."""
    rng = np.random.default_rng(seed)
    if case in ("fine_level", "coarse_level"):
        p, m = _cov_cloud("ring", device)
        res, cap = (2.0, 65536) if case == "fine_level" else (4.0, 32768)
        vmap = build_ndt_map(p, m, res, capacity=cap)
        return vmap.keys, vmap.valid
    if case == "occupancy":
        kp = torch.as_tensor(rng.normal(0.0, 25.0, (8192, 3)).astype(np.float32),
                             device=device)
        valid = torch.as_tensor(rng.random(8192) < 0.85, device=device)
        leaf = torch.tensor(2.0, device=device)
        origin = torch.where(valid[:, None], kp, PAD_VALUE).amin(dim=0) - leaf
        keys = pack_key(voxel_coords(kp, origin, 1.0 / leaf))
        return torch.where(valid, keys, INVALID_KEY), valid
    if case == "mixed":
        n = 20000
        cx, cy, cz = rng.integers(0, 300, n), rng.integers(0, 300, n), rng.integers(0, 80, n)
        keys = ((cx << 19) | (cy << 8) | cz).astype(np.int64)
        keys[n // 2:] = rng.permutation(keys[: n - n // 2])
        keys[::11] = 2**31 - 1
        keys[5::97] = -rng.integers(1, 2**31 - 1, len(keys[5::97]))
        return (torch.as_tensor(keys.astype(np.int32), device=device),
                torch.as_tensor(rng.random(n) < 0.8, device=device))
    return (torch.empty(0, dtype=torch.int32, device=device),
            torch.empty(0, dtype=torch.bool, device=device))


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_rows_bit_equal_to_plain(cuda, case):
    """`grid_rows` twice against `grid_rows_plain` (the running max, the packed rows and
    the scatter-min table), one launch a call (none at N = 0)."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb

    keys, pts = _grid_rows_args(case, cuda)
    n = keys.shape[0]
    before = tk.grid_rows.launches
    got = tk.grid_rows(keys, pts)
    again = tk.grid_rows(keys, pts)
    want = tnb.grid_rows_plain(keys, pts)
    torch.cuda.synchronize()
    _same_bits(got, want)
    _same_bits(again, want)
    assert tk.grid_rows.launches - before == 2 * int(n > 0)
    if case == "loop_submap":
        assert n == 131072 and int((keys == INVALID_KEY).sum()) > 90000
    if case in ("ring", "source", "loop_submap", "one_cell"):
        assert bool((want[2] >= 0).any())


@pytest.mark.parametrize("case", TABLE_CASES)
def test_dense_table_bit_equal_to_plain(cuda, case):
    """`dense_table` twice against `build_dense_table_plain`, one launch a call (none at N
    = 0); also at other dims."""
    from lidar_graph_slam_tpu_torch.ops.voxel import build_dense_table_plain

    keys, valid = _dense_table_args(case, cuda)
    before = tk.dense_table.launches
    got, again = tk.dense_table(keys, valid), tk.dense_table(keys, valid)
    want = build_dense_table_plain(keys, valid, TABLE_DIMS)
    small = tk.dense_table(keys, valid, (64, 32, 16))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert torch.equal(small, build_dense_table_plain(keys, valid, (64, 32, 16)))
    assert tk.dense_table.launches - before == 3 * int(keys.shape[0] > 0)
    assert bool((want >= 0).any()) == (case != "empty")


def test_grid_kernels_in_a_cuda_graph_and_without_a_read(cuda):
    """Both wrappers under `torch.cuda.set_sync_debug_mode("error")`, and captured in one
    CUDA graph: replays on new inputs copied into the captured ones equal the plain
    versions on those inputs (the table cleared at each replay)."""
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
    from lidar_graph_slam_tpu_torch.ops.voxel import build_dense_table_plain

    keys, pts = (t.clone() for t in _grid_rows_args("source", cuda))
    tkeys, tvalid = (t.clone() for t in _dense_table_args("occupancy", cuda))
    tk.grid_rows(keys, pts)
    tk.dense_table(tkeys, tvalid)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        tk.grid_rows(keys, pts)
        tk.dense_table(tkeys, tvalid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.grid_rows(keys, pts)
        tk.dense_table(tkeys, tvalid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (tk.grid_rows.launches, tk.dense_table.launches)
    with tk.recorded_launches() as tally, torch.cuda.graph(graph):
        rows = tk.grid_rows(keys, pts)
        table = tk.dense_table(tkeys, tvalid)
    assert tally == {tk.grid_rows: 1, tk.dense_table: 1}
    assert (tk.grid_rows.launches, tk.dense_table.launches) == before
    for seed in (1, 2):
        p2, m2 = _cov_cloud("source", cuda, seed=seed)
        cells = tnb.sort_by_cell(p2, m2, 2.0)
        k2, v2 = _dense_table_args("occupancy", cuda, seed=seed)
        keys.copy_(cells.keys)
        pts.copy_(cells.points)
        tkeys.copy_(k2)
        tvalid.copy_(v2)
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(rows, tnb.grid_rows_plain(keys, pts))
        assert torch.equal(table, build_dense_table_plain(tkeys, tvalid, TABLE_DIMS))


def test_grid_kernels_reject_bad_inputs(cuda):
    keys, pts = _grid_rows_args("n257", cuda)
    tkeys, tvalid = _dense_table_args("occupancy", cuda)
    before = (tk.grid_rows.launches, tk.dense_table.launches)
    for bad in ((keys.long(), pts), (keys, pts.double()), (keys[:-1], pts),
                (keys, pts[:, :2]), (keys, pts.cpu()), (keys, pts.t().contiguous().t())):
        with pytest.raises(ValueError):
            tk.grid_rows(*bad)
    for bad, kw in (((tkeys.long(), tvalid), {}), ((tkeys, tvalid.int()), {}),
                    ((tkeys[:-1], tvalid), {}), ((tkeys, tvalid.cpu()), {}),
                    ((tkeys[::2], tvalid[::2]), {}), ((tkeys, tvalid), {"dims": (0, 4, 4)}),
                    ((tkeys, tvalid), {"dims": (4096, 4096, 256)})):
        with pytest.raises(ValueError):
            tk.dense_table(*bad, **kw)
    assert (tk.grid_rows.launches, tk.dense_table.launches) == before


@pytest.mark.parametrize("method", ["GICP", "ICP"])
def test_captured_inserts_build_the_grid_with_its_kernel(cuda, method):
    """The GICP and ICP front ends' insert programs record one `grid_rows` launch (and
    GICP's one `gicp_covariances`), and the grid's sort by cell its two `cell_keys`
    launches and one `sorted_runs` gather; the target build they capture launches
    `grid_rows_kernel` and no `torch.cummax` scan and no scatter (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_graph_slam_tpu_torch.odometry.fused import FusedFrontEnd, make_fused_frontend

    cfg, raws = _capture_course(cuda, method)
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=cuda)
    for t, raw in enumerate(raws[:3]):
        front.dispatch(raw, None, None, t % 2)
        front.insert_and_rebuild(t % 2)
    torch.cuda.synchronize()
    want = {tk.grid_rows: 1, tk.cell_keys: 2, tk.sorted_runs: 1,
            **({tk.gicp_covariances: 1} if method == "GICP" else {})}
    assert front.insert_program.tally == want and front.insert_program.replays == 2
    _, _, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter, cfg.capacity,
                                    device=cuda)
    aux["rebuild"](front.ring)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        aux["rebuild"](front.ring)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert any("grid_rows_kernel" in k for k in names), names
    assert not [k for k in names if "cummax" in k or "dim_with_indices" in k
                or "scatter" in k.lower()], names


# -- the classic driver as three programs --------------------------------------------------

CLASSIC_FRAMES = 12


@pytest.fixture(scope="module")
def dense_frames():
    """The first 12 frames of `chip_smoke.py:dense_course(40)` (~73k points a scan)."""
    rng = np.random.default_rng(2)
    world = make_world(rng, extent=60.0, density=60.0, wall_height=12.0,
                       box_height=(6.0, 25.0), n_boxes=60)
    seq = SyntheticSequence(n_frames=40, seed=2, radius=35.0, laps=0.25, max_points=131072,
                            n_azimuth=2048, n_elevation=64)
    return [simulate_scan(world, seq.poses[i], rng, max_points=131072, n_azimuth=2048,
                          n_elevation=64) for i in range(CLASSIC_FRAMES)]


def _classic(method, extra=()):
    return apply_cli_overrides(PipelineConfig(), [
        "enable_loop_closure=false", "fused_frontend=false",
        f"scan_matcher.registration_method={method}", *extra])


def _run_bodies(pipe):
    """From now on `pipe`'s classic programs run their bodies directly, not captured."""
    pipe.prefilter_program = pipe.prefilter_program.body
    pipe.front.register_program = pipe.front.register_program.body
    pipe.front.insert_program = pipe.front.insert_program.body


def _classic_pair(cuda, cfg, scans):
    """The classic pipeline through its programs and with their bodies run eagerly, on
    the same scans: (captured, eager)."""
    pipes = SlamPipeline(cfg, device=cuda), SlamPipeline(cfg, device=cuda)
    _run_bodies(pipes[1])
    for pipe in pipes:
        for t, scan in enumerate(scans):
            pipe.process_scan(scan, stamp=0.1 * t)
    torch.cuda.synchronize()
    return pipes


def _same_classic(a, b):
    ra, rb = a.result(), b.result()
    np.testing.assert_array_equal(ra.odometry_poses, rb.odometry_poses)
    np.testing.assert_array_equal(ra.keyframe_poses, rb.keyframe_poses)
    np.testing.assert_array_equal(ra.keyframe_frame_indices, rb.keyframe_frame_indices)
    for k in range(a.back.n_keyframes):
        np.testing.assert_array_equal(a.back._cloud(k), b.back._cloud(k))
    leaves = {"ring": (a.front.ring, b.front.ring), "target": (a.front.target, b.front.target)}
    for name, (x, y) in leaves.items():
        for u, v in zip(_bits_of(x), _bits_of(y)):
            assert torch.equal(u.reshape(-1).view(torch.uint8),
                               v.reshape(-1).view(torch.uint8)), name
    return ra


def _bits_of(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for item in x for t in _bits_of(item)]
    return [t for f in dataclasses.fields(x) for t in _bits_of(getattr(x, f.name))]


@pytest.mark.parametrize("method", ["NDT", "ICP", "GICP"])
def test_captured_classic_driver_equals_its_bodies(cuda, dense_frames, method):
    """12 dense frames through the classic driver's three programs (CUDA graphs after the
    first call) and through the same bodies run eagerly on the card: every pose, keyframe
    and keyframe cloud, the ring and the target bit for bit; one capture a program, then
    replays only (the prefilter from frame 1, the register from frame 2)."""
    captured, eager = _classic_pair(cuda, _classic(method), dense_frames)
    res = _same_classic(captured, eager)
    n_kf = len(res.keyframe_frame_indices)
    log = captured.program_log()
    assert {k: (v["captures"], v["replays"]) for k, v in log.items()} == {
        "prefilter": (1, CLASSIC_FRAMES - 1), "register": (1, CLASSIC_FRAMES - 2),
        "insert": (1, n_kf - 1)}
    assert n_kf >= 3 and all(v["pool_bytes"] > 0 for v in log.values())
    assert all(r["converged"] for r in captured.metrics_writer.records if "frame" in r)


def test_captured_classic_prefilter_draws_as_its_body(cuda, dense_frames):
    """With `prefilter.use_random_sampling`, the classic prefilter program and the fused
    step program (their draws made once, at the first call) give what their bodies give
    eagerly, bit for bit, at every replay."""
    from lidar_graph_slam_tpu_torch.odometry.fused import (
        FusedFrontEnd,
        make_fused_frontend,
        pack_scalars,
    )

    sample = ["prefilter.use_random_sampling=true", "prefilter.random_sample_num=20000"]
    captured, eager = _classic_pair(cuda, _classic("NDT", sample), dense_frames[:5])
    _same_classic(captured, eager)
    assert captured.program_log()["prefilter"]["replays"] == 4
    assert int(captured.front.cloud_in.mask.sum()) == 20000

    cfg = apply_cli_overrides(PipelineConfig(), ["enable_loop_closure=false", *sample])
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device=cuda)
    init_state, step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter,
                                                cfg.capacity, device=cuda)
    state, ring = init_state(), aux["init_ring"]()
    target = aux["rebuild"](ring)
    eye3, eye4 = torch.eye(3, device=cuda), torch.eye(4, device=cuda)
    for t, scan in enumerate(dense_frames[:4]):
        raw = np.full((cfg.capacity.raw_points, 3), PAD_VALUE, np.float32)
        raw[:len(scan)] = scan[:cfg.capacity.raw_points]
        front.dispatch(raw, None, None, 0)
        state, out = step(state, torch.as_tensor(raw, device=cuda), target, eye3, False,
                          eye4, False)
        assert torch.equal(front.slots.scalars[0], pack_scalars(out)), t
        assert torch.equal(front.slots.kf_mask[0], out.kf_mask), t
        if bool(out.is_keyframe):
            front.insert_and_rebuild(0)
            ring, target = aux["insert_and_rebuild"](
                ring, int(out.keyframe_id) % aux["window"], out.kf_cloud, out.kf_mask,
                out.pose)
    assert front.captures == 2


@pytest.mark.parametrize("method", ["NDT", "ICP", "GICP"])
def test_classic_frames_launch_no_kernel_from_their_thread(cuda, dense_frames, method):
    """After frame 2, a classic frame's CUDA runtime calls (torch.profiler) are one
    `cudaGraphLaunch` for the prefilter, one for the register and one for a keyframe's
    insert, with its copies and waits, and no kernel launch call."""
    from torch.profiler import ProfilerActivity, profile

    pipe = SlamPipeline(_classic(method), device=cuda)
    for scan in dense_frames[:3]:
        pipe.process_scan(scan)
    torch.cuda.synchronize()
    kf_before = len(pipe.kf_frame_indices)
    frames = dense_frames[3:8]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for scan in frames:
            pipe.process_scan(scan)
        torch.cuda.synchronize()
    calls = {e.key: e.count for e in prof.key_averages() if e.key.startswith("cuda")}
    keyframes = len(pipe.kf_frame_indices) - kf_before
    assert calls.get("cudaGraphLaunch", 0) == 2 * len(frames) + keyframes, calls
    assert not [k for k in calls if "LaunchKernel" in k], calls
