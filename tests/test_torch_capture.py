"""The fused front end's two programs on fixed buffers (`odometry/fused.py:FusedFrontEnd`,
run by `utils/capture.py:Program`), on the CPU, where each program runs its body on the
same fixed buffers the card's CUDA graphs read and write.

  (a) A short fused course through the programs equals the plain step and
      insert-and-rebuild bit for bit, with NDT, GICP and ICP; its first frames equal the
      JAX package's fused step and jitted insert-and-rebuild.
  (b) With pipeline depth 1 and 2, frame t's output slot read after frames t+1 .. t+depth
      were dispatched equals what was read right after frame t, and the course equals the
      plain one at that depth (with one slot for all frames in flight, both fail).
  (c) The device flags `use_imu` / `use_ext` against the JAX step's masked selects, on and
      off; a flag that is off returns the same bits whatever the matrix beside it.
  (d) A checkpoint loaded into the fixed buffers continues as the run flushed at the
      same frame does, bit for bit, and the buffers keep their storage.
  (e) The launch tally a capture records is counted at each replay (a stand-in graph:
      this machine has no card), on the capturing thread only; a failed capture raises.
  (f) `batch_odometry`'s frame program (`parallel/multi_sequence.py`), built from its
      body and buffers on CPU tensors and given to a `Program` on a stand-in card:
      captured once, on frame 0, and replayed at every later frame, with the kernel
      wrappers' launch counts those of its body run eagerly on the same frames; a failed
      capture raises, and the body runs no more after it.

Tolerances: the programs against the plain bodies bit for bit (the same operators on the
same values). Against the JAX package, those of `tests/test_torch_pipeline.py` and
`tests/test_torch_classic.py` for one fused step: the pose to atol 1e-4, the flags and
iterations exact, num_inliers within 1%.
"""

import contextlib
import dataclasses
import threading
from collections import deque
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.odometry.fused import make_fused_frontend as jax_fused
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.core.pointcloud import PAD_VALUE
from lidar_graph_slam_tpu_torch.odometry.fused import (
    FusedFrontEnd,
    make_fused_frontend,
    pack_scalars,
)
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.parallel import multi_sequence as tms
from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline
from lidar_graph_slam_tpu_torch.utils import capture
from lidar_graph_slam_tpu_torch.utils import checkpoint as tckpt
from tests.test_pipeline import small_config

N_FRAMES = 3
METHODS = ("NDT", "GICP", "ICP")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module (GICP's covariances are ~800 small ops,
    and the suite runs its files in parallel processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(method: str = "NDT", depth: int = 1):
    cfg = replace(small_config(), enable_loop_closure=False, pipeline_depth=depth)
    return replace(cfg, scan_matcher=replace(cfg.scan_matcher, registration_method=method))


def _port(cfg) -> tcfg.PipelineConfig:
    return tcfg._update_dataclass(tcfg.PipelineConfig(), dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def raws():
    """`tests/test_torch_pipeline.py`'s course, padded to the 8,192-row bucket."""
    seq = SyntheticSequence(n_frames=N_FRAMES, seed=3, max_points=8192, radius=30.0,
                            laps=1.1 * 5 / 90)
    out = []
    for scan, _ in seq:
        raw = np.full((8192, 3), PAD_VALUE, np.float32)
        raw[:len(scan)] = scan[:8192]
        out.append(raw)
    return out


def _lagged(raws, depth, dispatch, consume):
    """The runner's lagged readback: frame 0 consumed at once, then `depth` frames kept in
    flight; returns each frame's consumed row."""
    rows, pending = [], deque()
    for t, raw in enumerate(raws):
        pending.append(dispatch(t, raw))
        while pending and (t == 0 or len(pending) > depth):
            rows.append(consume(pending.popleft()))
    while pending:
        rows.append(consume(pending.popleft()))
    return torch.stack(rows)


def program_course(cfg, raws):
    """The course through `FusedFrontEnd`'s programs; (rows, front end)."""
    depth = max(1, cfg.pipeline_depth)
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, depth + 1,
                          device="cpu")

    def dispatch(t, raw):
        front.dispatch(raw, None, None, t % (depth + 1))
        return t % (depth + 1)

    def consume(slot):
        row = front.slots.scalars[slot].clone()
        if row[17] > 0.5:
            front.insert_and_rebuild(slot)
        return row

    return _lagged(raws, depth, dispatch, consume), front


def plain_course(cfg, raws):
    """The course through the plain step and insert-and-rebuild; (rows, ring, target)."""
    depth = max(1, cfg.pipeline_depth)
    init_state, step, aux = make_fused_frontend(cfg.scan_matcher, cfg.prefilter,
                                                cfg.capacity, device="cpu")
    run = {"state": init_state(), "ring": aux["init_ring"]()}
    run["target"] = aux["rebuild"](run["ring"])

    def dispatch(t, raw):
        run["state"], out = step(run["state"], torch.as_tensor(raw), run["target"],
                                 torch.eye(3), False, torch.eye(4), False)
        return out

    def consume(out):
        if bool(out.is_keyframe):
            run["ring"], run["target"] = aux["insert_and_rebuild"](
                run["ring"], int(out.keyframe_id) % aux["window"], out.kf_cloud, out.kf_mask,
                out.pose)
        return pack_scalars(out)

    return _lagged(raws, depth, dispatch, consume), run["ring"], run["target"]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for item in x for t in _leaves(item)]
    return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]


def same_bits(a, b) -> bool:
    """Every tensor of `a` has the bits of `b`'s (NaN included: a grid's packed rows hold
    the invalid cell key bitcast to float32, a NaN)."""
    pairs = list(zip(_leaves(a), _leaves(b)))
    return len(pairs) == len(_leaves(b)) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in pairs)


@pytest.fixture(scope="module")
def jax_fronts():
    """The JAX package's fused front end a method, built (and compiled) once a module."""
    fronts = {}

    def get(method):
        if method not in fronts:
            cfg = _config(method)
            fronts[method] = jax_fused(cfg.scan_matcher, cfg.prefilter, cfg.capacity)
        return fronts[method]

    return get


def _empty_target(aux):
    """The empty ring's target, from the jitted insert-and-rebuild (so `rebuild` needs no
    compile of its own): a slot of an empty ring with every point masked out."""
    ring = aux["init_ring"]()
    return aux["insert_and_rebuild"](ring, jnp.asarray(0, jnp.int32), ring.clouds[0],
                                     ring.masks[0], jnp.eye(4))[1]


def jax_course(front, raws, frames: int):
    """The JAX package's fused step and jitted insert-and-rebuild (`front`) over the first
    `frames` frames, lagged as the runner lags them: each frame's (pose, converged,
    is_keyframe, iterations, num_inliers)."""
    init_state, step, aux = front
    state, ring = init_state(), aux["init_ring"]()
    no, eye3, eye4 = jnp.asarray(False), jnp.eye(3), jnp.eye(4)
    target = _empty_target(aux)

    def dispatch(t, raw):
        nonlocal state
        state, out = step(state, jnp.asarray(raw), target, eye3, no, eye4, no)
        return out

    def consume(out):
        nonlocal ring, target
        if bool(out.is_keyframe):
            ring, target = aux["insert_and_rebuild"](
                ring, jnp.asarray(int(out.keyframe_id) % aux["window"], jnp.int32),
                out.kf_cloud, out.kf_mask, out.pose)
        return torch.as_tensor(np.concatenate([np.asarray(out.pose, np.float32).reshape(16), [
            float(out.converged), float(out.is_keyframe), float(out.iterations),
            float(out.num_inliers)]]).astype(np.float32))

    return _lagged(raws[:frames], 1, dispatch, consume)


# -- (a) the programs against the plain bodies and the JAX package --------------------------

@pytest.mark.parametrize("method", METHODS)
def test_program_course_equals_plain_body_and_reference(raws, jax_fronts, method):
    cfg = _port(_config(method))
    rows, front = program_course(cfg, raws)
    want, ring, target = plain_course(cfg, raws)
    assert torch.equal(rows, want), (rows - want).abs().max()
    assert same_bits(front.ring, ring) and same_bits(front.target, target)
    assert bool((rows[:, 17] > 0.5).any()) and len(front.programs) == 1

    ref = jax_course(jax_fronts(method), raws, 2)
    np.testing.assert_allclose(rows[:2, :16].numpy(), ref[:, :16].numpy(), atol=1e-4)
    assert torch.equal(rows[:2, 16:18], ref[:, 16:18])        # converged, is_keyframe
    assert torch.equal(rows[:2, 19], ref[:, 18])               # iterations
    inl, ref_inl = rows[1, 22].item(), ref[1, 19].item()
    assert ref_inl > 100 and abs(inl - ref_inl) <= 0.01 * ref_inl


# -- (b) one output slot for each frame in flight ------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_output_slots_outlive_the_frames_in_flight(raws, depth):
    cfg = _port(_config("NDT", depth))
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, depth + 1,
                          device="cpu")
    reads = {}
    for t, raw in enumerate(raws):
        front.dispatch(raw, None, None, t % (depth + 1))
        reads[t] = {k: v.clone() for k, v in front.outputs(t % (depth + 1)).items()}
        if t == 0:
            front.insert_and_rebuild(0)  # the bootstrap keyframe, as the runner does
        if t >= depth:  # frame t - depth, read again after the frames dispatched since
            old = t - depth
            again = front.outputs(old % (depth + 1))
            assert all(torch.equal(again[k], reads[old][k]) for k in again), old
            assert not torch.equal(reads[t]["kf_cloud"], reads[old]["kf_cloud"])
    if depth > 1:  # depth 1 is (a)'s course
        rows, _ = program_course(cfg, raws)
        want, _, _ = plain_course(cfg, raws)
        assert torch.equal(rows, want)


# -- (c) the device flags ------------------------------------------------------------------

@pytest.fixture(scope="module")
def bootstrapped(raws, jax_fronts):
    """The JAX package's state and target after the bootstrap frame, and its step."""
    init_state, step, aux = jax_fronts("NDT")
    no, eye3, eye4 = jnp.asarray(False), jnp.eye(3), jnp.eye(4)
    state, out = step(init_state(), jnp.asarray(raws[0]), _empty_target(aux), eye3, no,
                      eye4, no)
    ring, target = aux["insert_and_rebuild"](aux["init_ring"](), jnp.asarray(0, jnp.int32),
                                             out.kf_cloud, out.kf_mask, out.pose)
    # The step donates its state: each test makes its own from these arrays.
    return jax.tree_util.tree_map(np.asarray, state), target, step


def _imu_ext():
    c, s = np.cos(0.01), np.sin(0.01)
    imu_R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    T_ext = np.eye(4, dtype=np.float32)
    T_ext[:3, :3] = imu_R.T
    T_ext[:3, 3] = [0.05, -0.02, 0.1]
    return imu_R, T_ext


@pytest.mark.parametrize("use_imu,use_ext", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_device_flags_match_the_reference_selects(raws, bootstrapped, use_imu, use_ext):
    jstate, jtarget, jstep = bootstrapped
    imu_R, T_ext = _imu_ext()
    _, want = jstep(jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(raws[1]), jtarget, jnp.asarray(imu_R),
                    jnp.asarray(use_imu), jnp.asarray(T_ext), jnp.asarray(use_ext))

    cfg = _port(_config("NDT"))
    front = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device="cpu")
    front.dispatch(raws[0], None, None, 0)
    front.insert_and_rebuild(0)
    state = dataclasses.replace(front.state, **{  # the step program updates front.state
        f.name: getattr(front.state, f.name).clone() for f in dataclasses.fields(front.state)})
    _, plain = front.step(state, torch.as_tensor(raws[1]), front.target,
                          torch.as_tensor(imu_R), torch.tensor(use_imu),
                          torch.as_tensor(T_ext), torch.tensor(use_ext))
    front.dispatch(raws[1], imu_R if use_imu else None, T_ext if use_ext else None, 1)
    row = front.slots.scalars[1]
    assert torch.equal(row, pack_scalars(plain))
    np.testing.assert_allclose(row[:16].view(4, 4).numpy(), np.asarray(want.pose), atol=1e-4)
    assert row[16].item() == float(want.converged) and row[17].item() == float(want.is_keyframe)
    assert row[19].item() == float(want.iterations)
    j_inl = int(np.asarray(want.num_inliers))
    assert abs(row[22].item() - j_inl) <= 0.01 * j_inl
    if not (use_imu or use_ext):
        # A flag that is off selects the other operand's own bits.
        _, off = front.step(state, torch.as_tensor(raws[1]), front.target,
                            torch.as_tensor(imu_R), False, torch.as_tensor(T_ext), False)
        assert torch.equal(pack_scalars(off), row)


# -- (d) a checkpoint into the fixed buffers -------------------------------------------------

def test_checkpoint_loads_into_the_fixed_buffers(raws, tmp_path):
    cfg = _port(_config("NDT"))
    scans = [r[r[:, 0] < 0.5 * PAD_VALUE] for r in raws]
    cut = 2
    flushed = SlamPipeline(cfg, device="cpu")
    for s in scans[:cut]:
        flushed.process_scan(s)
    flushed.flush()
    for s in scans[cut:]:
        flushed.process_scan(s)
    res_a = flushed.result()

    saved = SlamPipeline(cfg, device="cpu")
    for s in scans[:cut]:
        saved.process_scan(s)
    path = str(tmp_path / "state.npz")
    tckpt.save_pipeline(saved, path)
    resumed = tckpt.load_pipeline(path, device="cpu")
    for s in scans[cut:]:
        resumed.process_scan(s)
    res_c = resumed.result()
    np.testing.assert_array_equal(res_c.odometry_poses, res_a.odometry_poses)
    np.testing.assert_array_equal(res_c.keyframe_frame_indices, res_a.keyframe_frame_indices)

    # `load` writes into the buffers the programs hold; it rebinds nothing.
    front = resumed.fused_front
    buffers = _leaves(front.state) + _leaves(front.ring) + _leaves(front.target)
    ptrs = [t.data_ptr() for t in buffers]
    src = FusedFrontEnd(cfg.scan_matcher, cfg.prefilter, cfg.capacity, 2, device="cpu")
    front.load(src.state, src.ring)
    assert [t.data_ptr() for t in buffers] == ptrs
    assert same_bits(front.ring, src.ring) and same_bits(front.target, src.target)
    assert int(front.state.n_keyframes) == 0


# -- (e) the launch tally across replays -----------------------------------------------------

class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: a replay re-runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return (0, 1)

    def reset(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """`torch.cuda`'s stream, graph and synchronize calls replaced by stand-ins; `fail`
    makes the next capture raise, as a refused capture does."""
    state = {"modes": [], "fail": False, "other_thread": None}
    finalize = kernels.ndt_finalize

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global"):
        state["modes"].append(capture_error_mode)
        yield
        # Another thread launches while this one captures: counted at once.
        worker = threading.Thread(target=kernels._count, args=(finalize, 5))
        worker.start()
        worker.join(timeout=10)
        state["other_thread"] = not worker.is_alive()
        if state["fail"]:
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return state


def test_launch_tally_is_counted_at_each_replay(fake_card):
    runs = []

    def body():
        runs.append(1)
        kernels._count(kernels.eigh3x3, 2)
        kernels._count(kernels.voxel_centroids)

    program = capture.Program(body, "cuda", stream=_FakeStream())
    before = (kernels.eigh3x3.launches, kernels.voxel_centroids.launches,
              kernels.ndt_finalize.launches, kernels.thread_launches())
    program()  # the warm-up runs and counts; the capture records
    assert program.captured and len(runs) == 2 and fake_card["modes"] == ["thread_local"]
    assert program.tally == {kernels.eigh3x3: 2, kernels.voxel_centroids: 1}
    assert fake_card["other_thread"]
    assert (kernels.eigh3x3.launches - before[0], kernels.voxel_centroids.launches - before[1],
            kernels.ndt_finalize.launches - before[2],
            kernels.thread_launches() - before[3]) == (2, 1, 5, 3)
    for _ in range(3):
        program()
    assert len(runs) == 2 and program.graph.replays == program.replays == 3
    assert (kernels.eigh3x3.launches - before[0], kernels.voxel_centroids.launches - before[1],
            kernels.thread_launches() - before[3]) == (8, 4, 12)


def test_a_failed_capture_raises(fake_card):
    fake_card["fail"] = True
    runs = []
    program = capture.Program(lambda: runs.append(1), "cuda", stream=_FakeStream())
    with pytest.raises(RuntimeError, match="capturing"):
        program()
    assert not program.captured and len(runs) == 2
    with pytest.raises(ValueError, match="capture stream"):
        capture.Program(lambda: None, "cuda")


# -- (f) batch_odometry's frame program ------------------------------------------------------

B_PROG, F_PROG, N_PROG, CAP_PROG = 2, 3, 512, 2048
BATCH_CFG = tcfg.ScanMatcherConfig(max_scan_accumulate_num=2,
                                   ndt=tcfg.NdtConfig(resolution=2.0, max_iterations=8))


@pytest.fixture(scope="module")
def batch_frames():
    """[B, F, N, 3] scans and [B, F, N] masks of two short synthetic sequences."""
    scans = np.full((B_PROG, F_PROG, N_PROG, 3), PAD_VALUE, np.float32)
    masks = np.zeros((B_PROG, F_PROG, N_PROG), bool)
    for b in range(B_PROG):
        seq = SyntheticSequence(n_frames=F_PROG, seed=10 + b, max_points=N_PROG, laps=0.1,
                                radius=30.0 + 2 * b)
        for f, (scan, _) in enumerate(seq):
            scans[b, f, :len(scan)], masks[b, f, :len(scan)] = scan, True
    return torch.as_tensor(scans), torch.as_tensor(masks)


def _batch_program(buf, body=None):
    return capture.Program(body or partial(tms._frame_body, buf, BATCH_CFG, CAP_PROG),
                           "cuda", stream=_FakeStream())


@pytest.fixture
def counted_launches(monkeypatch):
    """The batch body's kernel wrappers count on CPU tensors what they launch on the card
    (their plain versions count nothing); returns a reader of their counts."""
    def counting(wrapper, launches):
        def call(*a, **k):
            kernels._count(wrapper, launches(a))
            return wrapper(*a, **k)
        return call

    wrappers = (kernels.ndt_align_loop_batched, kernels.ndt_finalize, kernels.dense_table)
    monkeypatch.setattr(kernels, "ndt_align_loop_batched",
                        counting(wrappers[0], lambda a: a[-2] + a[-1]))  # iterations + polish
    monkeypatch.setattr(kernels, "ndt_finalize", counting(wrappers[1], lambda a: 1))
    monkeypatch.setattr(kernels, "dense_table", counting(wrappers[2], lambda a: 1))
    return lambda: np.array([w.launches for w in wrappers] + [kernels.thread_launches()])


def test_batch_frame_program_captures_once_and_replays(fake_card, counted_launches,
                                                       batch_frames):
    scans, masks = batch_frames
    window = BATCH_CFG.max_scan_accumulate_num
    eager = tms._buffers(scans, masks, window)
    before = counted_launches()
    for _ in range(F_PROG):
        tms._frame_body(eager, BATCH_CFG, CAP_PROG)
    want = counted_launches() - before
    assert (want[:3] > 0).all() and int(eager.frame) == F_PROG

    buf = tms._buffers(scans, masks, window)
    program, log = _batch_program(buf), []
    before = counted_launches()
    tms._run_frames(program, F_PROG, log)
    # The stand-in capture's other thread counted 5 finalizes of its own.
    assert (counted_launches() - before - want == [0, 5, 0, 0]).all()
    assert log == [{"device": "cuda", "captures": 1, "replays": F_PROG - 1, "pool_bytes": 0}]
    assert fake_card["modes"] == ["thread_local"] and not program.captured  # released


def test_failed_batch_capture_raises_and_runs_no_more(fake_card, batch_frames):
    fake_card["fail"] = True
    buf = tms._buffers(*batch_frames, BATCH_CFG.max_scan_accumulate_num)
    runs = []

    def body():
        runs.append(1)
        tms._frame_body(buf, BATCH_CFG, CAP_PROG)

    program = _batch_program(buf, body)
    with pytest.raises(RuntimeError, match="capturing"):
        tms._run_frames(program, F_PROG, [])
    # The warm-up and the capture ran the body; no frame ran eagerly after the failure.
    assert len(runs) == 2 and int(buf.frame) == 2 and not program.captured
