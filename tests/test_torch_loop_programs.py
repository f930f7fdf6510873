"""A loop attempt as two programs over fixed buffers (`graph/slam.py:LoopPrograms`): the
frame's thread stages the attempt's padded clouds into pinned host buffers, and the
verify worker runs the inputs program (upload, filter, grid, maps, the GICP target and
covariances) and the verify program (`make_verify_one` a candidate), on the CPU each
body on the same fixed buffers the card's CUDA graphs read and write.

  (a) ICP, NDT and GICP: two attempts in a row through the programs, each loop record
      against the JAX package's `try_close_loop` at the same point, and against the
      same attempts built and verified operator by operator bit for bit; the programs'
      input, target and output buffers keep their `data_ptr` across the attempts.
  (b) `loop_topk=2`: the two candidates run in one pair of programs of their own key,
      against the JAX package's vmapped verification of both.
  (c) On a stand-in card (`tests/test_torch_capture.py:fake_card`): one capture a program
      at the first attempt, replays after; the captures and the input builds run on the
      verify worker's thread, and the frame's thread launches no kernel at a tick; a
      failed capture is raised by `_consume_verify` and no body runs after it.
  (d) `use_global_init`: the guess and RANSAC counts written into the verify program's
      fixed buffers equal the eager `_initial_guess` on the inputs built operator by
      operator.
  (e) The staging writes a cloud as `PointCloud.from_array` pads it, a longer one before
      it or not; the mesh path stays operator by operator.

Tolerances: against the JAX package those of `tests/test_torch_loop.py:
test_try_close_loop_matches_reference` (fitness rtol 1e-4, transform and optimized poses
atol 1e-4, candidate and decisions exact); programs against operator by operator, and the
guess, bit for bit (the same operators on the same values).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.graph.slam import GraphBasedSLAM as JBack
from lidar_graph_slam_tpu_torch.core import config as tcfg
from lidar_graph_slam_tpu_torch.core.pointcloud import PointCloud
from lidar_graph_slam_tpu_torch.graph import slam as tslam
from lidar_graph_slam_tpu_torch.ops import kernels
from lidar_graph_slam_tpu_torch.parallel.distributed import make_mesh
from lidar_graph_slam_tpu_torch.utils import capture
from tests.test_loop_verifiers import build_loop_backend
from tests.test_torch_capture import _FakeStream, fake_card  # noqa: F401 (a fixture)
from tests.test_torch_loop import BIG_DRIFT, REDUCED_REG, _port_backend

METHODS = ("ICP", "NDT", "GICP")
# The loop path's kernel wrappers (`counted_wrappers`).
LOOP_WRAPPERS = ("voxel_centroids", "grid_rows", "dense_table", "ndt_finalize",
                 "ndt_align_loop", "icp_align_loop", "icp_fitness", "gicp_covariances",
                 "gicp_align_loop")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module (`tests/test_torch_loop.py`: the back end
    runs torch ops in worker threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_backend(jb, **overrides) -> JBack:
    """A reference back end with `overrides` fed the keyframes `jb` was fed."""
    back = JBack(dataclasses.replace(jb.cfg, **overrides), jb.capacity)
    for k in range(jb.n_keyframes):
        cloud = jb._cloud(k)
        back.add_keyframe({"pose": jb.kf_front_poses[k], "cloud": cloud,
                           "cloud_mask": np.ones(cloud.shape[0], bool),
                           "accum_distance": jb.kf_accum_dist[k],
                           "stamp": jb.kf_stamps[k]})
    return back


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dataclasses, in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]


def _buffers(progs) -> list:
    """Every fixed buffer of a key's programs: inputs, the inputs program's outputs (the
    targets), the guesses and the rows."""
    return _tensors((progs.source, progs.submaps, progs.inputs.outputs, progs.guess,
                     progs.out))


def _same_record(a, b, exact: bool) -> None:
    for key in ("latest", "candidate", "converged", "accepted"):
        assert a[key] == b[key], (key, a, b)
    if exact:
        assert a["fitness"] == b["fitness"]
        np.testing.assert_array_equal(a["transform"], b["transform"])
    else:
        np.testing.assert_allclose(a["fitness"], b["fitness"], rtol=1e-4)
        np.testing.assert_allclose(a["transform"], b["transform"], atol=1e-4)


@pytest.fixture(scope="module")
def two_attempts():
    """For each verifier: the reference's loop log and optimized poses after each of two
    `try_close_loop` calls, and a port back end fed the same keyframes."""
    out = {}
    for method in METHODS:
        jb, _ = build_loop_backend(method)
        fresh = _port_backend(jb, async_backend=True)
        logs = []
        for _ in range(2):
            jb.try_close_loop()
            logs.append(([dict(r) for r in jb.loop_log], jb.optimized_poses()))
        out[method] = (logs, fresh, jb)
    return out


@pytest.mark.parametrize("method", METHODS)
def test_two_attempts_through_the_programs(two_attempts, method):
    logs, back, jb = two_attempts[method]
    plain = _port_backend(jb, async_backend=True)
    plain.programs_enabled = False
    ptrs = None
    for attempt, (jlog, jposes) in enumerate(logs):
        back.try_close_loop()
        plain.try_close_loop()
        assert len(back.loop_log) == len(jlog) == attempt + 1
        _same_record(back.loop_log[-1], jlog[-1], exact=False)
        _same_record(back.loop_log[-1], plain.loop_log[-1], exact=True)
        np.testing.assert_allclose(back.optimized_poses(), jposes, atol=1e-4)
        np.testing.assert_array_equal(back.optimized_poses(), plain.optimized_poses())
        progs = back.loop_programs.keys[(method, 1, False)]
        now = [t.data_ptr() for t in _buffers(progs)]
        assert ptrs is None or now == ptrs
        ptrs = now
    assert back.loop_log[0]["accepted"]
    assert list(back.loop_programs.keys) == [(method, 1, False)]
    assert not plain.loop_programs.keys
    # The source's covariances are an output of the inputs program with GICP only.
    assert (progs.inputs.outputs[1] is not None) == (method == "GICP")


def test_topk_two_matches_the_vmapped_reference():
    jb0, _ = build_loop_backend("ICP")
    jb = _jax_backend(jb0, loop_topk=2, search_key_frame_num=3)
    back = _port_backend(jb0, async_backend=True, loop_topk=2, search_key_frame_num=3)
    assert jb.try_close_loop() and back.try_close_loop()
    assert len(back.loop_log) == len(jb.loop_log) == 2
    assert back.loop_log[0]["candidate"] != back.loop_log[1]["candidate"]
    for rt, rj in zip(back.loop_log, jb.loop_log):
        _same_record(rt, rj, exact=False)
    np.testing.assert_allclose(back.optimized_poses(), jb.optimized_poses(), atol=1e-4)
    progs = back.loop_programs.keys[("ICP", 2, False)]
    assert list(back.loop_programs.keys) == [("ICP", 2, False)]
    assert len(progs.inputs.outputs[0]) == 2 and progs.out.shape == (2, tslam._ROW)


# -- (c) on a stand-in card --------------------------------------------------------------------

@pytest.fixture
def counted_wrappers(monkeypatch):
    """The loop path's kernel wrappers count one launch a call on CPU tensors too (their
    plain versions count nothing)."""
    def counting(wrapper):
        def call(*a, **k):
            kernels._count(wrapper)
            return wrapper(*a, **k)
        return call

    for name in LOOP_WRAPPERS:
        monkeypatch.setattr(kernels, name, counting(getattr(kernels, name)))


@pytest.fixture
def on_threads(monkeypatch):
    """The thread names of each program capture and of each input build."""
    seen = {"capture": [], "builds": []}
    real_capture = capture.Program.capture

    def spy_capture(self):
        seen["capture"].append(threading.current_thread().name)
        return real_capture(self)

    def spy_build(fn):
        def call(*a, **k):
            seen["builds"].append(threading.current_thread().name)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(capture.Program, "capture", spy_capture)
    for name in ("voxel_downsample", "build_hash_grid", "build_ndt_map"):
        monkeypatch.setattr(tslam, name, spy_build(getattr(tslam, name)))
    return seen


@pytest.fixture
def programs_on_card(fake_card, monkeypatch):
    """The loop programs made as CUDA programs on the stand-in card (their bodies still on
    the CPU's fixed buffers)."""
    monkeypatch.setattr(tslam, "Program", lambda body, device, stream: capture.Program(
        body, "cuda", stream=_FakeStream()))
    return fake_card


def _ticking_backend(method="ICP"):
    jb, _ = build_loop_backend(method)
    return _port_backend(jb, async_backend=True, loop_search_period_frames=1)


def test_programs_capture_once_in_the_worker(programs_on_card, counted_wrappers, on_threads):
    back = _ticking_backend()
    frame = threading.current_thread().name
    for attempt in range(3):
        before = kernels.thread_launches()
        back.on_frame()  # a tick: stages the attempt and starts the worker
        assert kernels.thread_launches() == before
        assert back._pending_verify is not None and "thread" in back._pending_verify
        back.finish_async()
        assert back.verify_launches > 0
    progs = back.loop_programs.keys[("ICP", 1, False)]
    log = progs.log()
    assert {k: (v["captures"], v["replays"]) for k, v in log.items()} == {
        "inputs": (1, 2), "verify": (1, 2)}
    assert set(log["verify"]["first_call_ms"]) == {"warm_up", "drain", "collect", "capture"}
    assert programs_on_card["modes"] == ["thread_local"] * 2
    assert on_threads["capture"] == ["loop-verify"] * 2
    # The warm-up and the capture built the inputs (a filter, a grid, the 4 m map); a
    # replay builds none; none on the frame's thread.
    assert on_threads["builds"] == ["loop-verify"] * 6 and frame != "loop-verify"
    assert back.loop_log[0]["accepted"] and len(back.loop_log) == 3


def test_failed_loop_capture_raises_and_runs_no_more(programs_on_card, monkeypatch):
    programs_on_card["fail"] = True
    back = _ticking_backend()
    runs = {"inputs": 0, "verify": 0}
    real_targets, real_verify = tslam.candidate_targets, back._verify_one

    def count_targets(*a, **k):
        runs["inputs"] += 1
        return real_targets(*a, **k)

    def count_verify(*a, **k):
        runs["verify"] += 1
        return real_verify(*a, **k)

    monkeypatch.setattr(tslam, "candidate_targets", count_targets)
    back._verify_one = count_verify
    back.on_frame()
    with pytest.raises(RuntimeError, match="capturing"):
        back.finish_async()
    # The inputs program warmed up and was captured (where it failed); the verify program
    # only warmed up. Nothing ran again, and no record was made.
    assert runs == {"inputs": 2, "verify": 1} and back.loop_log == []
    progs = back.loop_programs.keys[("ICP", 1, False)]
    assert not progs.inputs.captured and not progs.verify.captured and not progs.in_flight


# -- (d) the global guess ------------------------------------------------------------------------

def test_global_guess_in_the_fixed_buffer_equals_the_eager_one():
    jb, _ = build_loop_backend("ICP", **BIG_DRIFT)
    kw = dict(async_backend=True, use_global_init=True, global_reg=REDUCED_REG)
    back, eager = _port_backend(jb, **kw), _port_backend(jb, **kw)
    pending = back.begin_loop_attempt()
    assert back._consume_verify(pending)
    progs = back.loop_programs.keys[("ICP", 1, True)]
    inp = eager._build_verify_inputs()
    src_p, src_m, _ = inp["source"]
    guess, (counts,) = eager._initial_guess(inp["targets"][0][3], src_p, src_m,
                                            inp["T_latest"][:3, 3])
    assert torch.equal(progs.guess[0], guess)
    assert not torch.equal(guess, torch.eye(4))
    assert back.loop_log[0]["ransac_families"] == {
        "n_3pt_valid": int(counts[0]), "n_yaw_valid": int(counts[1]),
        "best_is_yaw": bool(counts[2])}
    # The viewpoints staged: the latest keyframe's position, then the candidate's.
    np.testing.assert_array_equal(progs.viewpoints.numpy(), np.stack(
        [inp["T_latest"][:3, 3], eager._poses_host[inp["cands"][0]][:3, 3]]))


# -- (e) the staging and the route -----------------------------------------------------------------

@pytest.mark.parametrize("rows", [0, 5, 300, 640])
def test_staging_pads_as_from_array(rows):
    """Each staging equals `PointCloud.from_array`'s padding, after a longer cloud, a
    shorter one and an empty one (the rows past the capacity are cut)."""
    rng = np.random.default_rng(rows)
    host = tslam._staging_cloud(512, "cpu")
    held = 0
    for n in (rows, 400, rows, 0, rows):
        xyz = rng.normal(size=(n, 3)).astype(np.float32)
        held = tslam._stage_rows(host, xyz, held)
        want = PointCloud.from_array(xyz, capacity=512)
        assert torch.equal(host.points, want.points) and torch.equal(host.mask, want.mask)
        assert held == min(n, 512)


def test_staging_refuses_while_in_flight():
    jb, _ = build_loop_backend("ICP")
    back = _port_backend(jb, async_backend=True)
    progs = back.loop_programs.get(1)
    plan = back._plan_attempt()
    progs.stage(plan["source"], plan["submaps"])
    with pytest.raises(RuntimeError, match="still read"):
        progs.stage(plan["source"], plan["submaps"])


def test_mesh_and_multiprocess_keep_the_operator_path():
    cfg, cap = tcfg.GraphSlamConfig(), tcfg.CapacityConfig(max_keyframes=64)
    assert tslam.GraphBasedSLAM(cfg, cap, device="cpu").programs_enabled
    meshed = tslam.GraphBasedSLAM(cfg, cap, device="cpu", mesh=make_mesh(2, device="cpu"))
    assert not meshed.programs_enabled
    assert not tslam.GraphBasedSLAM(cfg, cap, device="cpu",
                                    cloud_store=object()).programs_enabled
