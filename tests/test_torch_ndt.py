"""PyTorch port vs the JAX reference: the normal-equation accumulation (the plain
version of the CUDA kernel; the kernel itself is tested on a card by
`tests/test_torch_cuda.py`, which imports no JAX) and NDT alignment.

Tolerances: the accumulation to rtol 2e-4 / atol 2e-3 against both `ndt_accumulate_xla`
and the float64 oracle of `tests/test_pallas_kernels.py` (the oracle test's own bound:
float32 sums of ~1e3 terms of magnitude ~1e3), hit counts exact. `ndt_align`: transform to
atol 1e-4, and iterations, converged and num_inliers exact.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from lidar_graph_slam_tpu.core.config import NdtConfig as JNdtConfig
from lidar_graph_slam_tpu.ops import pallas_kernels as jpk
from lidar_graph_slam_tpu.registration import base as jbase
from lidar_graph_slam_tpu.registration import ndt as jndt
from lidar_graph_slam_tpu_torch.core.config import NdtConfig as TNdtConfig
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import voxel as tv
from lidar_graph_slam_tpu_torch.registration import base as tbase
from lidar_graph_slam_tpu_torch.registration import ndt as tndt
from lidar_graph_slam_tpu_torch.utils.state import ndt_map_from_numpy
from tests.test_pallas_kernels import _oracle, make_inputs

RTOL, ATOL = 2e-4, 2e-3


def _torch_inputs(e, icovs, p, hit):
    return [torch.as_tensor(x) for x in (e, icovs, p, hit)]


@pytest.mark.parametrize("K", [512, 7 * 300])
def test_plain_accumulate_matches_xla_and_oracle(rng, K):
    e, icovs, p, hit = make_inputs(rng, K=K)
    d2, w_scale = 0.25, 1.05
    H, g, sw, nh = tk.ndt_accumulate_plain(*_torch_inputs(e, icovs, p, hit), d2, w_scale)
    Hj, gj, swj, nhj = jpk.ndt_accumulate_xla(
        jnp.asarray(e), jnp.asarray(icovs), jnp.asarray(p), jnp.asarray(hit), d2, w_scale)
    Ho, go, swo, nho = _oracle(e, icovs, p, hit, d2, w_scale)
    for want in ((np.asarray(Hj), np.asarray(gj), float(swj)), (Ho, go, swo)):
        np.testing.assert_allclose(H.numpy(), want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), want[1], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(sw), want[2], rtol=1e-4)
    assert float(nh) == nho == float(nhj)


def test_accumulate_wrapper_takes_plain_version_on_cpu(rng):
    e, icovs, p, hit = make_inputs(rng, K=256)
    before = tk.ndt_accumulate.launches
    args = _torch_inputs(e, icovs, p, np.zeros(256, bool))
    H, g, sw, nh = tk.ndt_accumulate(*args, torch.tensor(0.25), torch.tensor(1.0))
    assert tk.ndt_accumulate.launches == before  # no kernel launch for CPU tensors
    assert float(nh) == 0.0 and float(sw) == 0.0
    np.testing.assert_allclose(H.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6)


def test_magnusson_and_step_helpers_match_reference(rng):
    for res, ratio in ((2.0, 0.55), (4.0, 0.55), (1.0, 0.3)):
        jd = jndt.magnusson_constants(jnp.float32(res), ratio)
        td = tndt.magnusson_constants(torch.tensor(res), ratio)
        for a, b in zip(td, jd):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = A @ A.T + np.eye(6, dtype=np.float32)
    g = rng.normal(size=6).astype(np.float32)
    jd = jbase.solve_damped(jnp.asarray(H), jnp.asarray(g), jnp.float32(1e-6))
    td = tbase.solve_damped(torch.as_tensor(H), torch.as_tensor(g), torch.tensor(1e-6))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    for cap in (0.05, 100.0):
        np.testing.assert_allclose(tbase.cap_step(td, cap).numpy(),
                                   np.asarray(jbase.cap_step(jd, cap)), rtol=1e-4, atol=1e-6)


PROBLEMS = {"tiny": (512, 1024), "dense": (2048, 4096)}  # (scan capacity, map capacity)


@pytest.fixture(scope="module")
def problems():
    """`__graft_entry__._tiny_problem` at its default size and at a denser one: (JAX map,
    source cloud, the same map carried into the port, source points, mask)."""
    out = {}
    for name, (cap, map_cap) in PROBLEMS.items():
        vm, sc = __graft_entry__._tiny_problem(capacity=cap, map_capacity=map_cap)
        arrays = {f.name: np.asarray(getattr(vm, f.name)) for f in dataclasses.fields(vm)}
        out[name] = (vm, sc, ndt_map_from_numpy(arrays), np.array(sc.points),
                     np.array(sc.mask))
    return out


def _init(kind):
    if kind == "identity":
        return np.eye(4, dtype=np.float32)
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.4, -0.3, 0.1]
    return T


KWARGS = {"iters8": dict(max_iterations=8), "iters64": dict(max_iterations=64),
          "no_polish": dict(max_iterations=16, polish_iterations=0, step_size=0.4),
          "line_search": dict(max_iterations=32, line_search=True)}
# The tiny problem matches ~14 of its 3584 correspondences: from identity it converges
# the same way in both packages, but from an offset start (and under line search, whose
# argmax over three near-equal scores is a discrete choice) it wanders a flat valley
# where the two packages' rounding drifts apart by ~1e-4..2e-3. Those starts run on the
# dense problem (~3600 inliers), where the packages agree to ~3e-7.
ALIGN_CASES = ([("tiny", "identity", k) for k in ("iters8", "iters64", "no_polish")]
               + [("dense", i, k) for i in ("identity", "offset") for k in KWARGS])


@pytest.mark.parametrize("problem,init,kw", ALIGN_CASES,
                         ids=["-".join(c) for c in ALIGN_CASES])
def test_ndt_align_matches_reference(problems, problem, init, kw):
    vm, sc, tmap, pts, mask = problems[problem]
    T0 = _init(init)
    kw = KWARGS[kw]
    j = jndt.ndt_align(vm, sc.points, sc.mask, jnp.asarray(T0), **kw)
    t = tndt.ndt_align(tmap, torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(T0), **kw)
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-4, atol=1e-6)


def test_ndt_matcher_pyramid_matches_reference(problems):
    """make_ndt_matcher: the fused-pyramid build from the same points, then the
    coarse-to-fine align."""
    _, _, _, pts, mask = problems["dense"]
    jb, ja = jndt.make_ndt_matcher(JNdtConfig(), map_capacity=4096)
    tb, ta = tndt.make_ndt_matcher(TNdtConfig(), map_capacity=4096)
    jt = jb(jnp.asarray(pts), jnp.asarray(mask))
    tt = tb(torch.as_tensor(pts), torch.as_tensor(mask))
    for jm, tm in zip(jt, tt):
        np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    T0 = _init("offset")
    j = ja(jt, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(T0))
    t = ta(tt, torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(T0))
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)
    assert isinstance(tt[0], tv.NdtVoxelMap)
