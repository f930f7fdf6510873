"""PyTorch port vs the JAX reference: the grid nearest-neighbor query and ICP.

Tolerances: `nearest` and `_candidate_scan` — idx, found and the candidate indices exact,
d2 to rtol 1e-6 (both sum three float32 squares; the packed rows are bit-equal). The
grid build exact (keys, order, table, packed bits). ICP from the same grid — transform
to atol 1e-4, iterations, converged and num_inliers exact, fitness to rtol 1e-4; R and t
of one Umeyama step to 1e-5 (a 3x3 SVD may flip signs of U and V between libraries, so
U and V themselves are not compared). Fitness and matched fraction to rtol 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core.config import IcpConfig as JIcpConfig
from lidar_graph_slam_tpu.core.pointcloud import PointCloud
from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops import neighbors as jnb
from lidar_graph_slam_tpu.registration import icp as jicp
from lidar_graph_slam_tpu_torch.core.config import IcpConfig as TIcpConfig
from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
from lidar_graph_slam_tpu_torch.registration import icp as ticp
from lidar_graph_slam_tpu_torch.utils.state import hash_grid_from_numpy
from tests.test_registration import perturbation


@pytest.fixture(scope="module")
def scans():
    """The fixture of `tests/test_registration.py`."""
    rng = np.random.default_rng(7)
    world = make_world(rng, extent=40.0, density=3.0)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [5.0, -3.0, 1.5]
    target = simulate_scan(world, pose, rng, max_range=45.0, max_points=8192, noise=0.01)
    source = simulate_scan(world, pose, rng, max_range=45.0, max_points=8192, noise=0.01)
    return target, source


def _cloud(xyz, capacity):
    c = PointCloud.from_array(xyz, capacity=capacity)
    return np.array(c.points), np.array(c.mask)


def _grids(points, mask, cell):
    jg = jnb.build_hash_grid(jnp.asarray(points), jnp.asarray(mask), cell)
    tg = tnb.build_hash_grid(torch.as_tensor(points), torch.as_tensor(mask), cell)
    return jg, tg


def _grid_arrays(g) -> dict:
    return {f.name: np.array(getattr(g, f.name)) for f in dataclasses.fields(g)}


def _moved(points, mask, T):
    moved = points @ T[:3, :3].T + T[:3, 3]
    return np.where(mask[:, None], moved, points).astype(np.float32)


def _queries(target, rng):
    """Target points nudged, points far outside the grid (all-miss rows), points just
    outside its border cells, and padding rows."""
    q = target[:400] + rng.normal(scale=0.3, size=(400, 3)).astype(np.float32)
    far = rng.uniform(500.0, 5000.0, size=(40, 3)).astype(np.float32)
    lo = target.min(axis=0)
    border = lo - rng.uniform(0.5, 6.0, size=(40, 3)).astype(np.float32)
    pad = np.full((20, 3), 1.0e6, np.float32)
    return np.concatenate([q, far, border, pad]).astype(np.float32)


def test_hash_grid_build_matches_reference(scans):
    target, _ = scans
    pts, mask = _cloud(target, 8192)
    jg, tg = _grids(pts, mask, 2.0)
    for name in ("keys", "order", "starts", "table", "num"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tg.packed.numpy().view(np.int32),
                                  np.asarray(jg.packed).view(np.int32))
    # The reference's grid carried across keeps every bit.
    carried = hash_grid_from_numpy(_grid_arrays(jg))
    np.testing.assert_array_equal(carried.packed.numpy().view(np.int32),
                                  tg.packed.numpy().view(np.int32))
    assert carried.order.dtype == torch.int64 and carried.table.dtype == torch.int32


@pytest.mark.parametrize("neighborhood", [7, 27])
@pytest.mark.parametrize("bucket_cap", [16, 32])
def test_nearest_and_candidate_scan_match_reference(scans, neighborhood, bucket_cap):
    target, _ = scans
    pts, mask = _cloud(target, 8192)
    jg, _ = _grids(pts, mask, 2.0)
    tg = hash_grid_from_numpy(_grid_arrays(jg))
    q = _queries(target, np.random.default_rng(neighborhood + bucket_cap))

    jd2, jidx = jnb._candidate_scan(jg, jnp.asarray(q), jnb._offsets_for(neighborhood),
                                    bucket_cap)
    td2, tidx = tnb._candidate_scan(tg, torch.as_tensor(q),
                                    tnb._offsets_for(neighborhood, "cpu"), bucket_cap)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(np.isfinite(td2.numpy()), np.isfinite(np.asarray(jd2)))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-6)

    ji, jdist, jfound = jnb.nearest(jg, jnp.asarray(q), bucket_cap=bucket_cap,
                                    neighborhood=neighborhood)
    ti, tdist, tfound = tnb.nearest(tg, torch.as_tensor(q), bucket_cap=bucket_cap,
                                    neighborhood=neighborhood)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_allclose(tdist.numpy(), np.asarray(jdist), rtol=1e-6)
    # The fixture has all three kinds of rows: found, and all-miss (far and padded).
    found = tfound.numpy()
    assert found[:400].mean() > 0.9 and not found[400:440].any() and not found[-20:].any()
    miss = ~found
    np.testing.assert_array_equal(ti.numpy()[miss], tidx.numpy()[miss, 0])


def test_offsets_and_neighborhood_check():
    np.testing.assert_array_equal(tnb._offsets_for(27, "cpu").numpy(),
                                  np.asarray(jnb._offsets_for(27)))
    np.testing.assert_array_equal(tnb._offsets_for(7, "cpu").numpy(),
                                  np.asarray(jnb._offsets_for(7)))
    with pytest.raises(ValueError):
        tnb._offsets_for(9, "cpu")


def test_umeyama_step_matches_reference(rng):
    src = rng.normal(size=(300, 3)).astype(np.float32) * 5.0
    T = np.array(perturbation(seed=4, rot=0.2, trans=1.0))
    dst = (_moved(src, np.ones(300, bool), T)
           + rng.normal(scale=0.01, size=(300, 3))).astype(np.float32)
    w = (rng.random(300) > 0.2).astype(np.float32)
    jR, jt = jicp._umeyama_step(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    tR, tt = ticp._umeyama_step(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), T[:3, :3], atol=1e-3)


ICP_CASES = {
    # test_icp_recovers_transform
    "recover": dict(seed=5, rot=0.03, trans=0.3, kw=dict(max_correspondence_distance=2.0,
                                                          max_iterations=50)),
    # the loop verifier's settings: 7 cells, bucket 16, PCL's fitness epsilon
    "verifier": dict(seed=5, rot=0.03, trans=0.3, kw=dict(
        max_correspondence_distance=2.0, max_iterations=40, transform_epsilon=1e-7,
        euclidean_fitness_epsilon=1e-6, bucket_cap=16, neighborhood=7)),
    # test_registration_result_fields: max_iterations stop
    "five_iters": dict(seed=None, kw=dict(max_iterations=5)),
    # test_icp_fitness_rejects_garbage: an unrelated target 200 m away
    "garbage": dict(seed=None, shift=200.0, kw=dict(max_correspondence_distance=2.0,
                                                     max_iterations=10)),
}


@pytest.mark.parametrize("case", list(ICP_CASES))
def test_icp_align_matches_reference(scans, case):
    c = ICP_CASES[case]
    target, source = scans
    tpts, tmask = _cloud(target, 8192)
    jg, _ = _grids(tpts, tmask, 2.0)
    tg = hash_grid_from_numpy(_grid_arrays(jg))
    src, smask = _cloud(source + np.float32(c.get("shift", 0.0)), 8192)
    if c["seed"] is not None:
        src = _moved(src, smask, perturbation(seed=c["seed"], rot=c["rot"], trans=c["trans"]))
    j = jicp.icp_align(jg, jnp.asarray(src), jnp.asarray(smask), jnp.eye(4), **c["kw"])
    t = ticp.icp_align(tg, torch.as_tensor(src), torch.as_tensor(smask), torch.eye(4), **c["kw"])
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_allclose(float(t.fitness), float(j.fitness), rtol=1e-4)
    if case == "garbage":
        assert float(t.fitness) > 0.3
    elif case != "five_iters":
        assert bool(t.converged) and float(t.fitness) < 0.3


def _fitness_source(target):
    """The sources of test_fitness_pcl_mode_parity / test_fitness_and_match_fraction."""
    src = np.array(target[:64], dtype=np.float32)
    src[:, 0] += 0.05
    src[:8] = [[999.0 + i, 999.0, 999.0] for i in range(8)]
    return src


@pytest.mark.parametrize("mode", ["pcl", "penalized"])
@pytest.mark.parametrize("source", ["nudged", "all_miss"])
def test_fitness_and_match_fraction_match_reference(scans, mode, source):
    target, _ = scans
    tpts, tmask = _cloud(target, 8192)
    jg, _ = _grids(tpts, tmask, 2.0)
    tg = hash_grid_from_numpy(_grid_arrays(jg))
    src = _fitness_source(target) if source == "nudged" else np.full((16, 3), 5000.0, np.float32)
    spts, smask = _cloud(src, 128 if source == "nudged" else 16)
    T = np.array(perturbation(seed=2, rot=0.01, trans=0.05))
    js, jf = jicp.fitness_and_match_fraction(jg, jnp.asarray(spts), jnp.asarray(smask),
                                             jnp.asarray(T), max_range=2.0, mode=mode)
    ts, tf = ticp.fitness_and_match_fraction(tg, torch.as_tensor(spts), torch.as_tensor(smask),
                                             torch.as_tensor(T), max_range=2.0, mode=mode)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-6)
    tscore = ticp.fitness_score(tg, torch.as_tensor(spts), torch.as_tensor(smask),
                                torch.as_tensor(T), max_range=2.0, mode=mode)
    assert float(tscore) == float(ts)
    if source == "all_miss":
        assert float(tf) == 0.0 and (np.isinf(float(ts)) == (mode == "pcl"))
    with pytest.raises(ValueError):
        ticp.fitness_and_match_fraction(tg, torch.as_tensor(spts), torch.as_tensor(smask),
                                        torch.as_tensor(T), max_range=2.0, mode="other")


def test_icp_matcher_matches_reference(scans):
    target, source = scans
    tpts, tmask = _cloud(target, 8192)
    src, smask = _cloud(source, 8192)
    src = _moved(src, smask, perturbation(seed=9, rot=0.02, trans=0.2))
    jb, ja = jicp.make_icp_matcher(JIcpConfig(max_iterations=30))
    tb, ta = ticp.make_icp_matcher(TIcpConfig(max_iterations=30))
    jg = jb(jnp.asarray(tpts), jnp.asarray(tmask))
    tg = tb(torch.as_tensor(tpts), torch.as_tensor(tmask))
    np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    j = ja(jg, jnp.asarray(src), jnp.asarray(smask), jnp.eye(4))
    t = ta(tg, torch.as_tensor(src), torch.as_tensor(smask), torch.eye(4))
    # The matcher's epsilon stop (1e-7) sits at the float32 noise floor of the step
    # norm, so where it fires is rounding, not convergence: iterations are not compared.
    np.testing.assert_allclose(t.transform.numpy(), np.asarray(j.transform), atol=1e-4)
    assert bool(t.converged) and bool(j.converged)
    assert int(t.num_inliers) == int(j.num_inliers)
