"""PyTorch port vs the JAX reference: the sorted hash grid, the sliding-window kNN
distances, statistical outlier removal (SOR) and the whole prefilter.

Tolerances: grid keys, order, starts, table and neighbor counts are EXACT; the window
mean distances to atol 1e-6 (sums of k square roots added in another order); every mask
is EXACT. SOR thresholds a float32 mean/std computed by two different reductions, so a
point whose mean distance sits within an ulp of the threshold could flip: the tests
count flipped points and, where the fixtures have any, name them — these fixtures have
none.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.core.config import PrefilterConfig as JPrefilterConfig
from lidar_graph_slam_tpu.filters import prefilter as jpf
from lidar_graph_slam_tpu.io.synthetic import SyntheticSequence
from lidar_graph_slam_tpu.ops import neighbors as jn
from lidar_graph_slam_tpu_torch.core.config import PrefilterConfig as TPrefilterConfig
from lidar_graph_slam_tpu_torch.filters import prefilter as tpf
from lidar_graph_slam_tpu_torch.ops import neighbors as tn

PAD = 1.0e6


def _scan(seed, capacity=8192, max_points=6000):
    seq = SyntheticSequence(n_frames=1, seed=seed, max_points=max_points)
    scan = next(iter(seq))[0]
    pts = np.full((capacity, 3), PAD, np.float32)
    pts[: len(scan)] = scan
    mask = np.zeros(capacity, bool)
    mask[: len(scan)] = True
    return pts, mask


def _assert_masks_equal(got, want, pts):
    flipped = np.flatnonzero(got != want)
    assert flipped.size == 0, (
        f"{flipped.size} flipped points: rows {flipped[:10].tolist()} at {pts[flipped[:10]].tolist()}")


@pytest.mark.parametrize("seed,cell", [(0, 1.0), (1, 3.0)])
def test_build_hash_grid_matches_reference(seed, cell):
    pts, mask = _scan(seed)
    j = jn.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), cell)
    t = tn.build_hash_grid(torch.as_tensor(pts), torch.as_tensor(mask), cell)
    for field in ("keys", "points", "packed", "order", "starts", "origin", "num", "table"):
        np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)


@pytest.mark.parametrize("k,window", [(30, 24), (10, 8)])
def test_window_mean_knn_distance_matches_reference(k, window):
    pts, mask = _scan(2)
    j = jn.build_hash_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0)
    t = tn.build_hash_grid(torch.as_tensor(pts), torch.as_tensor(mask), 1.0)
    np.testing.assert_array_equal(tn.window_neighbor_d2(t, window).numpy(),
                                  np.asarray(jn.window_neighbor_d2(j, window)))
    jd, jc = jn.window_mean_knn_distance(j, k, window)
    td, tc = tn.window_mean_knn_distance(t, k, window)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_statistical_outlier_mask_matches_reference(seed):
    pts, mask = _scan(seed)
    j = jpf.statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(mask), 10, jnp.float32(1.2),
                                     cell_size=3.0)
    t = tpf.statistical_outlier_mask(torch.as_tensor(pts), torch.as_tensor(mask), 10,
                                     torch.tensor(1.2), cell_size=3.0)
    _assert_masks_equal(t.numpy(), np.asarray(j), pts)
    assert 0 < int(t.sum()) < int(mask.sum())


CONFIGS = {
    "small": dict(leaf_size=0.3, mean_k=10),
    "crop_maxdist": dict(leaf_size=0.3, mean_k=10, use_crop=True, min_xyz=(-20.0, -30.0, -1.0),
                         max_xyz=(25.0, 30.0, 3.0), max_distance=28.0),
    "no_sor": dict(leaf_size=0.2, use_outlier_filter=False),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_make_prefilter_matches_reference(name):
    pts, mask = _scan(5)
    kw = CONFIGS[name]
    j = jpf.make_prefilter(JPrefilterConfig(**kw), 4096, 8192)(jnp.asarray(pts), jnp.asarray(mask))
    t = tpf.make_prefilter(TPrefilterConfig(**kw), 4096, 8192)(torch.as_tensor(pts),
                                                              torch.as_tensor(mask))
    _assert_masks_equal(t.mask.numpy(), np.asarray(j.mask), np.asarray(j.points))
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), atol=1e-5, rtol=0)


def test_random_sample_mask_keeps_num_valid_points():
    """The dormant random-sample mode: the generator's numbers differ from threefry's, so
    the port is held to the mode's contract (exactly `num` of the valid rows, invalid
    rows never chosen, the same pick for the same seed), not to the reference's rows."""
    pts, mask = _scan(6)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    picks = [tpf.random_sample_mask(tp, tm, 1000, torch.Generator().manual_seed(0))
             for _ in range(2)]
    assert int(picks[0].sum()) == 1000
    assert not bool((picks[0] & ~tm).any())
    assert torch.equal(picks[0], picks[1])
    cfg = TPrefilterConfig(leaf_size=0.3, mean_k=10, use_random_sampling=True,
                           random_sample_num=500)
    out = tpf.make_prefilter(cfg, 4096, 8192)(tp, tm)
    assert int(out.mask.sum()) == 500
