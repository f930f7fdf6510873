"""PyTorch port vs the JAX reference: NDT's fused DIRECT7 gather + accumulation,
`ops.kernels.ndt_direct7_accumulate`, through its plain version on the CPU (the CUDA
kernel is held against that plain version on a card by `tests/test_torch_cuda.py`).

The reference side is what one iteration of JAX `ndt_align`'s body computes
(`lidar_graph_slam_tpu/registration/ndt.py:81-116`): `lookup_direct7`, the source mask,
e = p - mean, `ndt_accumulate_xla`, and the centre residuals' sums of its fitness. Both
sides get the same seeded numpy points against a map built by the JAX package and carried
across (`utils/state.py:ndt_map_from_numpy`), with points outside the dense table, in
empty cells, in voxels under `min_points`, on cell borders, and masked rows.

Tolerances: hit and centre counts exact; H, g, sum_w and the centre |e|^2 sum to rtol 2e-4
/ atol 2e-3 (float32 sums of ~1e4 terms in different orders, as in
`tests/test_torch_ndt.py`). The plain version equals the composition the NDT body used
before the fused kernel bit for bit.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_graph_slam_tpu.io.synthetic import make_world, simulate_scan
from lidar_graph_slam_tpu.ops import pallas_kernels as jpk
from lidar_graph_slam_tpu.ops import voxel as jv
from lidar_graph_slam_tpu_torch.ops import kernels as tk
from lidar_graph_slam_tpu_torch.ops import voxel as tv
from lidar_graph_slam_tpu_torch.registration.ndt import magnusson_constants
from lidar_graph_slam_tpu_torch.utils.state import ndt_map_from_numpy

RTOL, ATOL = 2e-4, 2e-3
CASES = {"scan": 2048, "borders": 512, "single": 1, "none": 0}


@pytest.fixture(scope="module")
def maps():
    """One scan's 2 m NDT map, built by the JAX package: (JAX map, the port's copy, the
    scan)."""
    rng = np.random.default_rng(11)
    world = make_world(rng, extent=40.0, density=4.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=6000)
    mask = np.ones(scan.shape[0], bool)
    jmap = jv.build_ndt_map(jnp.asarray(scan), jnp.asarray(mask), jnp.float32(2.0),
                            capacity=4096)
    arrays = {f.name: np.asarray(getattr(jmap, f.name)) for f in dataclasses.fields(jmap)}
    return jmap, ndt_map_from_numpy(arrays), scan


def query(case: str, scan: np.ndarray, origin: np.ndarray, leaf: float):
    """Seeded query points and source mask for one case."""
    rng = np.random.default_rng(CASES[case] + 5)
    n = CASES[case]
    if case == "borders":
        # Points exactly on cell borders along x (then y, z): floor() there must agree.
        k = rng.integers(1, 60, size=(n, 1)).astype(np.float32)
        p = scan[rng.integers(0, scan.shape[0], n)].copy()
        axis = np.arange(n) % 3
        p[np.arange(n), axis] = origin[axis] + k[:, 0] * np.float32(leaf)
    else:
        p = scan[rng.integers(0, max(scan.shape[0], 1), n)] + rng.normal(
            scale=0.4, size=(n, 3))
        # Out of the table's range (below the origin, past 512 m), and far out.
        p[: n // 10] = origin - rng.uniform(5.0, 50.0, size=(n // 10, 3))
        p[n // 10: n // 5] = origin + rng.uniform(520.0, 900.0, size=(n // 5 - n // 10, 3))
    mask = rng.random(n) > 0.2
    return p.astype(np.float32), mask


def _reference(jmap, p, mask, d2, ws):
    """One JAX NDT body's sums (`registration/ndt.py:83-116`)."""
    means, icovs, hit = jv.lookup_direct7(jmap, jnp.asarray(p))
    valid = hit & jnp.asarray(mask)[:, None]
    pj = jnp.asarray(p)
    e = pj[:, None, :] - means
    K = p.shape[0] * 7
    H, g, sw, nh = jpk.ndt_accumulate_xla(
        e.reshape(K, 3), icovs.reshape(K, 3, 3),
        jnp.broadcast_to(pj[:, None, :], (p.shape[0], 7, 3)).reshape(K, 3),
        valid.reshape(K), d2, ws)
    d2_center = jnp.sum(e[:, 0, :] ** 2, axis=-1)
    cv = valid[:, 0]
    return [np.asarray(x) for x in (H, g, sw, nh, jnp.sum(jnp.where(cv, d2_center, 0.0)),
                                    jnp.sum(cv))]


def _constants(tmap):
    d1, d2 = magnusson_constants(tmap.leaf, 0.55)
    return d2, -d1 * d2


@pytest.mark.parametrize("case", list(CASES))
def test_plain_direct7_matches_reference(maps, case):
    jmap, tmap, scan = maps
    p, mask = query(case, scan, tmap.origin.numpy(), float(tmap.leaf))
    d2, ws = _constants(tmap)
    H, g, sw, nh, csum, cnt = tk.ndt_direct7_accumulate_plain(
        tmap, torch.as_tensor(p), torch.as_tensor(mask), d2, ws)
    Hj, gj, swj, nhj, csumj, cntj = _reference(jmap, p, mask, float(d2), float(ws))
    assert float(nh) == float(nhj) and float(cnt) == float(cntj)
    np.testing.assert_allclose(H.numpy(), Hj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), gj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(sw), float(swj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(csum), float(csumj), rtol=RTOL, atol=ATOL)
    if case == "scan":  # the case exercises every kind of miss and many hits
        _, _, hit = tv.lookup_direct7(tmap, torch.as_tensor(p))
        assert 1000 < float(nh) < hit.sum() < 7 * CASES[case]
        assert (~tmap.valid[: int(tmap.num_voxels)]).any()  # voxels under min_points


def _parent_body(vmap, p, mask, d2, ws):
    """The NDT body's composition before the fused kernel: gather, then accumulate the
    gathered rows, then the fitness."""
    means, icovs, hit = tv.lookup_direct7(vmap, p)
    valid = hit & mask[:, None]
    e = p[:, None, :] - means
    n = p.shape[0]
    K = n * 7
    p_rep = p[:, None, :].expand(n, 7, 3).reshape(K, 3)
    H, g, sw, nh = tk.ndt_accumulate(
        e.reshape(K, 3), icovs.reshape(K, 3, 3).contiguous(), p_rep.contiguous(),
        valid.reshape(K), d2, ws)
    d2_center = torch.sum(e[:, 0, :] ** 2, dim=-1)
    cv = valid[:, 0]
    fitness = torch.sum(torch.where(cv, d2_center, 0.0)) / torch.clamp(
        torch.sum(cv.to(torch.int32)), min=1)
    return H, g, sw, nh, fitness


@pytest.mark.parametrize("case", list(CASES))
def test_plain_direct7_equals_parent_body_bitwise(maps, case):
    _, tmap, scan = maps
    p, mask = query(case, scan, tmap.origin.numpy(), float(tmap.leaf))
    pt, mt = torch.as_tensor(p), torch.as_tensor(mask)
    d2, ws = _constants(tmap)
    H, g, sw, nh, csum, cnt = tk.ndt_direct7_accumulate_plain(tmap, pt, mt, d2, ws)
    want = _parent_body(tmap, pt, mt, d2, ws)
    for got, ref in zip((H, g, sw, nh, csum / torch.clamp(cnt, min=1.0)), want):
        assert torch.equal(got, ref)


def test_map_inv_leaf_is_float32_reciprocal(maps):
    """`NdtVoxelMap.inv_leaf`, which the fused kernel reads for its voxel arithmetic, is
    the float32 `1.0 / leaf`: on a map carried across, on both maps the port builds, and on
    a copy with a field replaced."""
    _, tmap, scan = maps
    pts = torch.as_tensor(scan)
    coarse, fine = tv.build_ndt_pyramid(pts, torch.ones(pts.shape[0], dtype=torch.bool),
                                        2.0, 2, 4096, 1024)
    for m in (tmap, coarse, fine, dataclasses.replace(tmap, packed=tmap.packed.clone())):
        assert m.inv_leaf.dtype == torch.float32 and m.inv_leaf.shape == ()
        assert torch.equal(m.inv_leaf, 1.0 / m.leaf)
    assert float(coarse.inv_leaf) == 0.25 and float(fine.inv_leaf) == 0.5


def test_direct7_wrapper_takes_plain_version_on_cpu(maps):
    _, tmap, scan = maps
    p, mask = query("scan", scan, tmap.origin.numpy(), float(tmap.leaf))
    pt, mt = torch.as_tensor(p), torch.as_tensor(mask)
    d2, ws = _constants(tmap)
    before, before_thread = tk.ndt_direct7_accumulate.launches, tk.thread_launches()
    out = tk.ndt_direct7_accumulate(tmap, pt, mt, d2, ws)
    assert tk.ndt_direct7_accumulate.launches == before  # no kernel launch for CPU tensors
    assert tk.thread_launches() == before_thread
    for a, b in zip(out, tk.ndt_direct7_accumulate_plain(tmap, pt, mt, d2, ws)):
        assert torch.equal(a, b)
