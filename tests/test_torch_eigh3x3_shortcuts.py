"""The exact-result rotations of the 3x3 eigensolve (`csrc/eigh3x3.cuh`) on the CPU.

`shortcut_eigh3x3` (`scripts/torch_eigh3x3_split.py`) is a float32 model of the kernel's
rotation: each rotation's t and c from its route's formula (`zero`, `no_divide`,
`large_tau`, `unit_c`, `general`). It must equal the port's `_eigh3x3` bit for bit,
compared through `view(int32)`, on structured matrices (identity, diagonal, -0 entries,
NaN and inf entries, subnormal and 1e-30 couplings, tau^2 overflow, tau = 0), random SPD
matrices and the FPFH normals' covariances of a synthetic scan. Its route counts match
hand counts. The header's two claims are checked in numpy: sqrt(fl(x^2)) = x over a whole
binade (which covers every significand), and no quotient of floats below 2^64 rounds to
a tau whose square overflows. The port's `_eigh3x3` still matches the JAX `_eigh3x3` on
the finite inputs (w to rtol 1e-5 and atol 1e-5, V to atol 1e-5, as
`tests/test_torch_voxel_finalize.py` holds them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu.ops import voxel as jv
from lidar_graph_slam_tpu_torch.ops import voxel as tv
from tests import torch_eigh3x3_cases as cases

SPLIT = cases.split_module()
STRUCTURED = cases.structured()


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


def _assert_model_bit_equal(A: np.ndarray):
    A = torch.as_tensor(A)
    w, V, routes = SPLIT.shortcut_eigh3x3(A)
    rw, rV = tv._eigh3x3(A)
    np.testing.assert_array_equal(_bits(w), _bits(rw))
    np.testing.assert_array_equal(_bits(V), _bits(rV))
    return routes


@pytest.mark.parametrize("case", sorted(STRUCTURED))
def test_model_bit_equal_on_structured(case):
    routes = _assert_model_bit_equal(STRUCTURED[case])
    assert routes.shape == (6, 3, STRUCTURED[case].shape[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_bit_equal_on_random_spd(seed):
    """Random SPD matrices, scaled over 12 orders of magnitude, and random non-symmetric
    ones (only the upper triangle is read): every route but `no_divide` is taken."""
    S = cases.spd(4096, seed)
    scale = np.float32(10.0) ** np.random.default_rng(seed).uniform(-6, 6, size=(4096, 1, 1))
    A = np.random.default_rng(seed + 10).normal(size=(1024, 3, 3)).astype(np.float32)
    routes = _assert_model_bit_equal(np.concatenate([S, (S * scale).astype(np.float32), A]))
    taken = set(np.unique(routes.numpy()).tolist())
    assert {0, 2, 3, 4} <= taken


def _normals_covariances(seed: int, n: int = 4096):
    """The FPFH normals' covariances of a synthetic scan, as `estimate_normals` hands them
    to the eigensolve on the CPU (the identity for guarded rows)."""
    import chip_smoke
    from lidar_graph_slam_tpu_torch.io.synthetic import make_world, simulate_scan
    from lidar_graph_slam_tpu_torch.ops import neighbors as tnb
    from lidar_graph_slam_tpu_torch.registration import features

    rng = np.random.default_rng(seed)
    world = make_world(rng, extent=30.0, density=5.0)
    scan = simulate_scan(world, np.eye(4, dtype=np.float32), rng, max_points=n)
    p = torch.as_tensor(scan)
    m = torch.ones(p.shape[0], dtype=torch.bool)
    m[::7] = False
    grid = tnb.build_hash_grid(p, m, 1.0)
    with chip_smoke.recording_eigh3x3([]) as seen:
        features.estimate_normals(grid, p, m, k=16)
    assert len(seen) == 1
    return seen[0].numpy()


@pytest.mark.parametrize("seed", [1, 2])
def test_model_bit_equal_on_normals_covariances(seed):
    A = _normals_covariances(seed)
    eye = np.eye(3, dtype=np.float32)
    assert (A == eye).all(axis=(1, 2)).any() and not (A == eye).all(axis=(1, 2)).all()
    routes = _assert_model_bit_equal(A)
    # The guarded (identity) rows take `zero` at every rotation.
    ident = (A == eye).all(axis=(1, 2))
    assert (routes.numpy()[:, :, ident] == 0).all()


@pytest.mark.parametrize("case,row", sorted(cases.HAND_ROUTES))
def test_route_counts_match_hand_counts(case, row):
    _, _, routes = SPLIT.shortcut_eigh3x3(torch.as_tensor(STRUCTURED[case][row:row + 1]))
    assert routes[..., 0].tolist() == cases.HAND_ROUTES[case, row]
    counts = SPLIT.route_counts(routes)
    for s in range(6):
        for r in range(3):
            name = SPLIT.ROUTES[cases.HAND_ROUTES[case, row][s][r]]
            assert counts["lanes"][s][r][name] == 1
            assert counts["warps"][s][r][name] == 1


def test_route_counts_by_warp():
    """A warp counts under its costliest lane's route: 31 identity rows and one tau = 0
    row make one `general` warp at the first rotation; a second, all-identity warp stays
    `zero`."""
    A = np.concatenate([np.broadcast_to(np.eye(3, dtype=np.float32), (31, 3, 3)),
                        STRUCTURED["tau_zero"][:1],
                        np.broadcast_to(np.eye(3, dtype=np.float32), (5, 3, 3))])
    _, _, routes = SPLIT.shortcut_eigh3x3(torch.as_tensor(A))
    counts = SPLIT.route_counts(routes)
    assert counts["lanes"][0][0] == dict(zero=36, no_divide=0, large_tau=0, unit_c=0,
                                         general=1)
    assert counts["warps"][0][0] == dict(zero=1, no_divide=0, large_tau=0, unit_c=0,
                                         general=1)
    assert counts["warps"][0][1]["zero"] == 2


def test_root_of_a_rounded_square_is_exact_over_a_binade():
    """sqrt(fl(x^2)) = x for every float x in [2^13, 2^14): fl(x^2) depends on x's
    significand alone (the exponent only shifts it), so this covers every x whose square
    is normal and finite, the large-tau route's |tau| >= 2^12.5 included. And 1 + fl(x^2)
    rounds to fl(x^2) once fl(x^2) >= 2^25."""
    x = (np.arange(2 ** 23, dtype=np.int32) + np.int32(140 << 23)).view(np.float32)
    assert x[0] == 2.0 ** 13 and x[-1] < 2.0 ** 14
    sq = x * x
    np.testing.assert_array_equal(np.sqrt(sq), x)
    big = sq[sq >= np.float32(2.0 ** 25)]
    assert big.size > 2 ** 21
    np.testing.assert_array_equal(np.float32(1.0) + big, big)


def test_no_quotient_below_two_to_the_64_overflows_when_squared():
    """The divide's lanes have |num| < 2^64 |den|: their tau rounds to at most 2^64 - 2^40
    and tau^2 stays finite. Quotients just below 2^64: the numerator one, two and three
    ulps below den * 2^64, over a million random significands."""
    m = np.random.default_rng(0).uniform(1.0, 2.0, size=2 ** 20).astype(np.float32)
    den = m * np.float32(2.0 ** -30)
    top = den * np.float32(2.0 ** 64)
    with np.errstate(over="ignore"):
        for k in (1, 2, 3):
            num = (top.view(np.int32) - np.int32(k)).view(np.float32)
            assert (num < top).all()
            tau = num / den
            assert (tau <= np.float32(2.0 ** 64 - 2.0 ** 40)).all()
            assert np.isfinite(tau * tau).all()
            # ... while at the limit itself tau = 2^64 and its square overflows.
        assert np.isinf((top / den) * (top / den)).all()


@pytest.mark.parametrize("case", sorted(k for k in STRUCTURED if k not in ("nan", "inf")))
def test_port_matches_jax_on_structured(case):
    """Where subnormals arise only w: XLA's CPU flushes them to zero. On the subnormal
    case the reference then sees a diagonal matrix and skips a rotation the port takes;
    the tau-overflow couplings of ~2^-65 leave entries of ~1e-40 beside a 0. Where two
    eigenvalues are equal (1, 1 or 0, 0 there) their eigenvectors then differ by a
    rotation or come out in the other order."""
    A = STRUCTURED[case]
    jw, jV = (np.asarray(x) for x in jv._eigh3x3(jnp.asarray(A)))
    tw, tV = (x.numpy() for x in tv._eigh3x3(torch.as_tensor(A)))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)
    if case not in ("subnormal", "tau_overflow"):
        np.testing.assert_allclose(tV, jV, atol=1e-5)


def test_port_matches_jax_on_random_and_normals():
    A = np.concatenate([cases.spd(2048, 5), _normals_covariances(3)])
    jw, jV = (np.asarray(x) for x in jv._eigh3x3(jnp.asarray(A)))
    tw, tV = (x.numpy() for x in tv._eigh3x3(torch.as_tensor(A)))
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tV, jV, atol=1e-5)
