"""Inputs for the 3x3 eigensolve's tests (`tests/test_torch_eigh3x3_shortcuts.py` on the
CPU, `tests/test_torch_cuda.py` on the card): structured matrices that reach each route
of `csrc/eigh3x3.cuh`'s rotation (zero, no divide, large tau, unit c, general) and its
IEEE edge cases, and the float32 torch model of the kernel's rotation from
`scripts/torch_eigh3x3_split.py`. Imports no JAX."""

from __future__ import annotations

import importlib.util
import os

import numpy as np

SPLIT_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts", "torch_eigh3x3_split.py")


def split_module():
    """`scripts/torch_eigh3x3_split.py` as a module (`shortcut_eigh3x3`, `route_counts`,
    `ROUTES`)."""
    spec = importlib.util.spec_from_file_location("torch_eigh3x3_split", SPLIT_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sym(d, o):
    """The symmetric matrix with diagonal d = (a00, a11, a22) and off-diagonals o = (a01,
    a02, a12)."""
    m = np.diag(np.asarray(d, np.float32))
    for (i, j), x in zip(((0, 1), (0, 2), (1, 2)), o):
        m[i, j] = m[j, i] = x
    return m


def structured() -> dict:
    """{case: [M, 3, 3] float32}: each a few matrices of one kind."""
    nan, inf, sub = np.float32("nan"), np.float32("inf"), np.float32(1e-40)
    cases = {
        "identity": [np.eye(3)],
        "diagonal": [_sym(d, (0, 0, 0)) for d in ((3, 1, 2), (1, 1, 1), (0, 0, 0),
                                                  (5, 5, 0.5), (-1, 2, -3), (1e-6, 4, 1e-6))],
        "negative_zero": [_sym((1, 2, 3), (-0.0, -0.0, -0.0)), _sym((-0.0, -0.0, -0.0), (0, 0, 0)),
                          _sym((-0.0, 1, -0.0), (-0.0, 0.5, -0.0)),
                          _sym((2, 2, 1), (-0.0, 1, -0.0))],
        "nan": [_sym((nan, 1, 2), (0.5, 0, 0)), _sym((1, 2, 3), (nan, 0, 0)),
                _sym((1, 2, 3), (0, nan, 0.5)), _sym((1, 1, 1), (nan, nan, nan)),
                _sym((nan, nan, nan), (0, 0, 0))],
        "inf": [_sym((inf, 1, 2), (0.5, 0, 0)), _sym((1, 2, 3), (inf, 0, 0)),
                _sym((-inf, 1, 2), (0.5, 0.25, 0)), _sym((inf, inf, 1), (1, 0, 0)),
                _sym((1, 2, 3), (0, -inf, 0.5)), _sym((3e38, -3e38, 1), (2e38, 0, 0))],
        "subnormal": [_sym((1, 2, 3), (sub, 0, 0)), _sym((1, 2, 3), (-sub, sub, -1.4e-45)),
                      _sym((1, 1, 2), (sub, 0, 0)), _sym((0, 0, 0), (sub, sub, sub)),
                      _sym((1e-38, 2e-38, 0), (sub, 0, 0))],
        "tiny": [_sym((1, 2, 3), (1e-30, 0, 0)), _sym((1, 2, 3), (1e-30, -1e-30, 1e-30)),
                 _sym((2, 1, 3), (1e-20, 1e-19, -1e-21)), _sym((1, 1 + 2 ** -23, 1), (1e-30, 0, 0))],
        # |a_qq - a_pp| / |2 a_pq| about 2^64: tau^2 overflows in the plain version.
        "tau_overflow": [_sym((0, 1, 0), (2.0 ** -65, 0, 0)),
                         _sym((0, 1, 0), (2.0 ** -65 * (1 + 2 ** -23), 0, 0)),
                         _sym((0, 1, 0), (2.0 ** -65 * (1 - 2 ** -24), 0, 0)),
                         _sym((0, 1.5, 0), (-(2.0 ** -65) * 1.5, 0, 0)),
                         _sym((0, 1, 0), (2.0 ** -66, 0, 0)), _sym((1e10, -1e10, 0), (1e-10, 0, 0)),
                         _sym((0, -1, 0), (2.0 ** -65 * (1 + 2 ** -22), 0, 0))],
        # Equal diagonal entries with a coupling: tau = 0, the 45-degree rotation.
        "tau_zero": [_sym((2, 2, 1), (1, 0, 0)), _sym((2, 1, 2), (0, 1, 0)),
                     _sym((1, 2, 2), (0, 0, 1)), _sym((1, 1, 1), (1, 1, 1)),
                     _sym((-0.0, 0, 1), (1, 0, 0)), _sym((2, 2, 2), (-1, -1, -1))],
        # One route each at the first rotation (tau 5e4: large tau; 3,000: unit c).
        "routes": [_sym((1, 2, 3), (1e-5, 0, 0)), _sym((1, 2, 3), (1 / 6000, 0, 0)),
                   _sym((1, 2, 3), (-1e-5, 1e-5, 1e-5)), _sym((1, 2, 3), (0.3, 0.2, 0.1))],
    }
    return {k: np.stack(v).astype(np.float32) for k, v in cases.items()}


# Each routes case's route at each rotation of each sweep, counted by hand (0 zero, 1 no
# divide, 2 large tau, 3 unit c, 4 general): with a single coupling a_01 the first rotation
# zeroes it and leaves a_02 = c 0 - s 0 = 0 and a_12 = 0, so every later rotation is `zero`.
HAND_ROUTES = {
    ("identity", 0): [[0, 0, 0]] * 6,
    ("diagonal", 0): [[0, 0, 0]] * 6,
    ("tau_zero", 0): [[4, 0, 0]] + [[0, 0, 0]] * 5,
    ("tiny", 0): [[1, 0, 0]] + [[0, 0, 0]] * 5,
    ("subnormal", 0): [[1, 0, 0]] + [[0, 0, 0]] * 5,
    ("tau_overflow", 0): [[1, 0, 0]] + [[0, 0, 0]] * 5,
    ("routes", 0): [[2, 0, 0]] + [[0, 0, 0]] * 5,
    ("routes", 1): [[3, 0, 0]] + [[0, 0, 0]] * 5,
}


def spd(n: int, seed: int) -> np.ndarray:
    """n random symmetric positive semi-definite matrices A A^T, float32."""
    A = np.random.default_rng(seed).normal(size=(n, 3, 3)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1)).astype(np.float32)
