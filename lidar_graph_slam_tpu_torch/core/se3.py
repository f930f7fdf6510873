"""SO(3)/SE(3) Lie-group algebra on torch tensors.

Port of `lidar_graph_slam_tpu/core/se3.py`: one canonical pose representation (batched
4x4 homogeneous matrices) plus exp/log maps on the se(3) tangent space, used by the
Gauss-Newton registration solvers.

Conventions (unchanged from the reference):
  * Twists are ordered (omega, v): rotation first, translation second.
  * Quaternions are (w, x, y, z).
  * All functions broadcast over leading batch dimensions and take Taylor fallbacks
    around theta=0 instead of data-dependent branches, so none of them syncs the device.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """Numerically-stable A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3."""
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return A, B, C


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation matrix."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(omega)
    W2 = W @ W
    return _eye(3, omega, W.shape) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Stable near theta=0 and theta=pi (uses the diagonal-based extraction at pi).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    # Generic branch: omega = theta/(2 sin theta) * vee(R - R^T)
    sin_theta = torch.sin(theta)
    generic_scale = torch.where(
        theta < 1e-4,
        0.5 + theta * theta / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * torch.clamp(sin_theta, min=_EPS)),
    )
    w_generic = generic_scale[..., None] * vee(R - R.transpose(-1, -2))
    # Near-pi branch: axis from the diagonal of (R + I)/2.
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag + 1.0) * 0.5, min=0.0)
    # Pick the largest-magnitude axis component as the sign anchor.
    k = torch.argmax(axis_sq, dim=-1)
    axis = torch.sqrt(axis_sq)
    # Signs relative to the anchor from off-diagonal sums: axis_i*axis_j = (R_ij+R_ji)/4.
    off = torch.stack(
        [
            (R[..., 2, 1] + R[..., 1, 2]),  # yz
            (R[..., 0, 2] + R[..., 2, 0]),  # xz
            (R[..., 1, 0] + R[..., 0, 1]),  # xy
        ],
        dim=-1,
    ) * 0.25
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    oyz, oxz, oxy = off[..., 0], off[..., 1], off[..., 2]
    cand_x = torch.stack([ax, torch.where(oxy == 0, ay, torch.sign(oxy) * ay),
                          torch.where(oxz == 0, az, torch.sign(oxz) * az)], dim=-1)
    cand_y = torch.stack([torch.where(oxy == 0, ax, torch.sign(oxy) * ax), ay,
                          torch.where(oyz == 0, az, torch.sign(oyz) * az)], dim=-1)
    cand_z = torch.stack([torch.where(oxz == 0, ax, torch.sign(oxz) * ax),
                          torch.where(oyz == 0, ay, torch.sign(oyz) * ay), az], dim=-1)
    cands = torch.stack([cand_x, cand_y, cand_z], dim=-2)  # [..., 3 anchors, 3]
    idx = k[..., None, None].expand(k.shape + (1, 3))
    w_pi = theta[..., None] * torch.gather(cands, -2, idx)[..., 0, :]
    near_pi = (math.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V: integrates translation in se(3) exp."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(omega)
    W2 = W @ W
    return _eye(3, omega, W.shape) + B[..., None, None] * W + C[..., None, None] * W2


def _left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    W = hat(omega)
    W2 = W @ W
    half_theta = 0.5 * theta
    cot_term = torch.where(
        theta_sq < 1e-8,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.clamp(torch.sin(half_theta), min=_EPS))
        / torch.clamp(theta_sq, min=_EPS * _EPS),
    )
    return _eye(3, omega, W.shape) - 0.5 * W + cot_term[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: twist [..., 6] (omega, v) -> homogeneous matrix [..., 4, 4]."""
    omega, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ v[..., None])[..., 0]
    return make_transform(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log: [..., 4, 4] -> twist [..., 6] (omega, v)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    omega = so3_log(R)
    v = (_left_jacobian_inv(omega) @ t[..., None])[..., 0]
    return torch.cat([omega, v], dim=-1)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]. Built by
    concatenation: writing a Python number into a CUDA tensor by index copies it from the
    host and syncs the stream."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def identity(dtype=torch.float32, batch: tuple = (), device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(batch + (4, 4))


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def between(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Relative transform A^{-1} B (gtsam::Pose3::between semantics)."""
    return inverse(A) @ B


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint [..., 6, 6] in (omega, v) ordering."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Z = torch.zeros_like(R)
    top = torch.cat([R, Z], dim=-1)
    bottom = torch.cat([hat(t) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# --- Quaternion / Euler conversions -----------------------------------------------------


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z), branch-free (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate extractions; pick the best-conditioned.
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    q0, q1, q2, q3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    c0 = torch.stack([q0, (m21 - m12) / (4 * q0), (m02 - m20) / (4 * q0), (m10 - m01) / (4 * q0)], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * q1), q1, (m01 + m10) / (4 * q1), (m02 + m20) / (4 * q1)], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * q2), (m01 + m10) / (4 * q2), q2, (m12 + m21) / (4 * q2)], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * q3), (m02 + m20) / (4 * q3), (m12 + m21) / (4 * q3), q3], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # [..., 4, 4]
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    k = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2, k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # Canonicalize sign (w >= 0).
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def pose7_to_matrix(pose7: torch.Tensor) -> torch.Tensor:
    """Compact pose [..., 7] = (tx,ty,tz, qw,qx,qy,qz) -> [..., 4, 4]."""
    return make_transform(quat_to_matrix(pose7[..., 3:]), pose7[..., :3])


def matrix_to_pose7(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], dim=-1)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) via SVD (drift control in long chains)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.ones(R.shape[:-2] + (3,), dtype=R.dtype, device=R.device)
    d[..., 2] = det
    return (u * d[..., None, :]) @ vt
