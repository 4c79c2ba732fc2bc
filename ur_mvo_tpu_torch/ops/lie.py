"""SO(3)/SE(3) Lie-group utilities (port of ``ur_mvo_tpu.ops.lie``).

Conventions
-----------
* Rotations are 3x3 matrices ``R`` (world-from-camera for ``T_wc``).
* Quaternions are ``(w, x, y, z)`` (Hamilton, unit norm).
* ``se3`` tangent vectors are ``(omega, upsilon)`` = (rotation, translation),
  shape ``(..., 6)``; ``exp``/``log`` follow the standard closed forms with
  Taylor fallbacks near zero.

All functions broadcast over leading batch dimensions. Products are
multiply-and-sum (:func:`ur_mvo_tpu_torch.ops.linalg.mm`): true float32
whatever the TF32 settings are.
"""

from __future__ import annotations

import torch

from ur_mvo_tpu_torch.ops.linalg import inv3x3, mm

_EPS = 1e-8


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, n) x (..., n) -> (..., m) in true float32."""
    return torch.sum(A * x[..., None, :], dim=-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w`` with shape (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
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
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), Taylor-safe at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * mm(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map, (..., 3, 3) -> (..., 3), through the quaternion
    (accurate uniformly in angle, near 0 and near pi)."""
    q = rotmat_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    vnorm = torch.sqrt(torch.sum(v * v, dim=-1))
    theta = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < 1e-6, 2.0 / torch.clamp(w, min=_EPS), theta / torch.clamp(vnorm, min=_EPS))
    return v * scale[..., None]


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3): exp(w) translation coupling term."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS),
    )
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * mm(W, W)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exponential map: (..., 6) tangent (omega, upsilon) -> (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    return so3_exp(w), mv(_so3_left_jacobian(w), v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Logarithm map: (R, t) -> (..., 6) tangent (omega, upsilon)."""
    w = so3_log(R)
    v = mv(inv3x3(_so3_left_jacobian(w)), t)
    return torch.cat([w, v], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return mm(Ra, Rb), mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -mv(Rt, t)


def se3_apply(R, t, p):
    """Apply transform to points p (..., 3)."""
    return mv(R, p) + t


def se3_matrix(R, t):
    """Pack (R, t) into a 4x4 homogeneous matrix."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    # Four candidate constructions; pick the numerically largest pivot.
    qw = torch.sqrt(torch.clamp(1.0 + m00 + m11 + m22, min=0.0)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 0.5
    cand = torch.stack(
        [
            torch.stack([qw, (m21 - m12) / (4 * qw + _EPS), (m02 - m20) / (4 * qw + _EPS), (m10 - m01) / (4 * qw + _EPS)], -1),
            torch.stack([(m21 - m12) / (4 * qx + _EPS), qx, (m01 + m10) / (4 * qx + _EPS), (m02 + m20) / (4 * qx + _EPS)], -1),
            torch.stack([(m02 - m20) / (4 * qy + _EPS), (m01 + m10) / (4 * qy + _EPS), qy, (m12 + m21) / (4 * qy + _EPS)], -1),
            torch.stack([(m10 - m01) / (4 * qz + _EPS), (m02 + m20) / (4 * qz + _EPS), (m12 + m21) / (4 * qz + _EPS), qz], -1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    pivot = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    q = torch.gather(cand, -2, pivot[..., None, None].expand(pivot.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=_EPS)
    # Canonical sign: w >= 0.
    sign = torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q * sign


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of a rotation matrix (used by the keyframe policy)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
