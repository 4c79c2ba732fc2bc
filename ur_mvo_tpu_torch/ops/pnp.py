"""Batched PnP-RANSAC: world points + pixels -> camera pose prior (port of
``ur_mvo_tpu.ops.pnp``).

All hypotheses are one batch: minimal sets are 6-point DLT solves with the
rotation projected by the analytic polar decomposition, scored by pixel
reprojection over all correspondences (100 iterations, 20 px, the
reference's ``solvePnPRansac`` operating point). The refined estimate
comes from the pose-only robust optimizer (``ops/pose_opt.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ur_mvo_tpu_torch.ops.linalg import assert_true_float32_matmul, det3, inv3x3, nearest_rotation, smallest_singular_vector
from ur_mvo_tpu_torch.ops.ransac import sample_minimal_sets


def dlt_pnp(X: torch.Tensor, rays: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct linear transform PnP on >= 6 correspondences.

    ``X``: (..., n, 3) world points; ``rays``: (..., n, 2) *normalized*
    image coordinates (K^-1 applied). Returns (R_cw, t_cw) with
    ``x_cam = R_cw X + t_cw``, orthogonality enforced by the polar
    projection and the sign fixed by det > 0.
    """
    ones = torch.ones_like(X[..., :1])
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], dim=-1)
    u = rays[..., 0:1]
    v = rays[..., 1:2]
    rows_u = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 2n, 12)
    P = smallest_singular_vector(A).reshape(A.shape[:-2] + (3, 4))
    # The null vector carries an arbitrary global sign; a valid pose needs
    # det(M) > 0 (M = s * R with s > 0), so resolve it first.
    P = P * torch.where(det3(P[..., :, :3]) < 0, -1.0, 1.0)[..., None, None]
    R, scale = nearest_rotation(P[..., :, :3])
    t = P[..., :, 3] / torch.clamp(scale, min=1e-12)[..., None]
    return R, t


class PnPResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def ransac_pnp(
    generator: Optional[torch.Generator],
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    iterations: int = 100,
    threshold_px: float = 20.0,
    sets: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Batched PnP RANSAC over padded correspondence arrays.

    ``X``: (N, 3) world points, ``uv``: (N, 2) pixels, ``valid``: (N,).
    ``sets`` (iterations, 6) overrides the sampler (the parity tests feed
    both packages the same minimal sets); otherwise they are drawn from
    ``generator``."""
    assert_true_float32_matmul()
    Kinv = inv3x3(K)
    uvh = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    rays = torch.sum(Kinv[None, :, :] * uvh[:, None, :], dim=-1)[:, :2]

    if sets is None:
        sets = sample_minimal_sets(generator, valid, iterations, 6)
    Rs, ts = dlt_pnp(X[sets], rays[sets])

    # Score every hypothesis against every point: camera-frame points from
    # ONE flat (3H, 3) x (3, N) product, then (H, N) elementwise.
    H = sets.shape[0]
    pc = torch.matmul(Rs.reshape(3 * H, 3), X.T).reshape(H, 3, -1) + ts[:, :, None]
    uvp = [K[a, 0] * pc[:, 0] + K[a, 1] * pc[:, 1] + K[a, 2] * pc[:, 2] for a in range(3)]
    w = torch.clamp(uvp[2], min=1e-9)
    du = uvp[0] / w - uv[:, 0]
    dv = uvp[1] / w - uv[:, 1]
    err2 = du * du + dv * dv  # (H, N)
    inls = valid & (err2 < threshold_px * threshold_px) & (pc[:, 2] > 0)
    counts = torch.sum(inls.to(torch.int32), dim=-1)
    best = torch.argmax(counts)
    return PnPResult(R_cw=Rs[best], t_cw=ts[best], inliers=inls[best], n_inliers=counts[best])
