"""Triangulation: two-view DLT and N-view bearing least squares (port of
``ur_mvo_tpu.ops.triangulation``). Batched and mask-aware; the batch is a
leading dimension written out where the JAX package uses ``vmap``.
"""

from __future__ import annotations

import torch

from ur_mvo_tpu_torch.ops.linalg import eigh3x3, inv3x3, smallest_singular_vector


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Two-view DLT: projection matrices (3, 4) + pixel observations
    (..., 2) -> points (..., 3) (frame of P1/P2's world).

    ``P1`` / ``P2`` may carry leading hypothesis dims (L..., 3, 4) with
    ``x1`` / ``x2`` (N, 2): every hypothesis triangulates every match,
    points (L..., N, 3)."""
    a1 = x1.reshape(-1, x1.shape[-1])[..., :2]
    a2 = x2.reshape(-1, x2.shape[-1])[..., :2]

    def rows(a, P):
        Pn = P[..., None, :, :]  # (L..., 1, 3, 4)
        return a[:, 0:1] * Pn[..., 2, :] - Pn[..., 0, :], a[:, 1:2] * Pn[..., 2, :] - Pn[..., 1, :]

    lead = torch.broadcast_shapes(P1.shape[:-2], P2.shape[:-2])
    n = a1.shape[0]
    A = torch.stack([r.expand(lead + (n, 4)) for r in rows(a1, P1) + rows(a2, P2)], dim=-2)  # (L..., n, 4, 4)
    X = smallest_singular_vector(A)
    w = X[..., 3]
    safe = torch.where(torch.abs(w) > 1e-12, w, torch.sign(w) * 1e-12 + (w == 0).to(w.dtype) * 1e-12)
    pts = X[..., :3] / safe[..., None]
    return pts.reshape(lead + x1.shape[:-1] + (3,))


def triangulate_bearings(
    origins: torch.Tensor,
    bearings: torch.Tensor,
    valid: torch.Tensor,
    rank_tol: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """N-view midpoint triangulation: the world point minimizing the
    squared distance to all observation rays.

    ``origins``: (..., N, 3) camera centers (world), ``bearings``:
    (..., N, 3) world-frame ray directions, ``valid``: (..., N) mask.
    Returns ``(point (..., 3), ok (...,))``; ``ok`` is False with fewer
    than 2 valid rays or a rank-deficient normal matrix (parallel rays).
    """
    w = valid.to(origins.dtype)
    n = torch.sum(w, dim=-1)
    b2 = torch.sum(bearings * bearings, dim=-1)
    inv_b2 = torch.where(b2 > 1e-12, 1.0 / torch.clamp(b2, min=1e-12), torch.zeros_like(b2)) * w
    # A = sum_i (I - b b^T / |b|^2),  rhs = sum_i (I - b b^T / |b|^2) o_i
    bbT = bearings[..., :, None] * bearings[..., None, :] * inv_b2[..., None, None]
    eye = torch.eye(3, dtype=origins.dtype, device=origins.device)
    A = n[..., None, None] * eye - torch.sum(bbT, dim=-3)
    rhs = torch.sum(origins * w[..., None], dim=-2) - torch.sum(
        torch.sum(bbT * origins[..., None, :], dim=-1), dim=-2
    )
    evals, _ = eigh3x3(A)
    ok = (n >= 2) & (evals[..., 0] > rank_tol)
    A_safe = torch.where(ok[..., None, None], A, eye.expand(A.shape))
    point = torch.sum(inv3x3(A_safe) * rhs[..., None, :], dim=-1)
    return torch.where(ok[..., None], point, torch.zeros_like(point)), ok
