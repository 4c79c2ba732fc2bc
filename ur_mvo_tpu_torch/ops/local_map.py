"""Projection-guided local-map association (port of
``ur_mvo_tpu.ops.local_map``).

With up to ``capacity`` padded map points and feature slots, the (M, K)
candidate relation is a dense masked similarity problem: projection,
radius mask, descriptor scores, row-argmax with the ratio test, and a
mutual-best check, all on the device without a host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.linalg import assert_true_float32_matmul


class LocalMapMatches(NamedTuple):
    """Per-map-point association to a feature slot of the current frame."""

    feat_idx: torch.Tensor  # (M,) int32 slot in the bank, -1 when none
    similarity: torch.Tensor  # (M,) descriptor dot product
    valid: torch.Tensor  # (M,)


def project_points(R_cw, t_cw, X, fx, fy, cx, cy):
    """(M, 3) world points -> (uv (M, 2), depth (M,)) through T_cw, the
    rotation as an elementwise multiply-and-sum (true float32)."""
    pc = torch.sum(R_cw[None, :, :] * X[:, None, :], dim=-1) + t_cw
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    return torch.stack([u, v], -1), pc[:, 2]


def search_by_projection(
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    mp_pos: torch.Tensor,  # (M, 3) world positions
    mp_desc: torch.Tensor,  # (M, D) unit descriptors
    mp_valid: torch.Tensor,  # (M,)
    bank: FeatureBank,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    radius_px: float = 15.0,
    min_similarity: float = 0.5,
    ratio: float = 0.9,
) -> LocalMapMatches:
    """Associate map points with current-frame features by projection:
    the best descriptor candidate within the pixel radius, required to beat
    the second best by the ratio test on d = 2(1 - cos), then mutual-best
    per feature slot. Ties keep the first index, as ``jnp.argmax`` does."""
    uv, depth = project_points(R_cw, t_cw, mp_pos, fx, fy, cx, cy)
    in_img = (depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] <= width - 1) & (uv[:, 1] >= 0) & (uv[:, 1] <= height - 1)
    mp_ok = mp_valid & in_img

    # (M, K) pixel distances + radius mask
    d2 = torch.sum((uv[:, None, :] - bank.kpts[None, :, :]) ** 2, dim=-1)
    cand = mp_ok[:, None] & bank.valid[None, :] & (d2 <= radius_px * radius_px)

    # (M, K) descriptor similarity: a float32 product (the JAX package pins
    # Precision.HIGHEST here), so TF32 must be off
    assert_true_float32_matmul()
    sim = torch.matmul(mp_desc.to(torch.float32), bank.desc.to(torch.float32).T)
    neg_inf = torch.full_like(sim, -math.inf)
    sim = torch.where(cand, sim, neg_inf)

    best = torch.argmax(sim, dim=1)
    best_sim = torch.max(sim, dim=1).values
    # second best for the ratio test
    second_sim = torch.max(sim.scatter(1, best[:, None], -math.inf), dim=1).values
    d_best = 2.0 * (1.0 - best_sim)
    d_second = 2.0 * (1.0 - second_sim)
    ratio_ok = torch.where(torch.isfinite(d_second), d_best < ratio * d_second, torch.ones_like(mp_ok))

    valid = mp_ok & torch.isfinite(best_sim) & (best_sim >= min_similarity) & ratio_ok

    # mutual-best: each feature slot keeps only its highest-similarity point
    K = bank.valid.shape[0]
    slot_best_sim = torch.full((K,), -math.inf, dtype=sim.dtype, device=sim.device).scatter_reduce(
        0, best, torch.where(valid, best_sim, torch.full_like(best_sim, -math.inf)), reduce="amax"
    )
    mutual = valid & (best_sim >= slot_best_sim[best])

    return LocalMapMatches(
        feat_idx=torch.where(mutual, best, torch.full_like(best, -1)).to(torch.int32),
        similarity=torch.where(mutual, best_sim, torch.zeros_like(best_sim)),
        valid=mutual,
    )
