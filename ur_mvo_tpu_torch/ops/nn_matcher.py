"""Mutual nearest-neighbor descriptor matching (port of
``ur_mvo_tpu.ops.nn_matcher``): one dense (K0, K1) similarity product +
mutual argmax with Lowe ratio test; interface-compatible with
``decode_assignment``'s output."""

from __future__ import annotations

import math

import torch

from ur_mvo_tpu_torch.ops.keypoints import FeatureBank
from ur_mvo_tpu_torch.ops.matching import Matches


def match_nn(
    bank0: FeatureBank,
    bank1: FeatureBank,
    min_similarity: float = 0.2,
    ratio: float = 0.95,
    center: bool = False,
) -> Matches:
    """Mutual-NN matches with a ratio test on distance d = 2(1 - cos).

    ``center``: re-center both banks' descriptors by their joint mean and
    re-normalize before matching (restores contrast in collapsed
    descriptor spaces)."""
    d0, d1 = bank0.desc, bank1.desc
    if center:
        n0 = torch.sum(bank0.valid)
        n1 = torch.sum(bank1.valid)
        mu = (torch.sum(d0 * bank0.valid[:, None], 0) + torch.sum(d1 * bank1.valid[:, None], 0)) / torch.clamp(
            n0 + n1, min=1
        )

        def cz(d, valid):
            c = d - mu
            c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-6)
            return c * valid[:, None]

        d0, d1 = cz(d0, bank0.valid), cz(d1, bank1.valid)
    # float32 product; TF32 stays off (torch's default for matmul), as
    # the JAX package pins Precision.HIGHEST here
    sim = torch.matmul(d0, d1.T)
    sim = torch.where(bank0.valid[:, None] & bank1.valid[None, :], sim, torch.full_like(sim, -math.inf))

    best1 = torch.argmax(sim, dim=1)
    best1_sim = torch.max(sim, dim=1).values
    K0 = sim.shape[0]
    second = torch.max(sim.scatter(1, best1[:, None], -math.inf), dim=1).values
    best0 = torch.argmax(sim, dim=0)

    mutual = best0[best1] == torch.arange(K0, device=sim.device)
    d_best = 2.0 * (1.0 - best1_sim)
    d_second = 2.0 * (1.0 - second)
    ratio_ok = torch.where(torch.isfinite(d_second), d_best < ratio * d_second, True)
    valid = bank0.valid & mutual & torch.isfinite(best1_sim) & (best1_sim >= min_similarity) & ratio_ok
    score = torch.where(valid, torch.clamp((best1_sim + 1.0) * 0.5, 0.0, 1.0), torch.zeros_like(best1_sim))
    return Matches(
        idx1=torch.where(valid, best1, torch.full_like(best1, -1)).to(torch.int32),
        score=score.to(torch.float32),
        valid=valid,
    )
