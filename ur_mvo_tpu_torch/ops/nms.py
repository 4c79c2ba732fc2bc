"""Non-maximum suppression via the max-pool trick (port of
``ur_mvo_tpu.ops.nms``).

SuperPoint's ``simple_nms``: iterative suppression with a (2r+1)-square
max filter, two refinement rounds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _maxpool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Square max filter with 'same' padding over the last two dims."""
    k = 2 * radius + 1
    return F.max_pool2d(x[None], k, stride=1, padding=radius)[0]


def simple_nms(scores: torch.Tensor, radius: int = 4, iterations: int = 2) -> torch.Tensor:
    """Suppress non-maxima of ``scores`` (..., H, W); keeps local maxima
    only. Leading dims are batched (the max filter runs over the last two)."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, radius)
    for _ in range(iterations):
        supp_mask = _maxpool_same(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_same(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)
