"""Match decoding + mutual-consistency filtering on the device (port of
``ur_mvo_tpu.ops.matching``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Matches(NamedTuple):
    """Padded match table between two feature banks.

    ``idx1``: (K0,) int32 — for each slot of bank0 the matched slot in
    bank1, or -1. ``score``: (K0,) f32 — assignment confidence
    ``exp(Z[i,j])``. ``valid``: (K0,) bool.
    """

    idx1: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def _second_max(S: torch.Tensor, best: torch.Tensor, dim: int) -> torch.Tensor:
    """Max along ``dim`` with the argmax entry knocked out."""
    knocked = S.scatter(dim, best.unsqueeze(dim), -math.inf)
    return torch.max(knocked, dim=dim).values


def decode_assignment(
    Z: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    threshold: float = 0.5,
    margin: float = 0.0,
) -> Matches:
    """(K0+1, K1+1) log-assignment matrix -> mutual-max matches.

    Argmax over the non-dustbin block both ways, mutual check, probability
    threshold; ``margin`` > 0 adds the ambiguity gate (best log-score must
    beat the runner-up in both its row and its column by ``margin``).
    """
    K0 = valid0.shape[0]
    K1 = valid1.shape[0]
    S = Z[:K0, :K1]
    S = torch.where(valid0[:, None] & valid1[None, :], S, torch.full_like(S, -math.inf))

    best1 = torch.argmax(S, dim=1)  # (K0,)
    best0 = torch.argmax(S, dim=0)  # (K1,)
    row_max = torch.max(S, dim=1).values

    slot_ids = torch.arange(K0, device=Z.device)
    mutual = best0[best1] == slot_ids
    zero = torch.zeros((), dtype=torch.float32, device=Z.device)
    score = torch.where(mutual, torch.exp(row_max), zero)
    valid = mutual & (score > threshold) & valid0 & (row_max > -math.inf)
    if margin > 0.0:
        second_row = _second_max(S, best1, 1)
        second_col = _second_max(S, best0, 0)
        col_max = torch.max(S, dim=0).values
        row_ok = torch.where(torch.isfinite(second_row), row_max - second_row >= margin, True)
        col_peaked = torch.where(torch.isfinite(second_col), col_max - second_col >= margin, True)
        valid = valid & row_ok & col_peaked[best1]
        score = torch.where(valid, score, zero)
    minus1 = torch.full_like(best1, -1)
    return Matches(
        idx1=torch.where(valid, best1, minus1).to(torch.int32),
        score=score.to(torch.float32),
        valid=valid,
    )


def gather_match_points(matches: Matches, kpts0: torch.Tensor, kpts1: torch.Tensor):
    """Matched coordinate pairs as padded arrays: (K0, 2), (K0, 2), mask."""
    idx = torch.clamp(matches.idx1, min=0).to(torch.int64)
    return kpts0, kpts1[idx], matches.valid


def filter_matches(matches: Matches, keep: torch.Tensor) -> Matches:
    """Apply an additional per-slot inlier mask (e.g. RANSAC verdicts)."""
    valid = matches.valid & keep
    return Matches(
        idx1=torch.where(valid, matches.idx1, torch.full_like(matches.idx1, -1)),
        score=torch.where(valid, matches.score, torch.zeros_like(matches.score)),
        valid=valid,
    )


def select_matches(cond: torch.Tensor, a: Matches, b: Matches) -> Matches:
    """``a`` where the scalar bool tensor ``cond`` holds, else ``b`` (on
    the device, without a host sync)."""
    return Matches(
        idx1=torch.where(cond, a.idx1, b.idx1),
        score=torch.where(cond, a.score, b.score),
        valid=torch.where(cond, a.valid, b.valid),
    )
