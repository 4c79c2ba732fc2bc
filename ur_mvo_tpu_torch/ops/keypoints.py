"""Fixed-shape keypoint selection: dense maps -> padded feature bank
(port of ``ur_mvo_tpu.ops.keypoints``).

Threshold, border removal (or semantic-mask filtering), top-K by score and
descriptor sampling, with a static output shape: a ``FeatureBank`` of
``capacity`` padded slots with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ur_mvo_tpu_torch.ops.gridsample import sample_descriptors


class FeatureBank(NamedTuple):
    """Padded per-frame feature state."""

    scores: torch.Tensor  # (K,) f32, 0 for invalid slots
    kpts: torch.Tensor  # (K, 2) f32 pixel (x, y); 0 for invalid slots
    desc: torch.Tensor  # (K, D) f32 L2-normalized; 0 for invalid slots
    valid: torch.Tensor  # (K,) bool

    @property
    def capacity(self) -> int:
        return self.scores.shape[-1]

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1)


def top_k_ordered(flat: torch.Tensor, k: int):
    """The ``k`` largest entries of 1-D ``flat`` ordered by (-score, index).

    ``jax.lax.approx_max_k`` is exact on the CPU and lists ties lowest
    flat index first; ``torch.topk`` leaves the order of ties unspecified.
    A stable descending sort pins it. This matters in bf16, where the
    score map has many exact ties: the order decides which candidates
    make the top ``k`` and in which slot each lands."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def select_keypoints(
    score_map: torch.Tensor,
    desc_map: torch.Tensor,
    capacity: int,
    threshold: float = 0.0005,
    border: int = 4,
    max_keypoints: int = 1000,
    mask: Optional[torch.Tensor] = None,
    cell: int = 8,
    raw_scores: Optional[torch.Tensor] = None,
) -> FeatureBank:
    """Dense maps -> top-K fixed-shape :class:`FeatureBank`.

    ``score_map``: (H, W) post-NMS keypoint scores.
    ``desc_map``: (H//cell, W//cell, D) coarse descriptor map.
    ``mask``: optional (H, W) semantic mask; nonzero keeps a pixel. When
    given, it *replaces* border removal (the reference's behavior).
    ``raw_scores``: optional (H, W) PRE-NMS score map: sub-pixel peak
    refinement by a 1-D quadratic fit per axis over the 3x3 raw-score
    neighbourhood, offsets clamped to +-0.5 px (NMS'd scores cannot serve:
    NMS zeroes exactly the neighbourhoods the fit needs).
    """
    H, W = score_map.shape
    dev = score_map.device
    row = torch.arange(H, device=dev)[:, None]
    col = torch.arange(W, device=dev)[None, :]

    keep = score_map > threshold
    if mask is not None:
        keep = keep & (mask != 0)
    else:
        keep = keep & (row >= border) & (row < H - border) & (col >= border) & (col < W - border)

    zero = torch.zeros((), dtype=score_map.dtype, device=dev)
    flat = torch.where(keep, score_map, zero).reshape(-1)
    k = capacity
    if flat.shape[0] < capacity:
        # degenerate tiny image: pad the candidate pool to capacity
        flat = torch.cat([flat, flat.new_zeros(capacity - flat.shape[0])])
    top_scores, top_idx = top_k_ordered(flat, k)
    yi, xi = top_idx // W, top_idx % W
    ys = yi.to(torch.float32)
    xs = xi.to(torch.float32)
    if raw_scores is not None:
        def at(dy, dx):
            return raw_scores[torch.clamp(yi + dy, 0, H - 1), torch.clamp(xi + dx, 0, W - 1)]

        sc, sl, sr = at(0, 0), at(0, -1), at(0, 1)
        su, sd = at(-1, 0), at(1, 0)
        # local max: denominators positive; guard degenerate plateaus
        dx_off = 0.5 * (sr - sl) / torch.clamp(2.0 * sc - sl - sr, min=1e-8)
        dy_off = 0.5 * (sd - su) / torch.clamp(2.0 * sc - su - sd, min=1e-8)
        xs = xs + torch.clamp(dx_off, -0.5, 0.5)
        ys = ys + torch.clamp(dy_off, -0.5, 0.5)

    valid = top_scores > threshold
    if max_keypoints < capacity:
        valid = valid & (torch.arange(k, device=dev) < max_keypoints)

    kpts = torch.stack([xs, ys], dim=-1)
    desc = sample_descriptors(desc_map, kpts, cell=cell)

    return FeatureBank(
        scores=torch.where(valid, top_scores, zero),
        kpts=torch.where(valid[:, None], kpts, zero),
        desc=torch.where(valid[:, None], desc, zero),
        valid=valid,
    )


def normalize_keypoints_for_matching(kpts: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """SuperGlue keypoint normalization: center + scale by 0.7*max-dim."""
    scale = 0.7 * max(width, height)
    cx = width // 2
    cy = height // 2
    return torch.stack([(kpts[..., 0] - cx) / scale, (kpts[..., 1] - cy) / scale], dim=-1)
