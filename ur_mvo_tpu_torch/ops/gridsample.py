"""Bilinear grid sampling on the device (port of ``ur_mvo_tpu.ops.gridsample``).

Conventions match ``torch.nn.functional.grid_sample(...,
align_corners=True)`` with border clipping, which is what the reference's
hand-rolled ``grid_sample`` implements.
"""

from __future__ import annotations

import torch


def grid_sample_nearest_corners(feature_map: torch.Tensor, grid_xy: torch.Tensor) -> torch.Tensor:
    """Sample ``feature_map`` (H, W, C) at normalized coords ``grid_xy``
    (N, 2) in [-1, 1] (x, y), align_corners=True, border-clipped.

    Returns (N, C).
    """
    H, W = feature_map.shape[0], feature_map.shape[1]
    ix = (grid_xy[:, 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid_xy[:, 1] + 1.0) * 0.5 * (H - 1)

    ix_nw = torch.clamp(torch.floor(ix).to(torch.int64), 0, W - 1)
    iy_nw = torch.clamp(torch.floor(iy).to(torch.int64), 0, H - 1)
    ix_se = torch.clamp(ix_nw + 1, 0, W - 1)
    iy_se = torch.clamp(iy_nw + 1, 0, H - 1)

    # Interpolation weights against the *clipped* corner indices
    # (reference/torch border behavior).
    fx_se, fy_se = ix_se.to(ix.dtype), iy_se.to(iy.dtype)
    fx_nw, fy_nw = ix_nw.to(ix.dtype), iy_nw.to(iy.dtype)
    nw = (fx_se - ix) * (fy_se - iy)
    ne = (ix - fx_nw) * (fy_se - iy)
    sw = (fx_se - ix) * (iy - fy_nw)
    se = (ix - fx_nw) * (iy - fy_nw)

    v_nw = feature_map[iy_nw, ix_nw]
    v_ne = feature_map[iy_nw, ix_se]
    v_sw = feature_map[iy_se, ix_nw]
    v_se = feature_map[iy_se, ix_se]
    return v_nw * nw[:, None] + v_ne * ne[:, None] + v_sw * sw[:, None] + v_se * se[:, None]


def patch_descriptors(img: torch.Tensor, kpts_xy: torch.Tensor, patch: int = 16, stride: float = 1.0) -> torch.Tensor:
    """Normalized intensity-patch descriptors sampled on the device.

    ``img``: (H, W) grayscale in [0, 1]; ``kpts_xy``: (K, 2) pixel
    coordinates. Bilinearly samples a ``patch`` x ``patch`` window (spacing
    ``stride`` px) centred on each keypoint and returns zero-mean,
    L2-normalized flattened patches, (K, patch**2): 256-d at the default
    size, a drop-in for SuperPoint's descriptors
    (``superpoint.descriptor_source: patch``, a weights-free source)."""
    H, W = img.shape
    K = kpts_xy.shape[0]
    half = (patch - 1) / 2.0
    offs = (torch.arange(patch, dtype=torch.float32, device=img.device) - half) * stride
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    # (K, patch*patch) absolute sample coordinates
    sx = kpts_xy[:, 0:1] + ox.reshape(1, -1)
    sy = kpts_xy[:, 1:2] + oy.reshape(1, -1)
    gx = sx / (W - 1) * 2.0 - 1.0
    gy = sy / (H - 1) * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(K * patch * patch, 2)
    vals = grid_sample_nearest_corners(img[:, :, None], grid).reshape(K, patch * patch)
    vals = vals - torch.mean(vals, dim=1, keepdim=True)
    norm = torch.clamp(torch.linalg.vector_norm(vals, dim=1, keepdim=True), min=1e-6)
    return vals / norm


def sample_descriptors(desc_map: torch.Tensor, kpts_xy: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """Sample L2-normalized descriptors at keypoint pixel locations.

    ``desc_map``: (Hc, Wc, D) coarse descriptor map (stride ``cell``).
    ``kpts_xy``: (N, 2) keypoint pixel coordinates (x, y) in the full image.
    SuperPoint's cell-center normalization, bilinear sampling, then L2
    normalization.
    """
    Hc, Wc = desc_map.shape[0], desc_map.shape[1]
    s = float(cell)
    gx = (kpts_xy[:, 0] - s / 2 + 0.5) / (Wc * s - s / 2 - 0.5) * 2.0 - 1.0
    gy = (kpts_xy[:, 1] - s / 2 + 0.5) / (Hc * s - s / 2 - 0.5) * 2.0 - 1.0
    desc = grid_sample_nearest_corners(desc_map, torch.stack([gx, gy], dim=-1))
    norm = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    return desc / norm
