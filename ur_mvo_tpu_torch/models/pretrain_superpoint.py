"""SuperPoint pretraining from scratch on synthetic geometry, port of
``ur_mvo_tpu.models.pretrain_superpoint``.

MagicLeap-style synthetic-shapes pretraining: random polygons, lines and
rectangles rendered with exact corner ground truth, a 65-way per-cell
detector cross-entropy (64 positions + dustbin), combined with the dense
descriptor loss on homography-warped pairs (``train_superpoint``), so that
usable detector + descriptor weights come from this repo alone.

Rendering is numpy on the host, copied from the JAX package so that the
same ``np.random.Generator`` gives the same images and labels; the losses
and the step run on the device. On the card every backbone call launches
the stage kernel once a stage (``ops/cuda_conv.stage_conv_op``), three
backbone calls a step (the detector batch, ``orig`` and ``warped``); their
gradient is the plain version's, recomputed (the JAX package's VJP).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ur_mvo_tpu_torch.device import DeviceLike, resolve_device
from ur_mvo_tpu_torch.models.superpoint import SuperPoint
from ur_mvo_tpu_torch.models.train_superpoint import (
    descriptor_loss,
    descriptor_loss_nce,
    head_mask,
    make_batch as make_desc_batch,
    masked_adam,
)

GRID = 8


# ---------------------------------------------------------------------------
# Synthetic-shapes rendering (host-side numpy, as the JAX package's)
# ---------------------------------------------------------------------------

def _draw_line(img, pts, x0, y0, x1, y1, value):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, 2 * n)
    ys = np.linspace(y0, y1, 2 * n)
    H, W = img.shape
    xi = np.clip(xs.round().astype(int), 0, W - 1)
    yi = np.clip(ys.round().astype(int), 0, H - 1)
    img[yi, xi] = value
    pts.append((x0, y0))
    pts.append((x1, y1))


def render_shapes(rng: np.random.Generator, H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic image + (N, 2) ground-truth corner points (x, y)."""
    img = np.full((H, W), rng.uniform(0.1, 0.5), np.float32)
    # mild background gradient
    img += np.linspace(0, rng.uniform(-0.15, 0.15), W)[None, :]
    corners = []

    for _ in range(rng.integers(2, 5)):
        kind = rng.integers(0, 3)
        value = rng.uniform(0.0, 1.0)
        if kind == 0:  # polygon (triangle/quad)
            k = rng.integers(3, 5)
            cx, cy = rng.uniform(0.15, 0.85) * W, rng.uniform(0.15, 0.85) * H
            radius = rng.uniform(0.08, 0.25) * min(H, W)
            angles = np.sort(rng.uniform(0, 2 * np.pi, k))
            xs = cx + radius * np.cos(angles)
            ys = cy + radius * np.sin(angles)
            for i in range(k):
                _draw_line(img, corners, xs[i], ys[i], xs[(i + 1) % k], ys[(i + 1) % k], value)
        elif kind == 1:  # line segment
            x0, y0 = rng.uniform(0.1, 0.9) * W, rng.uniform(0.1, 0.9) * H
            x1, y1 = rng.uniform(0.1, 0.9) * W, rng.uniform(0.1, 0.9) * H
            _draw_line(img, corners, x0, y0, x1, y1, value)
        else:  # filled rectangle (4 corners)
            x0, y0 = rng.uniform(0.1, 0.7) * W, rng.uniform(0.1, 0.7) * H
            w = rng.uniform(0.1, 0.25) * W
            h = rng.uniform(0.1, 0.25) * H
            xi0, yi0 = int(x0), int(y0)
            xi1, yi1 = min(int(x0 + w), W - 1), min(int(y0 + h), H - 1)
            img[yi0:yi1, xi0:xi1] = value
            for c in [(x0, y0), (x0 + w, y0), (x0, y0 + h), (x0 + w, y0 + h)]:
                corners.append(c)

    img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)
    pts = np.asarray(corners, np.float32) if corners else np.zeros((0, 2), np.float32)
    inb = (pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)
    return img, pts[inb]


def _resize_bilinear_np(a: np.ndarray, H: int, W: int) -> np.ndarray:
    """Pure-numpy bilinear upsample of a small 2D grid."""
    h, w = a.shape
    ys = np.linspace(0, h - 1, H)
    xs = np.linspace(0, w - 1, W)
    y0 = np.clip(ys.astype(int), 0, h - 2)
    x0 = np.clip(xs.astype(int), 0, w - 2)
    dy = (ys - y0)[:, None]
    dx = (xs - x0)[None, :]
    return (
        a[y0][:, x0] * (1 - dy) * (1 - dx)
        + a[y0][:, x0 + 1] * (1 - dy) * dx
        + a[y0 + 1][:, x0] * dy * (1 - dx)
        + a[y0 + 1][:, x0 + 1] * dy * dx
    )


def render_texture(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """Multi-octave value-noise texture in [0, 1].

    Descriptor training needs *texture*: flat synthetic shapes give the
    descriptor head nothing local to discriminate, and a head trained on
    them transfers worse than random projections on textured scenes
    (measured: ~100 px median mutual-NN displacement vs 8 px for random
    init on a rendered textured plane). The homography-pair descriptor
    loss is fully self-supervised, so any image content works — octave
    noise supplies dense, scale-diverse structure."""
    img = np.zeros((H, W), np.float32)
    amp_total = 0.0
    for octave, amp in ((4, 1.0), (8, 0.6), (16, 0.35), (32, 0.2)):
        g = rng.uniform(0, 1, (octave, octave)).astype(np.float32)
        img += amp * _resize_bilinear_np(g, H, W)
        amp_total += amp
    # blocky (nearest-neighbor) octave: piecewise-constant noise with
    # sharp edges, the texture class of block-noise renders/sensor
    # mosaics — smooth octaves alone teach descriptors that transfer
    # poorly to high-frequency content
    block = rng.integers(2, 5)
    gh, gw = (H + block - 1) // block, (W + block - 1) // block
    g = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
    amp = rng.uniform(0.3, 0.8)
    img += amp * np.kron(g, np.ones((block, block), np.float32))[:H, :W]
    amp_total += amp
    return img / amp_total


def make_texture_batch(rng: np.random.Generator, batch: int, H: int, W: int) -> np.ndarray:
    """Images for the descriptor pairs: synthetic shapes blended over
    octave-noise texture (shapes keep corner structure in-domain; the
    texture provides discriminative local appearance)."""
    imgs = np.zeros((batch, H, W), np.float32)
    for i in range(batch):
        shapes, _ = render_shapes(rng, H, W)
        tex = render_texture(rng, H, W)
        alpha = rng.uniform(0.35, 0.65)
        imgs[i] = np.clip(alpha * shapes + (1 - alpha) * tex, 0, 1)
    return imgs


def corners_to_cell_labels(pts: np.ndarray, H: int, W: int) -> np.ndarray:
    """(Hc, Wc) int labels in [0, 65): 8*dy+dx of the corner inside its
    cell, or 64 (dustbin) for empty cells — the SuperPoint detector
    target."""
    Hc, Wc = H // GRID, W // GRID
    labels = np.full((Hc, Wc), 64, np.int32)
    for x, y in pts:
        xi, yi = int(x), int(y)
        if 0 <= xi < W and 0 <= yi < H:
            labels[yi // GRID, xi // GRID] = (yi % GRID) * GRID + (xi % GRID)
    return labels


def make_pretrain_batch(rng: np.random.Generator, batch: int, H: int, W: int) -> Dict[str, np.ndarray]:
    imgs = np.zeros((batch, H, W), np.float32)
    labels = np.zeros((batch, H // GRID, W // GRID), np.int32)
    for i in range(batch):
        img, pts = render_shapes(rng, H, W)
        imgs[i] = img
        labels[i] = corners_to_cell_labels(pts, H, W)
    return {"image": imgs, "labels": labels}


# ---------------------------------------------------------------------------
# Losses + train step
# ---------------------------------------------------------------------------

def detector_loss(model: SuperPoint, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """65-way per-cell cross-entropy on the detector logits of (B, H, W)
    images, corner cells (rare) weighted 10."""
    feat = model.backbone(images[..., None].to(model.dtype)).permute(0, 3, 1, 2)
    logits = model.convPb(torch.relu(model.convPa(feat))).permute(0, 2, 3, 1)  # (B, Hc, Wc, 65)
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.to(torch.int64)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = torch.where(labels != 64, 10.0, 1.0)
    return torch.sum(nll * w) / torch.sum(w)


def pretrain_loss(model: SuperPoint, det_batch, desc_batch, lambda_desc: float = 0.001,
                  desc_objective: str = "nce", with_detector: bool = True):
    """Joint detector + descriptor loss: ``(loss, (det, desc))``. The
    descriptor term uses ``train_superpoint``'s Siamese pairs;
    ``desc_objective`` "nce" (InfoNCE, the from-scratch signal) or "hinge"
    (the reference's double-normalized hinge)."""
    zero = torch.zeros((), device=next(model.parameters()).device)
    det = detector_loss(model, det_batch["image"], det_batch["labels"]) if with_detector else zero
    if lambda_desc == 0.0:
        # detector-only mode: no Siamese descriptor forward at all
        return det, (det, zero)
    d0 = model.descriptor_head(model.backbone(desc_batch["orig"][..., None]))
    d1 = model.descriptor_head(model.backbone(desc_batch["warped"][..., None]))
    objective = descriptor_loss_nce if desc_objective == "nce" else descriptor_loss
    desc = objective(d0, d1, desc_batch["H"], desc_batch["mask"])
    return det + lambda_desc * desc, (det, desc)


def detector_head_mask(model: nn.Module) -> Dict[str, bool]:
    """Trainable: the detector head (convPa/convPb) only. Training the shared
    backbone for cornerness collapses the feature diversity the descriptors
    need; a backbone frozen at its random init keeps it."""
    return head_mask(model, ("convPa", "convPb"))


def descriptor_head_mask(model: nn.Module) -> Dict[str, bool]:
    """Trainable: the descriptor head (convDa/convDb) only (domain
    adaptation on target imagery keeps the backbone and detector)."""
    return head_mask(model, ("convDa", "convDb"))


def make_pretrain_step(optimizer: torch.optim.Optimizer, lambda_desc: float = 0.001, desc_objective: str = "nce",
                       with_detector: bool = True):
    """``step(model, det_batch, desc_batch) -> (loss, det, desc)``, one
    optimizer step; the values are those before the step."""

    def step(model, det_batch, desc_batch):
        optimizer.zero_grad(set_to_none=True)
        loss, (det, desc) = pretrain_loss(model, det_batch, desc_batch, lambda_desc, desc_objective, with_detector)
        loss.backward()
        optimizer.step()
        return loss.detach(), det.detach(), desc.detach()

    return step


def pretrain(
    generator: Optional[torch.Generator] = None,
    steps: int = 1000,
    batch: int = 8,
    H: int = 128,
    W: int = 128,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 100,
    lambda_desc: float = 0.001,
    init_params: Union[SuperPoint, Dict[str, torch.Tensor], None] = None,
    textured_desc: bool = True,
    desc_objective: str = "nce",
    detector_only: bool = False,
    desc_head_only: bool = False,
    device: DeviceLike = None,
) -> SuperPoint:
    """Run pretraining; returns the trained ``SuperPoint`` on ``device``.

    ``generator`` (a CPU ``torch.Generator``) draws the random init, as the
    JAX ``key`` does; ``seed`` seeds the numpy renderer and, plus one, the
    device generator of the descriptor pairs. ``init_params`` warm-starts
    (a state dict or a module). ``textured_desc`` feeds octave-noise
    textured images to the descriptor pairs. ``detector_only`` trains only
    the detector head; ``desc_head_only`` only the descriptor head (with the
    descriptor loss alone)."""
    dev = resolve_device(device)
    model = SuperPoint()
    if init_params is None:
        model.init_random(generator if generator is not None else torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(init_params.state_dict() if isinstance(init_params, nn.Module) else init_params)
    model = model.to(dev)
    if detector_only:
        optimizer = masked_adam(model, detector_head_mask(model), lr)
    elif desc_head_only:
        optimizer = masked_adam(model, descriptor_head_mask(model), lr)
    else:
        optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    step = make_pretrain_step(
        optimizer,
        0.0 if detector_only else (1.0 if desc_head_only else lambda_desc),
        desc_objective,
        with_detector=not desc_head_only,
    )
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for i in range(steps):
        det_np = make_pretrain_batch(rng, batch, H, W)
        det_batch = {k: torch.from_numpy(v).to(dev) for k, v in det_np.items()}
        desc_imgs = torch.from_numpy(make_texture_batch(rng, batch, H, W)).to(dev) if textured_desc else det_batch["image"]
        # large translations so absolute position cannot shortcut the
        # correspondence task (see train_superpoint.make_pair)
        desc_batch = make_desc_batch(gen, desc_imgs, translation=0.35, scale=0.25, rotation=0.3)
        loss, det, desc = step(model, det_batch, desc_batch)
        if log_every and (i + 1) % log_every == 0:
            print(f"pretrain step {i + 1}/{steps}: loss {float(loss):.4f} (det {float(det):.4f} desc {float(desc):.4f})")
    return model
