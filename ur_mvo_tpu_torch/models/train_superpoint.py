"""SuperPoint descriptor fine-tuning (domain adaptation), port of
``ur_mvo_tpu.models.train_superpoint``.

Only the descriptor head (convDa/convDb) is trained, on Siamese
homography-warped pairs with photometric augmentation, with the dense
hinge-contrastive descriptor loss whose cell correspondences come from the
homography (margins 1.0 / 0.2, lambda_d = 650), Adam 1e-3.

Randomness comes from an explicit ``torch.Generator`` on the device the
images lie on; its numbers are not the JAX package's, so the tests feed
both packages the same homographies and images. The augmentation, the
warps and the losses take a leading batch axis where the JAX package
vmaps. ``optax.multi_transform(adam / set_to_zero)`` becomes
``torch.optim.Adam`` over the trainable parameters, the others frozen
(``requires_grad_(False)``: they get no gradient and keep every bit).
The encoder's stages 1-3 run through the stage kernel's op
(``ops/cuda_conv.stage_conv_op``), whose gradient is the plain version's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GRID = 8
POSITIVE_MARGIN = 1.0
NEGATIVE_MARGIN = 0.2
LAMBDA_D = 650.0

TRAINABLE = ("convDa", "convDb")


# ---------------------------------------------------------------------------
# Homography + photometric augmentation
# ---------------------------------------------------------------------------

def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def random_homography(g: torch.Generator, height: int, width: int, perspective: float = 0.1,
                      scale: float = 0.15, rotation: float = 0.25, translation: float = 0.05,
                      batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """Random homographies mapping original -> warped pixel coordinates,
    (*batch, 3, 3) float32. tx and ty share one draw (as the JAX package's
    shared key gives them)."""
    ang = _uniform(g, batch, -rotation, rotation)
    s = 1.0 + _uniform(g, batch, -scale, scale)
    t = _uniform(g, batch, -translation, translation)
    p = _uniform(g, batch + (2,), -perspective, perspective)
    cx, cy = width / 2.0, height / 2.0
    ca, sa = torch.cos(ang), torch.sin(ang)
    one, zero = torch.ones_like(ang), torch.zeros_like(ang)
    dev = ang.device

    def mat(*rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    T1 = torch.tensor([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]], device=dev)
    S = mat((s * ca, -s * sa, t * width), (s * sa, s * ca, t * height), (zero, zero, one))
    P = mat((one, zero, zero), (zero, one, zero), (p[..., 0] / width, p[..., 1] / height, one))
    T2 = torch.tensor([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]], device=dev)
    return T2 @ P @ S @ T1


def warp_points_xy(pts: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Warp (..., N, 2) (x, y) points by (..., 3, 3) ``H``."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    w = ph @ H.transpose(-1, -2)
    z = w[..., 2:3]
    return w[..., :2] / torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))


def warp_image(image: torch.Tensor, H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-warp ``image`` (..., h, w) by ``H`` (..., 3, 3): (warped,
    valid mask), warped(x) = image(H^-1 x), bilinear, zero outside."""
    h, w = image.shape[-2:]
    dev = image.device
    Hinv = torch.linalg.inv(H)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    pts = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    src = warp_points_xy(pts, Hinv)  # (..., h*w, 2)
    x, y = src[..., 0], src[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    dx, dy = x - x0, y - y0
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    flat = image.reshape(image.shape[:-2] + (h * w,))

    def g(yy, xx):
        idx = torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)
        return torch.gather(flat, -1, idx)

    out = (g(y0, x0) * (1 - dx) * (1 - dy) + g(y0, x0 + 1) * dx * (1 - dy)
           + g(y0 + 1, x0) * (1 - dx) * dy + g(y0 + 1, x0 + 1) * dx * dy)
    out = torch.where(inb, out, torch.zeros_like(out))
    return out.reshape(image.shape), inb.to(torch.float32).reshape(image.shape)


def photometric_aug(g: torch.Generator, image: torch.Tensor) -> torch.Tensor:
    """Brightness / contrast / gaussian noise / speckle / shade on (..., h, w)
    images in [0, 1], each image its own draws."""
    batch = image.shape[:-2]
    h, w = image.shape[-2:]

    def per_image(t):
        return t.reshape(batch + (1, 1))

    img = image + per_image(_uniform(g, batch, -0.1, 0.1))  # brightness
    img = (img - 0.5) * (1.0 + per_image(_uniform(g, batch, -0.3, 0.3))) + 0.5
    img = img + 0.02 * torch.randn(image.shape, generator=g, device=g.device)  # gaussian noise
    img = img * (1.0 + 0.05 * torch.randn(image.shape, generator=g, device=g.device))  # speckle
    # smooth multiplicative shade field (half-pixel bilinear upsampling, as
    # jax.image.resize upsamples)
    coarse = _uniform(g, batch + (4, 4), 0.7, 1.0)
    shade = F.interpolate(coarse.reshape((-1, 1, 4, 4)), size=(h, w), mode="bilinear", align_corners=False)
    img = img * shade.reshape(image.shape)
    return torch.clamp(img, 0.0, 1.0)


def make_pair(g: torch.Generator, image: torch.Tensor, translation: float = 0.05, rotation: float = 0.25,
              scale: float = 0.15, perspective: float = 0.1):
    """Siamese training pairs of (..., h, w) images: (orig, warped, H,
    warped-valid mask). From-scratch pretraining passes a much larger
    ``translation``: with small warps a cell's correspondent is nearly
    always the same cell, which a padded convnet solves from position."""
    h, w = image.shape[-2:]
    H = random_homography(g, h, w, perspective=perspective, scale=scale, rotation=rotation,
                          translation=translation, batch=tuple(image.shape[:-2]))
    warped, mask = warp_image(image, H)
    return photometric_aug(g, image), photometric_aug(g, warped), H, mask


def make_batch(g: torch.Generator, images: torch.Tensor, **pair_kwargs) -> Dict[str, torch.Tensor]:
    """Siamese batch from raw images (B, H, W) in [0, 1]."""
    orig, warped, H, mask = make_pair(g, images, **pair_kwargs)
    return {"orig": orig, "warped": warped, "H": H, "mask": mask}


# ---------------------------------------------------------------------------
# Dense descriptor losses
# ---------------------------------------------------------------------------

def _cell_centers(Hc: int, Wc: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(Hc, dtype=torch.float32, device=device),
                            torch.arange(Wc, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1) * GRID + GRID // 2  # (Hc, Wc, 2) in px


def _unit(d: torch.Tensor) -> torch.Tensor:
    """sqrt(sum+eps) normalization: an exactly-zero descriptor (a
    zero-filled warp border through a zero-bias net) keeps a finite
    gradient, where max(norm, eps) gives 0 * inf."""
    return d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)


def descriptor_loss_terms(desc0: torch.Tensor, desc1: torch.Tensor, H: torch.Tensor,
                          valid_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hinge loss's numerator and normalization, sums over the batch:
    :func:`descriptor_loss` is ``total / max(norm, 1)``. Kept apart so that
    a data-parallel step can divide each rank's sum by the whole batch's
    normalization (``parallel/train_step.py``)."""
    B, Hc, Wc, D = desc0.shape
    centers = _cell_centers(Hc, Wc, desc0.device)
    warped_centers = warp_points_xy(centers.reshape(-1, 2), H).reshape(B, Hc, Wc, 2)
    # original cell (i, j) <-> warped cell (k, l) when warp(center_ij) lands
    # within half a cell of center_kl
    dist = torch.linalg.vector_norm(warped_centers[:, :, :, None, None, :] - centers[None, None, None], dim=-1)
    s = (dist <= (GRID - 0.5)).to(torch.float32)  # (B, Hc, Wc, Hc, Wc): orig cell x warped cell

    dot = torch.relu(torch.einsum("bijd,bkld->bijkl", _unit(desc0), _unit(desc1)))
    # double normalization as in the reference
    dot = dot / torch.clamp(torch.linalg.vector_norm(dot.reshape(B, Hc, Wc, -1), dim=-1)[..., None, None], min=1e-12)
    dot = dot / torch.clamp(torch.linalg.vector_norm(dot.reshape(B, -1, Hc, Wc), dim=1)[:, None, None], min=1e-12)

    loss = LAMBDA_D * s * torch.relu(POSITIVE_MARGIN - dot) + (1.0 - s) * torch.relu(dot - NEGATIVE_MARGIN)
    # a warped cell is valid when all its pixels are
    vm = valid_mask.reshape(B, Hc, GRID, Wc, GRID).prod(dim=4).prod(dim=2)[:, None, None]
    return torch.sum(vm * loss), torch.sum(vm) * (Hc * Wc)


def descriptor_loss(desc0: torch.Tensor, desc1: torch.Tensor, H: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """Hinge-contrastive dense descriptor loss. ``desc0``/``desc1``: (B, Hc,
    Wc, D) descriptor maps of the original and warped images; ``H``: (B, 3,
    3) original -> warped homographies; ``valid_mask``: (B, H, W)
    warped-image validity."""
    total, norm = descriptor_loss_terms(desc0, desc1, H, valid_mask)
    return total / torch.clamp(norm, min=1.0)


def descriptor_loss_nce(desc0: torch.Tensor, desc1: torch.Tensor, H: torch.Tensor, valid_mask: torch.Tensor,
                        temperature: float = 0.1) -> torch.Tensor:
    """InfoNCE (dual-softmax) descriptor loss over cell correspondences: each
    original cell must rank its true warped cell above all others, and the
    other way round (the from-scratch signal; the hinge loss only nudges
    pretrained weights)."""
    B, Hc, Wc, D = desc0.shape
    N = Hc * Wc
    centers = _cell_centers(Hc, Wc, desc0.device)
    wc = warp_points_xy(centers.reshape(-1, 2), H)  # (B, N, 2)
    # ground truth: the nearest cell center, valid when within half a cell
    # of it, inside the image and on a valid warped cell
    gl = torch.round((wc[..., 0] - GRID // 2) / GRID)
    gk = torch.round((wc[..., 1] - GRID // 2) / GRID)
    cx = gl * GRID + GRID // 2
    cy = gk * GRID + GRID // 2
    close = torch.maximum(torch.abs(wc[..., 0] - cx), torch.abs(wc[..., 1] - cy)) <= GRID / 2.0
    inb = (gk >= 0) & (gk < Hc) & (gl >= 0) & (gl < Wc)
    vm = valid_mask.reshape(B, Hc, GRID, Wc, GRID).amin(dim=(2, 4)) > 0.5  # (B, Hc, Wc)
    gt_c = torch.clamp((gk * Wc + gl).to(torch.int64), 0, N - 1)
    pair_ok = inb & close & torch.gather(vm.reshape(B, N), 1, gt_c)

    sim = torch.einsum("bnd,bmd->bnm", _unit(desc0).reshape(B, N, D), _unit(desc1).reshape(B, N, D)) / temperature
    logp0 = torch.log_softmax(sim, dim=2)
    logp1 = torch.log_softmax(sim, dim=1)
    idx = gt_c[:, :, None]
    nll = -(torch.gather(logp0, 2, idx)[..., 0] + torch.gather(logp1, 2, idx)[..., 0])
    w = pair_ok.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0) * 0.5


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------

def head_mask(model: nn.Module, layers: Tuple[str, ...]) -> Dict[str, bool]:
    """Parameter name -> trainable: the parameters of ``layers``."""
    return {name: name.split(".")[0] in layers for name, _ in model.named_parameters()}


def trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable: the descriptor head only."""
    return head_mask(model, TRAINABLE)


def masked_adam(model: nn.Module, mask: Dict[str, bool], lr: float) -> torch.optim.Adam:
    """``optax.multi_transform({True: adam, False: set_to_zero})``: Adam
    over the parameters ``mask`` selects; the others frozen in place."""
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.Adam(params, lr=lr)


def make_optimizer(model: nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam on the descriptor head only (frozen encoder, the reference's
    ``train.py:12``)."""
    return masked_adam(model, trainable_mask(model), lr)


def _descriptors(model, batch):
    d0 = model.descriptor_head(model.backbone(batch["orig"][..., None]))
    d1 = model.descriptor_head(model.backbone(batch["warped"][..., None]))
    return d0, d1


def loss_terms(model, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`descriptor_loss_terms` of the model on ``batch``."""
    d0, d1 = _descriptors(model, batch)
    return descriptor_loss_terms(d0, d1, batch["H"], batch["mask"])


def loss_fn(model, batch) -> torch.Tensor:
    """batch: dict(orig (B,H,W), warped (B,H,W), H (B,3,3), mask (B,H,W)).
    Only the descriptor branch runs: the detector head is frozen and unused
    by this loss."""
    total, norm = loss_terms(model, batch)
    return total / torch.clamp(norm, min=1.0)


def train_step(model, optimizer: torch.optim.Optimizer, batch) -> torch.Tensor:
    """One optimizer step of :func:`loss_fn` on ``batch``; returns the loss
    (before the step)."""
    optimizer.zero_grad(set_to_none=True)
    value = loss_fn(model, batch)
    value.backward()
    optimizer.step()
    return value.detach()


def make_train_step(optimizer: torch.optim.Optimizer):
    """``step(model, batch) -> loss`` (:func:`train_step` with ``optimizer``)."""
    return lambda model, batch: train_step(model, optimizer, batch)
