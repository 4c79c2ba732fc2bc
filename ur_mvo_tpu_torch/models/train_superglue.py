"""SuperGlue matcher training on synthetic warped correspondences, port
of ``ur_mvo_tpu.models.train_superglue``.

Trains the port's SuperGlue (``models/superglue.py``) from scratch with the
published matching objective (Sarlin et al., CVPR 2020, Eq. 10): the
negative log-likelihood of the ground-truth partial assignment under the
Sinkhorn transport, dustbins included. Supervision is synthetic: keypoints
warped by a random similarity with pixel jitter, some dropped and replaced
by distractors, matched descriptors noisy copies of each other.

The trainer's SuperGlue runs with ``kernels=False``: the JAX trainer calls
``match_scores`` with its Pallas attention and Sinkhorn off, so neither
kernel lies on this path (and neither has a gradient). ``optax.chain(
clip_by_global_norm(1.0), adam)`` becomes ``clip_grad_norm_(1.0)`` then
``torch.optim.Adam``; the clip differs by PyTorch's 1e-6: it scales by
``1 / (norm + 1e-6)`` where optax scales by ``1 / norm``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ur_mvo_tpu_torch.device import DeviceLike, resolve_device
from ur_mvo_tpu_torch.models.superglue import D, SuperGlue
from ur_mvo_tpu_torch.ops.keypoints import FeatureBank

CLIP_NORM = 1.0


# ---------------------------------------------------------------------------
# Synthetic correspondence batches
# ---------------------------------------------------------------------------

def make_batch(
    rng: np.random.Generator,
    batch: int,
    capacity: int,
    width: int,
    height: int,
    drop_frac: float = 0.2,
    desc_noise: float = 1.0,
    jitter_px: float = 1.0,
    device: DeviceLike = "cpu",
) -> Tuple[FeatureBank, FeatureBank, torch.Tensor, torch.Tensor]:
    """Sample a batch of feature-bank pairs with known assignment.

    Returns ``(bank0, bank1, tgt0, tgt1)`` where every array is stacked on
    a leading batch axis. ``tgt0[b, i]`` is the bank-1 column matched to
    bank-0 slot ``i`` (``capacity`` = dustbin); ``tgt1[b, j]`` is the
    bank-0 row for column ``j`` (``capacity`` = dustbin). Padding slots are
    marked invalid and excluded from the loss by the valid masks.

    ``desc_noise`` is the norm of a unit-direction perturbation added to a
    matched descriptor before renormalizing, so the matched-pair cosine is
    ~``1/sqrt(1 + desc_noise**2)`` (1.0 -> ~0.71, the regime of real
    SuperPoint matches; distractor cosines concentrate near 0 at D=256).
    The numpy draws are the JAX package's; the arrays land on ``device``.
    """
    K = capacity
    border = 8.0
    s0 = np.zeros((batch, K), np.float32)
    s1 = np.zeros((batch, K), np.float32)
    k0 = np.zeros((batch, K, 2), np.float32)
    k1 = np.zeros((batch, K, 2), np.float32)
    d0 = np.zeros((batch, K, D), np.float32)
    d1 = np.zeros((batch, K, D), np.float32)
    v0 = np.zeros((batch, K), bool)
    v1 = np.zeros((batch, K), bool)
    tgt0 = np.full((batch, K), K, np.int32)
    tgt1 = np.full((batch, K), K, np.int32)

    for b in range(batch):
        n0 = int(rng.integers(K // 2, K + 1))
        pts = np.stack(
            [rng.uniform(border, width - border, n0), rng.uniform(border, height - border, n0)], 1
        ).astype(np.float32)
        desc = rng.normal(size=(n0, D)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)

        # random similarity warp about the image center
        theta = rng.uniform(-0.3, 0.3)
        scale = rng.uniform(0.85, 1.15)
        t = rng.uniform(-0.12, 0.12, 2) * [width, height]
        c = np.array([width / 2.0, height / 2.0])
        R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
        warped = (pts - c) @ (scale * R).T + c + t
        warped += rng.normal(scale=jitter_px, size=warped.shape)

        inside = (
            (warped[:, 0] >= 0) & (warped[:, 0] < width) & (warped[:, 1] >= 0) & (warped[:, 1] < height)
        )
        kept = inside & (rng.random(n0) > drop_frac)
        kept_idx = np.nonzero(kept)[0]
        n_match = len(kept_idx)
        n_distract = min(K - n_match, max(0, int(rng.integers(0, K // 4 + 1))))
        n1 = n_match + n_distract

        # shuffled placement of true correspondences in bank 1
        perm = rng.permutation(n1)
        cols_of_match = perm[:n_match]
        cols_of_distract = perm[n_match:]

        nd = rng.normal(size=(n_match, D)).astype(np.float32)
        nd /= np.linalg.norm(nd, axis=1, keepdims=True)
        noisy = desc[kept_idx] + desc_noise * nd
        noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)

        k0[b, :n0] = pts
        d0[b, :n0] = desc
        s0[b, :n0] = rng.uniform(0.3, 1.0, n0)
        v0[b, :n0] = True
        k1[b, cols_of_match] = warped[kept_idx]
        d1[b, cols_of_match] = noisy
        if n_distract:
            k1[b, cols_of_distract] = np.stack(
                [rng.uniform(border, width - border, n_distract), rng.uniform(border, height - border, n_distract)], 1
            )
            dd = rng.normal(size=(n_distract, D)).astype(np.float32)
            d1[b, cols_of_distract] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
        s1[b, perm] = rng.uniform(0.3, 1.0, n1)
        v1[b, perm] = True
        tgt0[b, kept_idx] = cols_of_match
        tgt1[b, cols_of_match] = kept_idx

    def t(a):
        return torch.from_numpy(a).to(device)

    bank0 = FeatureBank(scores=t(s0), kpts=t(k0), desc=t(d0), valid=t(v0))
    bank1 = FeatureBank(scores=t(s1), kpts=t(k1), desc=t(d1), valid=t(v1))
    return bank0, bank1, t(tgt0), t(tgt1)


# ---------------------------------------------------------------------------
# On-device batch generation
# ---------------------------------------------------------------------------

def _uniform(g: torch.Generator, shape, lo, hi) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def make_batch_device(
    g: torch.Generator,
    batch: int,
    capacity: int,
    width: int,
    height: int,
    drop_frac: float = 0.2,
    desc_noise: float = 1.0,
    jitter_px: float = 1.0,
) -> Tuple[FeatureBank, FeatureBank, torch.Tensor, torch.Tensor]:
    """Static-shape synthetic correspondence batch drawn on the generator's
    device: the distribution of :func:`make_batch` with every slot
    populated (a dropped point becomes a distractor in bank 1), so that no
    batch crosses from the host."""
    B, K = batch, capacity
    border = 8.0
    dev = g.device
    pts = torch.stack([_uniform(g, (B, K), border, width - border), _uniform(g, (B, K), border, height - border)], -1)
    desc = _unit_rows(torch.randn((B, K, D), generator=g, device=dev))

    theta = _uniform(g, (B,), -0.3, 0.3)
    scale = _uniform(g, (B,), 0.85, 1.15)
    t = _uniform(g, (B, 2), -0.12, 0.12) * torch.tensor([width, height], dtype=torch.float32, device=dev)
    c = torch.tensor([width / 2.0, height / 2.0], device=dev)
    ct, st = torch.cos(theta), torch.sin(theta)
    R = torch.stack([torch.stack([ct, -st], -1), torch.stack([st, ct], -1)], -2)  # (B, 2, 2)
    warped = (pts - c) @ (scale[:, None, None] * R).transpose(-1, -2) + c + t[:, None, :]
    warped = warped + jitter_px * torch.randn((B, K, 2), generator=g, device=dev)

    inside = (warped[..., 0] >= 0) & (warped[..., 0] < width) & (warped[..., 1] >= 0) & (warped[..., 1] < height)
    kept = inside & (torch.rand((B, K), generator=g, device=dev) > drop_frac)

    # bank-1 content per source slot: the warped point if kept, a fresh
    # distractor otherwise, then shuffled by a random permutation
    d_pts = torch.stack([_uniform(g, (B, K), border, width - border), _uniform(g, (B, K), border, height - border)], -1)
    d_desc = _unit_rows(torch.randn((B, K, D), generator=g, device=dev))
    nd = _unit_rows(torch.randn((B, K, D), generator=g, device=dev))
    noisy = _unit_rows(desc + desc_noise * nd)
    content_k = torch.where(kept[..., None], warped, d_pts)
    content_d = torch.where(kept[..., None], noisy, d_desc)

    perm = torch.argsort(torch.rand((B, K), generator=g, device=dev), dim=1)
    # slot perm[i] of bank 1 holds source i's content
    k1 = torch.zeros((B, K, 2), device=dev).scatter(1, perm[..., None].expand(B, K, 2), content_k)
    d1 = torch.zeros((B, K, D), device=dev).scatter(1, perm[..., None].expand(B, K, D), content_d)
    slots = torch.arange(K, device=dev).expand(B, K)
    tgt0 = torch.where(kept, perm, K).to(torch.int32)
    tgt1 = torch.full((B, K), K, dtype=torch.int64, device=dev).scatter(1, perm, torch.where(kept, slots, K))

    s0 = _uniform(g, (B, K), 0.3, 1.0)
    s1 = _uniform(g, (B, K), 0.3, 1.0)
    ones = torch.ones((B, K), dtype=torch.bool, device=dev)
    b0 = FeatureBank(scores=s0, kpts=pts, desc=desc, valid=ones)
    b1 = FeatureBank(scores=s1, kpts=k1, desc=d1, valid=ones)
    return b0, b1, tgt0, tgt1.to(torch.int32)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def matching_loss(log_p: torch.Tensor, tgt0: torch.Tensor, tgt1: torch.Tensor, valid0: torch.Tensor,
                  valid1: torch.Tensor) -> torch.Tensor:
    """NLL of the ground-truth assignment under (..., K0+1, K1+1)
    log-transport matrices. ``tgt0`` covers the true matches and the
    frame-0 points assigned to the dustbin column; frame 1 adds only its
    unmatched points (the dustbin row), so that no pair counts twice."""
    K0, K1 = tgt0.shape[-1], tgt1.shape[-1]
    t0, t1 = tgt0.to(torch.int64), tgt1.to(torch.int64)
    l0 = -torch.gather(log_p[..., :K0, :], -1, t0[..., None])[..., 0]
    l1 = -torch.gather(log_p[..., :, :K1], -2, t1[..., None, :])[..., 0, :]
    unmatched1 = valid1 & (t1 == K0)
    zero = torch.zeros((), dtype=log_p.dtype, device=log_p.device)
    total = torch.sum(torch.where(valid0, l0, zero), -1) + torch.sum(torch.where(unmatched1, l1, zero), -1)
    count = torch.sum(valid0, -1) + torch.sum(unmatched1, -1)
    return total / torch.clamp(count, min=1).to(log_p.dtype)


def batch_loss(model: SuperGlue, bank0: FeatureBank, bank1: FeatureBank, tgt0: torch.Tensor, tgt1: torch.Tensor,
               width: int, height: int, sinkhorn_iterations: int = 20, num_heads: int = 4) -> torch.Tensor:
    """Mean :func:`matching_loss` over the batch: the banks' leading axis is
    the batch, matched as lanes by ``SuperGlue.match_scores``."""
    log_p = model.match_scores(bank0, bank1, width, height, sinkhorn_iterations, num_heads=num_heads)
    return torch.mean(matching_loss(log_p, tgt0, tgt1, bank0.valid, bank1.valid))


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def make_model(num_layers: int, seed: int, params: Union[SuperGlue, Dict[str, torch.Tensor], None],
               device: torch.device) -> SuperGlue:
    """The trainer's SuperGlue (``kernels=False``): ``params`` (a state dict
    or a module) or the random init of ``seed`` (``superglue.init_params``)."""
    if params is None:
        model = SuperGlue(num_layers, kernels=False).init_random(torch.Generator().manual_seed(seed))
    else:
        state = params.state_dict() if isinstance(params, torch.nn.Module) else params
        model = SuperGlue.from_state_dict(state, kernels=False)
    return model.to(device)


def make_train_step(width: int, height: int, sinkhorn_iterations: int, num_heads: int,
                    optimizer: torch.optim.Optimizer):
    """``step(model, bank0, bank1, tgt0, tgt1) -> loss``: the gradient, its
    global norm clipped to 1, one Adam step; the loss before the step."""

    def step(model, bank0, bank1, tgt0, tgt1):
        optimizer.zero_grad(set_to_none=True)
        loss = batch_loss(model, bank0, bank1, tgt0, tgt1, width, height, sinkhorn_iterations, num_heads)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), CLIP_NORM)
        optimizer.step()
        return loss.detach()

    return step


def train(
    steps: int = 2000,
    batch: int = 8,
    capacity: int = 256,
    width: int = 640,
    height: int = 512,
    num_layers: int = 9,
    num_heads: int = 4,
    sinkhorn_iterations: int = 20,
    lr: float = 1e-4,
    seed: int = 0,
    log_every: int = 50,
    params: Union[SuperGlue, Dict[str, torch.Tensor], None] = None,
    log_fn: Optional[Callable] = print,
    batch_kwargs: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> SuperGlue:
    """Host-fed training: a numpy batch (:func:`make_batch`) a step.
    Returns the trained model."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = make_model(num_layers, seed, params, dev)
    step = make_train_step(width, height, sinkhorn_iterations, num_heads,
                           torch.optim.Adam(model.parameters(), lr=lr))
    for i in range(steps):
        b0, b1, t0, t1 = make_batch(rng, batch, capacity, width, height, device=dev, **(batch_kwargs or {}))
        loss = step(model, b0, b1, t0, t1)
        if log_every and log_fn and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i}: loss {float(loss):.4f}")
    return model


def train_on_device(
    steps: int = 3000,
    batch: int = 8,
    capacity: int = 256,
    width: int = 640,
    height: int = 512,
    num_layers: int = 9,
    num_heads: int = 4,
    sinkhorn_iterations: int = 20,
    lr: float = 1e-4,
    seed: int = 0,
    chunk: int = 100,
    params: Union[SuperGlue, Dict[str, torch.Tensor], None] = None,
    log_fn: Optional[Callable] = print,
    batch_kwargs: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> SuperGlue:
    """Training with batches drawn on the device (:func:`make_batch_device`),
    ``chunk`` steps at a time with one host read a chunk (its mean loss),
    whole chunks until ``steps`` are done (the JAX package's ``lax.scan``
    chunks). Returns the trained model."""
    dev = resolve_device(device)
    bk = batch_kwargs or {}
    model = make_model(num_layers, seed, params, dev)
    step = make_train_step(width, height, sinkhorn_iterations, num_heads,
                           torch.optim.Adam(model.parameters(), lr=lr))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    done = 0
    while done < steps:
        losses = [step(model, *make_batch_device(gen, batch, capacity, width, height, **bk)) for _ in range(chunk)]
        done += chunk
        if log_fn:
            log_fn(f"step {done}: mean chunk loss {float(torch.stack(losses).mean()):.4f}")
    return model
