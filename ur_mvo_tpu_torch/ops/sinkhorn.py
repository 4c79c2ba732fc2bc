"""Masked log-domain Sinkhorn optimal transport (port of
``ur_mvo_tpu.ops.sinkhorn``): the plain reference with dustbins, where
invalid rows/columns carry no mass and the potentials of invalid slots
are held at 0. The matcher's main path runs the kernel-backed
``ops.cuda_kernels.log_optimal_transport_kernel``, which agrees with this
on the valid block and the dustbins."""

from __future__ import annotations

import torch

_NEG = -1e9


def _masked_logsumexp(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch.where(mask, x, torch.full_like(x, _NEG))
    m = torch.clamp(torch.max(x, dim=dim, keepdim=True).values, min=_NEG)  # no -inf on empty rows
    s = torch.sum(torch.where(mask, torch.exp(x - m), torch.zeros_like(x)), dim=dim, keepdim=True)
    return (m + torch.log(torch.clamp(s, min=1e-30))).squeeze(dim)


def log_optimal_transport(
    scores: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    alpha: torch.Tensor,
    iterations: int = 20,
) -> torch.Tensor:
    """Partial-assignment transport with dustbins.

    ``scores``: (M, N) similarity over padded slots; ``valid0``/``valid1``
    slot masks; ``alpha``: scalar dustbin score. Returns the (M+1, N+1)
    log-assignment matrix (``+log(m+n)`` restored), invalid pairs at -1e9.
    Each valid keypoint has mass ``1/(m+n)``; the dustbin row/column get
    ``n/(m+n)`` and ``m/(m+n)``.
    """
    M, N = scores.shape
    dev = scores.device
    m = torch.sum(valid0.to(scores.dtype))
    n = torch.sum(valid1.to(scores.dtype))
    norm = -torch.log(torch.clamp(m + n, min=1.0))

    couplings = torch.zeros((M + 1, N + 1), dtype=scores.dtype, device=dev) + alpha.to(scores.dtype)
    couplings[:M, :N] = scores
    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    v0 = torch.cat([valid0, true1])
    v1 = torch.cat([valid1, true1])
    pair_mask = v0[:, None] & v1[None, :]
    neg = torch.full_like(couplings, _NEG)
    couplings = torch.where(pair_mask, couplings, neg)

    log_mu = torch.where(v0, norm, torch.full_like(norm, _NEG)).clone()
    log_mu[M] = torch.log(torch.clamp(n, min=1.0)) + norm
    log_nu = torch.where(v1, norm, torch.full_like(norm, _NEG)).clone()
    log_nu[N] = torch.log(torch.clamp(m, min=1.0)) + norm

    u = torch.zeros((M + 1,), dtype=scores.dtype, device=dev)
    v = torch.zeros((N + 1,), dtype=scores.dtype, device=dev)
    zu, zv = torch.zeros_like(u), torch.zeros_like(v)
    for _ in range(iterations):
        u = log_mu - _masked_logsumexp(couplings + v[None, :], pair_mask, 1)
        u = torch.where(v0, u, zu)
        v = log_nu - _masked_logsumexp(couplings + u[:, None], pair_mask, 0)
        v = torch.where(v1, v, zv)

    Z = couplings + u[:, None] + v[None, :] - norm
    return torch.where(pair_mask, Z, neg)
