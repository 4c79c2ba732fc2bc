"""Matcher kernels: masked attention and log-Sinkhorn, each a CUDA kernel
beside its plain version (counterpart of ``ur_mvo_tpu.ops.pallas_kernels``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
(``csrc/attention.cu``, ``csrc/sinkhorn.cu``) or raises, also where an
input requires grad under grad mode (the kernels have no gradient).
"""

from __future__ import annotations

import math

import torch

from ur_mvo_tpu_torch.ops import cuda_ext

_NEG = -1e9


# ---------------------------------------------------------------------------
# Masked multi-head attention (TPU kernel: pallas_kernels.py::_attention_kernel)
# ---------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor) -> torch.Tensor:
    """``q`` (B, Kq, H, d), ``k``/``v`` (B, Kkv, H, d), ``kv_valid`` (B, Kkv)
    bool -> (B, Kq, H, d) in ``q.dtype``. Logits and softmax in float32,
    invalid keys at exactly -1e9, probabilities cast to the value dtype
    before the value product (``models/superglue._attention``)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    logits = torch.where(kv_valid[:, None, None, :], logits, torch.full_like(logits, _NEG))
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_valid: torch.Tensor,
              plain: bool = False, split: bool = False) -> torch.Tensor:
    """Masked attention core; see :func:`attention_plain` for the contract.
    ``plain=True`` asks for the plain version on any device. ``split=True``
    launches the bf16 key-group kernel (``attention_split_kernel``, counted
    as ``attention_split``) in place of the main path's: its outputs differ
    from the main path's by about a bf16 ulp, and the matcher does not use
    it (``csrc/attention.cu``)."""
    if plain or q.device.type == "cpu":
        return attention_plain(q, k, v, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    B, Kq, H, d = q.shape
    Kkv = k.shape[1]
    if k.shape != (B, Kkv, H, d) or v.shape != k.shape or kv_valid.shape != (B, Kkv):
        raise ValueError(f"attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} valid{tuple(kv_valid.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    if split and q.dtype != torch.bfloat16:
        raise ValueError(f"attention: the key-group kernel takes bfloat16, not {q.dtype}")
    cuda_ext.refuse_grad("attention", q, k, v)
    # bool (or uint8) as it is: the kernel reads a byte a key
    out = cuda_ext.extension().attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_valid.contiguous(),
                                         1.0 / math.sqrt(d), split)
    cuda_ext.count("attention_split" if split else "attention")
    return out


# ---------------------------------------------------------------------------
# Log-domain Sinkhorn (TPU kernel: pallas_kernels.py::_sinkhorn_kernel)
# ---------------------------------------------------------------------------

def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = torch.clamp(torch.max(x, dim=dim, keepdim=True).values, min=_NEG)
    return (m + torch.log(torch.clamp(torch.sum(torch.exp(x - m), dim=dim, keepdim=True), min=1e-30))).squeeze(dim)


def sinkhorn_plain(couplings: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor, iterations: int = 20) -> torch.Tensor:
    """Plain version of the Sinkhorn kernel: ``iterations`` row/column
    log-sum-exp sweeps from u = v = 0; returns ``couplings + u + v``."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iterations):
        u = log_mu - _lse(couplings + v[None, :], 1)
        v = log_nu - _lse(couplings + u[:, None], 0)
    return couplings + u[:, None] + v[None, :]


def sinkhorn(couplings: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor, iterations: int = 20,
             plain: bool = False) -> torch.Tensor:
    """Masked log-Sinkhorn on a prepared (M, N) float32 couplings matrix
    (dustbins included, -1e9 at invalid entries) with (M,)/(N,)
    log-marginals. Returns ``couplings + u + v``. ``plain=True`` asks for
    the plain version on any device. On the card every sweep and the final
    write are one cooperative launch (``csrc/sinkhorn.cu``)."""
    if plain or couplings.device.type == "cpu":
        return sinkhorn_plain(couplings, log_mu, log_nu, iterations)
    if couplings.device.type != "cuda":
        raise ValueError(f"sinkhorn: unsupported device {couplings.device}")
    M, N = couplings.shape
    if couplings.dtype != torch.float32 or log_mu.shape != (M,) or log_nu.shape != (N,):
        raise ValueError("sinkhorn: expects float32 (M, N) couplings with (M,) and (N,) marginals")
    cuda_ext.refuse_grad("sinkhorn", couplings, log_mu, log_nu)
    out = cuda_ext.extension().sinkhorn(
        couplings.contiguous(), log_mu.to(torch.float32).contiguous(), log_nu.to(torch.float32).contiguous(), int(iterations)
    )
    cuda_ext.count("sinkhorn")
    return out


def transport_problem(scores: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor, alpha: torch.Tensor):
    """The dustbin transport's Sinkhorn inputs: the (M+1, N+1) couplings
    (scores, ``alpha`` in the dustbin row and column, -1e9 at invalid pairs),
    the log-marginals, ``norm`` = -log(m + n) and the valid-pair mask."""
    M, N = scores.shape
    dev = scores.device
    m = torch.sum(valid0.to(scores.dtype))
    n = torch.sum(valid1.to(scores.dtype))
    norm = -torch.log(torch.clamp(m + n, min=1.0))

    couplings = torch.full((M + 1, N + 1), 0.0, dtype=scores.dtype, device=dev) + alpha.to(scores.dtype)
    couplings[:M, :N] = scores
    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    v0 = torch.cat([valid0, true1])
    v1 = torch.cat([valid1, true1])
    pair_mask = v0[:, None] & v1[None, :]
    couplings = torch.where(pair_mask, couplings, torch.full_like(couplings, _NEG))

    log_mu = torch.where(v0, norm, torch.full_like(norm, _NEG)).clone()
    log_mu[M] = torch.log(torch.clamp(n, min=1.0)) + norm
    log_nu = torch.where(v1, norm, torch.full_like(norm, _NEG)).clone()
    log_nu[N] = torch.log(torch.clamp(m, min=1.0)) + norm
    return couplings, log_mu, log_nu, norm, pair_mask


def log_optimal_transport_kernel(
    scores: torch.Tensor,
    valid0: torch.Tensor,
    valid1: torch.Tensor,
    alpha: torch.Tensor,
    iterations: int = 20,
    plain: bool = False,
) -> torch.Tensor:
    """Dustbin transport through :func:`sinkhorn` (port of
    ``log_optimal_transport_pallas``): builds the couplings and marginals
    (:func:`transport_problem`), runs the sweeps, subtracts ``norm`` and
    masks invalid pairs (with the couplings' own -1e9 there). ``scores``
    (S, M, N) with (S, M)/(S, N) masks transports S pairs, each as its own
    call (S launches on the card), so each keeps its single call's bits (the
    JAX package vmaps the Pallas kernel)."""
    if scores.dim() == 3:
        return torch.stack([log_optimal_transport_kernel(s, v0, v1, alpha, iterations, plain)
                            for s, v0, v1 in zip(scores, valid0, valid1)])
    couplings, log_mu, log_nu, norm, pair_mask = transport_problem(scores, valid0, valid1, alpha)
    Z = sinkhorn(couplings, log_mu, log_nu, iterations, plain=plain) - norm
    return torch.where(pair_mask, Z, couplings)
