"""Batched fundamental-matrix and homography RANSAC (port of
``ur_mvo_tpu.ops.ransac``).

All hypotheses are one batch: minimal sets are drawn with a Gumbel top-k
(distinct indices), the 8-point null vectors come from batched inverse
iteration (``ops/linalg.py``), and symmetric-epipolar chi^2 scoring is a
dense (hypotheses x points) computation. Scoring constants match
ORB-SLAM3's (th 3.841, score cap 5.991). Every product runs in true
float32 (:func:`ur_mvo_tpu_torch.ops.linalg.mm`), the port's counterpart
of the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ur_mvo_tpu_torch.ops.linalg import eigh3x3, inv3x3, mm, smallest_singular_vector

F_CHI2_TH = 3.841  # 1-dof 95% — inlier gate per direction
H_CHI2_TH = 5.991  # 2-dof 95%
SCORE_CAP = 5.991  # both models accumulate (cap - chi2)


def sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor, num_sets: int, set_size: int) -> torch.Tensor:
    """Draw ``num_sets`` x ``set_size`` distinct indices from valid slots.

    Gumbel top-k over the validity mask: iid Gumbel noise on the valid
    slots, top ``set_size`` per hypothesis — a without-replacement sample.
    The noise comes from ``generator`` (on the tensor's device); it is
    not JAX's counter-based stream, so parity tests pass the same
    ``sets`` to both packages instead."""
    K = valid.shape[0]
    u = torch.rand((num_sets, K), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    scores = torch.where(valid[None, :], g, torch.full_like(g, -math.inf))
    return torch.topk(scores, set_size, dim=-1).indices


def _normalize(pts: torch.Tensor):
    """Hartley normalization of (..., N, 2) -> (pts_n, T (..., 3, 3))."""
    mean = torch.mean(pts, dim=-2)
    centered = pts - mean[..., None, :]
    mean_dist = torch.mean(torch.sqrt(torch.sum(centered * centered, dim=-1)), dim=-1)
    s = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-8)
    one = torch.ones_like(s)
    zero = torch.zeros_like(s)
    T = torch.stack(
        [
            torch.stack([one, zero, -mean[..., 0]], -1),
            torch.stack([zero, one, -mean[..., 1]], -1),
            torch.stack([zero, zero, 1.0 / s], -1),
        ],
        dim=-2,
    )
    T = T * s[..., None, None]
    return centered * s[..., None, None], T


def fit_fundamental_8pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point algorithm: (..., 8, 2) x2 -> F21 (..., 3, 3) with
    ``x2^T F x1 = 0`` and rank-2 projection."""
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)
    Fn = smallest_singular_vector(A).reshape(A.shape[:-2] + (3, 3))
    # Rank-2 projection without an SVD: F' = F - (F v3) v3^T with v3 from
    # the analytic eigendecomposition of F^T F.
    _, V = eigh3x3(mm(Fn.transpose(-1, -2), Fn))
    v3 = V[..., :, 0]
    Fv = mm(Fn, v3[..., :, None])[..., :, 0]
    Fn = Fn - Fv[..., :, None] * v3[..., None, :]
    F = mm(mm(T2.transpose(-1, -2), Fn), T1)
    f22 = F[..., 2, 2]
    return F / torch.where(torch.abs(f22) > 1e-8, f22, torch.ones_like(f22))[..., None, None]


def fit_homography_dlt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT homography: (..., N>=4, 2) x2 -> H21 (..., 3, 3) with ``x2 ~ H x1``."""
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], dim=-1)
    rows_b = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)  # (..., 2n, 9)
    Hn = smallest_singular_vector(A).reshape(A.shape[:-2] + (3, 3))
    H = mm(mm(inv3x3(T2), Hn), T1)
    h22 = H[..., 2, 2]
    return H / torch.where(torch.abs(h22) > 1e-8, h22, torch.ones_like(h22))[..., None, None]


def _lines_T(M: torch.Tensor, xT: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``l`` (..., 3, K) = M (or M^T) applied to homogeneous points ``xT``
    (3, K)."""
    Mm = M.transpose(-1, -2) if transpose else M
    return mm(Mm, xT)


def _homog_T(p1: torch.Tensor, p2: torch.Tensor):
    """(K, 2) point pairs -> homogeneous (3, K) arrays."""
    ones = torch.ones((1, p1.shape[0]), dtype=p1.dtype, device=p1.device)
    return torch.cat([p1.T, ones], dim=0), torch.cat([p2.T, ones], dim=0)


def score_fundamental(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor, sigma: float = 1.0):
    """Symmetric epipolar-distance chi^2 score. ``F`` may carry leading
    hypothesis dims (..., 3, 3). Returns (score (...,), inliers (..., K))."""
    inv_s2 = 1.0 / (sigma * sigma)
    x1T, x2T = _homog_T(p1, p2)
    l2 = _lines_T(F, x1T, False)  # (..., 3, K) epipolar lines in image 2
    l1 = _lines_T(F, x2T, True)  # (..., 3, K) in image 1
    n2 = l2[..., 0, :] * x2T[0] + l2[..., 1, :] * x2T[1] + l2[..., 2, :]
    n1 = l1[..., 0, :] * x1T[0] + l1[..., 1, :] * x1T[1] + l1[..., 2, :]
    d2 = n2 * n2 / torch.clamp(l2[..., 0, :] ** 2 + l2[..., 1, :] ** 2, min=1e-12)
    d1 = n1 * n1 / torch.clamp(l1[..., 0, :] ** 2 + l1[..., 1, :] ** 2, min=1e-12)
    chi1 = d2 * inv_s2
    chi2 = d1 * inv_s2
    ok1 = chi1 <= F_CHI2_TH
    ok2 = chi2 <= F_CHI2_TH
    zero = torch.zeros((), dtype=chi1.dtype, device=chi1.device)
    score = torch.sum(
        torch.where(valid & ok1, SCORE_CAP - chi1, zero) + torch.where(valid & ok2, SCORE_CAP - chi2, zero),
        dim=-1,
    )
    return score, valid & ok1 & ok2


def score_homography(H21: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor, sigma: float = 1.0):
    """Symmetric transfer-error chi^2 score for a homography; ``H21`` may
    carry leading hypothesis dims. Returns (score (...,), inliers (..., K))."""
    inv_s2 = 1.0 / (sigma * sigma)
    H12 = inv3x3(H21)
    x1T, x2T = _homog_T(p1, p2)

    def transfer_err(H, xsrcT, pdstT):
        y = _lines_T(H, xsrcT, False)  # (..., 3, K)
        w = y[..., 2, :]
        w = torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
        du = y[..., 0, :] / w - pdstT[0]
        dv = y[..., 1, :] / w - pdstT[1]
        return du * du + dv * dv

    d1 = transfer_err(H12, x2T, x1T) * inv_s2
    d2 = transfer_err(H21, x1T, x2T) * inv_s2
    ok1 = d1 <= H_CHI2_TH
    ok2 = d2 <= H_CHI2_TH
    zero = torch.zeros((), dtype=d1.dtype, device=d1.device)
    score = torch.sum(
        torch.where(valid & ok1, SCORE_CAP - d1, zero) + torch.where(valid & ok2, SCORE_CAP - d2, zero),
        dim=-1,
    )
    return score, valid & ok1 & ok2


class RansacResult(NamedTuple):
    model: torch.Tensor  # (3, 3)
    score: torch.Tensor  # scalar
    inliers: torch.Tensor  # (K,) bool


def ransac_fundamental(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    iterations: int = 200,
    sigma: float = 1.0,
    sets: Optional[torch.Tensor] = None,
) -> RansacResult:
    """All-hypotheses-at-once fundamental RANSAC over padded match arrays.

    ``sets`` (iterations, 8) overrides the sampler (the parity tests feed
    the JAX sampler's indices); otherwise they are drawn from
    ``generator``."""
    if sets is None:
        sets = sample_minimal_sets(generator, valid, iterations, 8)
    Fs = fit_fundamental_8pt(p1[sets], p2[sets])
    scores, inliers = score_fundamental(Fs, p1, p2, valid, sigma)
    best = torch.argmax(scores)
    return RansacResult(model=Fs[best], score=scores[best], inliers=inliers[best])


def ransac_homography(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    iterations: int = 200,
    sigma: float = 1.0,
    sets: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Batched homography RANSAC (8-point DLT sets, as the reference's
    initializer uses); ``sets`` as in :func:`ransac_fundamental`."""
    if sets is None:
        sets = sample_minimal_sets(generator, valid, iterations, 8)
    Hs = fit_homography_dlt(p1[sets], p2[sets])
    scores, inliers = score_homography(Hs, p1, p2, valid, sigma)
    best = torch.argmax(scores)
    return RansacResult(model=Hs[best], score=scores[best], inliers=inliers[best])
