"""Two-view relative-pose initialization (port of
``ur_mvo_tpu.ops.epipolar``).

The 200-hypothesis RANSAC for both models runs as batched tensor code
(``ops/ransac.py``) and all 12 candidate motions are cheirality-checked
together: triangulation of every match under every hypothesis is one
batched computation. Model selection (RH = SH/(SH+SF) > 0.5) and the
per-model acceptance rules (clear winner, 90% support, parallax) match
the reference's ORB-SLAM3-derived initializer.

The two 3x3 SVDs go to ``torch.linalg.svd``, as the JAX package leaves
them to ``jnp.linalg.svd``; the sign freedom of a singular vector
permutes the hypothesis list, not its content.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ur_mvo_tpu_torch.ops.lie import mv
from ur_mvo_tpu_torch.ops.linalg import det3, inv3x3, mm
from ur_mvo_tpu_torch.ops.ransac import ransac_fundamental, ransac_homography
from ur_mvo_tpu_torch.ops.triangulation import triangulate_dlt

COS_PARALLAX_MAX = 0.99998  # reference's "infinite point" gate


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def decompose_essential(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E -> 4 motion hypotheses ((4, 3, 3) R, (4, 3) t)."""
    U, _, Vt = torch.linalg.svd(E)
    t = U[:, 2]
    t = t / torch.clamp(_norm(t), min=1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = mm(mm(U, W), Vt)
    R2 = mm(mm(U, W.T), Vt)
    R1 = torch.where(det3(R1) < 0, -R1, R1)
    R2 = torch.where(det3(R2) < 0, -R2, R2)
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    return Rs, ts


def decompose_homography(H21: torch.Tensor, K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Faugeras decomposition of a homography into 8 (R, t) hypotheses.

    Returns (Rs (8,3,3), ts (8,3), feasible (8,)). ``feasible`` is False
    for all when the singular values are too equal (the pure-rotation case
    the reference rejects, ``d1/d2 < 1.00001 || d2/d3 < 1.00001``).
    """
    A = mm(mm(inv3x3(K), H21), K)
    U, w, Vt = torch.linalg.svd(A)
    s = det3(U) * det3(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    feasible = (d1 / torch.clamp(d2, min=1e-12) >= 1.00001) & (d2 / torch.clamp(d3, min=1e-12) >= 1.00001)

    eps = 1e-12
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=eps), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=eps), min=0.0))
    sg = torch.tensor([[1.0, 1.0, -1.0, -1.0], [1.0, -1.0, 1.0, -1.0], [1.0, -1.0, -1.0, 1.0]],
                      dtype=A.dtype, device=A.device)
    x1 = aux1 * sg[0]
    x3 = aux3 * sg[1]
    zero = torch.zeros(4, dtype=A.dtype, device=A.device)
    one = torch.ones(4, dtype=A.dtype, device=A.device)
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    def rows(a, b, c):
        return torch.stack([a, b, c], dim=-1)

    # case d' = d2
    stheta = prod / torch.clamp((d1 + d3) * d2, min=eps) * sg[2]
    ctheta = ((d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)) * one
    Rp_pos = torch.stack([rows(ctheta, zero, -stheta), rows(zero, one, zero), rows(stheta, zero, ctheta)], dim=-2)
    tp_pos = rows(x1, zero, -x3) * (d1 - d3)
    # case d' = -d2
    sphi = prod / torch.clamp((d1 - d3) * d2, min=eps) * sg[2]
    cphi = ((d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)) * one
    Rp_neg = torch.stack([rows(cphi, zero, sphi), rows(zero, -one, zero), rows(sphi, zero, -cphi)], dim=-2)
    tp_neg = rows(x1, zero, x3) * (d1 + d3)

    Rp = torch.cat([Rp_pos, Rp_neg])  # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])  # (8, 3)
    Rs = s * mm(mm(U, Rp), Vt)
    ts = mv(U, tp)
    ts = ts / torch.clamp(_norm(ts), min=eps)[:, None]
    return Rs, ts, feasible.expand(8)


def check_rt(
    R: torch.Tensor,
    t: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    inliers: torch.Tensor,
    K: torch.Tensor,
    sigma2: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheirality / parallax / reprojection check of motion hypotheses
    over all matches. ``R`` (..., 3, 3) and ``t`` (..., 3) may carry a
    leading hypothesis dimension.

    Returns (n_good, parallax_deg, points3d (..., N, 3) in camera-1 frame,
    good_mask (..., N)).
    """
    th2 = 4.0 * sigma2
    P1 = torch.cat([K, torch.zeros((3, 1), dtype=K.dtype, device=K.device)], dim=1)
    P2 = mm(K, torch.cat([R, t[..., :, None]], dim=-1))
    O2 = -mv(R.transpose(-1, -2), t)

    X = triangulate_dlt(P1, P2, p1, p2)  # (..., N, 3) in cam1
    finite = torch.all(torch.isfinite(X), dim=-1)

    n1 = X
    n2 = X - O2[..., None, :]
    cos_par = torch.sum(n1 * n2, dim=-1) / torch.clamp(_norm(n1) * _norm(n2), min=1e-12)

    Xc2 = mv(R[..., None, :, :], X) + t[..., None, :]
    low_par = cos_par >= COS_PARALLAX_MAX
    depth_ok = ((X[..., 2] > 0) | low_par) & ((Xc2[..., 2] > 0) | low_par)

    def reproj_err(P, pts, obs):
        h = mv(P[..., None, :, :3], pts) + P[..., None, :, 3]
        uv = h[..., :2] / torch.clamp(h[..., 2:3], min=1e-12)
        return torch.sum((uv - obs) ** 2, dim=-1)

    err1 = reproj_err(P1, X, p1)
    err2 = reproj_err(P2, X, p2)
    counted = inliers & finite & depth_ok & (err1 <= th2) & (err2 <= th2)
    good = counted & (cos_par < COS_PARALLAX_MAX)

    n_good = torch.sum(counted.to(torch.int32), dim=-1)
    # parallax = angle of the min(50, nGood-1)-th smallest cosParallax
    cp_sorted = torch.sort(torch.where(counted, cos_par, torch.full_like(cos_par, math.inf)), dim=-1).values
    idx = torch.clamp(torch.clamp(n_good - 1, min=0), max=50).to(torch.int64)
    picked = torch.gather(cp_sorted, -1, idx[..., None])[..., 0]
    par = torch.rad2deg(torch.arccos(torch.clamp(picked, -1.0, 1.0)))
    parallax = torch.where(n_good > 0, par, torch.zeros_like(par))
    return n_good, parallax, X, good


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # bool
    R21: torch.Tensor  # (3, 3): x2 = R21 x1 + t21
    t21: torch.Tensor  # (3,)
    points3d: torch.Tensor  # (N, 3) in camera-1 frame
    triangulated: torch.Tensor  # (N,) bool
    used_homography: torch.Tensor  # bool (diagnostic)
    n_good: torch.Tensor  # int


def two_view_init(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    iterations: int = 200,
    sigma: float = 1.0,
    min_parallax_deg: float = 1.0,
    min_triangulated: int = 50,
    sets_f: Optional[torch.Tensor] = None,
    sets_h: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Full monocular initialization on padded match arrays: batched H+F
    RANSAC, model selection by RH = SH/(SH+SF), decomposition into 12
    motion hypotheses, batched cheirality checks, reference acceptance
    rules. ``sets_f`` / ``sets_h`` (iterations, 8) override the samplers
    of the two RANSACs (parity tests); else both draw from ``generator``.
    """
    resF = ransac_fundamental(generator, p1, p2, valid, iterations, sigma, sets=sets_f)
    resH = ransac_homography(generator, p1, p2, valid, iterations, sigma, sets=sets_h)

    SH = torch.clamp(resH.score, min=0.0)
    SF = torch.clamp(resF.score, min=0.0)
    rh = SH / torch.clamp(SH + SF, min=1e-12)
    use_h = rh > 0.5

    E = mm(mm(K.T, resF.model), K)
    Rf, tf = decompose_essential(E)  # (4,...)
    Rh, th, h_feasible = decompose_homography(resH.model, K)  # (8,...)

    sigma2 = sigma * sigma

    # Each hypothesis family is cheirality-checked against its own
    # model's RANSAC support, all hypotheses of a family in one batch.
    nf, pf, Xf, gf = check_rt(Rf, tf, p1, p2, resF.inliers, K, sigma2)
    nh, ph, Xh, gh = check_rt(Rh, th, p1, p2, resH.inliers, K, sigma2)
    nh = torch.where(h_feasible, nh, torch.zeros_like(nh))

    # F-model acceptance: enough support, a clear winner among the 4,
    # enough parallax.
    NF = torch.sum(resF.inliers.to(torch.int32))
    bestF = torch.argmax(nf)
    bestF_good = nf[bestF]
    n_min_good = torch.clamp((0.9 * NF).to(torch.int32), min=min_triangulated)
    n_similar = torch.sum((nf > 0.7 * bestF_good).to(torch.int32))
    acc_f = (bestF_good >= n_min_good) & (n_similar == 1) & (pf[bestF] > min_parallax_deg)

    # H-model acceptance.
    NH = torch.sum(resH.inliers.to(torch.int32))
    bestH = torch.argmax(nh)
    bestH_good = nh[bestH]
    secondH = torch.sort(nh).values[-2]
    acc_h = (
        (secondH < 0.75 * bestH_good)
        & (ph[bestH] >= min_parallax_deg)
        & (bestH_good > min_triangulated)
        & (bestH_good > 0.9 * NH)
    )

    # Model choice: the reference commits to RH > 0.5 and fails outright
    # if that model's reconstruction is rejected. On planar scenes the
    # scores tie (any F fits coplanar points), so fall back to the other
    # model when the selected one fails acceptance.
    take_h = (use_h & acc_h) | (~use_h & ~acc_f & acc_h)
    success = torch.where(take_h, acc_h, acc_f)

    R_sel = torch.where(take_h, Rh[bestH], Rf[bestF])
    t_sel = torch.where(take_h, th[bestH], tf[bestF])
    X_sel = torch.where(take_h, Xh[bestH], Xf[bestF])
    good_sel = torch.where(take_h, gh[bestH], gf[bestF])
    n_sel = torch.where(take_h, bestH_good, bestF_good)

    return TwoViewResult(
        success=success,
        R21=R_sel,
        t21=t_sel,
        points3d=X_sel,
        triangulated=good_sel & success,
        used_homography=take_h,
        n_good=n_sel,
    )
