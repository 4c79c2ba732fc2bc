"""Trajectory evaluation: Umeyama alignment + ATE.

Own copy of ``ur_mvo_tpu.utils.metrics``: the self-contained equivalent
of the reference's external evaluation call
``evo_ape tum gt.txt poses.txt --align --correct_scale``: SE(3) (+ optional scale)
Umeyama alignment of the estimated positions onto ground truth followed by
the RMSE of translational residuals.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform aligning ``src`` (N,3) onto
    ``dst`` (N,3). Returns (scale, R, t) with dst ~= s * R @ src + t."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True, correct_scale: bool = True) -> float:
    """Absolute translation error RMSE after (optional) Umeyama alignment —
    the reference's headline metric (``--pose_relation trans_part``)."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    assert est.shape == gt.shape and est.ndim == 2 and est.shape[1] == 3
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale=correct_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))
