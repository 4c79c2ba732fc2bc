"""Pose-graph optimization over SE(3) relative-pose constraints (port of
``ur_mvo_tpu.ops.pose_graph``).

Given keyframe poses and relative-pose edges (the odometry chain, plus loop
edges from place recognition), minimize

    sum_e w_e || log( T_ij^-1 * T_i^-1 * T_j ) ||^2

with Gauss-Newton on the SE(3) tangent over fixed shapes (padded edges,
masked). The edge Jacobians are forward-mode derivatives of the residual in
the two tangents (``torch.func.vmap(torch.func.jacfwd(...))``, as the JAX
package takes them with ``jax.vmap(jax.jacfwd(...))``). The (6F, 6F)
system is dense: at a few hundred keyframes a dense Cholesky beats sparse
bookkeeping. Products are the port's true float32 ``mm`` / ``mv``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ur_mvo_tpu_torch.ops.lie import mv, se3_exp, se3_log
from ur_mvo_tpu_torch.ops.linalg import assert_true_float32_matmul, mm


class PoseGraph(NamedTuple):
    R_wc: torch.Tensor  # (F, 3, 3)
    t_wc: torch.Tensor  # (F, 3)
    node_valid: torch.Tensor  # (F,) bool
    node_fixed: torch.Tensor  # (F,) bool — gauge (typically node 0)
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    # measured relative transform: T_ij = T_i^-1 T_j (i-frame <- j-frame)
    R_ij: torch.Tensor  # (E, 3, 3)
    t_ij: torch.Tensor  # (E, 3)
    edge_weight: torch.Tensor  # (E,) >= 0 (0 = padding)


class PoseGraphResult(NamedTuple):
    R_wc: torch.Tensor
    t_wc: torch.Tensor
    cost: torch.Tensor


def _T(R: torch.Tensor) -> torch.Tensor:
    return R.transpose(-1, -2)


def _edge_residuals(R, t, g: PoseGraph):
    """r_e = log(T_ij^-1 T_i^-1 T_j) in (E, 6)."""
    Ri, ti = R[g.edge_i], t[g.edge_i]
    Rj, tj = R[g.edge_j], t[g.edge_j]
    R_rel = mm(_T(Ri), Rj)
    t_rel = mv(_T(Ri), tj - ti)
    return se3_log(mm(_T(g.R_ij), R_rel), mv(_T(g.R_ij), t_rel - g.t_ij))


def _residual_of_tangents(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
    """One edge's residual after left-multiplicative updates of its two
    nodes by the tangents ``xi_i``, ``xi_j``."""
    dRi, dti = se3_exp(xi_i)
    dRj, dtj = se3_exp(xi_j)
    Ri2, ti2 = mm(dRi, Ri), mv(dRi, ti) + dti
    Rj2, tj2 = mm(dRj, Rj), mv(dRj, tj) + dtj
    R_rel = mm(_T(Ri2), Rj2)
    t_rel = mv(_T(Ri2), tj2 - ti2)
    return se3_log(mm(_T(Rm), R_rel), mv(_T(Rm), t_rel - tm))


_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_residual_of_tangents, argnums=(0, 1)))


def optimize_pose_graph(g: PoseGraph, iterations: int = 20, damping: float = 1e-6) -> PoseGraphResult:
    """Fixed-count Gauss-Newton (no flag is read back)."""
    assert_true_float32_matmul()
    F = g.R_wc.shape[0]
    E = g.edge_i.shape[0]
    dev, dt = g.R_wc.device, g.R_wc.dtype
    free = g.node_valid & ~g.node_fixed
    w = g.edge_weight[:, None, None]
    free_i = free[g.edge_i].to(dt)[:, None, None]
    free_j = free[g.edge_j].to(dt)[:, None, None]
    M = torch.repeat_interleave(free, 6).to(dt)
    pin = torch.diag(1.0 - M) + damping * torch.eye(F * 6, dtype=dt, device=dev)
    zeros = torch.zeros((E, 6), dtype=dt, device=dev)

    R, t = g.R_wc, g.t_wc
    for _ in range(iterations):
        r = _edge_residuals(R, t, g)  # (E, 6)
        Ji, Jj = _edge_jacobians(zeros, zeros, R[g.edge_i], t[g.edge_i], R[g.edge_j], t[g.edge_j], g.R_ij, g.t_ij)
        # forward mode carries the tangents of torch.where in float64:
        # the Jacobians come back in the working dtype
        Ji, Jj = Ji.to(dt) * free_i, Jj.to(dt) * free_j  # fixed/invalid nodes take no step
        H = torch.zeros((F, F, 6, 6), dtype=dt, device=dev)
        ends = ((g.edge_i, Ji), (g.edge_j, Jj))
        for a, Ja in ends:
            for c, Jc in ends:
                H.index_put_((a, c), mm(_T(Ja), Jc) * w, accumulate=True)
        b = torch.zeros((F, 6), dtype=dt, device=dev)
        b.index_add_(0, g.edge_i, -mv(_T(Ji), r) * w[:, :, 0])
        b.index_add_(0, g.edge_j, -mv(_T(Jj), r) * w[:, :, 0])

        Hf = H.permute(0, 2, 1, 3).reshape(F * 6, F * 6) * M[:, None] * M[None, :] + pin
        L, _ = torch.linalg.cholesky_ex(Hf)
        dx = torch.cholesky_solve((b.reshape(F * 6) * M)[:, None], L)[:, 0].reshape(F, 6)
        dR, dtr = se3_exp(dx)
        R = torch.where(free[:, None, None], mm(dR, R), R)
        t = torch.where(free[:, None], mv(dR, t) + dtr, t)
    r = _edge_residuals(R, t, g)
    cost = torch.sum(torch.sum(r * r, -1) * g.edge_weight)
    return PoseGraphResult(R_wc=R, t_wc=t, cost=cost)


def sequential_edges_from_trajectory(R_wc, t_wc, n_valid: int, max_edges: int):
    """Odometry chain edges (i, i+1) with measured relatives from the
    current estimates (numpy in, numpy out) — the default graph when no
    loop closures exist."""
    E = max_edges
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    Rm = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    tm = np.zeros((E, 3), np.float32)
    w = np.zeros(E, np.float32)
    for k in range(max(0, min(n_valid - 1, E))):
        i, j = k, k + 1
        ei[k], ej[k] = i, j
        Rm[k] = np.asarray(R_wc[i]).T @ np.asarray(R_wc[j])
        tm[k] = np.asarray(R_wc[i]).T @ (np.asarray(t_wc[j]) - np.asarray(t_wc[i]))
        w[k] = 1.0
    return ei, ej, Rm, tm, w
