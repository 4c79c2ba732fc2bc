"""Pose-only robust optimization, the per-frame tracking optimizer (port of
``ur_mvo_tpu.ops.pose_opt`` and of its kernel ``ops/pallas_pose.py``).

A single SE(3) vertex with mono (2D) and stereo (3D) reprojection rows,
Huber weights, and the reference's schedule: 4 rounds x 10 iterations,
each round restarting from the initial pose with the current inlier
classification, chi^2 gates (mono 10 / stereo 75), Huber dropped in the
last round; damped Gauss-Newton on the SE(3) tangent with step acceptance.

On CUDA tensors :func:`optimize_pose` launches the kernel
``csrc/pose_gn.cu`` (one launch for the whole schedule, any batch). On CPU
tensors, or with ``plain=True``, it runs :func:`optimize_pose_plain`: the
same function in plain PyTorch ops with the kernel's arithmetic (damping
and scaling from the undamped trace, a Cholesky solve by substitution),
which differs in rounding from the JAX package's XLA route (scaling by the
damped trace, an explicit inverse); the two agree to R 2e-5, t 2e-4.

Convention: optimizes T_cw (world->camera); callers convert from/to T_wc.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PoseObs(NamedTuple):
    """Padded pose-optimization problem: N candidate map-point tracks
    (an optional leading batch dimension on every field)."""

    X: torch.Tensor  # (N, 3) world points (fixed)
    uv: torch.Tensor  # (N, 3): u, v, u_right (u_right <= 0 => mono)
    valid: torch.Tensor  # (N,)


class PoseOptResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inliers: torch.Tensor  # (N,) final chi2-gated classification
    n_inliers: torch.Tensor


def _se3_exp_scalar(dx):
    """Rodrigues SE(3) exp on six (B,) tensors -> (dR 3x3 list, dt 3 list),
    with the kernel's small-angle branch (theta^2 < 1e-12)."""
    wx, wy, wz = dx[0], dx[1], dx[2]
    th2 = wx * wx + wy * wy + wz * wz
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2 < 1e-12
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / torch.clamp(th2, min=1e-30))
    zero = torch.zeros_like(wx)
    one = torch.ones_like(wx)
    K = [[zero, -wz, wy], [wz, zero, -wx], [-wy, wx, zero]]
    K2 = [
        [-(wy * wy + wz * wz), wx * wy, wx * wz],
        [wx * wy, -(wx * wx + wz * wz), wy * wz],
        [wx * wz, wy * wz, -(wx * wx + wy * wy)],
    ]
    eye = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    dR = [[eye[i][j] + A * K[i][j] + B * K2[i][j] for j in range(3)] for i in range(3)]
    V = [[eye[i][j] + B * K[i][j] + C * K2[i][j] for j in range(3)] for i in range(3)]
    dt = [V[i][0] * dx[3] + V[i][1] * dx[4] + V[i][2] * dx[5] for i in range(3)]
    return dR, dt


def _chol_solve6(H, g):
    """Solve H x = g for 6x6 SPD systems given as lists of (B,) tensors:
    unrolled Cholesky (pivots floored at 1e-12) + two substitutions."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            t = H[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def optimize_pose_plain(
    R_cw0: torch.Tensor,
    t_cw0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float = 0.0,
    chi2_mono: float = 10.0,
    chi2_stereo: float = 75.0,
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-3,
    full_schedule: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the pose-GN kernel, batched: ``R_cw0`` (B, 3, 3),
    ``t_cw0`` (B, 3), ``X`` / ``uv`` (B, N, 3), ``valid`` (B, N) bool ->
    (R (B, 3, 3), t (B, 3), inliers (B, N) bool, steps (B,) int32). A
    Python loop of ``rounds`` x ``iters_per_round`` steps of elementwise
    ops and sums.

    It takes the kernel's two exact shortcuts. A step that is rejected, or
    that lands on the bits it started from, is a fixed point of its round:
    every later step of the round would repeat it bit for bit, so a round's
    loop ends once every problem of the batch is at one, and a problem at
    its fixed point takes no further step. A round whose inlier set and
    Huber flag equal the previous round's repeats its result, so a problem
    for which it would repeat keeps its pose and flags through that round
    (the round's loop is not run at all once every problem repeats). ``steps``
    counts, per problem, the steps the kernel runs for it: those up to and
    including its first fixed point, in the rounds it does not skip.
    ``full_schedule`` runs every step of every round instead (the results
    are the same bits; ``steps`` is then rounds x iters_per_round)."""
    f32 = torch.float32
    R0 = R_cw0.to(f32)
    t0 = t_cw0.to(f32)
    Xx, Xy, Xz = X[..., 0].to(f32), X[..., 1].to(f32), X[..., 2].to(f32)
    uo, vo, uro = uv[..., 0].to(f32), uv[..., 1].to(f32), uv[..., 2].to(f32)
    validf = valid.to(f32)
    stereo = (uro > 0.0).to(f32)
    th = stereo * chi2_stereo + (1.0 - stereo) * chi2_mono
    delta_th = torch.sqrt(th)

    def project(R, t):
        pcx = R[:, 0, 0, None] * Xx + R[:, 0, 1, None] * Xy + R[:, 0, 2, None] * Xz + t[:, 0, None]
        pcy = R[:, 1, 0, None] * Xx + R[:, 1, 1, None] * Xy + R[:, 1, 2, None] * Xz + t[:, 1, None]
        pcz = R[:, 2, 0, None] * Xx + R[:, 2, 1, None] * Xy + R[:, 2, 2, None] * Xz + t[:, 2, None]
        iz = 1.0 / torch.clamp(pcz, min=1e-6)
        u = fx * pcx * iz + cx
        v = fy * pcy * iz + cy
        ru = u - uo
        rv = v - vo
        rr = stereo * (u - bf * iz - uro)
        chi2 = ru * ru + rv * rv + rr * rr
        return pcx, pcy, pcz, iz, ru, rv, rr, chi2

    def robust_cost(chi2, mask, use_huber):
        if not use_huber:
            return torch.sum(chi2 * mask, dim=-1)
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        rho = torch.where(chi2 <= th, chi2, 2.0 * delta_th * s - th)
        return torch.sum(rho * mask, dim=-1)

    def jac(d, pcx, pcy, pcz):
        return torch.stack(
            [
                d[1] * (-pcz) + d[2] * pcy,
                d[0] * pcz + d[2] * (-pcx),
                d[0] * (-pcy) + d[1] * pcx,
                d[0],
                d[1],
                d[2],
            ],
            dim=-1,
        )  # (B, N, 6)

    def bits(a):
        return a.reshape(a.shape[0], -1).view(torch.int32)

    inl = validf
    R, t = R0, t0
    nb = R0.shape[0]
    steps = torch.zeros(nb, dtype=torch.int32, device=R0.device)
    # repeat[b]: problem b's next round has the inputs (inlier set, Huber
    # flag) of its last one, and so would repeat its result
    repeat = torch.zeros(nb, dtype=torch.bool, device=R0.device)
    for rnd in range(rounds):
        use_huber = rnd < 3  # the robust kernel is dropped in the 4th round
        if full_schedule or rnd == 3:
            repeat = torch.zeros_like(repeat)  # round 3 drops Huber: it never repeats round 2
        if bool(repeat.all()):
            continue  # R, t and the inlier flags stay
        # the vertex is reset at the start of every round, except for the
        # problems that skip it: they keep their pose and flags
        R = torch.where(repeat[:, None, None], R, R0)
        t = torch.where(repeat[:, None], t, t0)
        live = ~repeat  # the problems still stepping in this round
        for _ in range(iters_per_round):
            if not (full_schedule or bool(live.any())):
                break
            pcx, pcy, pcz, iz, ru, rv, rr, chi2 = project(R, t)
            iz2 = iz * iz
            if use_huber:
                rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
                w = torch.clamp(delta_th / rn, max=1.0) * inl
            else:
                w = inl
            zero = torch.zeros_like(iz)
            du = (fx * iz, zero, -fx * pcx * iz2)
            dv = (zero, fy * iz, -fy * pcy * iz2)
            dur = (stereo * du[0], zero, stereo * (du[2] + bf * iz2))
            Ju, Jv, Jr = jac(du, pcx, pcy, pcz), jac(dv, pcx, pcy, pcz), jac(dur, pcx, pcy, pcz)
            Hm = torch.sum(
                w[..., None, None]
                * (Ju[..., :, None] * Ju[..., None, :] + Jv[..., :, None] * Jv[..., None, :] + Jr[..., :, None] * Jr[..., None, :]),
                dim=1,
            )  # (B, 6, 6)
            gv = -torch.sum(w[..., None] * (Ju * ru[..., None] + Jv * rv[..., None] + Jr * rr[..., None]), dim=1)
            tr = Hm[:, 0, 0] + Hm[:, 1, 1] + Hm[:, 2, 2] + Hm[:, 3, 3] + Hm[:, 4, 4] + Hm[:, 5, 5]
            lam = damping * torch.clamp(tr / 6.0, min=1e-6)
            inv_s = 1.0 / torch.clamp(tr / 6.0, min=1e-12)
            Hn = [[(Hm[:, j, k] + (lam if j == k else 0.0)) * inv_s for k in range(6)] for j in range(6)]
            gn = [gv[:, j] * inv_s for j in range(6)]
            dx = _chol_solve6(Hn, gn)
            dR, dt = _se3_exp_scalar(dx)
            R_new = torch.stack(
                [
                    torch.stack([dR[i][0] * R[:, 0, j] + dR[i][1] * R[:, 1, j] + dR[i][2] * R[:, 2, j] for j in range(3)], -1)
                    for i in range(3)
                ],
                dim=-2,
            )
            t_new = torch.stack(
                [dR[i][0] * t[:, 0] + dR[i][1] * t[:, 1] + dR[i][2] * t[:, 2] + dt[i] for i in range(3)], dim=-1
            )
            # a step that raises the active robust cost, or is not finite,
            # is reverted
            cost0 = robust_cost(chi2, inl, use_huber)
            cost1 = robust_cost(project(R_new, t_new)[7], inl, use_huber)
            ok = (cost1 <= cost0) & torch.isfinite(torch.sum(t_new, dim=-1))
            # a rejected step, or one onto the same bits, is a fixed point
            same = torch.all(bits(R_new) == bits(R), dim=-1) & torch.all(bits(t_new) == bits(t), dim=-1)
            steps += live.to(torch.int32)
            take = ok & live  # a problem at its fixed point, or skipping the round, takes no step
            if not full_schedule:
                live = live & ok & ~same
            R = torch.where(take[:, None, None], R_new, R)
            t = torch.where(take[:, None], t_new, t)
        _, _, pcz, _, _, _, _, chi2 = project(R, t)
        inl_next = validf * (chi2 <= th).to(f32) * (pcz > 0.0).to(f32)
        inl_next = torch.where(repeat[:, None], inl, inl_next)  # a problem that skipped keeps its flags
        repeat = torch.all(inl_next == inl, dim=-1)
        inl = inl_next
    return R, t, inl > 0.5, steps


def optimize_pose(
    R_cw0: torch.Tensor,
    t_cw0: torch.Tensor,
    obs: PoseObs,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float = 0.0,
    chi2_mono: float = 10.0,
    chi2_stereo: float = 75.0,
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-3,
    plain: bool = False,
) -> PoseOptResult:
    """Robust pose refinement with the reference's 4x10 schedule.

    One problem (``obs.X`` (N, 3), ``R_cw0`` (3, 3)) or a batch (a leading
    B on every tensor). CUDA tensors launch the kernel once for the whole
    batch; CPU tensors, or ``plain=True``, run the plain version."""
    single = obs.X.dim() == 2
    R0, t0, X, uv, valid = R_cw0, t_cw0, obs.X, obs.uv, obs.valid
    if single:
        R0, t0, X, uv, valid = R0[None], t0[None], X[None], uv[None], valid[None]
    args = (R0, t0, X, uv, valid, fx, fy, cx, cy, bf, chi2_mono, chi2_stereo, rounds, iters_per_round, damping)
    if plain or X.device.type == "cpu":
        R, t, inl, _ = optimize_pose_plain(*args)
    else:
        from ur_mvo_tpu_torch.ops.cuda_pose import pose_gn

        R, t, inl, _ = pose_gn(*args)
    n_inl = torch.sum(inl.to(torch.int32), dim=-1)
    if single:
        R, t, inl, n_inl = R[0], t[0], inl[0], n_inl[0]
    return PoseOptResult(R_cw=R, t_cw=t, inliers=inl, n_inliers=n_inl)
