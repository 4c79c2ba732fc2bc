"""Sliding-window bundle adjustment: Schur-complement Levenberg-Marquardt
(port of ``ur_mvo_tpu.ops.ba``).

SE(3) keyframe vertices, marginalized 3D point vertices, mono (2D) and
stereo (3D) reprojection rows with identity information, Huber weights,
and the reference's two-phase schedule: 10 robust LM iterations, chi^2
outlier gating (mono 10 / stereo 75, plus positive depth), then 5 more
iterations without the outliers, returning per-observation inlier
verdicts for the map-maintenance pass.

The problem is padded to static shapes (F frames, P points, O
observations). Per-observation value rows are closed forms; the normal
equations are assembled by one of three routes (:func:`resolve_assembly`):

* ``"scatter"``: float32 segment sums with ``index_add_``. ``"auto"``
  takes it at window scale, where the JAX package's ``"auto"`` picks its
  one-hot matmul. On CUDA ``index_add_`` adds with atomics, so a BA is
  repeatable run to run only to float32 summation order.
* ``"sorted"``: the observations are sorted by point once per problem and
  the point side (``U``, ``H_pp``, ``b_p``) is summed by the
  ``point_reduce_sorted`` kernel (``ops/cuda_ba.py``, the TPU kernel
  ``ur_mvo_tpu/ops/pallas_ba.py:141``), bf16 summands with float32
  accumulation, in a fixed order. ``"auto"`` takes it once the one-hot
  indicator of the matmul route would exceed 128M elements (O x P): a
  global BA over a long sequence.
* ``"pallas"``: the same sums in the caller's observation order by the
  ``point_reduce`` kernel (TPU kernel ``pallas_ba.py:38``), with atomics.

The frame side (``H_cc``, ``b_c``) stays exact float32 on every route.
``BAConfig.bf16_point_side`` rounds the ``"scatter"`` route's point-side
summands to bf16 before its float32 sums: the JAX package's window
numerics (its one-hot matmul, ``ur_mvo_tpu/ops/ba.py:278-284``), which
the stereo and RGB-D setups take (``runtime/backend.py``).

The LM loop runs its fixed number of iterations with every update masked
once the phase has converged (the JAX ``while_loop`` stops there; the
frozen state gives the same result) so that no iteration reads a flag
back to the host. The coupling tensor ``U`` is dense (P, FF, 6, 3), the
reduced camera system (6 FF)^2 goes through ``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ur_mvo_tpu_torch.ops import cuda_ba
from ur_mvo_tpu_torch.ops.lie import mv, se3_exp
from ur_mvo_tpu_torch.ops.linalg import assert_true_float32_matmul, inv3x3, mm


class BAProblem(NamedTuple):
    """Padded BA problem. All tensors static-shape; masks gate validity."""

    # Keyframe poses, world-from-camera.
    R_wc: torch.Tensor  # (F, 3, 3)
    t_wc: torch.Tensor  # (F, 3)
    frame_valid: torch.Tensor  # (F,) bool
    frame_fixed: torch.Tensor  # (F,) bool — gauge/fixed frames
    # Landmarks.
    X: torch.Tensor  # (P, 3) world positions
    point_valid: torch.Tensor  # (P,) bool
    # Observations.
    obs_frame: torch.Tensor  # (O,) int64 -> [0, F)
    obs_point: torch.Tensor  # (O,) int64 -> [0, P)
    obs_uv: torch.Tensor  # (O, 3): u, v, u_right (u_right <= 0 => mono)
    obs_valid: torch.Tensor  # (O,) bool


class BAResult(NamedTuple):
    R_wc: torch.Tensor
    t_wc: torch.Tensor
    X: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) bool — final chi2 verdicts
    cost: torch.Tensor  # final robust cost


class BAConfig(NamedTuple):
    chi2_mono: float = 10.0
    chi2_stereo: float = 75.0
    iters_phase1: int = 10
    iters_phase2: int = 5
    lm_lambda0: float = 1e-4
    # normal-equation assembly: "scatter" (float32 index_add_), "sorted"
    # (point-sorted segment sums, point_reduce_sorted kernel), "pallas"
    # (point_reduce kernel, atomics) or "auto" (resolve_assembly)
    assembly: str = "auto"
    # LM convergence: once an ACCEPTED step improves the cost by less than
    # tol (relative) the phase's remaining iterations leave the state as
    # it is. 0.0 disables.
    tol: float = 1e-4
    # Static bound on simultaneously-optimized (non-fixed) frames: sizes
    # the camera system, the coupling tensor U and the reduced solve.
    max_free_frames: int = 16
    # "scatter" only: round the point side's summands (U, H_pp, b_p) to
    # bf16 before the float32 sums, as the JAX package's one-hot matmul
    # does; the kernel routes always do
    bf16_point_side: bool = False


def _invert_poses(R_wc, t_wc):
    R_cw = R_wc.transpose(-1, -2)
    return R_cw, -mv(R_cw, t_wc)


def _residuals(R_cw, t_cw, X, prob: BAProblem, fx, fy, cx, cy, bf):
    """Residuals (O, 3), Jacobians Jc (O, 3, 6), Jp (O, 3, 3), masks."""
    Rf = R_cw[prob.obs_frame]
    tf = t_cw[prob.obs_frame]
    Xp = X[prob.obs_point]
    pc = mv(Rf, Xp) + tf
    x, y = pc[:, 0], pc[:, 1]
    z = torch.clamp(pc[:, 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    is_stereo = prob.obs_uv[:, 2] > 0
    zeros = torch.zeros_like(x)
    r = torch.stack(
        [u - prob.obs_uv[:, 0], v - prob.obs_uv[:, 1], torch.where(is_stereo, ur - prob.obs_uv[:, 2], zeros)],
        dim=-1,
    )
    du = torch.stack([fx * iz, zeros, -fx * x * iz2], dim=-1)
    dv = torch.stack([zeros, fy * iz, -fy * y * iz2], dim=-1)
    dur = du + torch.stack([zeros, zeros, bf * iz2], dim=-1)
    dur = torch.where(is_stereo[:, None], dur, torch.zeros_like(dur))
    J_pc = torch.stack([du, dv, dur], dim=1)  # (O, 3, 3)

    neg_skew = torch.stack(
        [
            torch.stack([zeros, pc[:, 2], -pc[:, 1]], -1),
            torch.stack([-pc[:, 2], zeros, pc[:, 0]], -1),
            torch.stack([pc[:, 1], -pc[:, 0], zeros], -1),
        ],
        dim=1,
    )
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(neg_skew.shape)
    J_xi = torch.cat([neg_skew, eye], dim=2)  # (O, 3, 6)
    Jc = mm(J_pc, J_xi)
    Jp = mm(J_pc, Rf)  # d pc / d X = R_cw
    depth_pos = pc[:, 2] > 0
    return r, Jc, Jp, is_stereo, depth_pos


def _chi2(r, is_stereo):
    return torch.where(is_stereo, torch.sum(r * r, -1), torch.sum(r[:, :2] ** 2, -1))


def _robust_cost(chi2, is_stereo, th_mono, th_stereo, use_huber):
    if not use_huber:
        return chi2
    th = torch.where(is_stereo, th_stereo, th_mono).to(chi2.dtype)
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= th, chi2, 2.0 * torch.sqrt(th) * s - th)


def _effective_free(prob: BAProblem, FF: int) -> torch.Tensor:
    """Free-frame mask with overflow protection: if more than FF frames
    are free, the excess (latest in index order) are treated as fixed
    rather than silently aliasing camera-system slots."""
    frame_free = prob.frame_valid & ~prob.frame_fixed
    rank = torch.cumsum(frame_free.to(torch.int64), dim=0) - 1
    return frame_free & (rank < FF)


def _free_rank(prob: BAProblem, FF: int) -> torch.Tensor:
    """Per-frame compact free-slot index in [0, FF); fixed/invalid frames
    get a clipped slot (their Jacobians are zero so any slot is safe)."""
    rank = torch.cumsum(_effective_free(prob, FF).to(torch.int64), dim=0) - 1
    return torch.clamp(rank, 0, FF - 1)


def _thresholds(is_stereo, cfg: BAConfig, dtype):
    th_m = torch.tensor(cfg.chi2_mono, dtype=dtype, device=is_stereo.device)
    th_s = torch.tensor(cfg.chi2_stereo, dtype=dtype, device=is_stereo.device)
    return th_m, th_s


def _cost_and_gate(prob: BAProblem, R_cw, t_cw, X, fx, fy, cx, cy, bf):
    """(chi2 (O,), is_stereo (O,), depth_pos (O,)) at a state: what the
    accept test and the inlier gates need, without the Jacobians."""
    pc = mv(R_cw[prob.obs_frame], X[prob.obs_point]) + t_cw[prob.obs_frame]
    iz = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] * iz + cx
    v = fy * pc[:, 1] * iz + cy
    is_st = prob.obs_uv[:, 2] > 0
    r0 = u - prob.obs_uv[:, 0]
    r1 = v - prob.obs_uv[:, 1]
    r2 = is_st.to(u.dtype) * (u - bf * iz - prob.obs_uv[:, 2])
    return r0 * r0 + r1 * r1 + r2 * r2, is_st, pc[:, 2] > 0


def _cost(prob: BAProblem, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg: BAConfig, active, use_huber):
    """Robust cost only (for the LM accept/reject evaluations)."""
    chi2, is_st, _ = _cost_and_gate(prob, R_cw, t_cw, X, fx, fy, cx, cy, bf)
    th_m, th_s = _thresholds(is_st, cfg, chi2.dtype)
    return torch.sum(_robust_cost(chi2, is_st, th_m, th_s, use_huber) * active)


def _obs_value_rows(prob: BAProblem, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg: BAConfig, active, use_huber):
    """Per-observation linearization rows: ``Vc`` (O, 42) = [Jc^T W Jc |
    Jc^T W r], ``Vp`` (O, 12) = [Jp^T W Jp | Jp^T W r], ``A`` (O, 18) =
    Jc^T W Jp, plus the robust cost at the linearization point."""
    O = prob.obs_frame.shape[0]
    FF = cfg.max_free_frames
    r, Jc, Jp, is_stereo, _ = _residuals(R_cw, t_cw, X, prob, fx, fy, cx, cy, bf)
    chi2 = _chi2(r, is_stereo)
    th_m, th_s = _thresholds(is_stereo, cfg, chi2.dtype)
    if use_huber:
        th = torch.where(is_stereo, th_s, th_m)
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(chi2 <= th, torch.ones_like(s), torch.sqrt(th) / s) * active
    else:
        w = active

    # Fixed/invalid frames contribute no pose Jacobian.
    frame_free = _effective_free(prob, FF)[prob.obs_frame]
    Jc = Jc * frame_free[:, None, None].to(Jc.dtype)

    Jcw = Jc * w[:, None, None]
    JcJc = mm(Jcw.transpose(-1, -2), Jc).reshape(O, 36)
    Jcr = torch.sum(Jcw * r[:, :, None], dim=1)
    Jpw = Jp * w[:, None, None]
    JpJp = mm(Jpw.transpose(-1, -2), Jp).reshape(O, 9)
    Jpr = torch.sum(Jpw * r[:, :, None], dim=1)
    A = mm(Jcw.transpose(-1, -2), Jp).reshape(O, 18)
    Vc = torch.cat([JcJc, Jcr], dim=1)
    Vp = torch.cat([JpJp, Jpr], dim=1)
    cost = torch.sum(_robust_cost(chi2, is_stereo, th_m, th_s, use_huber) * active)
    return Vc, Vp, A, cost


def build_normal_terms(prob: BAProblem, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg: BAConfig, active, use_huber,
                       obs_slot=None, reduce=None):
    """One linearization: the normal-equation blocks.

    ``active``: (O,) weights in {0,1} (validity x inlier classification);
    ``obs_slot``: the loop-invariant free-slot index of every observation
    (computed here when not given). The frame side is an exact float32
    ``index_add_``. ``reduce``: the point side's reducer, ``(A, Vp,
    obs_point, obs_slot, P, FF) -> (P, FF*18 + 12)`` (``ops/cuda_ba.py``);
    None sums it in float32 with ``index_add_`` (``"scatter"``), of bf16
    summands where ``cfg.bf16_point_side``.
    Returns (H_cc (FF, 6, 6), b_c (FF, 6), H_pp (P, 3, 3), b_p (P, 3),
    U (P, FF, 6, 3), cost).
    """
    P = prob.X.shape[0]
    FF = cfg.max_free_frames
    if obs_slot is None:
        obs_slot = _free_rank(prob, FF)[prob.obs_frame]
    Vc, Vp, A, cost = _obs_value_rows(prob, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg, active, use_huber)
    Hb_c = torch.zeros((FF, 42), dtype=Vc.dtype, device=Vc.device).index_add_(0, obs_slot, Vc)
    H_cc, b_c = Hb_c[:, :36].reshape(FF, 6, 6), -Hb_c[:, 36:]
    if reduce is None:
        if cfg.bf16_point_side:
            Vp, A = Vp.to(torch.bfloat16).to(Vp.dtype), A.to(torch.bfloat16).to(A.dtype)
        Hb_p = torch.zeros((P, 12), dtype=Vp.dtype, device=Vp.device).index_add_(0, prob.obs_point, Vp)
        U = torch.zeros((P * FF, 18), dtype=A.dtype, device=A.device).index_add_(0, prob.obs_point * FF + obs_slot, A)
        return H_cc, b_c, Hb_p[:, :9].reshape(P, 3, 3), -Hb_p[:, 9:], U.reshape(P, FF, 6, 3), cost
    out = reduce(A, Vp, prob.obs_point, obs_slot, P, FF)
    H_pp = out[:, FF * 18 : FF * 18 + 9].reshape(P, 3, 3)
    return H_cc, b_c, H_pp, -out[:, FF * 18 + 9 :], out[:, : FF * 18].reshape(P, FF, 6, 3), cost


def build_normal_terms_pallas(prob: BAProblem, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg: BAConfig, active, use_huber,
                              obs_slot=None, plain: bool = False):
    """The ``"pallas"`` assembly: the point side by the ``point_reduce``
    kernel over the observations in the caller's order (bf16 summands,
    float32 accumulation, atomics)."""
    return build_normal_terms(prob, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg, active, use_huber, obs_slot=obs_slot,
                              reduce=partial(cuda_ba.point_reduce, plain=plain))


class SortedLayout(NamedTuple):
    """Loop-invariant index structure of the ``"sorted"`` assembly, every
    observation-indexed tensor in point-sorted order."""

    slot: torch.Tensor  # (O,) free-frame slot of each sorted row
    seg_start: torch.Tensor  # (P + 1,) rows seg_start[p]:seg_start[p+1] observe point p; invalid rows follow seg_start[P]


def permute_observations(prob: BAProblem, order: torch.Tensor) -> BAProblem:
    return prob._replace(
        obs_frame=prob.obs_frame[order],
        obs_point=prob.obs_point[order],
        obs_uv=prob.obs_uv[order],
        obs_valid=prob.obs_valid[order],
    )


def make_sorted_layout(prob: BAProblem, cfg: BAConfig):
    """Sort the observations by point (stably, so rows of one point keep
    the caller's order and the sums their fixed order) and build the CSR
    ``seg_start`` the kernel reads; once per BA problem. Invalid
    observations (padding: zero value rows, all on point 0) sort last and
    belong to no point's rows, so no warp walks them. Returns ``(order,
    prob_s, layout)``: the permutation, the sorted problem and a
    :class:`SortedLayout`. The TPU kernel's 512-row window table has no
    counterpart: it sized VMEM accumulator windows."""
    P = prob.X.shape[0]
    key = torch.where(prob.obs_valid, prob.obs_point, torch.full_like(prob.obs_point, P))
    order = torch.argsort(key, stable=True)
    prob_s = permute_observations(prob, order)
    seg_start = torch.searchsorted(key[order], torch.arange(P + 1, dtype=key.dtype, device=key.device))
    slot = _free_rank(prob, cfg.max_free_frames)[prob_s.obs_frame]
    return order, prob_s, SortedLayout(slot=slot, seg_start=seg_start)


def build_normal_terms_sorted(prob_s: BAProblem, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg: BAConfig, active,
                              use_huber, layout: SortedLayout, plain: bool = False):
    """The ``"sorted"`` assembly on a point-sorted problem (see
    :func:`make_sorted_layout`): the point side by the
    ``point_reduce_sorted`` kernel, each point's rows summed in order
    (bf16 summands, float32 accumulation)."""

    def reduce(A, Vp, pt, slot, P, FF):
        return cuda_ba.point_reduce_sorted(A, Vp, pt, slot, layout.seg_start, FF, plain=plain)

    return build_normal_terms(prob_s, R_cw, t_cw, X, fx, fy, cx, cy, bf, cfg, active, use_huber,
                              obs_slot=layout.slot, reduce=reduce)


# the JAX package's bound on a one-hot indicator (O x P elements): past it
# its matmul assembly would materialize gigabytes
ONE_HOT_LIMIT = 128 * 1024 * 1024


def resolve_assembly(cfg: BAConfig, n_obs: int = 0, n_points: int = 0) -> str:
    """``"auto"`` -> ``"scatter"`` up to 128M indicator elements (O x P),
    ``"sorted"`` beyond: the JAX package's threshold, where its one-hot
    matmul would materialize gigabytes (a global BA at 65k points and 500k
    observations). Window BA stays far below it. Other values pass."""
    if cfg.assembly != "auto":
        return cfg.assembly
    if n_obs * n_points > ONE_HOT_LIMIT:
        return "sorted"
    return "scatter"


def solve_schur(H_cc, b_c, H_pp, b_p, U, slot_active, point_free, lam, psum=None):
    """Damped Schur-complement solve over the FREE-frame camera system ->
    (delta_c (FF, 6) per free slot, delta_p (P, 3)).

    ``slot_active``: (FF,) mask of free slots actually populated;
    ``point_free``: (P,). Inactive unknowns get a pinned identity block
    (delta = 0). A reduced system that is not positive definite yields
    NaN steps, which the caller's accept test rejects. ``psum``: on a mesh,
    the sum over ranks of ``[H_cc, b_c, S_red, b_red]`` (one collective);
    every rank then solves the same reduced system.
    """
    assert_true_float32_matmul()
    FF = H_cc.shape[0]
    P = H_pp.shape[0]
    dev, dt = H_cc.device, H_cc.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    H_ppd = H_pp + lam * eye3 + (~point_free)[:, None, None].to(dt) * eye3
    Hpp_inv = inv3x3(H_ppd) * point_free[:, None, None].to(dt)

    Ur = U.reshape(P, FF * 6, 3)
    V = mm(Ur, Hpp_inv)  # (P, 6FF, 3): U Hpp^-1
    S_red = torch.matmul(V.permute(1, 0, 2).reshape(FF * 6, P * 3), Ur.permute(0, 2, 1).reshape(P * 3, FF * 6))
    b_red = torch.sum(V * b_p[:, None, :], dim=(0, 2))
    if psum is not None:
        H_cc, b_c, S_red, b_red = psum([H_cc, b_c, S_red, b_red])

    S_full = torch.block_diag(*(H_cc + lam * eye6)) - S_red

    # Pin inactive rows/cols: S <- M S M + (I - M).
    M = torch.repeat_interleave(slot_active, 6).to(dt)
    S_full = S_full * M[:, None] * M[None, :] + torch.diag(1.0 - M)
    b_s = (b_c.reshape(FF * 6) - b_red) * M

    L, info = torch.linalg.cholesky_ex(S_full)
    dc = torch.cholesky_solve(b_s[:, None], L)[:, 0]
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan")))
    # Back-substitution: delta_p = Hpp^-1 (b_p - U^T delta_c).
    rhs_p = b_p - torch.sum(Ur * dc[None, :, None], dim=1)
    delta_p = mv(Hpp_inv, rhs_p)
    return dc.reshape(FF, 6), delta_p


def _apply_update(R_cw, t_cw, X, delta_c, delta_p, frame_free, point_free):
    dR, dt = se3_exp(delta_c)
    R_new = torch.where(frame_free[:, None, None], mm(dR, R_cw), R_cw)
    t_new = torch.where(frame_free[:, None], mv(dR, t_cw) + dt, t_cw)
    X_new = torch.where(point_free[:, None], X + delta_p, X)
    return R_new, t_new, X_new


def bundle_adjust(
    prob: BAProblem,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float = 0.0,
    cfg: BAConfig = BAConfig(),
    plain: bool = False,
    psum=None,
) -> BAResult:
    """Two-phase robust LM bundle adjustment; nothing is read back to the
    host inside it. ``plain=True`` runs the point-reduce kernels' plain
    versions on any device (the on-card comparison); the inlier verdicts
    come back in the caller's observation order on every route.

    ``psum``: ``prob`` is one rank's block of points and observations
    (``parallel/dist_ba``), and ``psum(tensors)`` sums a list of tensors
    over the ranks in one collective. It sums the reduced camera system
    each step and every cost, so every flag of the loop reads the same
    values on every rank; ``X`` and the verdicts stay the rank's own."""
    assembly = resolve_assembly(cfg, n_obs=prob.obs_frame.shape[0], n_points=prob.X.shape[0])
    FF = cfg.max_free_frames
    frame_free = _effective_free(prob, FF)
    point_free = prob.point_valid
    free_rank = _free_rank(prob, FF)
    slot_active = torch.arange(FF, device=prob.X.device) < torch.sum(frame_free.to(torch.int64))

    unsort = None
    if assembly == "sorted":
        # the index structure is loop-invariant: sorted once, not per LM step
        unsort, prob, layout = make_sorted_layout(prob, cfg)
        builder = partial(build_normal_terms_sorted, layout=layout, plain=plain)
    elif assembly == "pallas":
        builder = partial(build_normal_terms_pallas, obs_slot=free_rank[prob.obs_frame], plain=plain)
    elif assembly == "scatter":
        builder = partial(build_normal_terms, obs_slot=free_rank[prob.obs_frame])
    else:
        raise ValueError(f"BAConfig.assembly={cfg.assembly!r}")

    R_cw0, t_cw0 = _invert_poses(prob.R_wc, prob.t_wc)
    geom = (fx, fy, cx, cy, bf)

    def cost_of(R_cw, t_cw, X, active, use_huber):
        cost = _cost(prob, R_cw, t_cw, X, *geom, cfg, active, use_huber)
        return cost if psum is None else psum([cost])[0]

    def lm_phase(state, active, n_iters, use_huber):
        def linearize(R_cw, t_cw, X):
            return builder(prob, R_cw, t_cw, X, *geom, cfg, active, use_huber)[:5]

        R_cw, t_cw, X = state
        cost = cost_of(R_cw, t_cw, X, active, use_huber)
        lam = torch.tensor(cfg.lm_lambda0, dtype=X.dtype, device=X.device)
        lin = linearize(R_cw, t_cw, X)
        done = torch.zeros((), dtype=torch.bool, device=X.device)
        for _ in range(n_iters):
            delta_c_free, delta_p = solve_schur(*lin, slot_active, point_free, lam, psum=psum)
            delta_c = delta_c_free[free_rank] * frame_free[:, None].to(delta_c_free.dtype)
            R_try, t_try, X_try = _apply_update(R_cw, t_cw, X, delta_c, delta_p, frame_free, point_free)
            cost_try = cost_of(R_try, t_try, X_try, active, use_huber)
            accept = cost_try < cost
            # converged: an accepted step no longer moves the cost
            rel = (cost - cost_try) / torch.clamp(cost, min=1e-12)
            take = accept & ~done  # the state moves only while the phase is live
            grow = ~accept & ~done
            done = done | (accept & (rel < cfg.tol))
            R_cw = torch.where(take, R_try, R_cw)
            t_cw = torch.where(take, t_try, t_cw)
            X = torch.where(take, X_try, X)
            lam = torch.clamp(torch.where(take, lam * 0.5, torch.where(grow, lam * 4.0, lam)), 1e-8, 1e6)
            cost = torch.where(take, cost_try, cost)
            # a rejected step retries with larger lambda against the SAME
            # linearization; after an accepted one the new linearization
            # is selected (computed every time: no flag is read back)
            relin = take & ~done
            lin = tuple(torch.where(relin, new, old) for new, old in zip(linearize(R_cw, t_cw, X), lin))
        return (R_cw, t_cw, X), cost

    active0 = prob.obs_valid.to(prob.X.dtype)
    state = (R_cw0, t_cw0, prob.X)
    state, _ = lm_phase(state, active0, cfg.iters_phase1, use_huber=True)

    # chi^2 gate between phases
    chi2, is_stereo, depth_pos = _cost_and_gate(prob, *state, *geom)
    th_m, th_s = _thresholds(is_stereo, cfg, chi2.dtype)
    th = torch.where(is_stereo, th_s, th_m)
    inlier = prob.obs_valid & (chi2 <= th) & depth_pos
    state, cost = lm_phase(state, inlier.to(prob.X.dtype), cfg.iters_phase2, use_huber=False)

    # final verdicts
    chi2, is_stereo, depth_pos = _cost_and_gate(prob, *state, *geom)
    inlier = prob.obs_valid & (chi2 <= th) & depth_pos
    if unsort is not None:
        inlier = torch.empty_like(inlier).index_put_((unsort,), inlier)

    R_cw, t_cw, X = state
    R_wc, t_wc = _invert_poses(R_cw, t_cw)
    return BAResult(R_wc=R_wc, t_wc=t_wc, X=X, obs_inlier=inlier, cost=cost)
