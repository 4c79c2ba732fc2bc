"""Wrapper of the pose-GN kernel ``csrc/pose_gn.cu`` (counterpart of
``ur_mvo_tpu.ops.pallas_pose.optimize_pose_pallas``).

The kernel runs the whole robust Gauss-Newton schedule of
:func:`ur_mvo_tpu_torch.ops.pose_opt.optimize_pose` in one launch, one
thread block per problem. Its plain version is
``pose_opt.optimize_pose_plain``; this module is only reached with CUDA
tensors and raises on anything the kernel does not take.

Each launch also adds the GN steps its problems ran to a counter on the
device (one atomic add a block, no launch and no sync of its own):
:func:`steps_run` reads the total since :func:`reset_steps`.
"""

from __future__ import annotations

import torch

from ur_mvo_tpu_torch.ops import cuda_ext

_step_total: dict[torch.device, torch.Tensor] = {}  # (1,) int64 on each device
_problems = 0


def reset_steps() -> None:
    global _problems
    for total in _step_total.values():
        total.zero_()
    _problems = 0


def steps_run() -> tuple[int, int]:
    """(GN steps, problems) of the ``pose_gn`` launches since :func:`reset_steps`."""
    return sum(int(total.item()) for total in _step_total.values()), _problems


def pose_gn(
    R_cw0: torch.Tensor,
    t_cw0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    bf: float,
    chi2_mono: float,
    chi2_stereo: float,
    rounds: int,
    iters_per_round: int,
    damping: float,
    huber_blind: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``R_cw0`` (B, 3, 3), ``t_cw0`` (B, 3), ``X`` / ``uv`` (B, N, 3),
    ``valid`` (B, N) bool, all on one CUDA device -> (R (B, 3, 3),
    t (B, 3), inliers (B, N) bool, steps (B,) int32: the GN steps each
    problem ran). One launch for all B problems. ``huber_blind`` is a
    control that must miss the right result: its round-repeat test ignores
    the Huber flag."""
    global _problems
    if X.device.type != "cuda":
        raise ValueError(f"pose_gn: needs CUDA tensors, got {X.device}")
    if X.dim() != 3 or X.shape[-1] != 3 or uv.shape != X.shape:
        raise ValueError(f"pose_gn: shapes X{tuple(X.shape)} uv{tuple(uv.shape)}")
    B, N = X.shape[0], X.shape[1]
    if valid.shape != (B, N) or R_cw0.shape != (B, 3, 3) or t_cw0.shape != (B, 3):
        raise ValueError(
            f"pose_gn: shapes valid{tuple(valid.shape)} R0{tuple(R_cw0.shape)} t0{tuple(t_cw0.shape)} for B={B}, N={N}"
        )
    total = _step_total.get(X.device)
    if total is None:
        total = _step_total[X.device] = torch.zeros(1, dtype=torch.int64, device=X.device)
    f32 = torch.float32
    pose, inl, steps = cuda_ext.extension().pose_gn(
        X.to(f32).contiguous(), uv.to(f32).contiguous(), valid.to(torch.uint8).contiguous(),
        R_cw0.to(f32).contiguous(), t_cw0.to(f32).contiguous(),
        float(fx), float(fy), float(cx), float(cy), float(bf), float(chi2_mono), float(chi2_stereo),
        int(rounds), int(iters_per_round), float(damping), total, bool(huber_blind),
    )
    cuda_ext.count("pose_gn")
    _problems += B
    return pose[:, :9].reshape(B, 3, 3), pose[:, 9:12], inl.to(torch.bool), steps
